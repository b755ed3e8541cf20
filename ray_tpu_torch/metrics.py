"""Application + system metrics: Counter / Gauge / Histogram.

Ref parity: ray.util.metrics (python/ray/util/metrics.py Counter/Gauge/
Histogram over src/ray/stats/metric.h:103). Re-designed transport: each
process aggregates locally (tag-tuple -> float or bucket counts) and a
pusher thread flushes deltas to the head over the existing control
connection; the head merges per (name, tags) so `metrics_summary()` /
`python -m ray_tpu list metrics`-style queries see cluster totals. No
Prometheus/OpenCensus dependency — the head table IS the scrape target
(`export_prometheus()` renders the text exposition format).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_FLUSH_PERIOD_S = 2.0
_registry_lock = threading.Lock()
_registry: List["Metric"] = []
_pusher_started = False


def _tags_key(tags: Optional[Dict[str, str]], tag_keys: Sequence[str]
              ) -> Tuple[str, ...]:
    tags = tags or {}
    return tuple(str(tags.get(k, "")) for k in tag_keys)


class Metric:
    """Base: local aggregation + registration with the pusher."""

    kind = "counter"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        if not name:
            raise ValueError("metric name is required")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], float] = {}
        self._default_tags: Dict[str, str] = {}
        # registration LAST: the pusher snapshots registered metrics from
        # its own thread, so the instance must be fully initialized first
        # (subclasses with extra state register themselves instead)
        if type(self)._registers_in_base:
            self._register()

    _registers_in_base = True

    def _register(self):
        with _registry_lock:
            _registry.append(self)
        _ensure_pusher()

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _merged(self, tags):
        if self._default_tags:
            merged = dict(self._default_tags)
            merged.update(tags or {})
            return merged
        return tags

    # pusher protocol: drain (and reset deltas for counters)
    def _snapshot(self) -> List[tuple]:
        with self._lock:
            out = [(self.kind, self.name, self.description, self.tag_keys,
                    k, v) for k, v in self._values.items()]
            if self.kind == "counter":
                self._values.clear()  # counters push deltas
        return out


class Counter(Metric):
    """Monotonic count (ref: util/metrics.py Counter)."""

    kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("Counter.inc() value must be >= 0")
        key = _tags_key(self._merged(tags), self.tag_keys)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value


class Gauge(Metric):
    """Last-written value (ref: util/metrics.py Gauge)."""

    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = _tags_key(self._merged(tags), self.tag_keys)
        with self._lock:
            self._values[key] = float(value)


DEFAULT_BOUNDARIES = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                      2.5, 5.0, 10.0)


class Histogram(Metric):
    """Bucketed observations (ref: util/metrics.py Histogram)."""

    kind = "histogram"
    _registers_in_base = False  # registers below, after _hist exists

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = DEFAULT_BOUNDARIES,
                 tag_keys: Sequence[str] = ()):
        if not boundaries or list(boundaries) != sorted(boundaries):
            raise ValueError("boundaries must be sorted and non-empty")
        super().__init__(name, description, tag_keys)
        self.boundaries = tuple(boundaries)
        # per tag-key: [bucket counts..., +inf count, sum, n]
        self._hist: Dict[Tuple[str, ...], List[float]] = {}
        self._register()

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None):
        key = _tags_key(self._merged(tags), self.tag_keys)
        with self._lock:
            h = self._hist.get(key)
            if h is None:
                h = self._hist[key] = [0.0] * (len(self.boundaries) + 3)
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    h[i] += 1
                    break
            else:
                h[len(self.boundaries)] += 1
            h[-2] += value
            h[-1] += 1

    def _snapshot(self) -> List[tuple]:
        with self._lock:
            out = [("histogram", self.name, self.description,
                    (self.tag_keys, self.boundaries), k, list(v))
                   for k, v in self._hist.items()]
            self._hist.clear()  # histograms push deltas
        return out


# ---------------------------------------------------- object-plane metrics

_object_plane: Optional[Dict[str, Metric]] = None
_object_plane_lock = threading.Lock()

# pull latency spans shm memcpy (sub-ms) to multi-GiB cross-host (minutes)
PULL_LATENCY_BOUNDARIES = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                           10.0, 30.0, 60.0)


def object_plane_metrics() -> Dict[str, Metric]:
    """Lazily-created counters for the object data plane (reference:
    object_manager_stats / pull_manager metrics). ``source_count`` tags
    split single-source pulls from striped multi-source ones; the head's
    locality hit/miss counters live head-side and are surfaced through
    the ``object_plane`` state query instead (the head is the metrics
    aggregator, not a client)."""
    global _object_plane
    if _object_plane is None:
        with _object_plane_lock:
            if _object_plane is None:
                _object_plane = {
                    "pulls": Counter(
                        "object_plane.pulls",
                        "Completed object pulls, by concurrent source "
                        "count",
                        tag_keys=("source_count",)),
                    "pull_bytes": Counter(
                        "object_plane.pull_bytes",
                        "Bytes pulled from peer transfer servers",
                        tag_keys=("source_count",)),
                    "pull_latency": Histogram(
                        "object_plane.pull_latency_s",
                        "End-to-end object pull latency (seconds)",
                        boundaries=PULL_LATENCY_BOUNDARIES),
                    # serving side (TransferServer): role=root streams a
                    # sealed local copy, role=relay re-serves an
                    # in-progress pull chunk-by-chunk (cooperative
                    # broadcast tree)
                    "serves": Counter(
                        "object_plane.serves",
                        "OBJ_PULL ranges served to downstream pullers, "
                        "by source role",
                        tag_keys=("role",)),
                    "serve_bytes": Counter(
                        "object_plane.serve_bytes",
                        "Bytes streamed out of local arenas to "
                        "downstream pullers, by source role",
                        tag_keys=("role",)),
                }
    return _object_plane


# ------------------------------------------------------------ wire plane

_WIRE_DESCS = {
    "frames_sent": "Framed messages written to sockets",
    "sendmsg_calls": "Vectored write syscalls issued",
    "frames_coalesced": "Frames that shared a sendmsg with others",
    "coalesced_flushes": "Vectored writes carrying more than one frame",
    "zero_copy_bytes": "Raw-frame bytes sent with no intermediate copy",
    "bytes_sent": "Total bytes written to sockets",
    "task_done_batches": "TASK_DONE_BATCH completion frames sent",
    "task_done_batched": "Task completions that rode batched frames",
    "backpressure_hits": "Times a connection write queue hit its bound",
}
_wire_last: Dict[str, int] = {}
_wire_lock = threading.Lock()


def wire_metrics_snapshot() -> List[tuple]:
    """Delta rows for the process's wire fast-path counters
    (protocol.WIRE), in the pusher's batch schema — so `frames coalesced /
    batched completions / zero-copy bytes` aggregate cluster-wide next to
    the application metrics."""
    from .core.protocol import WIRE

    snap = WIRE.snapshot()
    out: List[tuple] = []
    with _wire_lock:
        for key, val in snap.items():
            delta = val - _wire_last.get(key, 0)
            if delta <= 0:
                continue
            _wire_last[key] = val
            out.append(("counter", f"wire.{key}", _WIRE_DESCS.get(key, ""),
                        (), (), float(delta)))
    return out


# ------------------------------------------------------------- transport


def _ensure_pusher():
    global _pusher_started
    with _registry_lock:
        if _pusher_started:
            return
        _pusher_started = True
    t = threading.Thread(target=_push_loop, daemon=True,
                         name="metrics-pusher")
    t.start()


def _push_loop():
    from .core import protocol as P
    from .core.context import get_context_if_exists

    while True:
        time.sleep(_FLUSH_PERIOD_S)
        ctx = get_context_if_exists()
        if ctx is None:
            continue
        with _registry_lock:
            metrics = list(_registry)
        batch: List[tuple] = []
        for m in metrics:
            batch.extend(m._snapshot())
        batch.extend(wire_metrics_snapshot())
        if not batch:
            continue
        try:
            ctx.head.send(P.METRICS_REPORT, batch)
        except Exception:  # noqa: BLE001 — shutdown race
            pass


def flush_now():
    """Push pending metric deltas immediately (tests / shutdown)."""
    from .core import protocol as P
    from .core.context import get_context_if_exists

    ctx = get_context_if_exists()
    if ctx is None:
        return
    with _registry_lock:
        metrics = list(_registry)
    batch: List[tuple] = []
    for m in metrics:
        batch.extend(m._snapshot())
    batch.extend(wire_metrics_snapshot())
    if batch:
        ctx.head.send(P.METRICS_REPORT, batch)


# ------------------------------------------------------------ query side


def metrics_summary() -> List[dict]:
    """Cluster-merged metric rows from the head."""
    from .core import protocol as P
    from .core.context import get_context

    (rows,) = get_context().head.call(P.STATE_QUERY, "metrics", 100000,
                                      timeout=30)
    return rows


def _escape_label_value(v) -> str:
    """Escape a label value per the Prometheus text exposition format
    spec: backslash, double-quote, and line-feed must be escaped (in
    that order — escaping the backslash first keeps it idempotent)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(tags: Dict[str, str]) -> str:
    return ",".join(f'{k}="{_escape_label_value(v)}"'
                    for k, v in tags.items())


def _escape_help(text: str) -> str:
    """HELP-line escaping per the exposition spec: backslash and
    line-feed only (double quotes are legal in HELP text)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


_NAME_SANITIZE = None  # compiled lazily (module import stays cheap)


def _metric_name(raw: str) -> str:
    """Sanitize to the spec's metric-name charset
    ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (dotted internal names like
    ``task.phase_ms`` become ``task_phase_ms``)."""
    global _NAME_SANITIZE
    if _NAME_SANITIZE is None:
        import re

        _NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")
    name = _NAME_SANITIZE.sub("_", raw)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def export_prometheus() -> str:
    """Render the head's metric table in Prometheus text exposition
    format (the reference exports via opencensus -> prometheus).

    Spec conformance (audited against the text-format spec, and parsed
    by a unit test): one ``# HELP``/``# TYPE`` header per metric family
    before any of its samples; histogram bucket counts are CUMULATIVE,
    always include the mandatory ``le="+Inf"`` bucket (whose value
    equals ``_count``), and every family ships its ``_sum``/``_count``
    series; label values escape backslash/quote/newline; metric names
    sanitize to the legal charset."""
    families: Dict[str, List[dict]] = {}
    order: List[str] = []
    for row in metrics_summary():
        name = _metric_name(row["name"])
        if name not in families:
            families[name] = []
            order.append(name)
        families[name].append(row)
    lines: List[str] = []
    for name in order:
        rows = families[name]
        kind = rows[0]["kind"]
        ptype = {"counter": "counter", "gauge": "gauge",
                 "histogram": "histogram"}.get(kind, "untyped")
        desc = next((r["description"] for r in rows
                     if r.get("description")), "")
        if desc:
            lines.append(f"# HELP {name} {_escape_help(desc)}")
        lines.append(f"# TYPE {name} {ptype}")
        for row in rows:
            tags = row["tags"]
            label = _label_str(tags)
            label = "{" + label + "}" if label else ""
            if row["kind"] == "histogram":
                h = row["value"]
                bounds = row["boundaries"]
                acc = 0.0
                for b, c in zip(list(bounds) + ["+Inf"], h[:-2]):
                    acc += c
                    ls = _label_str(dict(tags, le=str(b)))
                    lines.append(f"{name}_bucket{{{ls}}} {acc:g}")
                lines.append(f"{name}_sum{label} {h[-2]:g}")
                lines.append(f"{name}_count{label} {h[-1]:g}")
            else:
                lines.append(f"{name}{label} {row['value']:g}")
    return "\n".join(lines) + "\n"
