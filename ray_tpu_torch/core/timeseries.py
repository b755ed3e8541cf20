"""Flight recorder: bounded in-memory time series over the head's
merged metric table (r19).

The head calls :meth:`FlightRecorder.sample` from its housekeeping
loop every ``timeseries_sample_s`` seconds, passing the same merged
metric rows that back ``metrics_summary()``. Each metric folds into
one or more scalar series:

- **counters** -> a per-second *rate* series (delta between
  consecutive cumulative samples / elapsed; negative deltas — a
  process restart resetting its counter — clamp to zero rather than
  emitting a large negative spike),
- **gauges** -> the sampled value as-is,
- **histograms** -> three point-estimate series (``<name>.p50`` /
  ``.p95`` / ``.p99``) via the standard linear-interpolation bucket
  estimator.

Memory is bounded per series by construction, not by policy: a *fine*
ring holds the most recent ``window_s / sample_s`` points at full
resolution, and points that age out are folded 8:1 (mean of ts, mean
of value) into a *coarse* ring of the same capacity — so the recorder
covers ~9x the configured window end-to-end, the most recent window at
sample resolution and the older tail at 1/8 resolution, in O(2 *
window_s / sample_s) floats per series. The reference system ships
this job out-of-process (dashboard metrics agent -> Prometheus ->
Grafana); a single-binary cluster wants the recent history answerable
by the head itself (`state.metrics_history()` / ``/api/timeseries``)
with no external TSDB.
"""
from __future__ import annotations

import fnmatch
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence

# Fine->coarse fold factor: 8 fine points average into one coarse
# point, so the coarse ring (same capacity as fine) spans 8 windows.
DOWNSAMPLE = 8
# Safety valve on series cardinality, far above anything a sane
# cluster produces; beyond it new series are counted, not stored.
MAX_SERIES = 4096


def hist_quantile(bounds, value, q: float) -> float:
    """Estimate the q-quantile of a [bucket counts..., +inf, sum, n]
    histogram row by linear interpolation inside the holding bucket
    (the Prometheus histogram_quantile estimator); the +Inf bucket
    clamps to the last finite bound."""
    n = value[-1]
    if n <= 0:
        return 0.0
    target = q * n
    acc, lo = 0.0, 0.0
    for i, b in enumerate(bounds):
        c = value[i]
        if c > 0 and acc + c >= target:
            return lo + (b - lo) * max(0.0, min(1.0, (target - acc) / c))
        acc += c
        lo = b
    return float(bounds[-1])


def series_key(name: str, tags: Optional[dict]) -> str:
    """Stable series identity: ``name`` or ``name{k=v,...}`` with
    sorted tag keys (mirrors the Prometheus exposition identity)."""
    if not tags:
        return name
    inner = ",".join(f"{k}={tags[k]}" for k in sorted(tags))
    return f"{name}{{{inner}}}"


class _Series:
    __slots__ = ("kind", "fine", "coarse", "_pending", "last_raw",
                 "last_ts")

    def __init__(self, kind: str, fine_cap: int):
        self.kind = kind                    # "rate" | "gauge" | "quantile"
        self.fine: deque = deque()          # (ts, value), manual eviction
        self.coarse: deque = deque(maxlen=fine_cap)
        self._pending: List[tuple] = []     # fine evictions awaiting fold
        self.last_raw: Optional[float] = None   # counters: last cumulative
        self.last_ts: Optional[float] = None

    def push(self, ts: float, value: float, fine_cap: int):
        self.fine.append((ts, value))
        while len(self.fine) > fine_cap:
            self._pending.append(self.fine.popleft())
            if len(self._pending) >= DOWNSAMPLE:
                n = len(self._pending)
                self.coarse.append((
                    sum(p[0] for p in self._pending) / n,
                    sum(p[1] for p in self._pending) / n,
                ))
                self._pending.clear()


class FlightRecorder:
    """Bounded ring-buffer recorder over metric-table snapshots.

    Thread-safe: ``sample()`` runs on the head housekeeping thread
    while ``history()`` is served from IO threads.
    """

    def __init__(self, sample_s: float = 1.0, window_s: float = 300.0):
        self.sample_s = float(sample_s)
        self.window_s = float(window_s)
        self.fine_cap = max(2, int(round(window_s / max(sample_s, 1e-6))))
        self._series: Dict[str, _Series] = {}
        self._lock = threading.Lock()
        self.samples_taken = 0
        self.series_dropped = 0  # new series refused past MAX_SERIES

    # -- ingestion ----------------------------------------------------

    def _get(self, key: str, kind: str) -> Optional[_Series]:
        s = self._series.get(key)
        if s is None:
            if len(self._series) >= MAX_SERIES:
                self.series_dropped += 1
                return None
            s = self._series[key] = _Series(kind, self.fine_cap)
        return s

    def sample(self, rows: Sequence[dict], now: float):
        """Fold one merged-metric-table snapshot into the rings.

        ``rows`` use the head's merged schema: ``{name, kind, tags,
        boundaries, value}`` where histogram values are the
        ``[buckets..., +inf, sum, n]`` list.
        """
        with self._lock:
            self.samples_taken += 1
            for row in rows:
                kind = row.get("kind")
                name = row.get("name")
                tags = row.get("tags") or {}
                value = row.get("value")
                if kind == "counter":
                    s = self._get(series_key(name, tags), "rate")
                    if s is None:
                        continue
                    v = float(value)
                    if s.last_raw is not None and s.last_ts is not None:
                        dt = now - s.last_ts
                        if dt > 0:
                            rate = max(0.0, (v - s.last_raw) / dt)
                            s.push(now, rate, self.fine_cap)
                    s.last_raw, s.last_ts = v, now
                elif kind == "gauge":
                    s = self._get(series_key(name, tags), "gauge")
                    if s is not None:
                        s.push(now, float(value), self.fine_cap)
                elif kind == "histogram":
                    bounds = row.get("boundaries")
                    if not bounds or not value:
                        continue
                    for q, suffix in ((0.50, "p50"), (0.95, "p95"),
                                      (0.99, "p99")):
                        key = series_key(f"{name}.{suffix}", tags)
                        s = self._get(key, "quantile")
                        if s is not None:
                            s.push(now, hist_quantile(bounds, value, q),
                                   self.fine_cap)

    # -- queries ------------------------------------------------------

    @staticmethod
    def _match(patterns: Optional[Sequence[str]], key: str) -> bool:
        if not patterns:
            return True
        base = key.split("{", 1)[0]
        for p in patterns:
            if "*" in p or "?" in p or "[" in p:
                if fnmatch.fnmatchcase(base, p) or \
                        fnmatch.fnmatchcase(key, p):
                    return True
            elif base == p or key == p or base.startswith(p + ".") \
                    or key.startswith(p):
                return True
        return False

    def history(self, names: Optional[Sequence[str]] = None,
                window_s: Optional[float] = None) -> dict:
        """Return matching series, fine points restricted to the most
        recent ``window_s`` seconds (default: the full fine window).
        ``names`` entries may be exact series keys, metric-name
        prefixes, or fnmatch globs (``collective.*``)."""
        with self._lock:
            out: Dict[str, dict] = {}
            horizon = None
            if window_s is not None:
                newest = max((s.fine[-1][0] for s in
                              self._series.values() if s.fine),
                             default=None)
                if newest is not None:
                    horizon = newest - float(window_s)
            for key, s in self._series.items():
                if not self._match(names, key):
                    continue
                pts = list(s.fine)
                if horizon is not None:
                    pts = [p for p in pts if p[0] >= horizon]
                out[key] = {
                    "kind": s.kind,
                    "points": [[t, v] for t, v in pts],
                    "coarse": [[t, v] for t, v in s.coarse],
                }
            return {
                "sample_s": self.sample_s,
                "window_s": self.window_s,
                "samples_taken": self.samples_taken,
                "series_dropped": self.series_dropped,
                "series": out,
            }

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)
