"""The device trace of a measured window, reduced to what the per-layer
metrics read.

``Window`` runs ``torch.profiler`` (CPU and CUDA activities) around the
window and marks the window with a user annotation, so that the window is
read in the trace's own clock. ``summary`` returns, for the device
operations (kernels, copies, sets) that ran inside it: the time in which
any ran (``busy_s``), the window's length (``window_s``), time and count by
name (``ops``), the ten longest by time (``device_ops``), and the ten
longest idle gaps, each named by the host operation that was running when
the gap began (``idle_gaps``).
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

MARK = "bench.window"
_NAMED_GAPS = 200  # the longest gaps named by host operation; the rest summed


def _on_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", lambda: False)())


class Window:
    """``with Window(enabled): ...``; then ``summary()`` (None when not
    enabled). ``host_ops=False`` traces the device alone: in a serving
    replica, recording every host operation of its busy threads slows the
    engine and starves it while the trace is read. The window is then the
    host clock's length of the session, from the first device operation."""

    def __init__(self, enabled: bool, host_ops: bool = True):
        self.enabled = enabled
        self.host_ops = host_ops
        self._prof = None
        self._mark = None
        self._host_s = 0.0

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() \
                else []
            if self.host_ops or not acts:
                acts.append(ProfilerActivity.CPU)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._t0 = time.monotonic()
            if self.host_ops:
                self._mark = torch.profiler.record_function(MARK)
                self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            import torch

            if self._mark is not None:
                self._mark.__exit__(None, None, None)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._host_s = time.monotonic() - self._t0
            self._prof.__exit__(None, None, None)
        return False

    def summary(self) -> Optional[dict]:
        if not self.enabled:
            return None
        return reduce_events(self._prof.profiler.kineto_results.events(),
                             self._host_s)


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce_events(events, host_s: float) -> dict:
    w0 = w1 = None
    device, host = [], []
    for e in events:
        name = e.name()
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), name)
        if _on_device(e):
            # kernels, copies and sets; not the annotations' device copies
            if name != MARK and not _annotation(e):
                device.append(span)
        elif name == MARK:
            if w0 is None:
                w0, w1 = span[0], span[1]
        else:
            host.append(span)
    if w0 is None:  # no mark: from the first device operation
        w0 = min((d[0] for d in device), default=0)
        w1 = w0 + int(host_s * 1e9)
    return reduce_intervals(device, host, w0, w1)


def reduce_intervals(device, host, w0: int, w1: int) -> dict:
    """``device``, ``host``: [(start_ns, end_ns, name)]; the window
    [w0, w1) in the same clock."""
    ops: Dict[str, List[float]] = {}
    clipped = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        clipped.append((s, e))
        rec = ops.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (e - s) / 1e9
    busy = _merge(clipped)
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    host.sort()
    starts = [h[0] for h in host]
    named: Dict[str, float] = {}
    gaps.sort(key=lambda g: g[0] - g[1])
    rest = sum(e - s for s, e in gaps[_NAMED_GAPS:]) / 1e9
    if rest:
        named["shorter gaps, not named"] = rest
    for s, e in gaps[:_NAMED_GAPS]:
        label = "host: no traced operation"
        i = bisect.bisect_right(starts, s) - 1
        # the latest-starting host operation still running when the gap began
        while i >= 0:
            hs, he, hn = host[i]
            if he > s and hn != MARK:
                label = f"host: {hn}"
                break
            if s - hs > 1_000_000_000:
                break
            i -= 1
        named[label] = named.get(label, 0.0) + (e - s) / 1e9
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][1])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_s,
        "ops": {k: v for k, v in top_ops[:300]},
        "device_ops": [[k, v[1]] for k, v in top_ops[:10]],
        "idle_gaps": [[k, v] for k, v in
                      sorted(named.items(), key=lambda kv: -kv[1])[:10]],
    }


def op_stats(summary: dict, pattern: str) -> Tuple[int, float]:
    """(calls, seconds) of the device operations whose name holds
    ``pattern``."""
    n, s = 0, 0.0
    for name, (calls, secs) in summary["ops"].items():
        if pattern in name:
            n += calls
            s += secs
    return n, s
