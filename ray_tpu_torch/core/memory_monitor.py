"""OOM control: kill the newest busy worker when host memory runs out.

Ref parity: the reference's MemoryMonitor + WorkerKillingPolicy
(src/ray/common/memory_monitor.h:52 polls /proc meminfo on a period;
retriable_lifo_order worker_killing_policy.cc kills the most recently
started retriable task first, so long-running work survives and the
killed task retries with backoff). The kill surfaces to the owner as a
WorkerCrashedError, which the normal retry machinery handles.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional


def read_meminfo_bytes() -> tuple:
    """(total_bytes, available_bytes) from /proc/meminfo — the ONE
    parser shared by the OOM monitor and the telemetry reporter
    (MemAvailable-based; free+cache alone undercounts reclaimable).
    (0, 0) when /proc is unreadable."""
    total = avail = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1])
                if total is not None and avail is not None:
                    break
    except OSError:
        return 0, 0
    return (total or 0) * 1024, (avail or 0) * 1024


def system_memory_usage_fraction() -> float:
    """Host memory pressure from /proc/meminfo."""
    total, avail = read_meminfo_bytes()
    if not total:
        return 0.0
    return 1.0 - avail / total


class MemoryMonitor:
    """Head-embedded monitor over the local nodes' worker pools."""

    def __init__(self, head, usage_fn: Optional[Callable[[], float]] = None,
                 period_s: Optional[float] = None,
                 threshold: Optional[float] = None):
        from .config import get_config

        cfg = get_config()
        self._head = head
        self._usage_fn = usage_fn or system_memory_usage_fraction
        self._period = period_s if period_s is not None else \
            cfg.memory_monitor_refresh_s
        self._threshold = threshold if threshold is not None else \
            cfg.memory_usage_threshold
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="memory-monitor")
        self.kills = 0  # observability + tests
        # one kill per cooldown: give the freed memory time to show up in
        # the next usage reading before escalating to another victim
        # (the reference re-reads memory after the worker exits)
        self.kill_cooldown_s = 2.0
        self._last_kill = 0.0

    def start(self):
        if self._period > 0:
            self._thread.start()

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(self._period):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — monitoring must not die
                pass

    def check_once(self):
        import time

        usage = self._usage_fn()
        if usage < self._threshold:
            return
        if time.monotonic() - self._last_kill < self.kill_cooldown_s:
            return
        victim = self._pick_victim()
        if victim is None:
            return
        self._last_kill = time.monotonic()
        self.kills += 1
        w, node = victim
        import sys

        print(f"ray_tpu memory monitor: host memory at {usage:.0%} >= "
              f"{self._threshold:.0%}; killing worker {w.worker_id[:8]} "
              f"(newest busy, retriable) to relieve pressure",
              file=sys.stderr)
        self._head.emit_event(
            "ERROR", "memory_monitor", "worker_oom_kill",
            f"worker {w.worker_id[:8]} killed: host memory at "
            f"{usage:.0%} >= {self._threshold:.0%}",
            node_idx=w.node_idx, entity_id=w.worker_id,
            extra={"usage": round(usage, 4),
                   "threshold": self._threshold})
        self._head._kill_worker_process(w)
        self._head._handle_worker_death(w)
        with self._head._lock:
            node.workers.pop(w.worker_id, None)

    def _pick_victim(self):
        """Newest BUSY worker (leased or actor), LIFO by spawn time — the
        reference's retriable-LIFO policy: the youngest work loses, so
        long-running tasks keep their progress."""
        with self._head._lock:
            candidates = [
                (w, node)
                for node in self._head.nodes.values()
                if not node.is_remote
                for w in node.workers.values()
                if w.state in ("leased", "actor")
            ]
        if not candidates:
            return None
        return max(candidates, key=lambda wn: wn[0].spawned_at)
