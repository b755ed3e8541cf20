"""Head-side log monitor: tail worker log files -> driver mirroring.

The reference runs a log_monitor.py process per node that tails
`/tmp/ray/session_*/logs/worker-*` files and pushes appended lines to
drivers over GCS pubsub; the driver prints them prefixed with the worker
pid (python/ray/_private/log_monitor.py:103, worker.py print_logs). Here
the monitor is a thread inside the head process (the head already hosts
every local node's workers and receives remote agents' log lines over
their control connection), publishing on the "logs" pubsub channel that
drivers subscribe to when ``log_to_driver=True``.
"""

from __future__ import annotations

import os
import threading
from typing import Dict

POLL_PERIOD_S = 0.3


class LogMonitor:
    """Tails `{session_dir}/logs/worker-*.out` and publishes new lines."""

    def __init__(self, session_dir: str, publish, period_s: float = POLL_PERIOD_S):
        self.log_dir = os.path.join(session_dir, "logs")
        self._publish = publish          # callable(channel: str, payload)
        self._period = period_s
        self._offsets: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="log-monitor")

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(self._period):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — monitoring must not die
                pass

    def poll_once(self):
        if not os.path.isdir(self.log_dir):
            return
        for fname in sorted(os.listdir(self.log_dir)):
            if not fname.endswith(".out"):
                continue
            path = os.path.join(self.log_dir, fname)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            off = self._offsets.get(fname, 0)
            if size <= off:
                if size < off:  # truncated/rotated — restart from 0
                    self._offsets[fname] = 0
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(off)
                    chunk = f.read(min(size - off, 1 << 20))
            except OSError:
                continue
            # only ship complete lines; carry partials to the next poll —
            # unless the window is full (a single line larger than the cap
            # would otherwise stall this file's tailing forever): then
            # ship the whole window as one (split) line and move on
            nl = chunk.rfind(b"\n")
            if nl < 0:
                if len(chunk) < (1 << 20):
                    continue
                nl = len(chunk)
            self._offsets[fname] = off + min(nl + 1, len(chunk))
            lines = chunk[:nl].decode("utf-8", "replace").splitlines()
            if lines:
                self._publish("logs", {
                    "source": fname[:-len(".out")],
                    "lines": lines,
                })
