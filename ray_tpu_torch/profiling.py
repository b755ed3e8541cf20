"""On-demand CPU flamegraphs of live workers (no py-spy dependency).

Ref analog: dashboard/modules/reporter/profile_manager.py — the
reference shells out to py-spy/memray against a worker PID. Re-design
for a sealed image: every worker installs a SIGUSR1 handler at boot
(worker_main). The profiler writes a request file
(`{session_dir}/profile/{worker_id}.req`) and signals the worker; the
handler spawns a daemon thread that samples `sys._current_frames()` at
the requested rate for the requested duration — a signal interrupts even
a worker stuck in a pure-Python busy loop — aggregates collapsed stacks
(Brendan Gregg "folded" format: `a;b;c count`), and writes
`{worker_id}.stacks.json`. The caller polls for the result. The folded
lines paste straight into flamegraph.pl / speedscope / inferno.

Surface: ``profile_worker()`` here, ``/api/profile`` on the dashboard,
``python -m ray_tpu profile <worker_id>`` on the CLI.
"""

from __future__ import annotations

import collections
import json
import os
import signal
import sys
import threading
import time
from typing import Dict, Optional

_DIR = "profile"


def _profile_dir(session_dir: str) -> str:
    d = os.path.join(session_dir, _DIR)
    os.makedirs(d, exist_ok=True)
    return d


# This module's own file: any sampled frame living here is profiler
# machinery (the SIGUSR1 handler interrupting user code, a concurrent
# request's sampler thread, profile_self's runner) — not user work, and
# it must not pollute the folded stacks (a flamegraph whose widest box
# is `collect_stacks` is measuring the measurement).
_THIS_FILE = os.path.abspath(__file__)
# memoized per raw co_filename string: the sampler visits every frame of
# every thread at every tick, and an abspath() per frame would be
# measurable self-overhead inside the very loop being profiled
_is_profiler_file: Dict[str, bool] = {}


def _profiler_frame(filename: str) -> bool:
    hit = _is_profiler_file.get(filename)
    if hit is None:
        hit = _is_profiler_file[filename] = (
            filename == __file__
            or os.path.abspath(filename) == _THIS_FILE)
    return hit


def collect_stacks(duration_s: float, hz: float,
                   skip_thread: Optional[int] = None) -> Dict[str, int]:
    """Sample every thread's stack for ``duration_s`` at ``hz``;
    -> {folded_stack: count}. Runs in-process (the sampler itself is
    excluded via ``skip_thread``; frames belonging to this module —
    signal handler, concurrent samplers — are filtered out of every
    stack, and a stack that was NOTHING but profiler frames is dropped
    entirely)."""
    counts: "collections.Counter[str]" = collections.Counter()
    period = 1.0 / max(hz, 1.0)
    end = time.monotonic() + duration_s
    while time.monotonic() < end:
        for tid, frame in sys._current_frames().items():
            if tid == (skip_thread or threading.get_ident()):
                continue
            parts = []
            f = frame
            while f is not None:
                code = f.f_code
                if not _profiler_frame(code.co_filename):
                    parts.append(f"{code.co_name} "
                                 f"({os.path.basename(code.co_filename)}:"
                                 f"{f.f_lineno})")
                f = f.f_back
            if parts:
                counts[";".join(reversed(parts))] += 1
        time.sleep(period)
    return dict(counts)


def folded(stacks: Dict[str, int]) -> str:
    """Collapsed-stack text, heaviest first (flamegraph.pl input)."""
    return "\n".join(f"{s} {n}" for s, n in
                     sorted(stacks.items(), key=lambda kv: -kv[1]))


# ---------------------------------------------------------------- worker side


def install_profile_handler(session_dir: str, worker_id: str):
    """Install the SIGUSR1-triggered sampler (called by worker_main)."""

    def _on_signal(_signum, _frame):
        # minimal work in the handler: hand off to a thread
        t = threading.Thread(target=_run_request,
                             args=(session_dir, worker_id),
                             daemon=True, name="stack-sampler")
        t.start()

    try:
        signal.signal(signal.SIGUSR1, _on_signal)
    except ValueError:  # non-main thread / unsupported platform
        pass


def _run_request(session_dir: str, worker_id: str):
    d = _profile_dir(session_dir)
    req_path = os.path.join(d, f"{worker_id}.req")
    try:
        with open(req_path) as f:
            req = json.load(f)
    except Exception:
        req = {}
    stacks = collect_stacks(float(req.get("duration_s", 1.0)),
                            float(req.get("hz", 100.0)))
    out = {"worker_id": worker_id, "pid": os.getpid(),
           "duration_s": req.get("duration_s", 1.0),
           "samples": sum(stacks.values()), "stacks": stacks}
    # per-request tmp name: two concurrent requests for the same worker
    # (double SIGUSR1 / racing /api/profile callers) must never
    # interleave writes into one tmp file — each writes its own and the
    # atomic replace makes the published .stacks.json always a complete
    # document (last writer wins)
    tmp = os.path.join(
        d, f".{worker_id}.{os.getpid()}.{threading.get_ident()}"
           ".stacks.tmp")
    try:
        with open(tmp, "w") as f:
            json.dump(out, f)
        os.replace(tmp, os.path.join(d, f"{worker_id}.stacks.json"))
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass  # already replaced (the normal path)


# ---------------------------------------------------------------- caller side


def profile_worker(worker_id: str, *, duration_s: float = 1.0,
                   hz: float = 100.0, timeout_s: float = 30.0) -> dict:
    """Flamegraph a live worker by id (`state.list_workers` ids).

    Signals the worker process (same-host workers — the reference's
    py-spy path has the same locality) and waits for its stack dump;
    -> {"stacks": {folded: count}, "folded": text, ...}.
    """
    import ray_tpu_torch
    from ray_tpu_torch.core import api as _api

    if not ray_tpu_torch.is_initialized():
        raise RuntimeError("ray_tpu_torch.init() first")
    head = _api._head  # the in-process Head (driver only)
    if head is None:
        raise RuntimeError(
            "profiling requires the driver (head) process; from a remote "
            "driver use profile_pid() with the worker's session dir")
    pid = None
    session_dir = head.session_dir
    with head._lock:
        for node in head.nodes.values():
            w = node.workers.get(worker_id)
            if w is not None and w.state != "dead":
                if node.is_remote:
                    raise RuntimeError(
                        "worker is on a remote host; run the profile from "
                        "that host's driver")
                pid = w.pid
                break
    if not pid:
        raise ValueError(f"no live worker {worker_id!r}")
    return profile_pid(session_dir, worker_id, pid, duration_s=duration_s,
                       hz=hz, timeout_s=timeout_s)


def profile_pid(session_dir: str, worker_id: str, pid: int, *,
                duration_s: float = 1.0, hz: float = 100.0,
                timeout_s: float = 30.0) -> dict:
    """Signal a same-host worker process directly and wait for its stack
    dump (the CLI path — needs only the session dir + the pid that
    `state.list_workers` reports)."""
    d = _profile_dir(session_dir)
    out_path = os.path.join(d, f"{worker_id}.stacks.json")
    if os.path.exists(out_path):
        os.remove(out_path)
    with open(os.path.join(d, f"{worker_id}.req"), "w") as f:
        json.dump({"duration_s": duration_s, "hz": hz}, f)
    os.kill(pid, signal.SIGUSR1)
    deadline = time.monotonic() + duration_s + timeout_s
    while time.monotonic() < deadline:
        if os.path.exists(out_path):
            with open(out_path) as f:
                result = json.load(f)
            result["folded"] = folded(result["stacks"])
            return result
        time.sleep(0.05)
    raise TimeoutError(
        f"worker {worker_id} produced no profile within {timeout_s}s "
        f"(stuck in C code, or signal delivery failed)")


def profile_self(*, duration_s: float = 1.0, hz: float = 100.0) -> dict:
    """Flamegraph the CURRENT process (driver/head) without signals."""
    sampler_result = {}

    def run():
        sampler_result["stacks"] = collect_stacks(
            duration_s, hz, skip_thread=threading.get_ident())

    t = threading.Thread(target=run, name="stack-sampler")
    t.start()
    t.join(duration_s + 10)
    stacks = sampler_result.get("stacks", {})
    return {"pid": os.getpid(), "duration_s": duration_s,
            "samples": sum(stacks.values()), "stacks": stacks,
            "folded": folded(stacks)}
