"""The port's dashboard endpoint smoke (`python -m ray_tpu_torch doctor`):
the cases of tests/test_doctor.py, one for one, on ray_tpu_torch's runtime
(``ray_start``: 4 CPUs, ``num_gpus=0``; doctor's own cluster has no GPU
either, and every dashboard listens on ``port=0``).
"""

import json

import ray_tpu_torch
from torch_port_util import deadline, ray_start  # noqa: F401 (fixture)


@deadline(120)
def test_doctor_all_endpoints_healthy():
    from ray_tpu_torch.dashboard import DOCTOR_ENDPOINTS, doctor

    booted = not ray_tpu_torch.is_initialized()
    results = doctor()
    if booted:
        # doctor boots (and tears down) its own 2-node cluster when no
        # runtime is up
        assert not ray_tpu_torch.is_initialized()
    assert {r["endpoint"] for r in results} == set(DOCTOR_ENDPOINTS)
    bad = [r for r in results if not r["ok"]]
    assert not bad, f"unhealthy endpoints: {bad}"
    assert all(r["status"] == 200 for r in results), results


@deadline(120)
def test_doctor_cli_exit_code(ray_start):
    """The CLI wrapper returns 0 on a healthy cluster (wired as the CI
    smoke gate); with a runtime already up it probes that cluster."""
    from ray_tpu_torch.scripts import main

    assert main(["doctor"]) == 0


@deadline(120)
def test_doctor_reports_500(ray_start, monkeypatch):
    """A broken endpoint must fail the doctor, not pass silently."""
    from ray_tpu_torch import dashboard as dash_mod
    from ray_tpu_torch import state

    def boom(*a, **k):
        raise RuntimeError("injected endpoint rot")

    monkeypatch.setattr(state, "list_objects", boom)
    results = dash_mod.doctor()
    by_ep = {r["endpoint"]: r for r in results}
    assert by_ep["/api/objects"]["status"] == 500
    assert not by_ep["/api/objects"]["ok"]
    assert by_ep["/api/nodes"]["ok"]


@deadline(120)
def test_doctor_warns_on_event_drops(ray_start):
    """Nonzero task/cluster event drop counters silently blind the task
    timelines — the doctor must warn about them."""
    from ray_tpu_torch import dashboard as dash_mod
    from ray_tpu_torch.core.api import _head

    # /dev/shm is machine-global: an earlier chaos test's hard-killed
    # agent (or an unrelated session) may legitimately have orphaned
    # rtpu_* arenas — that warning is not this test's subject
    assert [w for w in dash_mod.doctor_warnings()
            if "orphaned arena" not in w] == []
    maxlen = _head.cluster_events.maxlen
    for n in range(maxlen + 3):
        _head.emit_event("INFO", "test", "filler", f"event {n}")
    warns = dash_mod.doctor_warnings()
    assert any("cluster_events_dropped" in w for w in warns), warns
    tmax = _head.task_events.maxlen
    batch = [(f"t{n}", "x", "RUNNING", "w", 0, 0.0, "", "", "", "")
             for n in range(tmax + 2)]
    _head._h_task_events(None, 0, batch, 0)
    warns = dash_mod.doctor_warnings()
    assert any("task_events_dropped" in w for w in warns), warns


@deadline(120)
def test_doctor_warns_on_prefetch_waste(ray_start):
    """A mostly-wasted prefetch window (task cancel/retry churn or
    misconfigured caps) must surface as a doctor warning; the check is
    windowed between doctor calls, so a long-past burst of waste does
    not alarm forever."""
    from ray_tpu_torch import dashboard as dash_mod
    from ray_tpu_torch.core.api import _head

    dash_mod.doctor_warnings()  # snapshot the window baseline
    _head.prefetch_issued += 40
    _head.prefetch_wasted += 30
    warns = dash_mod.doctor_warnings()
    assert any("prefetch_wasted" in w for w in warns), warns
    # next window: counters unchanged -> no stale re-warning
    assert not any("prefetch_wasted" in w
                   for w in dash_mod.doctor_warnings())
    # healthy ratio in a new window -> quiet
    _head.prefetch_issued += 100
    _head.prefetch_wasted += 2
    assert not any("prefetch_wasted" in w
                   for w in dash_mod.doctor_warnings())


@deadline(120)
def test_summary_tasks_phase_percentiles_smoke(ray_start):
    """Tier-1 CI smoke: after a short 2-node workload,
    /api/summary/tasks reports per-phase p50/p95/p99 and /metrics
    contains the task_phase_ms_bucket histogram series."""
    import time
    import urllib.request

    import ray_tpu_torch
    from ray_tpu_torch.core.api import _head
    from ray_tpu_torch.core.context import get_context
    from ray_tpu_torch.dashboard import start_dashboard

    _head.add_node(num_cpus=1, num_gpus=0)

    @ray_tpu_torch.remote
    def phase_probe(i):
        return i

    ray_tpu_torch.get([phase_probe.remote(i) for i in range(6)],
                      timeout=60)
    get_context().events.flush(sync=True)
    want = {"sched_wait", "dispatch", "arg_fetch", "exec",
            "result_return", "e2e"}
    dash = start_dashboard(port=0)
    try:
        t_end = time.monotonic() + 20
        phases = {}
        while time.monotonic() < t_end:
            with urllib.request.urlopen(dash.url + "/api/summary/tasks",
                                        timeout=30) as r:
                summ = json.loads(r.read())
            phases = summ.get("phases", {}).get("phase_probe", {})
            # wait for the COUNTS, not just the phase keys: each
            # worker's event buffer flushes on its own ~1s cadence, so
            # under a loaded suite the first batches can land with
            # only part of the 6 tasks folded — breaking on keys alone
            # raced the remaining flushes (r18 deflake)
            if want <= set(phases) and all(
                    phases[p].get("count", 0) >= 6 for p in want):
                break
            time.sleep(0.3)  # worker event buffers flush on a 1s period
        assert want <= set(phases), phases
        for row in phases.values():
            assert row["count"] >= 6
            assert 0 <= row["p50_ms"] <= row["p95_ms"] <= row["p99_ms"]
        with urllib.request.urlopen(dash.url + "/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
        assert "task_phase_ms_bucket" in text
        assert 'phase="exec"' in text
    finally:
        dash.stop()


@deadline(120)
def test_loop_lag_gauge_in_metrics_and_io_loop_state(ray_start):
    """Tier-1 2-node smoke (r11): after a short workload the head's
    loop-lag self-probe has samples, the io_loop state row carries the
    lag quantiles + fold-queue/lease-batch health fields, and
    head.loop_lag_ms rides the /metrics Prometheus exposition."""
    import time
    import urllib.request

    import ray_tpu_torch
    from ray_tpu_torch import state
    from ray_tpu_torch.core.api import _head
    from ray_tpu_torch.dashboard import start_dashboard

    _head.add_node(num_cpus=1, num_gpus=0)

    @ray_tpu_torch.remote
    def lag_probe(i):
        return i

    ray_tpu_torch.get([lag_probe.remote(i) for i in range(8)], timeout=60)
    t_end = time.monotonic() + 20
    row = {}
    while time.monotonic() < t_end:
        row = state.io_loop_stats()[0]
        if row.get("loop_lag_samples", 0) > 0:
            break
        time.sleep(0.3)  # probes ride the 0.25s housekeeping tick
    assert row.get("loop_lag_samples", 0) > 0, row
    for key in ("loop_lag_ms_p50", "loop_lag_ms_p99", "loop_lag_ms_max",
                "fold_queue_depth", "fold_queue_drops",
                "lease_grant_batches", "lease_grants_batched"):
        assert key in row, (key, row)
    dash = start_dashboard(port=0)
    try:
        t_end = time.monotonic() + 20
        text = ""
        while time.monotonic() < t_end:
            with urllib.request.urlopen(dash.url + "/metrics",
                                        timeout=30) as r:
                text = r.read().decode()
            if "head_loop_lag_ms" in text:
                break
            time.sleep(0.3)
        assert "head_loop_lag_ms" in text
        assert 'quantile="p99"' in text
    finally:
        dash.stop()


@deadline(120)
def test_cluster_events_endpoint_shape(ray_start):
    """/api/cluster_events serves the structured log as JSON."""
    import urllib.request

    from ray_tpu_torch.dashboard import start_dashboard

    dash = start_dashboard(port=0)
    try:
        with urllib.request.urlopen(
                dash.url + "/api/cluster_events", timeout=30) as resp:
            rows = json.loads(resp.read())
        assert isinstance(rows, list) and rows
        assert {"ts", "severity", "source", "node_idx", "entity_id",
                "type", "message", "extra"} <= set(rows[0])
    finally:
        dash.stop()
