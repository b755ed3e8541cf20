"""The port's dashboard and CLI observability: the dashboard and CLI cases
of tests/test_timeseries.py (the /api/timeseries endpoint, the status
digest), tests/test_profiling.py (a flamegraph through /api/profile) and
tests/test_memory_observatory.py (the leak, pressure, deferred-delete and
dead-owner warnings, ``memory`` and ``list objects --sort-by``,
/api/summary/memory), one for one, on ray_tpu_torch's runtime
(``num_gpus=0``, dashboards on ``port=0``). Then the pure helpers held
against the JAX package's on the same inputs: the dashboard's warnings,
the status sparkline and the memory formatter.
"""

import json
import time
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import state
from ray_tpu_torch import state as state_api
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.dashboard import _arena_growth_warnings, _memory_warnings
from torch_port_util import deadline, ray_start  # noqa: F401 (fixture)


def _wait_for(pred, timeout=30.0, interval=0.2):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        out = pred()
        if out:
            return out
        time.sleep(interval)
    return pred()


# ================================================ tests/test_timeseries.py


@deadline(120)
def test_api_timeseries_endpoint(ray_start):
    """/api/timeseries serves the flight record as JSON and honors the
    names/window_s query params."""
    from ray_tpu_torch.dashboard import start_dashboard

    @ray_tpu_torch.remote
    def tick(i):
        return i

    ray_tpu_torch.get([tick.remote(i) for i in range(4)], timeout=60)
    dash = start_dashboard(port=0)
    try:
        t_end = time.monotonic() + 30
        body = {}
        while time.monotonic() < t_end:
            url = (dash.url + "/api/timeseries?"
                   "names=head.loop_lag_ms,tasks.&window_s=120")
            with urllib.request.urlopen(url, timeout=30) as r:
                body = json.loads(r.read())
            if any(s["points"] for s in body.get("series", {}).values()):
                break
            time.sleep(0.5)
        assert body.get("sample_s", 0) > 0
        series = body["series"]
        assert any(s["points"] for s in series.values()), series
        # the names filter held: nothing outside the asked families
        for key in series:
            assert key.startswith(("head.loop_lag_ms", "tasks.")), key
        # unfiltered query returns a superset
        with urllib.request.urlopen(dash.url + "/api/timeseries",
                                    timeout=30) as r:
            full = json.loads(r.read())
        assert set(series) <= set(full["series"])
    finally:
        dash.stop()


@deadline(120)
def test_status_digest_renders(ray_start, capsys):
    """The `status` flight-recorder digest renders sparklines once the
    head has samples (quiet-on-empty is part of the contract, so wait for
    a sample first; the CLI itself needs a TCP head, so the digest helper
    is driven directly in the attached driver)."""
    from ray_tpu_torch.scripts import _print_timeseries_digest

    @ray_tpu_torch.remote
    def tick(i):
        return i

    ray_tpu_torch.get([tick.remote(i) for i in range(4)], timeout=60)
    t_end = time.monotonic() + 30
    while time.monotonic() < t_end:
        hist = state.metrics_history(names=["head.loop_lag_ms"])
        if any(s["points"] for s in hist.get("series", {}).values()):
            break
        time.sleep(0.5)
    _print_timeseries_digest()
    out = capsys.readouterr().out
    assert "metrics (last" in out, out
    assert "head.loop_lag_ms" in out, out


# ================================================= tests/test_profiling.py


@ray_tpu_torch.remote
class Spinner:
    def __init__(self):
        self._stop = False

    def spin_hot_loop(self, seconds: float) -> int:
        n = 0
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            n += 1
        return n

    def ping(self):
        return True


@deadline(120)
def test_profile_via_dashboard_endpoint(ray_start):
    from ray_tpu_torch.dashboard import start_dashboard

    a = Spinner.options(max_concurrency=2).remote()
    ray_tpu_torch.get(a.ping.remote(), timeout=60)
    fut = a.spin_hot_loop.remote(8.0)
    time.sleep(0.3)
    workers = [w for w in state.list_workers(limit=1000)
               if w.get("state") == "actor"]
    dash = start_dashboard(port=0)
    try:
        url = (f"{dash.url}/api/profile?worker_id="
               f"{workers[0]['worker_id']}&duration_s=0.5&hz=200")
        with urllib.request.urlopen(url, timeout=30) as r:
            body = json.loads(r.read())
        assert body["samples"] > 10
        assert "spin_hot_loop" in body["folded"]
    finally:
        dash.stop()
    assert ray_tpu_torch.get(fut, timeout=60) > 0


# ======================================= tests/test_memory_observatory.py


def _cfg(**kw):
    return Config(**kw)


def _series(pts):
    return {"kind": "gauge", "points": pts}


def _mono_history(n=10, cap=1 << 30, start=0.0, step=0.1 * (1 << 30)):
    """Monotone arena fill: n points, 15s apart, growing `step` each."""
    pts = [(start + 15.0 * i, float(i) * step) for i in range(n)]
    return {"series": {
        "object_plane.arena_used_bytes{node=0}": _series(pts),
        "object_plane.arena_capacity_bytes{node=0}":
            _series([(p[0], float(cap)) for p in pts]),
    }}


def test_growth_warning_fires_on_monotone_fill():
    cfg = _cfg(arena_growth_warn_window_s=120.0,
               arena_growth_warn_min_frac=0.05)
    warns = _arena_growth_warnings(_mono_history(), cfg)
    assert len(warns) == 1
    assert "grew monotonically" in warns[0]
    assert "{node=0}" in warns[0]


def test_growth_warning_quiet_on_dip():
    """One dip anywhere in the window means churn, not a leak."""
    cfg = _cfg(arena_growth_warn_window_s=120.0,
               arena_growth_warn_min_frac=0.05)
    hist = _mono_history()
    key = "object_plane.arena_used_bytes{node=0}"
    pts = hist["series"][key]["points"]
    pts[5] = (pts[5][0], pts[4][1] - 1.0)  # a single free
    assert _arena_growth_warnings(hist, cfg) == []


def test_growth_warning_quiet_below_min_frac():
    """Growth under arena_growth_warn_min_frac of capacity is noise."""
    cfg = _cfg(arena_growth_warn_window_s=120.0,
               arena_growth_warn_min_frac=0.05)
    hist = _mono_history(step=0.001 * (1 << 30))  # ~1% total growth
    assert _arena_growth_warnings(hist, cfg) == []


def test_growth_warning_quiet_on_short_history():
    """< 4 points, or points spanning < half the window, can't be
    judged — a freshly booted node must not warn."""
    cfg = _cfg(arena_growth_warn_window_s=120.0,
               arena_growth_warn_min_frac=0.05)
    assert _arena_growth_warnings(_mono_history(n=3), cfg) == []
    # 10 points squeezed into 9s: plenty of points, tiny span
    pts = [(float(i), float(i) * 1e8) for i in range(10)]
    hist = {"series": {
        "object_plane.arena_used_bytes{node=0}": _series(pts)}}
    assert _arena_growth_warnings(hist, cfg) == []


def test_growth_warning_ignores_other_series():
    cfg = _cfg(arena_growth_warn_window_s=120.0)
    pts = [(15.0 * i, float(i) * 1e9) for i in range(10)]
    hist = {"series": {"object_plane.bytes_pulled{node=0}":
                       _series(pts)}}
    assert _arena_growth_warnings(hist, cfg) == []


def _summary(arena=None, dead=None):
    return {
        "nodes": {0: {"resident_bytes": 100, "resident_objects": 1,
                      "spilled_bytes": 0, "arena": arena or {}}},
        "dead_owner": dead or {"objects": 0, "bytes": 0, "owners": []},
    }


def test_pressure_warning_near_highwater():
    cfg = _cfg(arena_pressure_warn_frac=0.90)
    s = _summary(arena={"capacity": 1000.0, "used_bytes": 950.0})
    warns = _memory_warnings(s, cfg)
    assert len(warns) == 1 and "95% of capacity" in warns[0]
    s = _summary(arena={"capacity": 1000.0, "used_bytes": 800.0})
    assert _memory_warnings(s, cfg) == []


def test_deferred_delete_pileup_warning():
    """Borrow-ledger deferred deletes stuck past the TTL flag a leaked
    zero-copy view."""
    cfg = _cfg(borrow_deferred_delete_warn_s=30.0)
    s = _summary(arena={"capacity": 1000.0, "used_bytes": 10.0,
                        "deferred_deletes": 3.0,
                        "deferred_delete_oldest_s": 45.0})
    warns = _memory_warnings(s, cfg)
    assert len(warns) == 1
    assert "deferred delete(s) stuck" in warns[0]
    # under the TTL: quiet
    s = _summary(arena={"capacity": 1000.0, "used_bytes": 10.0,
                        "deferred_deletes": 3.0,
                        "deferred_delete_oldest_s": 5.0})
    assert _memory_warnings(s, cfg) == []
    # TTL 0 disables the check entirely
    cfg = _cfg(borrow_deferred_delete_warn_s=0.0)
    s = _summary(arena={"capacity": 1000.0, "used_bytes": 10.0,
                        "deferred_deletes": 3.0,
                        "deferred_delete_oldest_s": 999.0})
    assert _memory_warnings(s, cfg) == []


def test_dead_owner_warning():
    cfg = _cfg()
    s = _summary(dead={"objects": 2, "bytes": 4096,
                       "owners": ["deadbeefcafe", "feedface0000"]})
    warns = _memory_warnings(s, cfg)
    assert len(warns) == 1
    assert "dead worker(s)" in warns[0]
    assert "deadbeef" in warns[0]  # truncated owner hex is listed


@deadline(120)
def test_list_objects_rows_and_cli_sort(ray_start, capsys, monkeypatch):
    """`list objects` rows carry size/owner/job columns and
    `--sort-by size` orders descending."""
    from ray_tpu_torch import scripts

    small = ray_tpu_torch.put(np.arange(10, dtype=np.uint8))
    big = ray_tpu_torch.put(np.arange(100_000, dtype=np.uint8))

    def _listed():
        rows = state_api.list_objects(limit=1000)
        return rows if len(rows) >= 2 else None
    rows = _wait_for(_listed)
    for r in rows:
        assert {"size", "owner", "job", "age_s", "tag"} <= set(r)
    monkeypatch.setattr(scripts, "_attached", lambda args: ray_tpu_torch)
    p = scripts.build_parser()
    args = p.parse_args(["list", "objects", "--sort-by", "size"])
    assert args.fn(args) == 0
    out = json.loads(capsys.readouterr().out)
    sizes = [r["size"] for r in out]
    assert sizes == sorted(sizes, reverse=True)
    assert small and big


@deadline(120)
def test_memory_cli_renders_groups(ray_start, capsys, monkeypatch):
    """`memory` renders totals, the class breakdown, and each
    --group-by view off a live summary."""
    from ray_tpu_torch import scripts

    ref = ray_tpu_torch.put(np.arange(50_000, dtype=np.float32))
    _wait_for(lambda: state_api.memory_summary().get("totals", {})
              .get("resident_bytes") or None)
    monkeypatch.setattr(scripts, "_attached", lambda args: ray_tpu_torch)
    p = scripts.build_parser()
    for group in ("node", "job", "owner"):
        args = p.parse_args(["memory", "--group-by", group])
        assert args.fn(args) == 0
        out = capsys.readouterr().out
        assert "cluster resident:" in out
        assert "by reference class:" in out
        assert f"by {group}:" in out
        assert "top " in out and "object_id" in out
    # --units kb forces fixed units; --sort-by age re-orders; --json
    # dumps the raw summary
    args = p.parse_args(["memory", "--units", "kb", "--sort-by", "age"])
    assert args.fn(args) == 0
    out = capsys.readouterr().out
    assert "KB" in out and "(by age)" in out
    args = p.parse_args(["memory", "--json"])
    assert args.fn(args) == 0
    s = json.loads(capsys.readouterr().out)
    assert {"nodes", "jobs", "owners", "classes", "totals"} <= set(s)
    assert ref


@deadline(120)
def test_api_summary_memory_endpoint(ray_start):
    """/api/summary/memory serves the same aggregates over HTTP (the
    doctor smokes it with every other endpoint)."""
    from ray_tpu_torch.dashboard import start_dashboard

    ref = ray_tpu_torch.put(np.arange(4096, dtype=np.uint8))
    _wait_for(lambda: state_api.memory_summary().get("totals", {})
              .get("resident_bytes") or None)
    dash = start_dashboard(port=0)
    try:
        with urllib.request.urlopen(dash.url + "/api/summary/memory",
                                    timeout=30) as r:
            body = json.loads(r.read())
        assert {"nodes", "jobs", "owners", "classes", "dead_owner",
                "top_objects", "totals"} <= set(body)
        assert body["totals"]["resident_bytes"] > 0
    finally:
        dash.stop()
    assert ref


# ===================================== parity against the JAX package's


def _as_port_cli(warns):
    """The reference's warnings name its CLI (`ray_tpu memory`); the
    port's name the port's (`ray_tpu_torch memory`)."""
    return [w.replace("`ray_tpu memory", "`ray_tpu_torch memory")
            for w in warns]


def _memory_cases():
    huge = _mono_history(n=12, cap=1 << 34, step=0.3 * (1 << 30))
    dipped = _mono_history()
    key = "object_plane.arena_used_bytes{node=0}"
    dipped["series"][key]["points"][3] = (45.0, 0.0)
    two = _mono_history()
    two["series"]["object_plane.arena_used_bytes{node=1}"] = \
        _mono_history(step=0.2 * (1 << 30))["series"][key]
    growth = [(_mono_history(), {}), (huge, {}), (dipped, {}), (two, {}),
              (_mono_history(n=3), {}),
              (_mono_history(), {"arena_growth_warn_window_s": 0.0}),
              (_mono_history(step=0.001 * (1 << 30)), {})]
    mem = [(_summary(arena={"capacity": 1000.0, "used_bytes": u,
                            "deferred_deletes": dd,
                            "deferred_delete_oldest_s": age}), {})
           for u in (10.0, 901.0, 999.0) for dd in (0.0, 3.0)
           for age in (5.0, 45.0)]
    mem.append((_summary(dead={"objects": 2, "bytes": 4096,
                               "owners": ["deadbeefcafe", "feedface0000",
                                          "0123456789ab"] * 3}), {}))
    mem.append(({"nodes": {1: {"arena": {"capacity": 10.0,
                                         "used_bytes": 10.0}},
                           0: {"arena": {}}}}, {}))
    return growth, mem


def _serve_cases():
    def app(enabled, rev, count, p95):
        return {"deployments": {"Model": {"autoscaler": {
            "enabled": enabled, "reversals_60s": rev,
            "cold_start": {"count": count, "p50_s": 1.0,
                           "p95_s": p95}}}}}

    out = []
    for enabled in (True, False):
        for rev in (0, 3, 99):
            for count, p95 in ((1, 999.0), (5, 1.0), (5, 999.0)):
                out.append({"app1": app(enabled, rev, count, p95),
                            "app2": app(True, 50, 9, 500.0)})
    out.append({"a": {"deployments": {"d": {}}}})
    out.append({})
    return out


def test_dashboard_warnings_match_reference():
    """_arena_growth_warnings, _memory_warnings and _serve_warnings give
    the reference's warnings on the same inputs and settings."""
    from ray_tpu import dashboard as ref_dash
    from ray_tpu.core.config import Config as RefConfig
    from ray_tpu_torch import dashboard as dash

    growth, mem = _memory_cases()
    seen = 0
    for hist, kw in growth:
        kw = {"arena_growth_warn_window_s": 120.0,
              "arena_growth_warn_min_frac": 0.05, **kw}
        got = dash._arena_growth_warnings(hist, Config(**kw))
        assert got == _as_port_cli(
            ref_dash._arena_growth_warnings(hist, RefConfig(**kw)))
        seen += len(got)
    for summary, kw in mem:
        got = dash._memory_warnings(summary, Config(**kw))
        assert got == _as_port_cli(
            ref_dash._memory_warnings(summary, RefConfig(**kw)))
        seen += len(got)
    for status in _serve_cases():
        got = dash._serve_warnings(status, Config())
        assert got == ref_dash._serve_warnings(status, RefConfig())
        seen += len(got)
    assert seen > 30  # the cases warn, not only stay quiet


@pytest.mark.parametrize("points", [
    [], [(0.0, 1.0)], [(float(i), 5.0) for i in range(7)],
    [(float(i), float(i * i)) for i in range(40)],
    [(float(i), -3.5 * i + (i % 3)) for i in range(24)],
    [(0.0, 1e-13), (1.0, 2e-13)], [(0.0, 0.0), (1.0, 1.0), (2.0, 0.5)]])
def test_status_sparkline_matches_reference(points):
    from ray_tpu.scripts import _spark as ref_spark
    from ray_tpu_torch.scripts import _spark

    for width in (24, 5):
        assert _spark(points, width) == ref_spark(points, width)


def test_fmt_mem_matches_reference():
    from ray_tpu.scripts import _fmt_mem as ref_fmt
    from ray_tpu_torch.scripts import _fmt_mem

    for n in (0, 1, 1023, 1024, 1536, 1 << 20, 5 * (1 << 30) + 7,
              -2048, 123456789, 1 << 40, 0.5):
        for units in ("auto", "b", "kb", "mb", "gb"):
            assert _fmt_mem(n, units) == ref_fmt(n, units), (n, units)
