"""`python -m ray_tpu_torch` — the cluster CLI.

Parity with the reference's `ray` CLI (python/ray/scripts/scripts.py):
``start --head`` / ``start --address`` / ``status`` / ``stop`` /
``list <entity>`` / ``summary tasks``. The head command runs a persistent
GCS-lite process other hosts join over TCP (node agents via
``start --address``, drivers via ``init(address=...)``); its coordinates
are written to ``--address-file`` (default ``head_address`` under the
port's runtime directory, ``core.config.runtime_tmp_dir()``) so the
sibling commands find it without flags.

A copy of ``ray_tpu.scripts`` on the port's runtime. Where the reference
takes ``--num-tpus`` this CLI takes ``--num-gpus``; left out, ``start``
counts the host's GPUs without CUDA or torch
(``core.resources._detect_gpus``), so a CPU-only node passes
``--num-gpus 0``. A new head's session directory is under the same
runtime directory: apart from the reference's ``/tmp/ray_tpu``, so a
head of each package on one host keeps its own files.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

from ray_tpu_torch.core.config import runtime_tmp_dir

DEFAULT_ADDRESS_FILE = os.path.join(runtime_tmp_dir(), "head_address")


def _write_address_file(path: str, payload: dict):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)


def _read_address(args) -> str:
    if getattr(args, "address", None):
        return args.address
    try:
        with open(args.address_file) as f:
            return json.load(f)["address"]
    except (OSError, KeyError, ValueError):
        sys.exit(f"no --address given and {args.address_file} not found; "
                 f"is a head running? (start one: python -m ray_tpu_torch "
                 f"start --head)")


def cmd_start(args):
    if args.head:
        return _start_head(args)
    if not args.address:
        sys.exit("start needs --head or --address tcp:IP:PORT")
    # join an existing head as a node agent (reference: `ray start
    # --address`, raylet registration)
    from ray_tpu_torch.core.node_agent import main as agent_main

    agent_args = ["--address", args.address,
                  "--num-cpus", str(args.num_cpus or os.cpu_count() or 1)]
    if args.num_gpus is not None:
        agent_args += ["--num-gpus", str(args.num_gpus)]
    return agent_main(agent_args)


def _start_head(args):
    import uuid

    from ray_tpu_torch.core.head import Head
    from ray_tpu_torch.dashboard import sweep_orphan_arenas

    # reclaim arenas a hard-killed predecessor (kill -9 head/agent)
    # left pinned in /dev/shm — nobody maps them, so they're garbage
    for path, size in sweep_orphan_arenas():
        print(f"swept orphaned arena {path} ({size >> 20} MB)",
              file=sys.stderr, flush=True)

    session_name = uuid.uuid4().hex[:10]
    session_dir = args.session_dir or \
        os.path.join(runtime_tmp_dir(), f"session_{session_name}")
    os.makedirs(session_dir, exist_ok=True)
    head = Head(session_dir, session_name)
    head.add_node(num_cpus=args.num_cpus, num_gpus=args.num_gpus)
    head.start()
    tcp = head.enable_tcp(port=args.port or 0)
    payload = {"address": head.addr, "tcp_address": tcp,
               "session_dir": session_dir, "pid": os.getpid()}
    _write_address_file(args.address_file, payload)
    print(f"head started\n  local driver address: {head.addr}\n"
          f"  cluster join address: {tcp}\n  session dir: {session_dir}\n"
          f"join from another host:\n  python -m ray_tpu_torch start "
          f"--address {tcp}\nattach a driver:\n  ray_tpu_torch.init("
          f"address={head.addr!r})", flush=True)

    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    while not stop:
        time.sleep(0.2)
    head.shutdown()
    return 0


def cmd_stop(args):
    try:
        with open(args.address_file) as f:
            pid = json.load(f)["pid"]
    except (OSError, KeyError, ValueError):
        sys.exit(f"{args.address_file} not found; nothing to stop")
    try:
        os.kill(pid, signal.SIGTERM)
        print(f"sent SIGTERM to head (pid {pid})")
    except ProcessLookupError:
        print(f"head (pid {pid}) already gone")
    try:
        os.unlink(args.address_file)
    except OSError:
        pass
    return 0


def _attached(args):
    import ray_tpu_torch

    ray_tpu_torch.init(address=_read_address(args), log_to_driver=False)
    return ray_tpu_torch


def cmd_status(args):
    rt = _attached(args)
    nodes = rt.nodes()
    total = rt.cluster_resources()
    avail = rt.available_resources()
    print(f"nodes: {len(nodes)}")
    for n in nodes:
        if n.get("draining"):
            state = "DRAINING"
        elif n.get("alive", True):
            state = "ALIVE"
        else:
            state = "DEAD"
        print(f"  node {n['node_idx']}: {state}  "
              f"{n.get('resources_total', {})}  "
              f"workers={n.get('num_workers', 0)}")
    print("resources (available / total):")
    for k in sorted(total):
        print(f"  {k}: {avail.get(k, 0):g} / {total[k]:g}")
    _print_timeseries_digest()
    return 0


def _spark(points, width: int = 24) -> str:
    """One-line unicode sparkline over [ts, value] points."""
    if not points:
        return ""
    vals = [v for _, v in points][-width:]
    lo, hi = min(vals), max(vals)
    bars = "▁▂▃▄▅▆▇█"
    if hi - lo < 1e-12:
        return bars[0] * len(vals)
    return "".join(
        bars[min(len(bars) - 1,
                 int((v - lo) / (hi - lo) * (len(bars) - 1)))]
        for v in vals)


def _print_timeseries_digest(window_s: float = 120.0):
    """Compact flight-recorder digest for `ray_tpu_torch status` (r19): the
    recent window of a few load-bearing series as sparklines + last
    value. Quiet when the recorder is empty or the head predates it."""
    from ray_tpu_torch import state as state_api

    try:
        hist = state_api.metrics_history(
            names=["head.loop_lag_ms", "collective.*", "object_plane.*",
                   "tasks.", "node."],
            window_s=window_s)
    except Exception:  # noqa: BLE001 — pre-r19 head
        return
    series = hist.get("series") or {}
    rows = [(k, s["points"]) for k, s in sorted(series.items())
            if s.get("points")]
    if not rows:
        return
    print(f"metrics (last {window_s:g}s, "
          f"{hist.get('sample_s', 0):g}s samples):")
    for key, pts in rows[:12]:
        print(f"  {key:<44} {_spark(pts)}  {pts[-1][1]:.3g}")
    if len(rows) > 12:
        print(f"  ... {len(rows) - 12} more series "
              f"(state.metrics_history() / /api/timeseries)")


def cmd_profile(args):
    """Flamegraph a live worker (ref analog: the dashboard's
    py-spy-on-PID endpoint, reporter/profile_manager.py)."""
    import sys

    from ray_tpu_torch import profiling
    from ray_tpu_torch import state as state_api
    from ray_tpu_torch.core.context import get_context

    _attached(args)
    if args.worker_id == "driver":
        result = profiling.profile_self(duration_s=args.duration,
                                        hz=args.hz)
    else:
        rows = [w for w in state_api.list_workers(limit=10_000)
                if w.get("worker_id") == args.worker_id
                and w.get("state") != "dead"]
        if not rows:
            print(f"no live worker {args.worker_id!r}", file=sys.stderr)
            return 1
        remote_idxs = {n["node_idx"] for n in state_api.list_nodes()
                       if n.get("is_remote")}
        if rows[0].get("node_idx") in remote_idxs:
            # the pid belongs to ANOTHER host — signaling it here would
            # hit an unrelated local process
            print(f"worker {args.worker_id!r} runs on a remote node; "
                  f"run the profile from that host", file=sys.stderr)
            return 1
        session_dir = get_context().session_dir
        result = profiling.profile_pid(
            session_dir, args.worker_id, rows[0]["pid"],
            duration_s=args.duration, hz=args.hz)
    print(f"# {result['samples']} samples over {args.duration}s "
          f"(pid {result['pid']}); paste into flamegraph.pl/speedscope",
          file=sys.stderr)
    print(result["folded"])
    return 0


def cmd_drain(args):
    """Gracefully drain a node (r16): no new work lands on it, its
    sole-copy objects replicate off, running leases get up to
    ``drain_deadline_s`` to migrate/complete, then the node shuts
    down. ``--wait`` blocks until the node leaves the table."""
    import time as _time

    from ray_tpu_torch import state as state_api

    from ray_tpu_torch.core.config import get_config

    rt = _attached(args)
    idx = args.node_idx
    if not rt.drain_node(idx):
        print(f"node {idx}: unknown, already dead, or the head's "
              "bootstrap node (node 0 cannot be drained)",
              file=sys.stderr)
        return 1
    print(f"node {idx}: draining (deadline "
          f"{get_config().drain_deadline_s:g}s)")
    if not args.wait:
        return 0
    deadline = _time.monotonic() + args.timeout
    while _time.monotonic() < deadline:
        rows = [r for r in state_api.list_nodes()
                if r.get("node_idx") == idx]
        if not rows or not rows[0].get("alive"):
            print(f"node {idx}: drained")
            return 0
        _time.sleep(0.5)
    print(f"node {idx}: still draining after {args.timeout:g}s",
          file=sys.stderr)
    return 1


def cmd_doctor(args):
    """Boot a 2-node local cluster and smoke every dashboard endpoint;
    exit non-zero on any 500 (CI guard against endpoint rot)."""
    from ray_tpu_torch.dashboard import doctor

    results = doctor(verbose=True)
    bad = [r for r in results if not r["ok"]]
    print(f"doctor: {len(results) - len(bad)}/{len(results)} endpoints "
          f"healthy")
    if bad:
        for r in bad:
            print(f"  FAILING: {r['endpoint']} -> {r['status']} "
                  f"{r['error']}", file=sys.stderr)
        return 1
    return 0


def cmd_timeline(args):
    """Export the cluster timeline as chrome-trace JSON (ref: `ray
    timeline`); ``--metrics`` additionally dumps the flight-recorder
    series next to it so counter movement correlates with the trace."""
    from ray_tpu_torch import tracing

    _attached(args)
    events = tracing.timeline(args.out)
    print(f"wrote {len(events)} trace events to {args.out} "
          f"(open in chrome://tracing or ui.perfetto.dev)")
    if args.metrics:
        mout = args.metrics_out or (
            args.out.rsplit(".", 1)[0] + ".metrics.json")
        record = tracing.dump_flight_record(mout)
        print(f"wrote {len(record.get('series', {}))} metric series "
              f"to {mout}")
    return 0


def cmd_analyze(args):
    """Comm-aware trace analysis (r19): utilization, exposed-comm,
    pipeline bubbles and the critical path, rendered as text (or raw
    JSON with --json)."""
    from ray_tpu_torch import tracing

    _attached(args)
    report = tracing.analyze()
    if args.json:
        print(json.dumps(report, indent=2, default=str))
        return 0
    t = report["total"]
    print(f"wall: {report['wall_s']:.3f}s   "
          f"utilization: {t['utilization']:.1%}")
    print(f"compute: {t['compute_s']:.3f}s   comm: {t['comm_s']:.3f}s   "
          f"exposed-comm: {t['exposed_comm_s']:.3f}s "
          f"({t['exposed_comm_frac']:.1%} of comm)")
    if report["lanes"]:
        print("lanes:")
        for lane, row in sorted(report["lanes"].items()):
            print(f"  {lane:<32} busy {row['busy_s']:7.3f}s "
                  f"({row['utilization']:6.1%})  "
                  f"comm {row['comm_s']:7.3f}s  "
                  f"exposed {row['exposed_comm_s']:7.3f}s")
    if report["stages"]:
        print("pipeline stages:")
        for key, st in sorted(report["stages"].items()):
            print(f"  {key:<12} fwd {st['fwd_s']:7.3f}s  "
                  f"bwd {st['bwd_s']:7.3f}s  ar {st['ar_s']:7.3f}s  "
                  f"bubble {st['bubble_s']:7.3f}s "
                  f"({st['bubble_frac']:.1%})")
    crit = report["critical_path"]
    if crit:
        print(f"critical path ({report['critical_path_s']:.3f}s, "
              f"{len(crit)} links):")
        for link in crit[-args.path_limit:]:
            print(f"  {link['start_s']:8.3f}s  {link['name']:<40} "
                  f"{link['dur_s']:7.3f}s  [{link['lane']}]")
    return 0


def cmd_list(args):
    from ray_tpu_torch import state as state_api

    fn = {
        "nodes": state_api.list_nodes,
        "workers": state_api.list_workers,
        "actors": state_api.list_actors,
        "tasks": state_api.list_tasks,
        "objects": state_api.list_objects,
        "placement-groups": state_api.list_placement_groups,
        "cluster-events": state_api.list_cluster_events,
        "slow-tasks": state_api.list_slow_tasks,
    }[args.entity]
    _attached(args)
    rows = fn(limit=args.limit)
    if getattr(args, "sort_by", None):
        # descending for numeric keys (size, age_s) — the debugging
        # question is "what's biggest/oldest", ascending for the rest
        sample = next((r[args.sort_by] for r in rows
                       if r.get(args.sort_by) is not None), 0)
        numeric = isinstance(sample, (int, float))
        rows.sort(key=lambda r: r.get(args.sort_by) or
                  (0 if numeric else ""), reverse=numeric)
    print(json.dumps(rows, indent=2, default=str))
    return 0


_MEMORY_UNITS = {"b": 1, "kb": 1 << 10, "mb": 1 << 20, "gb": 1 << 30}


def _fmt_mem(n, units: str) -> str:
    if units != "auto":
        div = _MEMORY_UNITS[units]
        body = f"{n / div:,.2f}".rstrip("0").rstrip(".")
        return body + units.upper()
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20),
                      ("KiB", 1 << 10)):
        if abs(n) >= div:
            return f"{n / div:.2f}{unit}"
    return f"{n:.0f}B"


def cmd_memory(args):
    """Cluster memory observatory (ref: `ray memory` /
    memory_utils.py): resident bytes grouped by node / job / owner,
    the reference-class breakdown, and the top-N largest objects with
    age and holder set."""
    from ray_tpu_torch import state as state_api

    _attached(args)
    s = state_api.memory_summary()
    if not s:
        print("no memory summary available (pre-r20 head?)",
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(s, indent=2, default=str))
        return 0
    u = args.units
    tot = s.get("totals", {})
    print(f"cluster resident: {_fmt_mem(tot.get('resident_bytes', 0), u)} "
          f"in {tot.get('resident_objects', 0)} object(s); "
          f"spilled: {_fmt_mem(tot.get('spilled_bytes', 0), u)}; "
          f"prefetch in flight: {tot.get('prefetch_inflight', 0)}")
    cls = s.get("classes", {})
    print("by reference class:")
    for label, key in (("sealed", "sealed_bytes"),
                       ("borrow-pinned", "borrow_pinned_bytes"),
                       ("checkpoint-held", "checkpoint_bytes"),
                       ("prefetch-in-flight", "prefetch_inflight_bytes"),
                       ("spilled", "spilled_bytes")):
        print(f"  {label:<20} {_fmt_mem(cls.get(key, 0), u)}")
    if args.group_by == "node":
        print("by node:")
        for idx, row in sorted(s.get("nodes", {}).items(),
                               key=lambda kv: str(kv[0])):
            arena = row.get("arena") or {}
            cap = arena.get("capacity", 0)
            used = arena.get("used_bytes", 0)
            fill = f"  arena {_fmt_mem(used, u)}/{_fmt_mem(cap, u)} " \
                   f"({used / cap:.0%}), highwater " \
                   f"{_fmt_mem(arena.get('highwater_bytes', 0), u)}" \
                if cap else "  (no arena heartbeat yet)"
            print(f"  node {idx}: {_fmt_mem(row['resident_bytes'], u)} "
                  f"in {row['resident_objects']} object(s)" + fill)
    elif args.group_by == "job":
        print("by job:")
        for job, row in sorted(s.get("jobs", {}).items(),
                               key=lambda kv: -kv[1]["resident_bytes"]):
            per_node = ", ".join(
                f"node {n}: {_fmt_mem(b, u)}" for n, b in
                sorted(row.get("per_node", {}).items(),
                       key=lambda kv: str(kv[0])))
            print(f"  job {job or '(none)'}: "
                  f"{_fmt_mem(row['resident_bytes'], u)} in "
                  f"{row['objects']} object(s)"
                  + (f"  [{per_node}]" if per_node else ""))
    else:  # owner
        print("by owner:")
        for owner, row in sorted(s.get("owners", {}).items(),
                                 key=lambda kv: -kv[1]["resident_bytes"]):
            live = "" if row.get("live", True) else "  DEAD OWNER"
            print(f"  {owner[:16] or '(none)':<16} "
                  f"{_fmt_mem(row['resident_bytes'], u)} in "
                  f"{row['objects']} object(s){live}")
    objs = s.get("top_objects", [])[:args.top]
    if args.sort_by == "age":
        objs = sorted(objs, key=lambda o: -o.get("age_s", 0.0))
    if objs:
        print(f"top {len(objs)} objects (by {args.sort_by}):")
        print(f"  {'object_id':<40} {'size':>10} {'age':>8} "
              f"{'node':>4}  {'job':<8} {'owner':<8} {'class':<10} "
              "holders")
        for o in objs:
            cls_label = o.get("tag") or \
                ("spilled" if o.get("spilled") else "sealed")
            print(f"  {o['object_id']:<40} "
                  f"{_fmt_mem(o['size'], u):>10} "
                  f"{o.get('age_s', 0.0):>7.1f}s "
                  f"{o.get('node_idx', -1):>4}  "
                  f"{(o.get('job') or '-')[:8]:<8} "
                  f"{(o.get('owner') or '-')[:8]:<8} "
                  f"{cls_label:<10} "
                  f"{','.join(str(h) for h in o.get('holders', []))}")
    dead = s.get("dead_owner") or {}
    if dead.get("bytes"):
        print(f"WARNING: {dead['objects']} object(s) "
              f"({_fmt_mem(dead['bytes'], u)}) held by dead owner(s) "
              f"{[o[:8] for o in dead.get('owners', [])]} — orphan refs")
    return 0


def cmd_summary(args):
    from ray_tpu_torch import state as state_api

    _attached(args)
    fn = {"tasks": state_api.summarize_tasks,
          "actors": state_api.summarize_actors,
          "objects": state_api.summarize_objects}[args.entity]
    print(json.dumps(fn(), indent=2, default=str))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ray_tpu_torch",
                                description="ray_tpu_torch cluster CLI")
    p.add_argument("--address-file", default=DEFAULT_ADDRESS_FILE,
                   help="where the head's coordinates are written/read")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("start", help="start a head or join as a node")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", help="tcp:IP:PORT of the head to join")
    sp.add_argument("--port", type=int, help="TCP port for the head")
    sp.add_argument("--num-cpus", type=int, default=None)
    sp.add_argument("--num-gpus", type=int, default=None)
    sp.add_argument("--session-dir", default="",
                    help="reuse a previous session dir to restore head "
                         "state from its WAL")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("stop", help="stop the head started by `start`")
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser("status", help="cluster nodes + resources")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser(
        "doctor",
        help="boot a 2-node cluster and smoke every dashboard endpoint")
    sp.set_defaults(fn=cmd_doctor)

    sp = sub.add_parser(
        "drain",
        help="gracefully drain a node (migrate work + copies, then "
             "shut it down)")
    sp.add_argument("node_idx", type=int)
    sp.add_argument("--wait", action="store_true",
                    help="block until the node leaves the cluster")
    sp.add_argument("--timeout", type=float, default=120.0,
                    help="--wait bound, seconds")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_drain)

    sp = sub.add_parser("list", help="list cluster entities")
    sp.add_argument("entity", choices=["nodes", "workers", "actors",
                                       "tasks", "objects",
                                       "placement-groups",
                                       "cluster-events", "slow-tasks"])
    sp.add_argument("--address")
    sp.add_argument("--limit", type=int, default=100)
    sp.add_argument("--sort-by", default=None,
                    help="row key to sort by (descending for numeric "
                         "keys — e.g. `list objects --sort-by size`)")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser(
        "memory",
        help="cluster memory observatory: resident bytes by "
             "node/job/owner, class breakdown, largest objects "
             "(ref: `ray memory`)")
    sp.add_argument("--group-by", choices=["node", "job", "owner"],
                    default="node")
    sp.add_argument("--sort-by", choices=["size", "age"], default="size",
                    help="top-objects ordering")
    sp.add_argument("--units", choices=["b", "kb", "mb", "gb", "auto"],
                    default="auto")
    sp.add_argument("--top", type=int, default=20,
                    help="largest objects to show (head caps at "
                         "memory_summary_top_n)")
    sp.add_argument("--json", action="store_true",
                    help="print the raw memory_summary() dict")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_memory)

    sp = sub.add_parser("summary", help="aggregate task/actor/object stats")
    sp.add_argument("entity", choices=["tasks", "actors", "objects"])
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_summary)

    sp = sub.add_parser("timeline",
                        help="export chrome-trace JSON (+ flight-"
                             "recorder metrics with --metrics)")
    sp.add_argument("--out", default="timeline.json")
    sp.add_argument("--metrics", action="store_true",
                    help="also dump state.metrics_history() to JSON")
    sp.add_argument("--metrics-out", default="",
                    help="metrics dump path (default: <out>.metrics.json)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser("analyze",
                        help="comm-aware trace analysis: utilization, "
                             "exposed-comm, bubbles, critical path")
    sp.add_argument("--json", action="store_true",
                    help="print the raw analyze() dict")
    sp.add_argument("--path-limit", type=int, default=12,
                    help="critical-path links to print")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_analyze)

    sp = sub.add_parser(
        "profile",
        help="flamegraph a live worker (folded stacks to stdout)")
    sp.add_argument("worker_id", help="worker id from `list workers`, or "
                                      "'driver' for the head process")
    sp.add_argument("--duration", type=float, default=1.0)
    sp.add_argument("--hz", type=float, default=100.0)
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_profile)

    # ----- serve group (ref: the `serve` CLI, python/ray/serve/scripts.py)
    sp = sub.add_parser("serve", help="model-serving commands")
    serve_sub = sp.add_subparsers(dest="serve_cmd", required=True)
    d = serve_sub.add_parser("deploy", help="deploy apps from a YAML/JSON "
                                            "config")
    d.add_argument("config_file")
    d.add_argument("--address")
    d.set_defaults(fn=cmd_serve_deploy)
    d = serve_sub.add_parser("run", help="import and run module:app")
    d.add_argument("import_path")
    d.add_argument("--name", default="default")
    d.add_argument("--route-prefix", default=None)
    d.add_argument("--address")
    d.set_defaults(fn=cmd_serve_run)
    d = serve_sub.add_parser("status", help="application status")
    d.add_argument("--address")
    d.set_defaults(fn=cmd_serve_status)
    d = serve_sub.add_parser("shutdown", help="tear down all serve apps")
    d.add_argument("--address")
    d.set_defaults(fn=cmd_serve_shutdown)

    # ----- job group (ref: `ray job`, dashboard/modules/job/cli.py)
    sp = sub.add_parser("job", help="job submission commands")
    job_sub = sp.add_subparsers(dest="job_cmd", required=True)
    d = job_sub.add_parser("submit", help="run an entrypoint on the "
                                          "cluster")
    d.add_argument("entrypoint", nargs=argparse.REMAINDER)
    d.add_argument("--address")
    d.add_argument("--submission-id")
    d.set_defaults(fn=cmd_job_submit)
    d = job_sub.add_parser("status")
    d.add_argument("job_id")
    d.add_argument("--address")
    d.set_defaults(fn=cmd_job_status)
    d = job_sub.add_parser("logs")
    d.add_argument("job_id")
    d.add_argument("--address")
    d.set_defaults(fn=cmd_job_logs)
    d = job_sub.add_parser("list")
    d.add_argument("--address")
    d.set_defaults(fn=cmd_job_list)
    d = job_sub.add_parser("stop")
    d.add_argument("job_id")
    d.add_argument("--address")
    d.set_defaults(fn=cmd_job_stop)
    return p


def cmd_serve_deploy(args):
    from ray_tpu_torch import serve

    _attached(args)
    names = serve.deploy_config(args.config_file)
    print(f"deployed applications: {names}")
    return 0


def cmd_serve_run(args):
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.schema import _import_target

    _attached(args)
    target = _import_target(args.import_path)
    serve.run(target, name=args.name,
              route_prefix=args.route_prefix or f"/{args.name}")
    print(f"app '{args.name}' running")
    return 0


def cmd_serve_status(args):
    from ray_tpu_torch import serve

    _attached(args)
    status = serve.status()
    print(json.dumps(status, indent=2, default=str))
    # compact autoscaler digest (r14): one line per autoscaled
    # deployment so a scale event is debuggable without jq — desired
    # vs running, live queue depth, the last decision + reason, recent
    # direction flips, and cold-start percentiles
    lines = []
    for app, info in status.get("applications", {}).items():
        for dn, dep in info.get("deployments", {}).items():
            auto = dep.get("autoscaler") or {}
            if not auto.get("enabled"):
                continue
            last = auto.get("last_decision") or {}
            cold = auto.get("cold_start") or {}
            lines.append(
                f"  {app}/{dn}: desired={auto.get('desired')} "
                f"running={auto.get('running')} "
                f"queue={auto.get('queue_depth')} "
                f"reversals_60s={auto.get('reversals_60s')} "
                f"cold_start_p50={cold.get('p50_s', 0)}s "
                f"p95={cold.get('p95_s', 0)}s"
                + (f"\n    last: {last.get('direction')} "
                   f"{last.get('from')}->{last.get('to')} "
                   f"({last.get('reason')})" if last else ""))
    if lines:
        print("autoscaler:")
        for ln in lines:
            print(ln)
    return 0


def cmd_serve_shutdown(args):
    from ray_tpu_torch import serve

    _attached(args)
    serve.shutdown()
    print("serve shut down")
    return 0


def _job_client(args):
    from ray_tpu_torch.jobs import JobSubmissionClient

    _attached(args)
    return JobSubmissionClient()


def cmd_job_submit(args):
    entry = " ".join(args.entrypoint).lstrip("- ")
    if not entry:
        sys.exit("job submit needs an entrypoint, e.g. "
                 "`job submit -- python my_script.py`")
    client = _job_client(args)
    jid = client.submit_job(entrypoint=entry,
                            submission_id=args.submission_id)
    print(jid)
    return 0


def cmd_job_status(args):
    print(_job_client(args).get_job_status(args.job_id))
    return 0


def cmd_job_logs(args):
    print(_job_client(args).get_job_logs(args.job_id), end="")
    return 0


def cmd_job_list(args):
    print(json.dumps(_job_client(args).list_jobs(), indent=2,
                     default=str))
    return 0


def cmd_job_stop(args):
    print(_job_client(args).stop_job(args.job_id))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
