"""Comm-aware trace analysis over timeline() events (r19).

Input: the chrome-trace event list ``tracing.timeline()`` produces —
complete ("X") events where cat "task" is compute (task bodies,
``stage{k}r{rep}.fwd/bwd`` pipeline ops), cat "comm" is communication
(``comm.*`` spans: collective hops, object-plane transfers, pipeline
grad all-reduce), cat "span" is user annotation and cat "phase" is the
lifecycle sub-slice layer (skipped here: phases shadow their task's
interval and would double-count busy time).

Output (all durations in seconds):

- per-lane utilization — a lane is one (pid, tid) Perfetto row, i.e.
  one worker thread on one node;
- **exposed-comm** — communication time NOT hidden under compute:
  per comm span, its overlap fraction with the union of ALL compute
  intervals cluster-wide (a late stage's batch-end all-reduce is
  hidden if ANY lane is computing under it — that is exactly the
  overlap the MPMD schedule buys); per lane and in total, the comm
  that no compute anywhere covered;
- per-(stage, replica) **bubble breakdown** for pipeline runs parsed
  from ``stage{k}r{rep}.fwd/bwd`` task names: busy vs idle inside each
  stage's active window, plus its attributed ``comm.ar.stage{k}r{rep}``
  all-reduce time;
- the **critical path**: the latest-finishing event walked backward
  through latest-ending predecessors — the chain of intervals that
  bounds the run's makespan (a heuristic over wall-clock order, not a
  dataflow proof, but it names the lanes/ops to shorten first).

Everything is pure function over the event list so tests can feed
hand-built traces with known answers.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

_STAGE_RE = re.compile(r"^(.*?)stage(\d+)(?:r(\d+))?\.(fwd|bwd)$")
_AR_RE = re.compile(r"^comm\.ar\.stage(\d+)r(\d+)$")


# ------------------------------------------------------- interval math


def merge_intervals(ivals: List[Tuple[float, float]]
                    ) -> List[Tuple[float, float]]:
    """Union of [start, end) intervals, sorted and coalesced."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(i for i in ivals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def total_len(ivals: List[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in ivals)


def overlap_len(s: float, e: float,
                merged: List[Tuple[float, float]]) -> float:
    """Length of [s, e) covered by a MERGED (sorted, disjoint) union."""
    cov = 0.0
    for a, b in merged:
        if b <= s:
            continue
        if a >= e:
            break
        cov += min(e, b) - max(s, a)
    return cov


# ------------------------------------------------------------ analysis


def _lane(ev: dict) -> str:
    return f"{ev.get('pid', '?')}/{ev.get('tid', '?')}"


def analyze(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """See the module docstring for semantics and the result shape."""
    compute = []   # (start_s, end_s, name, lane)
    comm = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        if cat not in ("task", "comm", "span"):
            continue
        s = ev["ts"] / 1e6
        e = s + ev.get("dur", 0.0) / 1e6
        row = (s, e, ev.get("name", ""), _lane(ev))
        if cat == "comm":
            comm.append(row)
        elif cat == "task":
            compute.append(row)
        # cat "span" (user annotations) is neither compute nor comm —
        # it overlays task intervals and would double-count busy time

    all_compute = merge_intervals([(s, e) for s, e, _, _ in compute])
    all_comm = merge_intervals([(s, e) for s, e, _, _ in comm])

    # per-lane busy/exposed accounting
    lanes: Dict[str, dict] = {}
    by_lane_compute: Dict[str, list] = {}
    by_lane_comm: Dict[str, list] = {}
    for s, e, _, lane in compute:
        by_lane_compute.setdefault(lane, []).append((s, e))
    for s, e, _, lane in comm:
        by_lane_comm.setdefault(lane, []).append((s, e))
    bounds = [(s, e) for s, e, _, _ in compute + comm]
    t0 = min((s for s, _ in bounds), default=0.0)
    t1 = max((e for _, e in bounds), default=0.0)
    wall = max(0.0, t1 - t0)
    for lane in sorted(set(by_lane_compute) | set(by_lane_comm)):
        cu = merge_intervals(by_lane_compute.get(lane, []))
        mu = merge_intervals(by_lane_comm.get(lane, []))
        busy = merge_intervals(cu + mu)
        exposed = total_len(mu) - sum(
            overlap_len(s, e, cu) for s, e in mu)
        lanes[lane] = {
            "compute_s": total_len(cu),
            "comm_s": total_len(mu),
            "busy_s": total_len(busy),
            # comm in this lane not under this lane's own compute
            "exposed_comm_s": max(0.0, exposed),
            "utilization": total_len(busy) / wall if wall > 0 else 0.0,
        }

    # per-comm-span exposure vs compute ANYWHERE: overlap_frac > 0
    # means some lane's compute ran under this transfer (the overlap
    # a pipeline schedule exists to create)
    comm_spans = []
    for s, e, name, lane in sorted(comm):
        dur = e - s
        cov = overlap_len(s, e, all_compute)
        comm_spans.append({
            "name": name, "lane": lane,
            "start_s": s - t0, "dur_s": dur,
            "exposed_s": max(0.0, dur - cov),
            "overlap_frac": (cov / dur) if dur > 0 else 0.0,
        })
    total_exposed = total_len(all_comm) - sum(
        overlap_len(s, e, all_compute) for s, e in all_comm)
    total_comm = total_len(all_comm)

    # per-(stage, replica) bubble breakdown
    stages: Dict[str, dict] = {}
    for s, e, name, lane in compute:
        m = _STAGE_RE.match(name)
        if not m:
            continue
        key = f"stage{int(m.group(2))}r{int(m.group(3) or 0)}"
        st = stages.setdefault(key, {
            "fwd_s": 0.0, "bwd_s": 0.0, "ar_s": 0.0,
            "first_s": s, "last_s": e})
        st[m.group(4) + "_s"] += e - s
        st["first_s"] = min(st["first_s"], s)
        st["last_s"] = max(st["last_s"], e)
    for s, e, name, lane in comm:
        m = _AR_RE.match(name)
        if not m:
            continue
        key = f"stage{int(m.group(1))}r{int(m.group(2))}"
        st = stages.get(key)
        if st is not None:
            st["ar_s"] += e - s
            st["last_s"] = max(st["last_s"], e)
    for key, st in stages.items():
        span = max(0.0, st["last_s"] - st["first_s"])
        busy = st["fwd_s"] + st["bwd_s"] + st["ar_s"]
        st["window_s"] = span
        st["bubble_s"] = max(0.0, span - busy)
        st["bubble_frac"] = st["bubble_s"] / span if span > 0 else 0.0
        st["first_s"] -= t0
        st["last_s"] -= t0

    crit = _critical_path(compute + comm)

    return {
        "wall_s": wall,
        "lanes": lanes,
        "total": {
            "compute_s": total_len(all_compute),
            "comm_s": total_comm,
            "exposed_comm_s": max(0.0, total_exposed),
            "exposed_comm_frac": (max(0.0, total_exposed) / total_comm)
            if total_comm > 0 else 0.0,
            # mean lane utilization over the run's wall window
            "utilization": (sum(r["busy_s"] for r in lanes.values())
                            / (wall * len(lanes)))
            if wall > 0 and lanes else 0.0,
        },
        "comm_spans": comm_spans,
        "stages": stages,
        "critical_path": crit,
        "critical_path_s": (crit[-1]["end_s"] - crit[0]["start_s"])
        if crit else 0.0,
    }


def _critical_path(rows: List[Tuple[float, float, str, str]],
                   eps: float = 1e-7) -> List[dict]:
    """Backward walk from the latest-finishing interval: each step
    picks the latest-ENDING interval that ends at/before the current
    one starts (the tightest wall-clock predecessor — the thing the
    current op was most plausibly waiting on). Returns oldest-first."""
    if not rows:
        return []
    by_end = sorted(rows, key=lambda r: r[1])
    cur = by_end[-1]
    path = [cur]
    idx = len(by_end) - 1
    while True:
        # binary-search-free scan: by_end is sorted, walk left to the
        # latest interval ending <= cur start
        pred = None
        for j in range(idx - 1, -1, -1):
            if by_end[j][1] <= cur[0] + eps:
                pred = by_end[j]
                idx = j
                break
        if pred is None:
            break
        path.append(pred)
        cur = pred
    t0 = min(r[0] for r in rows)
    return [{
        "name": r[2], "lane": r[3],
        "start_s": r[0] - t0, "end_s": r[1] - t0,
        "dur_s": r[1] - r[0],
    } for r in reversed(path)]
