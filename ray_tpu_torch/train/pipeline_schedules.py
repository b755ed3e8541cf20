"""Pipeline schedules as per-stage op orders.

A schedule here is nothing more than, for every stage ``k``, the ordered
list of ops ``("F", mb)`` / ``("B", mb)`` that stage executes. The
object-plane pipeline (``train/pipeline.py``) turns each op into one
actor-method task; two mechanisms then enforce the schedule with no
central coordinator on the hot path:

- **intra-stage order** — actor tasks execute in per-actor submission
  (seqno) order, so submitting a stage's ops in schedule order IS the
  stage's local schedule;
- **inter-stage deps** — each op's input rides in as a by-ref
  ``ObjectRef`` produced by the neighbouring stage's op, so an op cannot
  start before its producer finished (and, with dispatch-time prefetch
  hints, its activation is usually already in flight to the stage's node
  when it does).

Ref analog: the paper "Scaling Deep Learning Training with MPMD Pipeline
Parallelism" hand-schedules per-stage programs with explicit cross-slice
sends; here the same orders are plain task graphs. The SPMD cousin
(`parallel/pipeline.py`) pipelines inside ONE program over the
``pipeline`` mesh axis; this module is the multi-program (per-node
actors, object-plane handoff) face. A copy of
``ray_tpu/train/pipeline_schedules.py`` (no JAX there).
"""

from __future__ import annotations

from typing import List, Tuple

Op = Tuple[str, int]  # ("F" | "B", microbatch index)


def gpipe_order(num_stages: int, num_microbatches: int) -> List[List[Op]]:
    """GPipe: every stage runs all forwards, then all backwards (reverse
    microbatch order). Peak live activations per stage = M (all saved
    contexts wait for the backward wave) — the all-fwd-then-all-bwd
    memory shape the 1F1B schedule exists to fix."""
    _check(num_stages, num_microbatches)
    orders: List[List[Op]] = []
    for _ in range(num_stages):
        order: List[Op] = [("F", mb) for mb in range(num_microbatches)]
        order += [("B", mb) for mb in reversed(range(num_microbatches))]
        orders.append(order)
    return orders


def one_f_one_b_order(num_stages: int,
                      num_microbatches: int) -> List[List[Op]]:
    """1F1B (PipeDream-flush / GPipe-1F1B): stage ``k`` warms up with
    ``min(M, S-1-k)`` forwards, then alternates one-forward-one-backward,
    then drains the remaining backwards. At any point stage ``k`` holds
    at most ``S - k`` live microbatch contexts, so the steady-state
    footprint is O(stages), independent of M."""
    _check(num_stages, num_microbatches)
    orders: List[List[Op]] = []
    for k in range(num_stages):
        warm = min(num_microbatches, num_stages - 1 - k)
        order: List[Op] = [("F", mb) for mb in range(warm)]
        nf, nb = warm, 0
        while nb < num_microbatches:
            if nf < num_microbatches:
                order.append(("F", nf))
                nf += 1
            order.append(("B", nb))
            nb += 1
        orders.append(order)
    return orders


SCHEDULES = {
    "gpipe": gpipe_order,
    "1f1b": one_f_one_b_order,
}


def replica_orders(schedule_fn, num_stages: int,
                   mb_ids_by_replica: List[List[int]]
                   ) -> List[List[List[Op]]]:
    """Generalize a per-stage schedule to per-(stage, replica) op
    orders (r18 PP x DP): replica ``rep`` of every stage runs the base
    schedule over ITS microbatch subset ``mb_ids_by_replica[rep]``
    (microbatch mb is assigned to replica mb mod R, so activations flow
    stage k replica rep -> stage k+1 replica rep — R independent
    1-wide pipelines sharing the stage programs). Returns
    ``orders[stage][replica]`` as ops over the GLOBAL microbatch ids;
    a replica with no microbatches this wave gets an empty order."""
    out: List[List[List[Op]]] = []
    for k in range(num_stages):
        row: List[List[Op]] = []
        for ids in mb_ids_by_replica:
            if not ids:
                row.append([])
                continue
            base = schedule_fn(num_stages, len(ids))[k]
            row.append([(op, ids[i]) for op, i in base])
        out.append(row)
    return out


def validate_replica_orders(orders: List[List[List[Op]]]) -> None:
    """Validate each replica's S-stage slice independently with the
    plain simulator: deps never cross replicas (microbatch ids are
    opaque to ``validate_order`` and each global id appears in exactly
    one replica's lanes), so per-replica validity IS gang validity."""
    if not orders:
        return
    for rep in range(len(orders[0])):
        slice_ = [orders[k][rep] for k in range(len(orders))]
        if any(slice_):
            validate_order(slice_)


def _check(num_stages: int, num_microbatches: int):
    if num_stages < 1:
        raise ValueError(f"num_stages must be >= 1, got {num_stages}")
    if num_microbatches < 1:
        raise ValueError(
            f"num_microbatches must be >= 1, got {num_microbatches}")


def max_live_contexts(order: List[Op]) -> int:
    """Peak number of microbatches a stage holds a saved forward context
    for at once, scanning the stage's op order (F opens, B closes)."""
    live = peak = 0
    for op, _ in order:
        live += 1 if op == "F" else -1
        peak = max(peak, live)
    return peak


def validate_order(orders: List[List[Op]]) -> None:
    """Simulate a dependency-respecting execution of per-stage op orders
    and raise if it cannot complete (a deadlocked / malformed schedule).
    Dep model: F(k, mb) needs F(k-1, mb); B(k, mb) needs B(k+1, mb) and
    this stage's own F(k, mb); each stage executes its list in order."""
    S = len(orders)
    idx = [0] * S
    done = set()
    total = sum(len(o) for o in orders)
    completed = 0
    while completed < total:
        progressed = False
        for k in range(S):
            while idx[k] < len(orders[k]):
                op, mb = orders[k][idx[k]]
                if op == "F":
                    ready = k == 0 or ("F", k - 1, mb) in done
                else:
                    ready = (("F", k, mb) in done
                             and (k == S - 1 or ("B", k + 1, mb) in done))
                if not ready:
                    break
                done.add((op, k, mb))
                idx[k] += 1
                completed += 1
                progressed = True
        if not progressed:
            stuck = [(k, orders[k][idx[k]]) for k in range(S)
                     if idx[k] < len(orders[k])]
            raise ValueError(f"schedule deadlocks; stuck at {stuck}")
