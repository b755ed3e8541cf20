"""MPMD pipeline parallelism on the object plane (r15).

Ref analog: "Scaling Deep Learning Training with MPMD Pipeline
Parallelism" (PAPERS.md) — pipeline stages as separate programs on
separate slices, activations flowing between them. The port of
``ray_tpu/train/pipeline.py``: a stage's program is torch-autograd
(``fn``) where the reference's is ``jax.vjp``, and a stage whose params
are CUDA tensors leases a GPU, on whose card it then keeps its params and
computes. Here each stage is one actor, gang-placed one-per-node when the
cluster allows, and the schedule (GPipe or 1F1B,
``pipeline_schedules.py``) is expressed as a plain task graph over those
actors:

- **intra-stage order** rides per-actor task seqno order — submitting a
  stage's ops in schedule order IS the stage's local program;
- **inter-stage handoff** rides the object plane: a stage's forward
  returns its activation as a plasma-resident tensor payload (the typed
  tensor reducer; a CUDA tensor crosses as one device-to-host copy and
  one host-to-device copy) on the stage's own node, the driver
  passes only the ``ObjectRef``, and the consuming stage's arg fetch
  pulls it store-to-store — the driver never touches activation bytes;
- **handoff overlap** (the perf core): pushing the consuming task fires
  a dispatch-time ``PREFETCH_HINT`` naming the consumer's node, so the
  activation pull starts while the consumer is still busy with the
  previous microbatch — the transfer hides under compute instead of
  serializing in front of it. Pipeline hot loops ship fresh refs every
  microbatch, so hints are COALESCED per destination across submit
  batches into one ``PREFETCH_HINT_BATCH`` frame per submitter wakeup
  (``prefetch_hint_coalesce``);
- **eager activation free**: every activation has exactly one consumer;
  the driver drops its handle the moment the consumer is submitted, so
  the owner free (consumer completion + borrow grace) deletes the
  store copy promptly and 1F1B's steady-state arena footprint stays
  O(stages), not O(microbatches);
- **bubble attribution comes free** from the r10 phase timelines: stage
  ops are submitted under per-stage func names (``stage{k}.fwd`` /
  ``stage{k}.bwd``), so ``summary tasks`` / ``state.phase_summary``
  split each stage's sched_wait (bubble) from arg_fetch (transfer) from
  exec (compute), and a deliberately slow stage trips the existing
  straggler detector under its own name.

- **data-parallel replicas** (r18, the MPMD paper's full PP x DP
  composition): ``replicas_per_stage=R`` runs R gang-placed actors per
  stage, routes microbatch mb through replica (mb mod R) of every
  stage — R independent 1-wide pipelines sharing the stage programs,
  zero cross-replica traffic during the schedule — and syncs grads at
  batch end with a bucketed all-reduce per stage's replica group over
  ``ray_tpu_torch.collective``'s object-plane ring, submitted into each
  replica's lane right after its last backward so late stages' sync
  overlaps early stages' remaining backward waves.

- **grads fold as the backwards run**: a stage adds each microbatch's
  parameter grads to its sum when that backward ends, so a schedule
  agrees bit for bit with ``single_program_reference`` given the
  microbatches in the schedule's backward order (GPipe's runs in
  reverse; low-precision sums round by their order).

The SPMD cousin ``parallel/pipeline.py`` pipelines inside one program
over the ``pipeline`` mesh axis; this module is the multi-program face
for stages too big or too heterogeneous to live in one program (or one
cluster node). Importing it loads no torch.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import ray_tpu_torch
from ray_tpu_torch.core.api import NodeAffinitySchedulingStrategy, \
    PlacementGroupSchedulingStrategy
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.task_graph import TaskGraphExecutor, TaskNode
from ray_tpu_torch.train.pipeline_schedules import SCHEDULES, \
    replica_orders, validate_order, validate_replica_orders

# ---------------------------------------------------------------- trees
# Params, grads and snapshots are trees of dicts (keys sorted, as
# jax.tree_util orders them), lists and tuples; None is an empty subtree.


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _tree_leaves(t)]
    return [] if tree is None else [tree]


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def _tree_unflatten(like, leaves: list):
    """The tree of ``like``'s structure whose leaves, in ``_tree_leaves``
    order, are ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(t) for t in node)
        return None if node is None else next(it)

    return build(like)


def _is_tensor(x) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _zeros_like(x):
    if _is_tensor(x):
        return sys.modules["torch"].zeros_like(x)
    import numpy as np

    return np.zeros_like(np.asarray(x))


def _nbytes(x) -> int:
    if _is_tensor(x):
        return x.numel() * x.element_size()
    return x.nbytes


def _concat(flats: list):
    if _is_tensor(flats[0]):
        return sys.modules["torch"].cat(flats)
    import numpy as np

    return np.concatenate(flats)


def _stage_gpus(stage) -> int:
    """GPUs a stage's gang member leases: one when the stage's params are
    CUDA tensors, else none."""
    return int(any(_is_tensor(p) and p.device.type == "cuda"
                   for p in _tree_leaves(stage.params)))


def _stage_device() -> str:
    """"cuda" in a process whose lease holds a GPU (it sees those cards
    alone), else "cpu"."""
    from ray_tpu_torch.core.context import get_context_if_exists

    ctx = get_context_if_exists()
    return "cuda" if ctx is not None and ctx.assigned_gpu_ids else "cpu"


_FLASH = "ray_tpu_torch.ops.flash_attention"


def _kernel_launches(reset: bool = False) -> dict:
    """This process's launches of the flash kernels (B1, B2, B3) since
    the counters were last zeroed; zero them with ``reset``."""
    fa = sys.modules.get(_FLASH)
    out = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if fa is not None:
        out = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.launches_dq,
               "flash_bwd_dkv": fa.launches_dkv}
        if reset:
            fa.launches = fa.launches_dq = fa.launches_dkv = 0
    return out


@dataclass
class PipelineStage:
    """One stage's program. Two modes:

    - **torch mode** (``fn``): ``fn(params, x) -> y`` must be
      torch-differentiable in ``params`` (a tree of floating-point
      tensors) and in a floating ``x``; forward runs it under autograd
      with the params as leaves that require grad (and, after the first
      stage, a detached copy of ``x`` that requires grad) and keeps the
      microbatch's output and input actor-locally; backward calls
      ``torch.autograd.grad`` on them and accumulates parameter grads.
      The LAST stage composes ``loss_fn(y, target)`` so its forward
      returns the (scalar) per-microbatch loss.
    - **raw mode** (``fwd``/``bwd``): ``fwd(params, x) -> (y, saved)``
      and ``bwd(params, saved, g) -> (dparams, dx)`` — arbitrary Python
      (benchmarks pace compute with sleeps; a hand-written backward
      schedule fits here too). ``g`` is None for the last stage.
    """

    fn: Optional[Callable] = None
    params: Any = None
    fwd: Optional[Callable] = None
    bwd: Optional[Callable] = None

    def __post_init__(self):
        if (self.fn is None) == (self.fwd is None):
            raise ValueError(
                "PipelineStage needs exactly one of fn= (torch mode) or "
                "fwd=/bwd= (raw mode)")
        if self.fwd is not None and self.bwd is None:
            raise ValueError("raw mode needs both fwd= and bwd=")


class _StageWorker:
    """Actor hosting one stage replica: params + per-microbatch saved
    contexts + accumulated grads. Stateless across batches once
    ``reset()``. With data-parallel replicas (r18) each replica of a
    stage runs one of these, sees only its microbatch subset, and syncs
    grads with its siblings via ``allreduce_grads`` at batch end."""

    def __init__(self, stage_idx: int, num_stages: int,
                 stage: PipelineStage, loss_fn=None, replica: int = 0):
        self.k = stage_idx
        self.S = num_stages
        self.replica = replica
        self._stage = stage
        self._loss_fn = loss_fn
        #: "cuda" when this actor's lease holds a GPU, else "cpu"
        self._device = _stage_device()
        self._leaves: list = []
        if stage.fn is not None:
            self._set_params(stage.params)
        self._ctx: Dict[int, Any] = {}
        #: LOCAL grads accumulated since the last reset()/grad sync
        self._gsum = None
        self._nmb = 0
        #: already-SYNCED global grads from prior allreduce_grads
        #: rounds (None/0 until a sync ran). Kept separate from the
        #: local accumulator so a second run_batch without reset()
        #: cannot re-contribute batch 1's global sum R times to batch
        #: 2's all-reduce — totals are base + local, exactly the R=1
        #: cross-batch accumulation semantics.
        self._gsum_base = None
        self._nmb_base = 0
        self._delay_fwd_s = 0.0
        self._delay_only_mb: Optional[int] = None
        self._dp_group: Optional[str] = None

    def _set_params(self, params):
        """Torch mode: the params on this stage's device, as leaves that
        require grad."""
        def leaf(p):
            if not (_is_tensor(p) and p.is_floating_point()):
                raise TypeError(
                    f"torch-mode stage params must be floating-point "
                    f"tensors, got {type(p).__name__}")
            return p.detach().to(self._device).requires_grad_(True)

        self._stage.params = _tree_map(leaf, params)
        self._leaves = _tree_leaves(self._stage.params)

    def _to_device(self, x):
        return x.to(self._device) if _is_tensor(x) else x

    # -------------------------------------------------- chaos / tests

    def set_delay(self, fwd_s: float, only_mb: Optional[int] = None):
        """Deliberately slow this stage's forward (straggler-detector
        validation): every microbatch, or just ``only_mb``."""
        self._delay_fwd_s = fwd_s
        self._delay_only_mb = only_mb
        return True

    def probe(self) -> dict:
        """{stage, replica, node_idx, live_contexts} as the reference's,
        plus the lease's ``gpu_ids``, the stage's ``device``, the CUDA
        devices this process sees (``cuda_devices``, None before torch
        loads) and its flash-kernel launches since the last reset()
        (``kernel_launches``)."""
        from ray_tpu_torch.core.context import get_context as _gc

        ctx = _gc()
        torch = sys.modules.get("torch")
        return {"stage": self.k, "replica": self.replica,
                "node_idx": ctx.node_idx,
                "live_contexts": len(self._ctx),
                "gpu_ids": list(ctx.assigned_gpu_ids),
                "device": self._device,
                "cuda_devices": (torch.cuda.device_count()
                                 if torch is not None else None),
                "kernel_launches": _kernel_launches()}

    # -------------------------------------- data-parallel sync (r18)

    def init_collective(self, world_size: int, rank: int,
                        group_name: str):
        """Join this replica to its stage's collective group (driver
        gang-creates one group per stage via
        ``collective.create_collective_group``)."""
        from ray_tpu_torch import collective

        collective.init_collective_group(world_size, rank,
                                         group_name=group_name)
        self._dp_group = group_name
        return True

    def allreduce_grads(self, bucket_bytes: int,
                        transport: str = "auto",
                        timeout: float = 300.0) -> int:
        """Batch-end data-parallel gradient sync: sum the LOCAL grads
        (and microbatch counts) accumulated since the last sync across
        this stage's replica group, bucketed — consecutive same-dtype
        leaves concatenate into ~bucket_bytes flat payloads, each
        all-reduced separately so the first buckets' ring hops overlap
        the later buckets'. Submitted into each replica's task lane
        right after its last backward, so late stages sync while early
        stages still run backward waves. The synced global sum folds
        into ``_gsum_base`` and the local accumulator resets — every
        replica then holds identical totals, and a later un-reset
        run_batch contributes only its OWN new grads (matching R=1
        cross-batch accumulation). Returns the cumulative global
        microbatch count."""
        import numpy as np

        from ray_tpu_torch import collective

        if self._dp_group is None:
            raise RuntimeError(
                "stage replica has no collective group; "
                "allreduce_grads requires replicas_per_stage > 1")
        # one inline round carries [my microbatch count, has-grads]:
        # the group must agree on whether the bucket rounds happen, and
        # a replica that saw zero microbatches (M < R edge) or a
        # grad-less raw stage must not desync siblings that did
        local = self._gsum
        rows = collective.allgather(
            np.asarray([float(self._nmb),
                        1.0 if local is not None else 0.0]),
            group_name=self._dp_group, transport="inline",
            timeout=timeout)
        delta_nmb = int(round(sum(float(r[0]) for r in rows)))
        if local is None and any(float(r[1]) > 0 for r in rows):
            if self._stage.params is None:
                raise RuntimeError(
                    "replica gradient sets diverge (some replicas hold "
                    "grads, this one has none and no params to zero-"
                    "fill) — give every replica at least one "
                    "microbatch")
            local = _tree_map(_zeros_like, self._stage.params)
        if local is not None:
            from ray_tpu_torch import tracing

            arrs = [leaf if _is_tensor(leaf) else np.asarray(leaf)
                    for leaf in _tree_leaves(local)]
            # comm.ar.stage{k}r{rep}: the batch-end grad sync as one
            # comm-lane interval (r19) — laid beside this replica's
            # fwd/bwd compute so analyze() can report how much of a
            # late stage's sync hid under early stages' backward waves
            with tracing.comm_span(f"ar.stage{self.k}r{self.replica}"):
                for idxs in _grad_buckets(arrs, bucket_bytes):
                    flat = (arrs[idxs[0]].reshape(-1) if len(idxs) == 1
                            else _concat(
                                [arrs[i].reshape(-1) for i in idxs]))
                    # a tensor comes back as a tensor on its device
                    red = collective.allreduce(
                        flat, group_name=self._dp_group, op="sum",
                        transport=transport, timeout=timeout)
                    off = 0
                    for i in idxs:
                        n = arrs[i].reshape(-1).shape[0]
                        arrs[i] = red[off:off + n].reshape(arrs[i].shape)
                        off += n
            synced = _tree_unflatten(local, arrs)
            self._gsum_base = (synced if self._gsum_base is None
                               else _tree_add(self._gsum_base, synced))
        self._gsum = None
        self._nmb = 0
        self._nmb_base += delta_nmb
        return self._nmb_base

    def reset(self):
        """Drop contexts and grads, and zero this process's kernel
        launch counters (``probe()``'s ``kernel_launches``)."""
        self._ctx.clear()
        _kernel_launches(reset=True)
        self._gsum = None
        self._nmb = 0
        self._gsum_base = None
        self._nmb_base = 0
        return True

    # ------------------------------------------- elastic repair (r16)

    def snapshot(self) -> dict:
        """Stage checkpoint: params + accumulated grads + microbatch
        count. Returned as a task result, so tensor leaves ride the
        typed tensor reducer into this node's arena and the driver holds
        only the ref. Taken at wave boundaries (the pipeline is drained
        there — no live per-microbatch contexts to capture)."""
        params = self._stage.params
        if self._stage.fn is not None:
            params = _tree_map(lambda p: p.detach(), params)
        return {"stage": self.k, "params": params,
                "gsum": self._gsum, "nmb": self._nmb,
                "gsum_base": self._gsum_base,
                "nmb_base": self._nmb_base}

    def restore(self, snap: dict):
        """Roll this stage back to a snapshot's wave boundary. On a
        REPLACEMENT actor this loads the dead predecessor's state; on a
        surviving actor it rewinds grads accumulated by the aborted
        wave. Per-actor seqno order makes the driver's restore an
        implicit quiescence barrier: it runs only after every
        already-submitted wave task on this actor finished (or
        errored)."""
        if self._stage.fn is not None:
            self._set_params(snap["params"])
        else:
            self._stage.params = snap["params"]
        self._gsum = _tree_map(self._to_device, snap["gsum"])
        self._nmb = snap["nmb"]
        self._gsum_base = _tree_map(self._to_device, snap.get("gsum_base"))
        self._nmb_base = snap.get("nmb_base", 0)
        self._ctx.clear()
        return True

    # -------------------------------------------------- schedule ops

    def fwd(self, x, mb: int, target=None):
        if self._delay_fwd_s and (self._delay_only_mb is None
                                  or self._delay_only_mb == mb):
            time.sleep(self._delay_fwd_s)
        st = self._stage
        if st.fn is None:
            y, saved = st.fwd(st.params, x)
            self._ctx[mb] = saved
            return y
        import torch

        x = self._to_device(x)
        xin = None
        if self.k > 0 and _is_tensor(x) and x.is_floating_point():
            xin = x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            y = st.fn(st.params, x)
            if self.k == self.S - 1 and self._loss_fn is not None:
                y = self._loss_fn(y, self._to_device(target))
        # the graph stays here; only the detached value travels (a
        # non-leaf that requires grad does not pickle)
        self._ctx[mb] = (y, xin)
        return y.detach()

    def bwd(self, g, mb: int):
        st = self._stage
        saved = self._ctx.pop(mb)
        if st.fn is None:
            dp, dx = st.bwd(st.params, saved, g)
        else:
            import torch

            y, xin = saved
            del saved
            # last stage: seed the scalar loss
            g = torch.ones_like(y) if g is None else self._to_device(g)
            inputs = self._leaves + ([xin] if xin is not None else [])
            grads = torch.autograd.grad(y, inputs, g, allow_unused=True)
            del y, xin
            grads = [torch.zeros_like(p) if d is None else d
                     for d, p in zip(grads, inputs)]
            n = len(self._leaves)
            dp = _tree_unflatten(st.params, grads[:n])
            dx = grads[n] if len(grads) > n else None
        if dp is not None:
            self._gsum = dp if self._gsum is None else _tree_add(
                self._gsum, dp)
        self._nmb += 1
        return dx if self.k > 0 else None

    def grads(self, mean: bool = True):
        """Accumulated parameter cotangents (mean over microbatches by
        default — matches a full-batch mean loss when microbatches are
        equal-sized and the per-microbatch loss is itself a mean).
        Totals combine the synced base (DP runs) with any local grads
        accumulated since (R=1 runs never sync, so base stays empty)."""
        if self._gsum_base is None:
            total, n = self._gsum, self._nmb
        elif self._gsum is None:
            total, n = self._gsum_base, self._nmb_base
        else:
            total = _tree_add(self._gsum_base, self._gsum)
            n = self._nmb_base + self._nmb
        if total is None or not n:
            return None
        if not mean:
            return total
        return _tree_map(lambda a: a / n, total)


def _tree_add(a, b):
    return _tree_map(lambda x, y: x + y, a, b)


def _grad_buckets(arrs: List[Any], bucket_bytes: int) -> List[List[int]]:
    """Group consecutive same-dtype gradient leaves into ~bucket_bytes
    buckets (indices into ``arrs``). Deterministic in the tree order,
    so every replica computes the identical split — a requirement for
    the bucket all-reduces to rendezvous."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    cur_dt = None
    for i, a in enumerate(arrs):
        if cur and (a.dtype != cur_dt or cur_bytes >= bucket_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += _nbytes(a)
        cur_dt = a.dtype
    if cur:
        buckets.append(cur)
    return buckets


def _uniform_mode(stages: Sequence[PipelineStage]) -> bool:
    """All stages must share one mode — loss composition happens on the
    LAST stage while driver-side loss resolution keys off the batch's
    mode, so a mixed list would silently drop the loss (or crash at
    batch end). Returns True for torch mode."""
    if not stages:
        raise ValueError("need at least one PipelineStage")
    modes = {st.fn is not None for st in stages}
    if len(modes) > 1:
        raise ValueError(
            "all PipelineStages must share one mode (every stage fn=, "
            "or every stage fwd=/bwd=)")
    return modes.pop()


def _check_targets(targets, torch_mode: bool, loss_fn) -> None:
    """Targets only reach the loss via the torch-mode last-stage
    ``loss_fn`` composition; anywhere else they'd be silently ignored."""
    if targets is None:
        return
    if not torch_mode:
        raise ValueError(
            "targets= requires torch-mode stages (raw fwd(params, x) "
            "cannot receive a target; fold labels into the microbatch)")
    if loss_fn is None:
        raise ValueError("targets= requires loss_fn=")


def _check_batch(microbatches, targets, torch_mode: bool,
                 loss_fn) -> list:
    """Shared run_batch input validation (Pipeline AND the
    SingleProgramPipeline baseline must reject identically — a baseline
    that zip-truncates a mismatched batch compares a different
    workload). Returns the per-microbatch target list."""
    if not len(microbatches):
        raise ValueError("need at least one microbatch")
    _check_targets(targets, torch_mode, loss_fn)
    if targets is not None and len(targets) != len(microbatches):
        raise ValueError("len(targets) != len(microbatches)")
    return (list(targets) if targets is not None
            else [None] * len(microbatches))


def plan_repair(dead_stages: Sequence[int], stage_nodes: Sequence[int],
                alive_nodes: Sequence[int], ckpt_wave: int,
                failed_wave: int, wave_sizes: Sequence[int]) -> dict:
    """Pure, deterministic repair plan for a pipeline whose stage(s)
    died with their node (r16) — factored out of ``Pipeline._repair``
    so the placement choice / checkpoint-wave selection / replay set
    are unit-testable without chaos.

    - **re-placement**: each dead stage (ascending) goes to the alive
      node hosting the FEWEST stages (surviving stages plus earlier
      re-placements in this same plan), ties broken by lowest node
      index — the gang stays as spread as the surviving cluster
      allows, and the choice is a pure function of its inputs.
    - **checkpoint-wave selection**: restore to ``ckpt_wave`` (the
      latest wave boundary every stage holds a snapshot for; -1 = the
      batch-start snapshot).
    - **replay set**: waves ``ckpt_wave+1 .. failed_wave`` inclusive —
      everything since the restored boundary, nothing before it.

    ``stage_nodes[k]`` is stage k's node before the failure (dead
    stages' entries are ignored); ``wave_sizes[w]`` the microbatch
    count of wave w. Returns ``{placement: {stage: node}, restore_wave,
    replay_waves, redo_microbatches}``. Raises when no node survives.
    """
    alive = sorted(set(alive_nodes))
    if not alive:
        raise ValueError("no surviving node to re-place stages on")
    dead = set(dead_stages)
    hosted = {n: 0 for n in alive}
    for k, n in enumerate(stage_nodes):
        if k not in dead and n in hosted:
            hosted[n] += 1
    placement: Dict[int, int] = {}
    for k in sorted(dead):
        target = min(alive, key=lambda n: (hosted[n], n))
        placement[k] = target
        hosted[target] += 1
    replay = list(range(ckpt_wave + 1, failed_wave + 1))
    return {
        "placement": placement,
        "restore_wave": ckpt_wave,
        "replay_waves": replay,
        "redo_microbatches": sum(wave_sizes[w] for w in replay),
    }


class Pipeline:
    """Driver handle: builds the stage gang, runs schedules.

    ``placement`` (default: config ``pipeline_stage_placement``):
    ``"auto"`` pins gang member f to alive node (f mod n) with soft
    node affinity — one actor per node when the cluster has enough
    nodes; ``"spread"`` uses a SPREAD placement group; ``"none"``
    leaves it to the default policy.

    ``replicas_per_stage`` (r18, default: config
    ``pipeline_replicas_per_stage``) composes PP with data parallelism:
    R gang-placed actors per stage, microbatch mb routed through
    replica (mb mod R) of every stage (activations never cross
    replicas), and a batch-end bucketed grad all-reduce per stage's
    replica group (``ray_tpu_torch.collective`` ring transport riding the
    object plane) submitted into each replica's lane right after its
    last backward — late stages sync while early stages still run
    backward waves. ``self.actors`` is the FLAT gang,
    ``actors[k * R + rep]``; checkpoints, repair and drain migration
    treat each (stage, replica) member independently, exactly like a
    1-wide stage.

    A stage whose params are CUDA tensors leases one GPU for each of its
    gang members, in their options and in the SPREAD bundles (a CUDA
    tensor reaches no process without a GPU lease); a stage that holds a
    GPU keeps its params and computes on its card, one without on the
    CPU. ``"auto"`` placement then spreads the gang over the alive nodes
    that have a GPU."""

    def __init__(self, stages: Sequence[PipelineStage], *,
                 loss_fn: Optional[Callable] = None,
                 schedule: str = "1f1b",
                 placement: Optional[str] = None,
                 num_cpus_per_stage: int = 1,
                 max_inflight_microbatches: Optional[int] = None,
                 pg_timeout_s: float = 60.0,
                 name_prefix: str = "",
                 replicas_per_stage: Optional[int] = None,
                 grad_bucket_bytes: Optional[int] = None,
                 grad_allreduce_transport: str = "auto"):
        #: prepended to the per-stage task names (``stage{k}.fwd`` ->
        #: ``{prefix}stage{k}.fwd``); mutable between batches — A/B
        #: benches retag rounds so the cumulative phase histograms
        #: stay separable per round
        self.name_prefix = name_prefix
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r} "
                             f"(have {sorted(SCHEDULES)})")
        cfg = get_config()
        self.num_stages = len(stages)
        self.schedule = schedule
        self._stages = list(stages)
        self._loss_fn = loss_fn
        self._torch_mode = _uniform_mode(stages)
        self._bound = (cfg.pipeline_max_inflight_microbatches
                       if max_inflight_microbatches is None
                       else max_inflight_microbatches)
        self._num_cpus_per_stage = num_cpus_per_stage
        #: GPUs each gang member of stage k leases (_stage_gpus)
        self._gpus = [_stage_gpus(st) for st in stages]
        self._pg = None
        # ---- data-parallel replicas (r18) ----
        self._replicas = (cfg.pipeline_replicas_per_stage
                          if replicas_per_stage is None
                          else int(replicas_per_stage))
        if self._replicas < 1:
            raise ValueError(
                f"replicas_per_stage must be >= 1, got {self._replicas}")
        self._grad_bucket_bytes = (cfg.pipeline_grad_bucket_bytes
                                   if grad_bucket_bytes is None
                                   else int(grad_bucket_bytes))
        self._grad_transport = grad_allreduce_transport
        #: collective group name per stage (empty when R == 1); rebuilt
        #: with a fresh generation after any actor replacement
        self._group_names: List[str] = []
        self._group_gen = 0
        #: completed batch-end grad all-reduce rounds
        self.grad_allreduces = 0
        # ---- elastic repair state (r16) ----
        # latest per-stage checkpoint refs + the wave boundary they
        # capture (-1 = batch start); exactly ONE generation is held —
        # taking a new checkpoint drops the old refs, so the owner free
        # reclaims them eagerly (O(stages) footprint, same discipline
        # as activations)
        self._ckpt: Dict[int, Any] = {}
        self._ckpt_wave = -1
        #: stage k -> node idx it currently runs on (refreshed lazily)
        self.stage_nodes: Optional[List[int]] = None
        #: node idxs the head announced as draining (pubsub); pruned
        #: when the node is removed
        self._draining_nodes: set = set()
        self._drain_subs: List[tuple] = []  # (channel, handler) pairs
        #: repair events absorbed (bounded by pipeline_max_repairs)
        self.pipeline_repairs = 0
        #: microbatches re-run because of repairs (the chaos gate
        #: asserts this stays <= one checkpoint interval of waves)
        self.repair_redo_microbatches = 0
        #: stages proactively moved off draining nodes (zero-redo path)
        self.stage_migrations = 0
        strategies = self._resolve_placement(
            placement or cfg.pipeline_stage_placement,
            num_cpus_per_stage, pg_timeout_s)
        self._actor_cls = ray_tpu_torch.remote(_StageWorker)
        self.actors = [self._spawn_stage(f, strategies[f])
                       for f in range(self.gang_size)]
        if self._replicas > 1:
            self._init_collective_groups()
        self._subscribe_drain_events()

    @property
    def gang_size(self) -> int:
        """Flat actor count: stages x replicas."""
        return self.num_stages * self._replicas

    def _stage_of(self, f: int):
        """Flat gang index -> (stage, replica)."""
        return divmod(f, self._replicas)

    def _fname(self, f: int, op: str) -> str:
        """Observability func name for gang member f's op: the r15
        ``{prefix}stage{k}.{op}`` shape when 1-wide, and
        ``{prefix}stage{k}r{rep}.{op}`` with replicas so phase
        histograms / ``pipeline_stage_summary`` attribute DP stragglers
        per (stage, replica)."""
        k, rep = self._stage_of(f)
        base = f"stage{k}" if self._replicas == 1 else f"stage{k}r{rep}"
        return f"{self.name_prefix}{base}.{op}"

    def _spawn_stage(self, f: int, strategy=None):
        """Create gang member f's actor (construction and repair share
        it). ``f`` is the FLAT index ``stage * R + replica``."""
        k, rep = self._stage_of(f)
        opts: Dict[str, Any] = {"num_cpus": self._num_cpus_per_stage}
        if self._gpus[k]:
            opts["num_gpus"] = self._gpus[k]
        if strategy is not None:
            opts["scheduling_strategy"] = strategy
        return self._actor_cls.options(**opts).remote(
            k, self.num_stages, self._stages[k],
            self._loss_fn if k == self.num_stages - 1 else None,
            rep)

    # ------------------------------------- replica collectives (r18)

    def _init_collective_groups(self):
        """One rendezvous group per stage's replica gang, created
        declaratively on the actors. Regrouped under a FRESH name after
        any actor replacement (repair / drain migration): a replaced
        actor's process restarts its per-group sequence numbering, so
        rejoining the old group would rendezvous rounds out of step —
        a fresh coordinator generation starts everyone at zero."""
        import uuid

        from ray_tpu_torch.collective import create_collective_group

        self._destroy_collective_groups()
        self._group_gen += 1
        uid = f"{uuid.uuid4().hex[:8]}g{self._group_gen}"
        R = self._replicas
        names = []
        for k in range(self.num_stages):
            gname = f"_pp{uid}_s{k}"
            create_collective_group(
                [self.actors[k * R + j] for j in range(R)], R,
                list(range(R)), group_name=gname)
            names.append(gname)
        self._group_names = names

    def _destroy_collective_groups(self):
        from ray_tpu_torch.collective import destroy_collective_group

        for g in self._group_names:
            try:
                destroy_collective_group(g)  # driver: kills coordinator
            except Exception:  # noqa: BLE001 — already dead
                pass
        self._group_names = []

    def _subscribe_drain_events(self):
        """Track head drain announcements so wave boundaries can
        migrate stages off a departing node BEFORE its shutdown (the
        graceful half of elastic repair — zero failed tasks, zero
        redo). Fire-and-forget one-way subscriptions; a pipeline built
        before any drain still catches later announcements, and
        ``_migrate_draining_stages(refresh=True)`` re-seeds from the
        node table at batch start in case the subscription raced one."""
        import weakref

        from ray_tpu_torch.core.context import get_context_if_exists

        ctx = get_context_if_exists()
        if ctx is None:  # pure-unit usage (schedule tests): no runtime
            return
        # weakly bound: pubsub handlers are never unsubscribed, and a
        # strong bound method would pin every Pipeline ever built
        wself = weakref.ref(self)

        def on_draining(idx, w=wself):
            p = w()
            if p is not None:
                p._on_node_draining(idx)

        def on_removed(idx, w=wself):
            p = w()
            if p is not None:
                p._on_node_removed(idx)

        try:
            ctx.subscribe("node_draining", on_draining, ack=False)
            ctx.subscribe("node_removed", on_removed, ack=False)
            # remembered so shutdown() can drop them — handler lists
            # would otherwise grow by two per Pipeline ever built
            self._drain_subs = [("node_draining", on_draining),
                                ("node_removed", on_removed)]
        except Exception:  # noqa: BLE001 — head outage: batch-start
            pass           # refresh still sees the draining flags

    def _on_node_draining(self, idx):
        try:
            self._draining_nodes.add(int(idx))
        except (TypeError, ValueError):
            pass

    def _on_node_removed(self, idx):
        try:
            self._draining_nodes.discard(int(idx))
        except (TypeError, ValueError):
            pass

    def _resolve_placement(self, mode: str, num_cpus: int,
                           pg_timeout_s: float) -> list:
        G = self.gang_size
        if mode == "auto":
            # draining nodes are departing — never pin a fresh stage
            # onto one (r16)
            alive = self._alive_node_idxs()
            if len(alive) <= 1:
                return [None] * G
            # soft pinning: a member whose node fills up may still land
            # elsewhere rather than wedging the gang. Flat round-robin
            # also spreads a stage's REPLICAS over distinct nodes when
            # the cluster allows (consecutive flat indices).
            return [NodeAffinitySchedulingStrategy(
                alive[f % len(alive)], soft=True) for f in range(G)]
        if mode == "spread":
            bundles = [{"CPU": num_cpus} for _ in range(G)]
            for f, b in enumerate(bundles):
                if self._gpus[self._stage_of(f)[0]]:
                    b["GPU"] = self._gpus[self._stage_of(f)[0]]
            self._pg = ray_tpu_torch.placement_group(
                bundles, strategy="SPREAD")
            if not self._pg.ready(timeout=pg_timeout_s):
                raise TimeoutError(
                    f"SPREAD placement group for {G} gang members not "
                    f"ready after {pg_timeout_s}s")
            return [PlacementGroupSchedulingStrategy(self._pg, f)
                    for f in range(G)]
        if mode != "none":
            raise ValueError(
                f"unknown placement {mode!r} (have auto/spread/none)")
        return [None] * G

    # ------------------------------------------------------ execution

    def run_batch(self, microbatches: Sequence[Any],
                  targets: Optional[Sequence[Any]] = None, *,
                  by_ref_min_bytes: int = 1 << 20) -> dict:
        """Run one optimizer batch of ``len(microbatches)`` microbatches
        through the configured schedule. Inputs (and torch-mode targets)
        may be values or ``ObjectRef``s; values of at least
        ``by_ref_min_bytes`` are ``put()`` so stage 0 pulls them by-ref.

        Returns ``{"loss", "per_mb_losses", "outputs"}`` — ``loss`` is
        the mean per-microbatch loss in torch mode (None in raw mode);
        ``outputs`` are the last stage's forward results (loss refs in
        torch mode, raw forwards' returns otherwise), already resolved
        for torch mode.

        **Elastic repair (r16).** With
        ``pipeline_checkpoint_every_waves > 0`` every stage snapshots
        params + accumulated grads at wave boundaries (by-ref, replica
        secured off the producing node), and a stage's NODE DEATH
        mid-batch is absorbed: the dead stage is re-placed on a
        surviving node (checkpoint pre-warmed under the actor spawn),
        every stage restores to the latest checkpointed boundary, and
        only the waves since it replay — redo bounded by the
        checkpoint interval. Wave boundaries also migrate stages off
        DRAINING nodes proactively (zero redo). Losses/grads of a
        repaired batch equal the no-fault run; raw-mode ``outputs``
        from pre-crash waves may be lost when they lived on the dead
        node (torch-mode losses are inline and always survive)."""
        tgts = _check_batch(microbatches, targets, self._torch_mode,
                            self._loss_fn)
        M = len(microbatches)
        bound = self._bound
        wave = M if bound <= 0 else min(bound, M)
        # a positive bound runs the batch in WAVES of at most `bound`
        # microbatches — at no point are more than `bound` in flight
        # (grads keep accumulating across waves, so results are
        # unchanged; each wave boundary drains the pipeline)
        waves = [(off, list(microbatches[off:off + wave]),
                  tgts[off:off + wave])
                 for off in range(0, M, wave)]
        cfg = get_config()
        every = cfg.pipeline_checkpoint_every_waves
        elastic = every > 0
        out_refs: List[Any] = [None] * M
        if elastic:
            self._migrate_draining_stages(refresh=True)
            # wave indices are PER BATCH: the previous batch's
            # checkpoint generation is invalid here (its grads belong
            # to that batch's boundary, and its wave tag would compute
            # a bogus replay set) — drop it before snapshotting fresh.
            # If the batch-start snapshot itself fails there is NO
            # valid restore point for this batch: fall back to the
            # pre-r16 fail-fast semantics instead of "repairing" to a
            # foreign boundary.
            self._ckpt = {}
            self._ckpt_wave = -1
            elastic = self._take_checkpoint(-1)
        wi = 0
        while wi < len(waves):
            off, mbs_w, tgts_w = waves[wi]
            try:
                refs = self._run_wave(mbs_w, tgts_w, off,
                                      by_ref_min_bytes,
                                      final=wi == len(waves) - 1)
            except Exception as err:  # noqa: BLE001 — repair filter below
                if not elastic:
                    raise
                max_repairs = get_config().pipeline_max_repairs
                replay_from = None
                attempt_err: Optional[Exception] = err
                attempts = 0
                # a SECOND death while the repair itself runs (during
                # restore/spawn) re-enters the repair against the new
                # failure instead of escaping with budget left; the
                # attempt bound stops a cluster dying node-by-node
                # from looping forever
                while attempt_err is not None and \
                        attempts < max_repairs and \
                        self.pipeline_repairs < max_repairs:
                    attempts += 1
                    try:
                        replay_from = self._repair(attempt_err, waves,
                                                   wi)
                        attempt_err = None
                    except Exception as e2:  # noqa: BLE001
                        attempt_err = e2
                if replay_from is None:
                    raise
                wi = replay_from
                continue
            out_refs[off:off + len(refs)] = refs
            wi += 1
            if elastic and wi < len(waves) and \
                    (wi - 1) - self._ckpt_wave >= every:
                self._migrate_draining_stages()
                self._take_checkpoint(wi - 1)
        result = {"loss": None, "per_mb_losses": None,
                  "outputs": out_refs}
        if self._torch_mode and self._loss_fn is not None:
            losses = [float(v) for v in ray_tpu_torch.get(out_refs,
                                                    timeout=600)]
            result["per_mb_losses"] = losses
            result["loss"] = sum(losses) / len(losses)
        return result

    def _run_wave(self, microbatches, tgts, mb_offset: int,
                  by_ref_min_bytes: int, final: bool = False) -> list:
        """One wave of the schedule, expressed on the shared task-graph
        executor (``core/task_graph.py``, extracted from this method's
        r15 inline walk): each (stage, replica) is a LANE (per-actor
        seqno order = the member's local program), F/B dataflow rides
        by-ref dep edges gated on producer SUBMISSION (the object plane
        handles data readiness), and every activation/cotangent handle
        is dropped by the executor the moment its single consumer is
        submitted — eager free, O(stages) steady-state arena footprint.

        With replicas (r18) microbatch mb belongs to replica
        ``(mb_offset + mb) % R`` of every stage, so node keys stay
        ``("F"|"B", stage, mb)`` and all dep edges are replica-local;
        on the FINAL wave each lane additionally gets an ``("AR", k,
        rep)`` grad all-reduce node after its last backward — stage
        S-1's replicas start syncing while stage 0 still drains
        backward waves (the overlap the bucketed collective exists
        for)."""
        S, M, R = self.num_stages, len(microbatches), self._replicas
        if R == 1:
            base = SCHEDULES[self.schedule](S, M)
            validate_order(base)
            orders = [[base[k]] for k in range(S)]
        else:
            rep_of = [(mb_offset + i) % R for i in range(M)]
            ids_by_rep = [[i for i in range(M) if rep_of[i] == rep]
                          for rep in range(R)]
            orders = replica_orders(SCHEDULES[self.schedule], S,
                                    ids_by_rep)
            validate_replica_orders(orders)
        g = TaskGraphExecutor()
        for mb, x in enumerate(microbatches):
            g.add_value(("in", mb), self._maybe_put(x, by_ref_min_bytes))

        def mk_fwd(actor, name, k, mb, target):
            def fwd(x):
                kwargs = {} if target is None else {"target": target}
                return actor.fwd.options(name=name).remote(
                    x, mb_offset + mb, **kwargs)

            return fwd

        def mk_bwd(actor, name, mb):
            def bwd(*grads):  # () for the last stage: it seeds g=None
                return actor.bwd.options(name=name).remote(
                    grads[0] if grads else None, mb_offset + mb)

            return bwd

        def mk_ar(actor, name):
            def ar():
                return actor.allreduce_grads.options(name=name).remote(
                    self._grad_bucket_bytes, self._grad_transport)

            return ar

        ar_keys = []
        for k in range(S):
            for rep in range(len(orders[k])):
                f = k * R + rep
                actor = self.actors[f]
                for op, mb in orders[k][rep]:
                    if op == "F":
                        deps = [("in", mb)] if k == 0 \
                            else [("F", k - 1, mb)]
                        tgt = tgts[mb] if k == S - 1 else None
                        g.add(TaskNode(
                            ("F", k, mb),
                            mk_fwd(actor, self._fname(f, "fwd"), k, mb,
                                   tgt),
                            deps, lane=f, keep=k == S - 1))
                    else:  # "B"
                        deps = [] if k == S - 1 else [("B", k + 1, mb)]
                        g.add(TaskNode(
                            ("B", k, mb),
                            mk_bwd(actor, self._fname(f, "bwd"), mb),
                            deps, lane=f, keep=k == 0))
                if final and R > 1:
                    # lane order sequences the sync behind this
                    # replica's last backward; no cross-lane deps — the
                    # collective itself rendezvouses the replica group
                    key = ("AR", k, rep)
                    g.add(TaskNode(
                        key, mk_ar(actor, self._fname(f, "allreduce")),
                        deps=[], lane=f, keep=True))
                    ar_keys.append(key)
        kept = g.run()
        out_refs = [kept[("F", S - 1, mb)] for mb in range(M)]
        # barrier: the wave is done when every microbatch's stage-0
        # backward (the tail of its dependency chain) has completed
        ray_tpu_torch.get([kept[("B", 0, mb)] for mb in range(M)],
                    timeout=600)
        if ar_keys:
            # grad-sync errors surface here; completion also means
            # every replica holds identical (global-sum) grads before
            # run_batch returns
            ray_tpu_torch.get([kept[key] for key in ar_keys], timeout=600)
            self.grad_allreduces += 1
        return out_refs

    @staticmethod
    def _maybe_put(x, min_bytes: int):
        from ray_tpu_torch.core.object_ref import ObjectRef

        if isinstance(x, ObjectRef):
            return x
        if min_bytes > 0 and getattr(x, "nbytes", 0) >= min_bytes:
            return ray_tpu_torch.put(x)
        return x

    # ------------------------------------------- elastic repair (r16)

    def _take_checkpoint(self, wave_idx: int) -> bool:
        """Snapshot every stage at a drained wave boundary. The refs
        are held driver-side tagged by ``wave_idx``; sole plasma copies
        are replicated off their producing node (a node kill must not
        take the only copy with it); the PREVIOUS generation's refs are
        dropped — eager free, O(stages) checkpoint footprint. A failed
        snapshot (stage died mid-checkpoint) keeps the previous
        generation: the following wave's failure then repairs from the
        older boundary — more redo, same correctness."""
        import threading

        from ray_tpu_torch.core.context import get_context

        refs = [a.snapshot.options(
            name=self._fname(f, "ckpt")).remote()
            for f, a in enumerate(self.actors)]
        ready, rest = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                   timeout=300)
        ctx = get_context()
        if rest or any(
                (e := ctx.memory_store.peek(r.id)) is None or e.is_error
                for r in refs):
            return False
        # the generation swaps in only when EVERY snapshot is secured:
        # a ref whose off-node replication failed would hold its sole
        # copy on the very node a repair needs it to outlive — keeping
        # the previous (secured) generation costs redo, never
        # correctness
        secured = [False] * len(refs)

        def _sec(i, r):
            secured[i] = self._secure_checkpoint(r)

        ts = [threading.Thread(target=_sec, args=(i, r), daemon=True)
              for i, r in enumerate(refs)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        if not all(secured):
            return False
        # memory observatory: mark the held generation "checkpoint" so
        # `ray_tpu memory`'s class breakdown separates checkpoint-held
        # bytes from ordinary sealed objects (advisory, one-way)
        try:
            ctx.tag_objects(refs, "checkpoint")
        except Exception:  # noqa: BLE001 — accounting must not fail a ckpt
            pass
        self._ckpt = dict(enumerate(refs))
        self._ckpt_wave = wave_idx
        return True

    def _secure_checkpoint(self, ref) -> bool:
        """Replicate a plasma-resident snapshot into the driver's arena
        (directory-registered second holder) so it survives the
        producing node; returns whether an off-node copy now exists.
        Inline snapshots (tiny params/grads) already live in driver
        memory and need nothing."""
        from ray_tpu_torch.core import protocol as P
        from ray_tpu_torch.core.context import get_context

        ctx = get_context()
        e = ctx.memory_store.peek(ref.id)
        if e is None or e.is_error:
            return False
        if not e.in_plasma or e.node_idx == ctx.node_idx:
            return True  # inline value / already driver-resident
        try:
            ctx.head.call(P.OBJECT_TRANSFER, ref.id.binary(),
                          ctx.node_idx, timeout=120)
            return True
        except Exception:  # noqa: BLE001 — primary copy still serves
            return False   # ... but is not crash-safe: not secured

    def _dead_stages(self, wait_s: float = 10.0) -> List[int]:
        """Stages whose actor the driver has marked DEAD (the
        ``CoreContext.actor_state`` view — the same signal that fails
        pending calls with ``ActorDiedError``). Polled for up to
        ``wait_s``: a wave failure may surface (e.g. as a failed
        activation fetch) moments before the head's actor-death
        notification lands."""
        import time as _time

        from ray_tpu_torch.core.context import get_context

        ctx = get_context()
        deadline = _time.monotonic() + wait_s
        while True:
            dead = [k for k, a in enumerate(self.actors)
                    if ctx.actor_state(a._actor_id) == "DEAD"]
            if dead or _time.monotonic() > deadline:
                return dead
            _time.sleep(0.2)

    def _alive_node_idxs(self) -> List[int]:
        """Alive, non-draining nodes that can host a gang member: when
        the stages lease GPUs, those with that many GPUs."""
        gpus = max(self._gpus)
        return sorted(
            n["node_idx"] for n in ray_tpu_torch.nodes()
            if n.get("alive") and not n.get("draining")
            and n.get("resources_total", {}).get("GPU", 0) >= gpus)

    def _repair(self, err: Exception, waves, failed_wi: int
                ) -> Optional[int]:
        """Node-death re-gang: re-place dead stages on surviving nodes,
        restore EVERY stage to the latest checkpointed wave boundary,
        and return the first wave index to replay — or None when the
        failure is not a stage death, in which case the caller
        re-raises ``err``. The `pipeline_max_repairs` budget is
        enforced by the caller's retry loop and consumed only when a
        repair COMPLETES (a repair interrupted by a further death
        re-enters with its budget intact)."""
        from ray_tpu_torch.collective import CollectiveError
        from ray_tpu_torch.core.api import NodeAffinitySchedulingStrategy
        from ray_tpu_torch.core.events import emit_cluster_event
        from ray_tpu_torch.core.exceptions import (
            ActorDiedError, ActorUnavailableError, GetTimeoutError,
            ObjectLostError, WorkerCrashedError)

        # only death-shaped failures are worth the detection poll — an
        # ordinary error (user bug in a stage fn surfacing as a task
        # error) gets ONE immediate check and re-raises promptly
        # instead of stalling 10s on every legitimate failure.
        # CollectiveError counts: a replica group's grad sync failing
        # mid-ring is exactly what a sibling's node death looks like
        # from the surviving ranks.
        deathlike = isinstance(err, (
            ActorDiedError, ActorUnavailableError, WorkerCrashedError,
            ObjectLostError, GetTimeoutError, CollectiveError))
        dead = self._dead_stages(wait_s=10.0 if deathlike else 0.0)
        if not dead:
            return None
        self._refresh_stage_nodes(skip=set(dead))
        plan = plan_repair(dead, self.stage_nodes or [],
                           self._alive_node_idxs(), self._ckpt_wave,
                           failed_wi, [len(w[1]) for w in waves])
        for k, target in sorted(plan["placement"].items()):
            ck = self._ckpt.get(k)
            if ck is not None:
                # overlap the checkpoint pull with the actor spawn:
                # no-op for head-local targets (same-host arenas)
                ray_tpu_torch.warm_object(ck, node_idx=target)
            self.actors[k] = self._spawn_stage(
                k, NodeAffinitySchedulingStrategy(target, soft=True))
        # restore ALL stages — survivors rewind the aborted wave's
        # partial grad contributions; per-actor seqno order makes each
        # restore an implicit quiescence barrier behind the wave's
        # already-submitted tasks
        restores = []
        for f, a in enumerate(self.actors):
            name = self._fname(f, "restore")
            ck = self._ckpt.get(f)
            restores.append(
                a.reset.options(name=name).remote() if ck is None
                else a.restore.options(name=name).remote(ck))
        ray_tpu_torch.get(restores, timeout=300)
        if self._replicas > 1:
            # replacement actors restart their collective sequence
            # numbering — rebuild every stage's replica group under a
            # fresh coordinator generation before any grad sync runs
            self._init_collective_groups()
        self._refresh_stage_nodes()
        redo = plan["redo_microbatches"]
        # budget and counters move only on a COMPLETED repair — an
        # attempt interrupted by a further death re-enters with its
        # budget intact (the caller bounds total attempts)
        self.pipeline_repairs += 1
        self.repair_redo_microbatches += redo
        emit_cluster_event(
            "WARNING", "pipeline", "pipeline_stage_repaired",
            f"re-placed dead stage(s) {sorted(dead)} on "
            f"{plan['placement']}, restored to wave "
            f"{plan['restore_wave']}, replaying {redo} microbatches",
            extra={"stages": sorted(dead),
                   "placement": {str(k): v for k, v in
                                 plan["placement"].items()},
                   # flat gang indices; stage = idx // R, replica =
                   # idx % R (identity when R == 1)
                   "replicas_per_stage": self._replicas,
                   "restore_wave": plan["restore_wave"],
                   "redo_microbatches": redo,
                   "cause": repr(err)[:200]})
        return plan["restore_wave"] + 1

    def _migrate_draining_stages(self, refresh: bool = False) -> int:
        """Graceful-drain half of elastic repair: at a wave boundary
        (pipeline drained — no in-flight stage tasks), move every stage
        hosted by a DRAINING node onto a surviving one — snapshot,
        spawn, warm, restore, retire — so the head's drain completes
        with zero failed tasks and zero redo. Returns stages moved."""
        from ray_tpu_torch.core.api import NodeAffinitySchedulingStrategy
        from ray_tpu_torch.core.events import emit_cluster_event

        if refresh:
            try:
                for n in ray_tpu_torch.nodes():
                    if n.get("draining"):
                        self._draining_nodes.add(n["node_idx"])
            except Exception:  # noqa: BLE001 — head outage: skip
                return 0
        draining = set(self._draining_nodes)
        if not draining:
            return 0
        self._refresh_stage_nodes()
        victims = [k for k, n in enumerate(self.stage_nodes or [])
                   if n in draining]
        if not victims:
            return 0
        alive = [n for n in self._alive_node_idxs()
                 if n not in draining]
        if not alive:
            return 0  # nowhere to go: the head's deadline decides
        plan = plan_repair(victims, self.stage_nodes, alive, 0, -1, [])
        moved = 0
        for f in victims:
            target = plan["placement"][f]
            old = self.actors[f]
            # mid-batch grads ride the snapshot; the wave boundary
            # guarantees no live contexts
            snap = old.snapshot.options(
                name=self._fname(f, "ckpt")).remote()
            new = self._spawn_stage(
                f, NodeAffinitySchedulingStrategy(target, soft=True))
            ray_tpu_torch.wait([snap], num_returns=1, timeout=300)
            ray_tpu_torch.warm_object(snap, node_idx=target)
            try:
                ray_tpu_torch.get([new.restore.options(
                    name=self._fname(f, "restore")).remote(snap)],
                    timeout=300)
            except Exception:  # noqa: BLE001 — replacement failed:
                # keep the old actor (the crash path repairs if the
                # drain escalates to a kill) and retire the orphaned
                # replacement — it would otherwise strand a CPU a
                # later repair needs
                try:
                    ray_tpu_torch.kill(new)
                except Exception:  # noqa: BLE001
                    pass
                continue
            self.actors[f] = new
            try:
                ray_tpu_torch.kill(old)
            except Exception:  # noqa: BLE001
                pass
            moved += 1
            self.stage_migrations += 1
            k, rep = self._stage_of(f)
            emit_cluster_event(
                "INFO", "pipeline", "pipeline_stage_migrated",
                f"stage {k} replica {rep} migrated off draining node "
                f"{(self.stage_nodes or [None] * (f + 1))[f]} "
                f"to node {target}",
                extra={"stage": k, "replica": rep, "to_node": target})
        if moved:
            if self._replicas > 1:
                self._init_collective_groups()
            self._refresh_stage_nodes()
        return moved

    def _refresh_stage_nodes(self, skip: Optional[set] = None) -> None:
        """Re-learn which node hosts each stage (placement is soft, so
        truth lives with the actors). ``skip`` names stages known dead
        — their last-known entry is kept for the planner's host load
        accounting of SURVIVORS only."""
        skip = skip or set()
        nodes = list(self.stage_nodes or [-1] * self.gang_size)
        probes = {k: self.actors[k].probe.remote()
                  for k in range(self.gang_size) if k not in skip}
        for k, ref in probes.items():
            try:
                nodes[k] = ray_tpu_torch.get([ref], timeout=120)[0]["node_idx"]
            except Exception:  # noqa: BLE001 — died since: keep stale
                pass
        self.stage_nodes = nodes

    def stats(self) -> dict:
        """Elastic-repair counters (the chaos/drain gates read these;
        they also ride the cluster event log as
        ``pipeline_stage_repaired`` / ``pipeline_stage_migrated``)."""
        return {
            "pipeline_repairs": self.pipeline_repairs,
            "repair_redo_microbatches": self.repair_redo_microbatches,
            "stage_migrations": self.stage_migrations,
            "checkpoint_wave": self._ckpt_wave,
            "checkpointed_stages": len(self._ckpt),
            "replicas_per_stage": self._replicas,
            "grad_allreduces": self.grad_allreduces,
        }

    # ---------------------------------------------------- gang state

    def grads(self, mean: bool = True) -> list:
        """Per-stage accumulated parameter grads (driver-fetched), one
        entry per STAGE. With replicas the batch-end all-reduce left
        every replica holding the identical global grads, so replica
        0's view is the stage's (equal to a 1-replica run)."""
        return ray_tpu_torch.get(
            [self.actors[k * self._replicas].grads.remote(mean)
             for k in range(self.num_stages)], timeout=600)

    def reset(self):
        ray_tpu_torch.get([a.reset.remote() for a in self.actors], timeout=60)

    def probe(self) -> list:
        """Per-stage {stage, node_idx, live_contexts} (tests/debug)."""
        return ray_tpu_torch.get([a.probe.remote() for a in self.actors],
                           timeout=60)

    def shutdown(self):
        self._destroy_collective_groups()
        for a in self.actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001
                pass
        self.actors = []
        self._ckpt = {}  # drop checkpoint refs -> eager owner free
        from ray_tpu_torch.core.context import get_context_if_exists

        ctx = get_context_if_exists()
        if ctx is not None:
            for channel, handler in self._drain_subs:
                ctx.unsubscribe(channel, handler)
        self._drain_subs = []
        if self._pg is not None:
            try:
                ray_tpu_torch.remove_placement_group(self._pg)
            except Exception:  # noqa: BLE001
                pass
            self._pg = None


class SingleProgramPipeline:
    """The sequential baseline: the SAME stages composed into one
    program on one actor — per microbatch, forward through every stage
    then backward through every stage, no cross-node handoff, no
    overlap. The bench's A and the numerical-equivalence oracle's
    cluster leg."""

    def __init__(self, stages: Sequence[PipelineStage], *,
                 loss_fn: Optional[Callable] = None,
                 num_cpus: int = 1, scheduling_strategy=None):
        self.num_stages = len(stages)
        self._torch_mode = stages[0].fn is not None
        self._loss_fn = loss_fn
        opts = {"num_cpus": num_cpus}
        if scheduling_strategy is not None:
            opts["scheduling_strategy"] = scheduling_strategy
        self._actor = ray_tpu_torch.remote(_SingleProgramWorker).options(
            **opts).remote(list(stages), loss_fn)

    def run_batch(self, microbatches: Sequence[Any],
                  targets: Optional[Sequence[Any]] = None, *,
                  by_ref_min_bytes: int = 1 << 20) -> dict:
        tgts = _check_batch(microbatches, targets, self._torch_mode,
                            self._loss_fn)
        refs = [self._actor.step.options(name="single_program.step")
                .remote(Pipeline._maybe_put(x, by_ref_min_bytes), t, mb)
                for mb, (x, t) in enumerate(zip(microbatches, tgts))]
        outs = ray_tpu_torch.get(refs, timeout=600)
        result = {"loss": None, "per_mb_losses": None, "outputs": outs}
        if self._torch_mode and self._loss_fn is not None:
            losses = [float(v) for v in outs]
            result["per_mb_losses"] = losses
            result["loss"] = sum(losses) / len(losses)
        return result

    def grads(self, mean: bool = True) -> list:
        return ray_tpu_torch.get(self._actor.grads.remote(mean), timeout=600)

    def reset(self):
        ray_tpu_torch.get([self._actor.reset.remote()], timeout=60)

    def shutdown(self):
        try:
            ray_tpu_torch.kill(self._actor)
        except Exception:  # noqa: BLE001
            pass


class _SingleProgramWorker:
    def __init__(self, stages: List[PipelineStage], loss_fn):
        self._workers = [
            _StageWorker(k, len(stages), st,
                         loss_fn if k == len(stages) - 1 else None)
            for k, st in enumerate(stages)]

    def step(self, x, target, mb: int):
        n = len(self._workers)
        for k, w in enumerate(self._workers):
            x = w.fwd(x, mb, target=target if k == n - 1 else None)
        out = x
        g = None
        for w in reversed(self._workers):
            g = w.bwd(g, mb)
        return out

    def grads(self, mean: bool = True):
        return [w.grads(mean) for w in self._workers]

    def reset(self):
        for w in self._workers:
            w.reset()
        return True


def single_program_reference(stages: Sequence[PipelineStage], loss_fn,
                             microbatches: Sequence[Any],
                             targets: Sequence[Any]):
    """Driver-side oracle (no cluster): compose the torch-mode stage fns
    into one function, ``torch.autograd.grad`` it per microbatch, sum the
    grads in the order of ``microbatches`` and average — the number the pipeline must
    reproduce. Runs where the stages' params and the inputs are. Returns
    ``(mean_loss, [per-stage mean grads])``."""
    import torch

    params = [_tree_map(lambda p: p.detach().requires_grad_(True),
                        st.params) for st in stages]
    leaves = [_tree_leaves(p) for p in params]
    flat = [p for ls in leaves for p in ls]
    loss_sum = 0.0
    gsum = None
    for x, t in zip(microbatches, targets):
        with torch.enable_grad():
            for st, p in zip(stages[:-1], params[:-1]):
                x = st.fn(p, x)
            loss = loss_fn(stages[-1].fn(params[-1], x), t)
        flat_g = list(torch.autograd.grad(loss, flat, allow_unused=True))
        flat_g = [torch.zeros_like(p) if d is None else d
                  for d, p in zip(flat_g, flat)]
        g, off = [], 0
        for p, ls in zip(params, leaves):
            g.append(_tree_unflatten(p, flat_g[off:off + len(ls)]))
            off += len(ls)
        loss_sum += float(loss.detach())
        del loss, x
        gsum = g if gsum is None else _tree_add(gsum, g)
    n = len(microbatches)
    return loss_sum / n, _tree_map(lambda a: a / n, gsum)
