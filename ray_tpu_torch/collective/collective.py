"""Host-level collective groups over the runtime control plane.

Ref analog: python/ray/util/collective/collective.py (GroupManager :40,
init_collective_group :120, allreduce :258); the port of
``ray_tpu/collective/collective.py``. Tensor collectives live in
``torch.distributed`` (``ray_tpu_torch.parallel``), so this module only
provides the *host-plane* collectives the reference used NCCL/Gloo for —
gang barriers, config broadcast, gradient allreduce/allgather between
data-parallel actors.

Every entry point takes a numpy array or a torch tensor (CPU or CUDA, any
dtype the object plane carries, bf16 included, with or without
``requires_grad``). A tensor goes to the host detached; the result comes
back as a tensor of its dtype on its device. bf16 travels as its 16 bits
and is folded with torch's bf16 arithmetic (each pairwise op rounded to
bf16, as the reference's ``ml_dtypes`` ufuncs round), never as integers.

Two transports (r18):

- **ring / tree (default)** — the data plane is the object plane: each
  rank ``put()``s its chunk into its LOCAL arena, peers pull it
  store-to-store over the striped-pull / zero-copy path (r13 typed
  reducer — the driver and the coordinator never touch payload bytes),
  and the rendezvous actor carries only per-hop *ref exchanges* (small
  control dicts). Large payloads ride a chunked ring
  (reduce-scatter + allgather, 2·(R-1)/R·nbytes moved per rank, each
  hop's pull warmed ahead so it overlaps the previous chunk's reduce);
  small payloads ride a halving-doubling (recursive-doubling) tree —
  log2(R) hops instead of 2(R-1), the standard small-message trade.
- **rendezvous (escape hatch)** — the pre-r18 implementation, preserved
  verbatim behind ``collective_transport="rendezvous"`` (or per-call
  ``transport="rendezvous"/"inline"/"object"``): payloads flow through
  the coordinator inline, or as the two-round slice-exchange for sized
  arrays.

Every collective runs a fixed number of rendezvous rounds for a given
(algorithm, world size), and each ring/tree round is tagged with its
algorithm + hop index, so ranks that accidentally disagree on the
algorithm fail with a clean ``CollectiveError`` instead of wedging the
group.
"""

from __future__ import annotations

import sys
import threading
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np

#: reduce ufuncs by op name (also the incremental fold the coordinator
#: applies as contributions land — satellite r18: O(1) payloads held)
_UFUNCS = {
    "sum": np.add,
    "prod": np.multiply,
    "max": np.maximum,
    "min": np.minimum,
}

#: the torch op of each reduce, for bf16 (numpy has no bf16 arithmetic)
_TORCH_OPS = {"sum": "add", "prod": "mul", "max": "maximum",
              "min": "minimum"}

#: the dtype name under which bf16 payloads travel, as their uint16 bits
BF16 = "bfloat16"


def _bf16_fold(op: str, a: np.ndarray, b: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """``a op b`` on bf16 values held as uint16 bits, in torch's bf16
    arithmetic: every element computed in fp32 and rounded to bf16 once,
    as ``ml_dtypes``' ufuncs do. With ``out`` (uint16, may alias ``a``)
    the result is written there."""
    import torch

    def bf16(x):
        with warnings.catch_warnings():
            # read-only arena views are only read here
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(np.ascontiguousarray(x).view(
                np.int16)).view(torch.bfloat16)

    fn = getattr(torch, _TORCH_OPS[op])
    if out is None:
        return fn(bf16(a), bf16(b)).view(torch.int16).numpy().view(
            np.uint16)
    if not out.flags.c_contiguous:
        raise ValueError("a bf16 fold writes only contiguous buffers")
    fn(bf16(a), bf16(b), out=bf16(out))
    return out


def _folder(op: str, bf16: bool = False):
    """The fold of one reduce op, called as ``fold(a, b)`` or ``fold(a, b,
    out=...)``: the numpy ufunc, or for bf16 bits ``_bf16_fold``."""
    if not bf16:
        return _UFUNCS[op]
    return lambda a, b, out=None: _bf16_fold(op, a, b, out=out)


def _tree_reduce(xs: List[Any], op):
    out = xs[0]
    for x in xs[1:]:
        out = op(out, x)
    return out


class CollectiveError(RuntimeError):
    """A collective operation failed as a GROUP: a rank died mid-ring,
    a round timed out, or ranks disagreed on the algorithm. The error
    surfaces on every surviving rank within the op's ``timeout`` bound
    (plus the get() margin) — the group is never silently wedged, and
    the failed round's coordinator state is dropped so later operations
    on the surviving group are not poisoned."""


class Rendezvous:
    """Coordinator actor: one per group; collects one contribution per
    rank per round, computes the result, hands it back to every caller.

    Create with max_concurrency >= world_size + 1 so all ranks can block
    inside ``contribute`` concurrently.

    For the reduce kinds (``allreduce`` / ``reduce``) contributions are
    FOLDED INCREMENTALLY as they land (r18): the coordinator holds one
    running accumulator instead of every rank's payload, so its peak
    memory is O(1) payloads rather than O(world) — the escape-hatch
    inline transport stays honest for large gradients. The fold order is
    arrival order (ops are commutative; float rounding may differ
    run-to-run but is identical across ranks within one round, since the
    result is computed once and shared). ``allgather`` / ``exchange`` /
    ``broadcast`` inherently need the per-rank parts and keep them.
    ``bf16=True`` marks payloads as bf16 bits (uint16), folded as bf16.
    """

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._rounds: Dict[tuple, dict] = {}

    def contribute(self, kind: str, seq: int, rank: int, payload,
                   op: str = "sum", src_rank: int = 0,
                   timeout: float = 300.0, bf16: bool = False):
        key = (kind, seq)
        with self._cond:
            state = self._rounds.setdefault(
                key, {"parts": {}, "acc": None, "arrived": 0,
                      "result": None, "done": False, "claimed": 0})
            state["arrived"] += 1
            if kind in ("allreduce", "reduce"):
                # incremental fold: never hold more than the running
                # accumulator (+ the payload being folded)
                acc = state["acc"]
                state["acc"] = payload if acc is None \
                    else _folder(op, bf16)(acc, payload)
            else:
                state["parts"][rank] = payload
            if state["arrived"] == self.world_size:
                state["result"] = self._finish(kind, state, op, src_rank)
                state["done"] = True
                state["acc"] = None
                state["parts"] = {}
                self._cond.notify_all()
            else:
                ok = self._cond.wait_for(lambda: state["done"],
                                         timeout=timeout)
                if not ok:
                    # drop the wedged round so a retry (or the next
                    # operation) on the surviving group starts clean
                    # instead of rendezvousing with stale arrivals
                    if self._rounds.get(key) is state:
                        del self._rounds[key]
                    raise TimeoutError(
                        f"collective {kind}#{seq}: only "
                        f"{state['arrived']}/{self.world_size} ranks "
                        f"arrived within {timeout}s")
            result = state["result"]
            state["claimed"] += 1
            if state["claimed"] == self.world_size:
                self._rounds.pop(key, None)
        return result

    def _finish(self, kind: str, state: dict, op: str, src_rank: int):
        if kind == "barrier":
            return True
        if kind in ("allreduce", "reduce"):
            return state["acc"]
        parts = state["parts"]
        if kind == "broadcast":
            return parts[src_rank]
        ordered = [parts[r] for r in sorted(parts)]
        if kind == "exchange":
            # control-plane-only round for the object-plane transports:
            # payloads are OBJECT REFS (+ small metadata), never tensor
            # bytes — every rank gets the full rank->payload picture and
            # the bulk data moves store-to-store
            return ordered
        if kind == "allgather":
            return ordered
        raise ValueError(f"unknown collective kind {kind}")

    def ping(self) -> bool:
        return True


class _GroupState:
    def __init__(self, name: str, world_size: int, rank: int, handle):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.handle = handle
        self.seq = 0
        self.lock = threading.Lock()

    def next_seq(self) -> int:
        with self.lock:
            self.seq += 1
            return self.seq


_groups: Dict[str, _GroupState] = {}
_groups_lock = threading.Lock()
#: groups this process was a MEMBER of and has already left — a repeat
#: destroy from a departed non-zero rank must be a no-op, not a
#: driver-style coordinator kill out from under the surviving ranks
_departed: set = set()


def _coordinator_name(group_name: str) -> str:
    return f"__collective_{group_name}"


#: "torch" is the reference's "jax": the array framework's name, on the
#: same host plane (tensor collectives are torch.distributed's)
BACKENDS = ("host", "torch")


def init_collective_group(world_size: int, rank: int,
                          backend: str = "host",
                          group_name: str = "default"):
    """Join this process to a named group (call once per member).

    Rank 0 creates the rendezvous coordinator actor; other ranks look it
    up by name (ref: collective.py:120 + the named-store rendezvous
    :40-118).
    """
    import ray_tpu_torch

    if backend not in BACKENDS:
        raise ValueError(f"unsupported backend {backend!r}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for {world_size}")
    name = _coordinator_name(group_name)
    handle = None
    if rank == 0:
        try:
            handle = ray_tpu_torch.remote(Rendezvous).options(
                name=name, num_cpus=0,
                max_concurrency=world_size + 2).remote(world_size)
        except Exception:
            handle = None
    if handle is None:
        import time as _time

        deadline = _time.monotonic() + 60
        while _time.monotonic() < deadline:
            try:
                handle = ray_tpu_torch.get_actor(name)
                break
            except ValueError:
                _time.sleep(0.05)
        else:
            raise TimeoutError(f"collective group {group_name} never "
                               "materialized")
    with _groups_lock:
        _groups[group_name] = _GroupState(group_name, world_size, rank,
                                          handle)


def is_group_initialized(group_name: str = "default") -> bool:
    with _groups_lock:
        return group_name in _groups


def get_rank(group_name: str = "default") -> int:
    return _get(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _get(group_name).world_size


def destroy_collective_group(group_name: str = "default"):
    """Leave the group; rank 0 (or a NON-member — e.g. the driver that
    gang-created the group on actors and owns its lifecycle) also kills
    the coordinator actor. A repeat call from a rank that already left
    is a no-op (it must not kill a coordinator its surviving siblings
    still rendezvous through)."""
    import ray_tpu_torch

    with _groups_lock:
        st = _groups.pop(group_name, None)
        if st is None and group_name in _departed:
            return  # former member, already left: nothing to do
        if st is not None:
            _departed.add(group_name)
    if st is None or st.rank == 0:
        try:
            ray_tpu_torch.kill(ray_tpu_torch.get_actor(_coordinator_name(group_name)))
        except Exception:
            pass


def _get(group_name: str) -> _GroupState:
    with _groups_lock:
        st = _groups.get(group_name)
    if st is None:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized; call "
            "init_collective_group first")
    return st


def _run(kind: str, group_name: str, payload, timeout: float = 300.0,
         **kw):
    import ray_tpu_torch

    st = _get(group_name)
    seq = st.next_seq()
    return ray_tpu_torch.get(
        st.handle.contribute.remote(kind, seq, st.rank, payload,
                                    timeout=timeout, **kw),
        timeout=timeout + 30)


# ---------------------------------------------------------- transports

# Payloads at or above this ride the OBJECT PLANE (store-to-store
# transfer) with the coordinator carrying refs only; below it, inline
# through the coordinator. The choice is PER RANK and cannot
# desynchronize the group within one algorithm family: every rendezvous
# algorithm runs a fixed number of "exchange" rounds regardless of
# inline-vs-object, and each round's payload self-describes. The
# ALGORITHM (rendezvous vs ring vs tree) must agree across ranks; it is
# a pure function of (nbytes, transport arg, config), and ring/tree
# rounds are tagged so a disagreement raises instead of wedging.
OBJECT_TRANSPORT_THRESHOLD = 256 * 1024

#: auto transport: payloads below this use the halving-doubling tree
#: (log2(R) hops) when the world size is a power of two; above it, the
#: bandwidth-optimal chunked ring
TREE_MAX_BYTES = 4 * 1024 * 1024

_TRANSPORTS = ("auto", "inline", "object", "rendezvous", "ring", "tree")


def _resolve_algorithm(arr: np.ndarray, transport: str,
                       world: int) -> str:
    """Pick the wire algorithm: "inline" / "object" (rendezvous scheme)
    or "ring" / "tree" (object-plane, r18). Validation happens even for
    world==1 so a typo'd transport fails everywhere identically."""
    if transport not in _TRANSPORTS:
        raise ValueError(f"transport must be one of {_TRANSPORTS}, "
                         f"got {transport!r}")
    if world <= 1:
        return "local"
    if transport == "inline":
        return "inline"
    if transport == "object":
        return "object"
    if transport == "rendezvous":
        # the rendezvous-actor DATA plane: every rank ships its full
        # payload to the coordinator, which folds incrementally and
        # hands the result back — the O(R·nbytes)-through-one-node
        # baseline, and the only transport with ZERO object-plane
        # involvement (the true escape hatch)
        return "rendezvous"
    if transport == "tree":
        if world & (world - 1):
            raise ValueError(
                f"tree transport needs a power-of-two world size, got "
                f"{world} (use transport='ring' or 'auto')")
        return "tree"
    if transport == "ring":
        return "ring"
    # auto: config decides the family, size decides within it
    from ray_tpu_torch.core.config import get_config

    if get_config().collective_transport == "rendezvous":
        return ("object" if arr.nbytes >= OBJECT_TRANSPORT_THRESHOLD
                else "inline")
    if arr.nbytes < OBJECT_TRANSPORT_THRESHOLD:
        return "inline"  # a put + R pulls costs more than it saves
    if arr.nbytes < TREE_MAX_BYTES and not (world & (world - 1)):
        return "tree"
    return "ring"


def _use_object_plane(arr: np.ndarray, transport: str) -> bool:
    """Rendezvous-scheme payload choice (broadcast / legacy paths).
    Ring-family transports map to the object plane — for broadcast the
    single-source object path IS the r9 cooperative relay tree, so
    there is nothing extra a ring would add; "rendezvous" forces the
    inline funnel (zero object-plane involvement)."""
    if transport not in _TRANSPORTS:
        raise ValueError(f"transport must be one of {_TRANSPORTS}, "
                         f"got {transport!r}")
    if transport in ("inline", "rendezvous"):
        return False
    if transport in ("object", "ring", "tree"):
        return True
    return arr.nbytes >= OBJECT_TRANSPORT_THRESHOLD


# ----------------------------------------------------------- telemetry

_METRICS: Optional[Dict[str, Any]] = None
_metrics_lock = threading.Lock()

#: per-hop latency spans sub-ms local folds to paced multi-second pulls
HOP_BOUNDARIES = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                  5.0, 15.0, 60.0)


def _m() -> Dict[str, Any]:
    """Lazily-created ``collective.*`` counters; pushed from each rank
    process over the normal metrics channel, merged on the head (the
    ``object_plane`` state row summarizes them, Prometheus exports them
    verbatim)."""
    global _METRICS
    if _METRICS is None:
        with _metrics_lock:
            if _METRICS is None:
                from ray_tpu_torch import metrics as _mm

                _METRICS = {
                    "ops": _mm.Counter(
                        "collective.ops",
                        "Completed collective operations, by algorithm "
                        "and kind",
                        tag_keys=("algorithm", "kind")),
                    "bytes_sent": _mm.Counter(
                        "collective.bytes_sent",
                        "Payload bytes this rank published for peers "
                        "(arena puts), by algorithm",
                        tag_keys=("algorithm",)),
                    "bytes_recv": _mm.Counter(
                        "collective.bytes_recv",
                        "Payload bytes this rank pulled from peers, by "
                        "algorithm",
                        tag_keys=("algorithm",)),
                    "hop_s": _mm.Histogram(
                        "collective.hop_s",
                        "Per-hop wall time (publish + ref exchange + "
                        "pull + fold), seconds",
                        boundaries=HOP_BOUNDARIES,
                        tag_keys=("algorithm",)),
                }
    return _METRICS


# --------------------------------------------- object-plane primitives


def _put_chunks(arr: np.ndarray, chunk_bytes: int):
    """Publish a 1-D array into the LOCAL arena as ~chunk_bytes pieces;
    returns ([refs], nbytes). Peers pull each chunk store-to-store, so
    chunking bounds per-pull latency and lets a consumer's later-chunk
    pulls overlap its earlier chunks' reduce compute."""
    import ray_tpu_torch

    flat = np.ascontiguousarray(arr).reshape(-1)
    n = max(1, -(-flat.nbytes // max(1, int(chunk_bytes))))
    parts = np.array_split(flat, n) if n > 1 else [flat]
    return ([ray_tpu_torch.put(np.ascontiguousarray(p)) for p in parts],
            flat.nbytes)


def _warm_refs(refs) -> None:
    """Start the store-to-store pulls for chunks this rank is about to
    consume (the dispatch-time PREFETCH_HINT analog, riding the same
    r13 prefetch machinery via OBJECT_WARM): the transfers run under
    whatever compute precedes the ``get`` — a failure only loses the
    overlap, never the data (the get demand-pulls)."""
    import ray_tpu_torch
    from ray_tpu_torch.core.context import get_context_if_exists

    ctx = get_context_if_exists()
    if ctx is None:
        return
    for r in refs:
        try:
            ray_tpu_torch.warm_object(r, node_idx=ctx.node_idx)
        except Exception:  # noqa: BLE001 — speculation only
            pass


def _fetch_flat(refs, timeout: float):
    """Pull a peer's chunk list (warmed pulls are joined in flight) and
    return (1-D array, nbytes). Chunks may come back as readonly
    arena-aliasing views; every consumer below produces a fresh array
    (ufunc output / concatenate), so the views die with this scope and
    the borrow ledger releases the slots."""
    import ray_tpu_torch

    vals = ray_tpu_torch.get(list(refs), timeout=timeout)
    arrs = [np.asarray(v).reshape(-1) for v in vals]
    nb = sum(a.nbytes for a in arrs)
    if len(arrs) == 1:
        return arrs[0], nb
    return np.concatenate(arrs), nb


def _fold_chunks(dst: np.ndarray, refs, ufunc, timeout: float) -> int:
    """Pull a peer's chunk list and fold it into ``dst`` IN PLACE,
    chunk by chunk: later chunks' (warmed) pulls overlap earlier
    chunks' folds, and — deliberately — NOTHING is allocated. Fresh
    multi-MiB allocations are exactly what the hot path must avoid:
    first-touch page faults on a shared, memory-pressured host cost
    ~20 ms/MiB under arena pressure (see object_store._populate_bg),
    which at 64 MiB payloads was costing more than a paced 16 MiB
    transfer. The pulled values stay readonly arena views; each is
    read once into the accumulator segment and dropped."""
    import ray_tpu_torch

    off = 0
    nb = 0
    for ref in refs:
        a = np.asarray(ray_tpu_torch.get(ref, timeout=timeout)).reshape(-1)
        n = a.size
        if off + n > dst.size:
            raise CollectiveError(
                f"peer chunk overruns the slice: {off + n} > "
                f"{dst.size} elements (mismatched chunk_bytes across "
                "ranks?)")
        seg = dst[off:off + n]
        ufunc(seg, a, out=seg)
        off += n
        nb += a.nbytes
        del a
    if off != dst.size:
        raise CollectiveError(
            f"peer chunks cover {off} of {dst.size} slice elements "
            "(mismatched chunk_bytes across ranks?)")
    return nb


def _copy_chunks(dst: np.ndarray, refs, timeout: float) -> int:
    """Pull a peer's chunk list straight into ``dst`` (allgather
    assembly) — same zero-allocation discipline as ``_fold_chunks``."""
    import ray_tpu_torch

    off = 0
    nb = 0
    for ref in refs:
        a = np.asarray(ray_tpu_torch.get(ref, timeout=timeout)).reshape(-1)
        n = a.size
        if off + n > dst.size:
            raise CollectiveError(
                f"peer chunk overruns the slice: {off + n} > "
                f"{dst.size} elements")
        dst[off:off + n] = a
        off += n
        nb += a.nbytes
        del a
    if off != dst.size:
        raise CollectiveError(
            f"peer chunks cover {off} of {dst.size} slice elements")
    return nb


def _work_buffer(arr: np.ndarray) -> np.ndarray:
    """Flat 1-D accumulator for the in-place ring/tree fold. A
    writable contiguous input is used DIRECTLY (the API's in-place
    contract already mutates it at the end; starting early saves the
    output allocation + final copy — on this host class, page-fault
    cost rivals transfer cost). Otherwise one private copy is made.
    On a failed collective the buffer (and thus a writable caller
    tensor) may hold partial sums — same contract as an aborted NCCL
    op."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    if not flat.flags.writeable:
        flat = np.array(flat, copy=True)
    return flat


def _check_round(grid, alg: str, hop: int, meta) -> None:
    """Every rank must have contributed the same (algorithm, hop) —
    and, when ``meta`` is given, the same shape/dtype."""
    for q, p in enumerate(grid):
        if not isinstance(p, dict) or p.get("alg") != alg \
                or p.get("hop") != hop:
            got = p.get("alg") if isinstance(p, dict) else type(p).__name__
            raise CollectiveError(
                f"collective round desync at {alg} hop {hop}: rank {q} "
                f"contributed {got!r} — every rank must choose the same "
                "transport/algorithm (auto resolves identically only "
                "when ranks share config and shapes)")
        if meta is not None and p.get("meta") != meta:
            raise CollectiveError(
                f"collective requires identical shape/dtype on every "
                f"rank; rank {q} sent {p.get('meta')}, expected {meta}")


#: per-process trace of the LAST object-plane collective's hops:
#: (label, seconds) tuples — ("put"/"exchange"/"pull+fold" per hop,
#: "ag_pull", "barrier"). Introspection for benches/tests; overwritten
#: per op. Not thread-safe (one collective per process at a time is
#: the supported pattern).
LAST_OP_TRACE: List[tuple] = []


def _trace(label: str, t0: float) -> float:
    now = time.monotonic()
    LAST_OP_TRACE.append((label, round(now - t0, 4)))
    return now


def _comm_span(name: str, t0_mono: float):
    """Retroactively stamp [t0_mono, now) as a ``comm.<name>`` timeline
    span (r19): collective hops land in the same Perfetto lanes as the
    compute that should hide them, and trace_analysis.analyze() reads
    the exposed remainder. No-op outside a CoreContext."""
    from ray_tpu_torch import tracing

    now_m, now_w = time.monotonic(), time.time()
    tracing.record_comm_span(name, now_w - (now_m - t0_mono), now_w,
                             t0_mono, now_m)


def _ring_chunk_bytes(chunk_bytes: Optional[int]) -> int:
    if chunk_bytes is not None:
        return int(chunk_bytes)
    from ray_tpu_torch.core.config import get_config

    return get_config().collective_ring_chunk_bytes


def _ring_collective(arr: np.ndarray, st: _GroupState, op: str,
                     timeout: float, chunk_bytes: Optional[int],
                     allgather_phase: bool, dtype: str):
    """Chunked ring reduce-scatter (+ allgather) on the object plane.

    Reduce-scatter: R-1 hops. At hop s rank r publishes its current
    partial for slice (r-1-s) mod R into its LOCAL arena (chunked), one
    control-only exchange round spreads the refs, and r pulls its
    predecessor's partial for slice (r-2-s) mod R — the pull warmed
    ahead so chunks stream in while earlier chunks fold — and reduces
    it into its accumulator. Completing hop s's exchange PROVES every
    rank consumed hop s-1's chunks, so each rank drops its previous
    hop's refs there (eager free: O(1) hops of chunks live per rank).
    After R-1 hops rank r holds the fully-reduced slice r.

    Allgather: each rank publishes its completed slice ONCE; a single
    exchange round spreads the refs and everyone pulls the other R-1
    slices — concurrent pulls of one slice form the r9 cooperative
    relay tree, giving ring-like link utilization without R-1 more
    rounds. A final barrier round lets every rank free its published
    slice eagerly.

    Per-rank traffic ~2·(R-1)/R·nbytes, none of it through the
    coordinator or the driver (counter-asserted in BENCH_dp_r18).
    ``dtype`` names the payload's type (``BF16`` for bf16 bits).
    """
    m = _m()
    t_setup = time.monotonic()
    W, r = st.world_size, st.rank
    ufunc = _folder(op, dtype == BF16)
    chunk_bytes = _ring_chunk_bytes(chunk_bytes)
    # the fold runs IN PLACE over contiguous segments of one flat
    # buffer (the writable caller tensor itself when possible): each
    # hop publishes a segment (put() snapshots it into the arena) then
    # folds the predecessor's partial into the next segment — no
    # per-hop allocations, no final concatenate
    flat = _work_buffer(arr)
    views = np.array_split(flat, W)
    meta = (tuple(arr.shape), dtype)
    kind = "allreduce" if allgather_phase else "reduce_scatter"
    sent = recv = 0
    prev_refs = None
    LAST_OP_TRACE.clear()
    try:
        for s in range(W - 1):
            if s == 0:
                _trace("setup", t_setup)
            t_hop = t = time.monotonic()
            out_idx = (r - 1 - s) % W
            in_idx = (r - 2 - s) % W
            refs, nb = _put_chunks(views[out_idx], chunk_bytes)
            sent += nb
            t = _trace(f"h{s}.put", t)
            grid = _run("exchange", st.name,
                        {"alg": "ring", "hop": s, "meta": meta,
                         "chunks": refs}, timeout=timeout)
            t = _trace(f"h{s}.exchange", t)
            _check_round(grid, "ring", s, meta)
            # hop s's exchange completing proves hop s-1's chunks were
            # consumed everywhere: drop them now (owner free)
            prev_refs = None  # noqa: F841 — eager free via refcount
            pred = grid[(r - 1) % W]
            _warm_refs(pred["chunks"])
            recv += _fold_chunks(views[in_idx], pred["chunks"], ufunc,
                                 timeout)
            prev_refs = refs
            _trace(f"h{s}.pull_fold", t)
            _comm_span(f"{kind}.ring.h{s}", t_hop)
            m["hop_s"].observe(time.monotonic() - t_hop,
                               {"algorithm": "ring"})
        # rank r now holds the fully-reduced slice r. Publish it only
        # when someone will pull it: a reduce_scatter's slices have no
        # consumers, so its hop W-1 round exists purely for round-
        # structure symmetry and carries no chunks.
        t_hop = t = time.monotonic()
        my_refs = None
        if allgather_phase:
            my_refs, nb = _put_chunks(views[r], chunk_bytes)
            sent += nb
        t = _trace("ag.put", t)
        grid = _run("exchange", st.name,
                    {"alg": "ring", "hop": W - 1, "meta": meta,
                     "chunks": my_refs}, timeout=timeout)
        t = _trace("ag.exchange", t)
        _check_round(grid, "ring", W - 1, meta)
        prev_refs = None
        if allgather_phase:
            # rotated order — rank r starts at its successor — so the
            # R-1 concurrent pullers spread their demand across every
            # host instead of convoying on slice 0's (the warm above
            # already races the background pulls; the demand order
            # decides who serves whom first)
            order = [(r + off) % W for off in range(1, W)]
            for q in order:
                _warm_refs(grid[q]["chunks"])
            for q in order:
                recv += _copy_chunks(views[q], grid[q]["chunks"],
                                     timeout)
            t = _trace("ag.pull", t)
        _comm_span(f"{kind}.ring.ag", t_hop)
        m["hop_s"].observe(time.monotonic() - t_hop,
                           {"algorithm": "ring"})
        if allgather_phase:
            # completion barrier: every rank pulled what it needs, so
            # the published slice refs can be dropped eagerly on
            # return. reduce_scatter needs no extra round — its hop
            # W-1 exchange already proved every published partial was
            # consumed.
            _run("exchange", st.name, {"alg": "ring", "hop": W,
                                       "meta": None, "chunks": None},
                 timeout=timeout)
            _trace("barrier", t)
            del my_refs
            _comm_span(f"{kind}.ring", t_setup)
            return flat.reshape(arr.shape)
        # reduce_scatter hands the slice out as an independent array
        # (the flat buffer may alias the caller's tensor)
        _comm_span(f"{kind}.ring", t_setup)
        return np.array(views[r], copy=True)
    except CollectiveError:
        raise
    except Exception as e:  # noqa: BLE001 — group failure surface
        raise CollectiveError(
            f"ring {kind} failed on rank {r}/{W} of group "
            f"{st.name!r}: {e!r}") from e
    finally:
        m["bytes_sent"].inc(float(sent), {"algorithm": "ring"})
        m["bytes_recv"].inc(float(recv), {"algorithm": "ring"})
        m["ops"].inc(1.0, {"algorithm": "ring", "kind": kind})


def _tree_allreduce(arr: np.ndarray, st: _GroupState, op: str,
                    timeout: float, chunk_bytes: Optional[int],
                    dtype: str):
    """Halving-doubling (recursive-doubling) allreduce for small
    payloads on the object plane: log2(R) pairwise hops — at hop t rank
    r publishes its full accumulator and pulls partner ``r ^ 2^t``'s,
    folding it in; after every hop each rank's accumulator covers a
    2^(t+1)-rank block, so log2(R) hops reach the global sum. Moves
    nbytes·log2(R) per rank (more than the ring's 2·nbytes for large
    payloads, far fewer latency-bound hops for small ones). Power-of-two
    world sizes only; ``auto`` falls back to the ring otherwise."""
    m = _m()
    t_setup = time.monotonic()
    W, r = st.world_size, st.rank
    ufunc = _folder(op, dtype == BF16)
    chunk_bytes = _ring_chunk_bytes(chunk_bytes)
    # same in-place discipline as the ring: each round publishes the
    # accumulator (put() snapshots it) then folds the partner's copy
    # into it — zero per-round allocations
    acc = _work_buffer(arr)
    meta = (tuple(arr.shape), dtype)
    rounds = W.bit_length() - 1
    sent = recv = 0
    prev_refs = None
    LAST_OP_TRACE.clear()
    try:
        for t in range(rounds):
            t_hop = time.monotonic()
            partner = r ^ (1 << t)
            refs, nb = _put_chunks(acc, chunk_bytes)
            sent += nb
            grid = _run("exchange", st.name,
                        {"alg": "tree", "hop": t, "meta": meta,
                         "chunks": refs}, timeout=timeout)
            _check_round(grid, "tree", t, meta)
            prev_refs = None  # noqa: F841 — consumed everywhere by now
            _warm_refs(grid[partner]["chunks"])
            recv += _fold_chunks(acc, grid[partner]["chunks"], ufunc,
                                 timeout)
            prev_refs = refs
            _trace(f"t{t}.hop", t_hop)
            _comm_span(f"allreduce.tree.t{t}", t_hop)
            m["hop_s"].observe(time.monotonic() - t_hop,
                               {"algorithm": "tree"})
        _run("exchange", st.name, {"alg": "tree", "hop": rounds,
                                   "meta": None, "chunks": None},
             timeout=timeout)
        prev_refs = None
        _comm_span("allreduce.tree", t_setup)
        return acc.reshape(arr.shape)
    except CollectiveError:
        raise
    except Exception as e:  # noqa: BLE001 — group failure surface
        raise CollectiveError(
            f"tree allreduce failed on rank {r}/{W} of group "
            f"{st.name!r}: {e!r}") from e
    finally:
        m["bytes_sent"].inc(float(sent), {"algorithm": "tree"})
        m["bytes_recv"].inc(float(recv), {"algorithm": "tree"})
        m["ops"].inc(1.0, {"algorithm": "tree", "kind": "allreduce"})


def _object_allgather(arr: np.ndarray, st: _GroupState, timeout: float,
                      chunk_bytes: Optional[int],
                      dtype: str) -> List[np.ndarray]:
    """Store-to-store allgather: each rank publishes its (chunked)
    tensor once, one exchange round spreads the refs, everyone pulls
    the other R-1 tensors (concurrent pulls of one tensor form the r9
    relay tree), a barrier round gates the eager free. Per-rank shapes
    may differ (each entry carries its own meta)."""
    import ray_tpu_torch  # noqa: F401 — symmetry with the ring path

    m = _m()
    W, r = st.world_size, st.rank
    chunk_bytes = _ring_chunk_bytes(chunk_bytes)
    flat = np.ascontiguousarray(arr).reshape(-1)
    sent = recv = 0
    try:
        t_hop = time.monotonic()
        refs, nb = _put_chunks(flat, chunk_bytes)
        sent += nb
        grid = _run("exchange", st.name,
                    {"alg": "gather", "hop": 0,
                     "meta": (tuple(arr.shape), dtype),
                     "chunks": refs}, timeout=timeout)
        _check_round(grid, "gather", 0, None)
        for q in range(W):
            if q != r:
                _warm_refs(grid[q]["chunks"])
        out: List[np.ndarray] = []
        for q in range(W):
            if q == r:
                out.append(np.asarray(arr))
                continue
            shape, _dtype = grid[q]["meta"]
            piece, nb_in = _fetch_flat(grid[q]["chunks"], timeout)
            recv += nb_in
            # the typed reducer preserved the dtype; copy detaches the
            # result from any arena-aliasing view before the free
            out.append(np.array(piece, copy=True).reshape(shape))
        m["hop_s"].observe(time.monotonic() - t_hop,
                           {"algorithm": "ring"})
        _run("exchange", st.name, {"alg": "gather", "hop": 1,
                                   "meta": None, "chunks": None},
             timeout=timeout)
        del refs
        _comm_span("allgather.object", t_hop)
        return out
    except CollectiveError:
        raise
    except Exception as e:  # noqa: BLE001 — group failure surface
        raise CollectiveError(
            f"object-plane allgather failed on rank {r}/{W} of group "
            f"{st.name!r}: {e!r}") from e
    finally:
        m["bytes_sent"].inc(float(sent), {"algorithm": "ring"})
        m["bytes_recv"].inc(float(recv), {"algorithm": "ring"})
        m["ops"].inc(1.0, {"algorithm": "ring", "kind": "allgather"})


def _rendezvous_allreduce(arr: np.ndarray, st: _GroupState, op: str,
                          timeout: float, dtype: str):
    """The rendezvous-actor data plane: every rank ships its FULL
    payload to the coordinator, which folds contributions incrementally
    as they land (O(1) payloads held) and hands every rank the result —
    O(R·nbytes) through the coordinator's node per operation. The
    pre-exchange baseline the ring exists to beat, preserved as the
    zero-object-plane escape hatch (transport="rendezvous") and the
    bench_pipeline collective phase's A."""
    m = _m()
    t0 = time.monotonic()
    out = _run("allreduce", st.name, np.ascontiguousarray(arr), op=op,
               timeout=timeout, bf16=dtype == BF16)
    _comm_span("allreduce.rendezvous", t0)
    m["hop_s"].observe(time.monotonic() - t0,
                       {"algorithm": "rendezvous"})
    m["ops"].inc(1.0, {"algorithm": "rendezvous", "kind": "allreduce"})
    return np.asarray(out).reshape(arr.shape).astype(arr.dtype,
                                                     copy=False)


# ------------------------------------------- rendezvous-scheme payloads


def _wrap(arr: Optional[np.ndarray], use_object: bool) -> Optional[dict]:
    """Self-describing round payload: inline value or nested ref (a
    BARE ref argument would be resolved to its value at the callee —
    exactly the byte funnel the object path exists to avoid)."""
    if arr is None:
        return None
    if use_object:
        import ray_tpu_torch

        return {"ref": [ray_tpu_torch.put(np.ascontiguousarray(arr))]}
    return {"val": np.asarray(arr)}


def _unwrap(payload: dict) -> np.ndarray:
    if "val" in payload:
        return payload["val"]
    import ray_tpu_torch

    return np.asarray(ray_tpu_torch.get(payload["ref"][0], timeout=300))


def _allreduce_exchange(arr: np.ndarray, st: _GroupState, op: str,
                        use_object: bool, timeout: float = 300.0,
                        dtype: Optional[str] = None):
    """Reduce-scatter + allgather by slices over TWO exchange rounds —
    the preserved pre-r18 rendezvous object path (the
    ``collective_transport="rendezvous"`` baseline and escape hatch).

    Each rank publishes W slices of its flattened tensor (refs when
    sized, inline when small), the first round spreads the W x W
    payload grid, every rank resolves COLUMN r (one slice from each
    peer), reduces it, publishes the reduced slice, and the second
    round lets everyone assemble the result — ~2x nbytes moved per
    rank, none of it through the coordinator when refs are used. The
    r18 ring improves on this with per-hop pipelining, warmed pulls and
    eager chunk frees; this path survives verbatim as the baseline. The
    round structure is IDENTICAL for both payload styles, so ranks
    choosing inline vs object still rendezvous."""
    W = st.world_size
    flat = np.ascontiguousarray(arr).reshape(-1)
    slices = np.array_split(flat, W)
    dtype = dtype or str(arr.dtype)
    mine = {"meta": (arr.shape, dtype),
            "slices": [_wrap(s, use_object) for s in slices]}
    grid = _run("exchange", st.name, mine,
                timeout=timeout)  # [rank] -> payload dict
    for q, p in enumerate(grid):
        if not isinstance(p, dict) or "slices" not in p:
            raise CollectiveError(
                f"collective round desync: rank {q} did not contribute "
                "a rendezvous slice grid — every rank must choose the "
                "same transport/algorithm")
    metas = {p["meta"] for p in grid}
    if len(metas) != 1:
        raise ValueError(
            f"allreduce requires identical shape/dtype on every rank; "
            f"got {sorted(metas)}")
    r = st.rank
    column = [_unwrap(grid[q]["slices"][r]) for q in range(W)]
    reduced = _tree_reduce(column, _folder(op, dtype == BF16))
    round2 = _run("exchange", st.name,
                  _wrap(reduced, use_object), timeout=timeout)
    pieces = [np.asarray(_unwrap(p)).reshape(-1) for p in round2]
    out = np.concatenate(pieces)
    _m()["ops"].inc(1.0, {"algorithm": "rendezvous",
                          "kind": "allreduce"})
    return out.reshape(arr.shape).astype(arr.dtype, copy=False)


# ------------------------------------------------------------- the API


class _Host:
    """A caller's tensor on the host plane: ``arr``, the numpy array the
    transports move and fold (bf16 as its uint16 bits, ``dtype`` then
    ``BF16``), and the way back to the caller's type. A numpy array is
    used as it is; a torch tensor goes to the host detached (a CPU
    tensor's memory is shared, a CUDA tensor is copied)."""

    def __init__(self, tensor):
        self.tensor = tensor
        self.torch = None
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(tensor, torch.Tensor):
            self.torch = torch
            t = tensor.detach()
            if t.device.type != "cpu":
                t = t.cpu()
            if t.dtype == torch.bfloat16:
                self.arr = t.view(torch.int16).numpy().view(np.uint16)
                self.dtype = BF16
            else:
                self.arr = t.numpy()
                self.dtype = str(self.arr.dtype)
            # the in-place contract holds for host memory the caller owns
            self.inplace = tensor.device.type == "cpu"
            return
        arr = np.asarray(tensor)
        if arr.dtype.name == BF16:  # ml_dtypes' bf16: fold as bf16
            self.arr, self.dtype = arr.view(np.uint16), BF16
        else:
            self.arr, self.dtype = arr, str(arr.dtype)
        self.inplace = isinstance(tensor, np.ndarray)

    def write_back(self, result: np.ndarray) -> None:
        """The in-place contract: copy the result into the caller's
        writable host memory (unless the fold already ran there)."""
        if self.inplace and self.arr.flags.writeable \
                and not np.may_share_memory(self.arr, result):
            np.copyto(self.arr, result)

    def out(self, result: np.ndarray):
        """``result`` as the caller's type: an array (bf16 re-viewed as
        the caller's bf16 dtype) or a tensor of the caller's dtype on its
        device."""
        result = np.asarray(result)
        if self.torch is None:
            if self.dtype == BF16 and result.dtype == np.uint16:
                return result.view(np.asarray(self.tensor).dtype)
            return result
        torch = self.torch
        if not result.flags.writeable:  # an arena view: the tensor owns
            result = result.copy()      # its memory
        if self.dtype == BF16 and result.dtype == np.uint16:
            t = torch.from_numpy(result.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(result)
        if self.tensor.device.type != "cpu":
            t = t.to(self.tensor.device)
        return t


def allreduce(tensor, group_name: str = "default", op: str = "sum",
              transport: str = "auto", timeout: float = 300.0,
              chunk_bytes: Optional[int] = None):
    """Reduce across the group; returns the reduced array or tensor (and
    copies it into ``tensor`` in place when it's a writable ndarray or CPU
    tensor, matching the reference's in-place contract, collective.py:258
    — the ring/tree transports fold INTO the writable tensor as hops
    complete, so after a failed op its contents are undefined, like an
    aborted NCCL op). A CUDA tensor's result comes back on its device.

    ``transport``: "auto" (config ``collective_transport`` picks the
    family; the default ring family uses the chunked ring for sized
    payloads, the halving-doubling tree below ``TREE_MAX_BYTES`` on
    power-of-two worlds, and the inline coordinator for tiny ones;
    config "rendezvous" restores the pre-r18 auto split of inline
    under 256 KiB / slice-exchange above), "ring" / "tree" (force the
    object-plane algorithm), "rendezvous" (the rendezvous-actor DATA
    plane: full payloads through the coordinator, which folds them
    incrementally — the O(R·nbytes)-through-one-node baseline, and the
    only transport with zero object-plane involvement), "inline" /
    "object" (force a pre-r18 slice-exchange payload style). Every
    rank must resolve the SAME algorithm (auto does, given shared
    config and identical shapes — which are validated).
    ``chunk_bytes`` overrides ``collective_ring_chunk_bytes`` for the
    ring/tree chunking and must agree across ranks.
    """
    h = _Host(tensor)
    arr, dtype = h.arr, h.dtype
    st = _get(group_name)
    if st.world_size > 1:
        alg = _resolve_algorithm(arr, transport, st.world_size)
        if alg == "ring":
            result = _ring_collective(arr, st, op, timeout, chunk_bytes,
                                      allgather_phase=True, dtype=dtype)
        elif alg == "tree":
            result = _tree_allreduce(arr, st, op, timeout, chunk_bytes,
                                     dtype)
        elif alg == "rendezvous":
            result = _rendezvous_allreduce(arr, st, op, timeout, dtype)
        else:
            result = _allreduce_exchange(arr, st, op, alg == "object",
                                         timeout, dtype)
    else:
        _resolve_algorithm(arr, transport, 1)  # validate the argument
        result = arr
    h.write_back(result)
    return h.out(result)


def reduce_scatter(tensor, group_name: str = "default", op: str = "sum",
                   transport: str = "auto", timeout: float = 300.0,
                   chunk_bytes: Optional[int] = None):
    """Reduce across the group and return THIS rank's slice of the
    result (``np.array_split(flat, world)[rank]`` of the flattened
    reduce — the reference's reduce_scatter contract, and the first
    half of the ring allreduce exposed directly: rank r pays only
    (R-1)/R·nbytes of pulls and never materializes the full result).
    Rendezvous-family transports compute the full allreduce and slice
    it (the escape hatch is correct, just not slimmer). A writable
    ``tensor`` is used as the ring fold's scratch buffer — its
    contents are undefined afterwards (pass a copy to keep the
    input)."""
    h = _Host(tensor)
    arr, dtype = h.arr, h.dtype
    st = _get(group_name)
    W, r = st.world_size, st.rank
    if W <= 1:
        _resolve_algorithm(arr, transport, 1)
        return h.out(arr.reshape(-1))
    alg = _resolve_algorithm(arr, transport, W)
    if alg in ("ring", "tree"):
        # the tree has no natural scatter half at these sizes; the ring
        # reduce-scatter is the algorithm either way
        return h.out(_ring_collective(arr, st, op, timeout, chunk_bytes,
                                      allgather_phase=False, dtype=dtype))
    if alg == "rendezvous":
        full = _rendezvous_allreduce(arr, st, op, timeout, dtype)
    else:
        full = _allreduce_exchange(arr, st, op, alg == "object",
                                   timeout, dtype)
    return h.out(np.array_split(np.asarray(full).reshape(-1), W)[r])


def allgather(tensor, group_name: str = "default",
              transport: str = "auto", timeout: float = 300.0,
              chunk_bytes: Optional[int] = None) -> List[Any]:
    """Gather every rank's tensor, in rank order, each as the caller's
    type. Unlike allreduce, per-rank SHAPES may differ — so the
    algorithm choice must not depend on this rank's payload size (ranks
    straddling a size threshold would desync the round structure):
    "auto" resolves from the config family alone — object-plane gather
    under "ring", the pre-r18 per-rank inline/object wrap under
    "rendezvous" (whose single-round structure is payload-style-agnostic
    by design)."""
    h = _Host(tensor)
    arr, dtype = h.arr, h.dtype
    st = _get(group_name)
    if st.world_size == 1:
        _resolve_algorithm(arr, transport, 1)
        return [h.out(arr)]
    alg = _resolve_algorithm(arr, transport, st.world_size)
    if transport == "auto" and alg in ("ring", "tree", "inline"):
        # size-independent re-resolution (see docstring): the family
        # decides, never this rank's nbytes
        from ray_tpu_torch.core.config import get_config

        alg = ("legacy" if get_config().collective_transport ==
               "rendezvous" else "ring")
    if alg in ("ring", "tree"):
        parts = _object_allgather(arr, st, timeout, chunk_bytes, dtype)
    elif alg == "rendezvous":
        # the coordinator gathers and re-ships every payload (the
        # allgather kind inherently holds all parts)
        parts = _run("allgather", group_name,
                     np.ascontiguousarray(arr), timeout=timeout)
        _m()["ops"].inc(1.0, {"algorithm": "rendezvous",
                              "kind": "allgather"})
    else:
        # pre-r18 single-round wrap: "legacy" keeps the per-rank
        # inline-vs-ref choice (safe — the round structure is identical
        # for both payload styles)
        use_object = (arr.nbytes >= OBJECT_TRANSPORT_THRESHOLD
                      if alg == "legacy" else alg == "object")
        parts = [_unwrap(p) for p in _run(
            "exchange", group_name, _wrap(arr, use_object),
            timeout=timeout)]
    return [h.out(p) for p in parts]


def broadcast(tensor, src_rank: int = 0, group_name: str = "default",
              transport: str = "auto"):
    """One exchange round for any world size: only the SOURCE's local
    tensor decides the payload style (receivers pass placeholders whose
    size must not influence the round structure), so ranks can never
    rendezvous on mismatched kinds. The object payload IS already the
    cooperative relay-tree broadcast (r9) — ring-family transports map
    onto it."""
    h = _Host(tensor)
    arr = h.arr
    st = _get(group_name)
    if st.world_size > 1:
        if st.rank == src_rank:
            mine = _wrap(arr, _use_object_plane(arr, transport))
        else:
            _use_object_plane(arr, transport)  # validate the argument
            mine = None
        parts = _run("exchange", group_name, mine)
        result = arr if st.rank == src_rank else _unwrap(parts[src_rank])
    else:
        _use_object_plane(arr, transport)
        result = arr
    result = np.asarray(result)
    if result is not arr:
        h.write_back(result)
    return h.out(result)


def barrier(group_name: str = "default", timeout: float = 300.0):
    _run("barrier", group_name, None, timeout=timeout)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: str = "sum"):
    """All ranks contribute; only dst_rank gets the result (others get
    their input back, matching the reference's semantics loosely)."""
    h = _Host(tensor)
    st = _get(group_name)
    result = _run("reduce", group_name, np.ascontiguousarray(h.arr),
                  op=op, bf16=h.dtype == BF16)
    return h.out(result) if st.rank == dst_rank else tensor


def create_collective_group(actors: list, world_size: int,
                            ranks: List[int],
                            backend: str = "host",
                            group_name: str = "default"):
    """Declarative form: initialize the group on a list of actor handles
    (each must expose ``init_collective(world_size, rank, group_name)``;
    ref: collective.py:151)."""
    import ray_tpu_torch

    if backend not in BACKENDS:
        raise ValueError(f"unsupported backend {backend!r}")
    if len(actors) != len(ranks):
        raise ValueError("actors and ranks must align")
    refs = [a.init_collective.remote(world_size, r, group_name)
            for a, r in zip(actors, ranks)]
    ray_tpu_torch.get(refs, timeout=120)
