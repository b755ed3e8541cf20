"""The port's MPMD pipeline (ray_tpu_torch.train.pipeline): the cases of
tests/test_pipeline.py, one for one, on ray_tpu_torch's runtime, with
torch-autograd stages where the reference's are jax-mode — schedules,
placement, handoff overlap, eager activation free, straggler attribution,
hint coalescing, and the get_config()-before-init() orphan fix.

The 2-node cases build a ray_tpu_torch.cluster_utils.Cluster with a remote
node agent. test_pipeline_2node_smoke reads the per-stage phase rows
through ``state.phase_summary`` and ``state.pipeline_stage_summary``, the
functions behind the reference dashboard's /api/summary/tasks and
/api/summary/pipeline (the port has no dashboard yet, ROADMAP A2b).
"""

import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import state
from ray_tpu_torch.train import pipeline as pl
from ray_tpu_torch.train import pipeline_schedules as sched
from torch_pipeline_stages import ACT_N as _ACT_N
from torch_pipeline_stages import mk_raw_stages as _mk_raw_stages
from torch_pipeline_stages import tiny_torch_stages as _tiny_torch_stages
from torch_pipeline_stages import tree_max_err as _tree_max_err
from torch_port_util import (  # noqa: F401 (fixtures)
    deadline, one_torch_thread, ray_start, ray_start_cluster)


# ================================================== schedule-order units


def _ops(order):
    return sorted(order)


class TestScheduleOrders:
    @pytest.mark.parametrize("S,M", [(1, 1), (2, 3), (4, 8), (3, 12)])
    def test_gpipe_complete_and_valid(self, S, M):
        orders = sched.gpipe_order(S, M)
        sched.validate_order(orders)
        for order in orders:
            assert _ops(order) == _ops(
                [("F", m) for m in range(M)] + [("B", m) for m in range(M)])
            # GPipe keeps every forward context live until the backward
            # wave: peak contexts == M
            assert sched.max_live_contexts(order) == M

    @pytest.mark.parametrize("S,M", [(1, 1), (2, 3), (4, 8), (3, 12),
                                     (6, 4)])
    def test_1f1b_complete_valid_and_bounded(self, S, M):
        orders = sched.one_f_one_b_order(S, M)
        sched.validate_order(orders)
        for k, order in enumerate(orders):
            assert _ops(order) == _ops(
                [("F", m) for m in range(M)] + [("B", m) for m in range(M)])
            # the 1F1B contract: stage k holds at most S-k live
            # microbatch contexts — O(stages), independent of M
            assert sched.max_live_contexts(order) <= min(M, S - k)

    def test_bad_args_rejected(self):
        with pytest.raises(ValueError):
            sched.gpipe_order(0, 4)
        with pytest.raises(ValueError):
            sched.one_f_one_b_order(2, 0)

    def test_validate_order_catches_deadlock(self):
        # stage 1 wants mb 0's backward before its forward
        bad = [[("F", 0), ("B", 0)], [("B", 0), ("F", 0)]]
        with pytest.raises(ValueError, match="deadlock"):
            sched.validate_order(bad)


class TestStageModeValidation:
    def test_mixed_mode_stage_list_rejected(self):
        """Loss composition lives on the LAST stage while driver-side
        loss resolution keys off the batch's mode — a mixed list would
        silently drop the loss, so it must be rejected up front."""
        mixed = [_mk_raw_stages(1)[0],
                 pl.PipelineStage(fn=lambda p, x: x, params=None)]
        with pytest.raises(ValueError, match="share one mode"):
            pl._uniform_mode(mixed)
        with pytest.raises(ValueError, match="at least one"):
            pl._uniform_mode([])

    def test_raw_mode_targets_rejected(self):
        """Raw fwd(params, x) cannot receive a target — supplying one
        must raise instead of silently computing without labels."""
        with pytest.raises(ValueError, match="torch-mode"):
            pl._check_targets([1.0], torch_mode=False, loss_fn=None)
        with pytest.raises(ValueError, match="loss_fn"):
            pl._check_targets([1.0], torch_mode=True, loss_fn=None)
        pl._check_targets(None, torch_mode=False, loss_fn=None)  # ok
        pl._check_targets([1.0], torch_mode=True, loss_fn=lambda y, t: y)

    def test_batch_validation_shared_with_baseline(self):
        """Pipeline and the SingleProgramPipeline baseline validate
        through one helper: empty batches and mismatched target lengths
        raise instead of zip-truncating (a baseline silently running a
        different workload poisons the A/B)."""
        lf = lambda y, t: y  # noqa: E731
        with pytest.raises(ValueError, match="at least one microbatch"):
            pl._check_batch([], None, True, lf)
        with pytest.raises(ValueError, match="len\\(targets\\)"):
            pl._check_batch([1.0, 2.0], [1.0], True, lf)
        assert pl._check_batch([1.0], None, False, None) == [None]

    def test_unknown_placement_rejected(self):
        """An unrecognized placement mode must raise, not silently
        degrade to co-located stages (the overlap win would vanish
        with no diagnostic)."""
        with pytest.raises(ValueError, match="unknown placement"):
            pl.Pipeline(_mk_raw_stages(2), placement="pack")


def test_pipeline_stage_summary_matches_name_prefix(monkeypatch):
    """A/B benches retag rounds via Pipeline.name_prefix — the stage
    summary must still attribute prefixed funcs, keep the dominant
    variant per (stage, op) by default, and filter exactly on
    ``prefix=``."""
    rows = {
        "stage0.fwd": {"exec": {"count": 4, "p95_ms": 1.0},
                       "sched_wait": {"p95_ms": 9.0}},
        "roundA_stage0.fwd": {"exec": {"count": 40, "p95_ms": 2.0},
                              "sched_wait": {"p95_ms": 5.0}},
        "roundA_stage1.bwd": {"exec": {"count": 7, "p95_ms": 3.0}},
        "unrelated.fn": {"exec": {"count": 99}},
    }
    monkeypatch.setattr(state, "phase_summary", lambda *a, **k: rows)
    default = state.pipeline_stage_summary()
    assert set(default) == {0, 1}
    # dominant variant wins the shared (stage0, fwd) slot
    assert default[0]["fwd"]["exec"]["count"] == 40
    assert default[0]["bubble_ms_p95"] == 5.0
    assert default[1]["bwd"]["exec"]["count"] == 7
    only_plain = state.pipeline_stage_summary(prefix="")
    assert set(only_plain) == {0}
    assert only_plain[0]["fwd"]["exec"]["count"] == 4
    only_a = state.pipeline_stage_summary(prefix="roundA_")
    assert set(only_a) == {0, 1}
    assert only_a[0]["fwd"]["exec"]["count"] == 40


# ================================================== config orphan fix


def test_config_reference_survives_reset():
    """r13 footgun: a get_config() reference grabbed BEFORE init()
    mutated an orphaned singleton after init() reset it. reset_config()
    now re-initializes IN PLACE, so every reference — whenever taken —
    stays the live object."""
    from ray_tpu_torch.core.config import get_config, reset_config

    early = get_config()
    early.arg_prefetch_max_inflight = 99
    reset_config()  # what init() does before applying _system_config
    live = get_config()
    assert live is early, "reset_config must not orphan prior references"
    assert early.arg_prefetch_max_inflight == 4  # reset to default
    # the r13 bench pattern: A/B toggles through the early reference
    # must reach the live config
    early.arg_prefetch_enabled = False
    assert get_config().arg_prefetch_enabled is False
    reset_config()
    assert early.arg_prefetch_enabled is True


# ================================================== hint coalescing


class TestHintCoalescing:
    def _fake_batch(self, *ids):
        from ray_tpu_torch.core.task_spec import ARG_REF

        class _Spec:
            def __init__(self, args):
                self.args = args

        return [_Spec([(ARG_REF, i, "owner") for i in ids])]

    def test_buffer_merges_per_destination(self, ray_start):
        """Consecutive hint batches to one destination within a flush
        window merge into one pending frame; the merge is counted in
        prefetch_hints_coalesced and the flush ships ONE frame."""
        from types import SimpleNamespace

        from ray_tpu_torch.core import protocol as P
        from ray_tpu_torch.core.context import get_context

        ctx = get_context()
        sent = []

        class _Recorder:
            def is_attached(self):
                return True

            def send(self, mt, *fields):
                sent.append((mt, fields))

        real_head = ctx.head
        ctx.head = _Recorder()
        try:
            holder = SimpleNamespace(hinted=None)
            base_c = ctx.prefetch_hints_coalesced
            base_s = ctx.prefetch_hints_sent
            with ctx._hint_lock:
                had = dict(ctx._hint_buf)
                ctx._hint_buf.clear()
            assert not had or True
            ctx._send_prefetch_hint(holder, self._fake_batch(b"a" * 16),
                                    "lease-1")
            ctx._send_prefetch_hint(holder, self._fake_batch(b"b" * 16),
                                    "lease-1")
            ctx._send_prefetch_hint(
                SimpleNamespace(hinted=None),
                self._fake_batch(b"c" * 16), "actor:deadbeef")
            # two batches to lease-1 merged -> one frame saved
            assert ctx.prefetch_hints_coalesced - base_c == 1
            ctx._flush_prefetch_hints()
            assert ctx.prefetch_hints_sent - base_s == 1
            assert len(sent) == 1
            mt, fields = sent[0]
            assert mt == P.PREFETCH_HINT_BATCH
            entries = dict(fields[0])
            assert entries["lease-1"] == [b"a" * 16, b"b" * 16]
            assert entries["actor:deadbeef"] == [b"c" * 16]
        finally:
            ctx.head = real_head

    def test_single_destination_flush_uses_plain_hint(self, ray_start):
        from types import SimpleNamespace

        from ray_tpu_torch.core import protocol as P
        from ray_tpu_torch.core.context import get_context

        ctx = get_context()
        sent = []

        class _Recorder:
            def is_attached(self):
                return True

            def send(self, mt, *fields):
                sent.append((mt, fields))

        real_head = ctx.head
        ctx.head = _Recorder()
        try:
            ctx._flush_prefetch_hints()  # drain any leftovers
            sent.clear()
            ctx._send_prefetch_hint(SimpleNamespace(hinted=None),
                                    self._fake_batch(b"z" * 16),
                                    "lease-solo")
            ctx._flush_prefetch_hints()
            assert len(sent) == 1
            assert sent[0][0] == P.PREFETCH_HINT
            assert sent[0][1] == ("lease-solo", [b"z" * 16])
        finally:
            ctx.head = real_head

    def test_coalesce_off_restores_frame_per_batch(self, ray_start):
        from types import SimpleNamespace

        from ray_tpu_torch.core import protocol as P
        from ray_tpu_torch.core.config import get_config
        from ray_tpu_torch.core.context import get_context

        ctx = get_context()
        cfg = get_config()
        sent = []

        class _Recorder:
            def is_attached(self):
                return True

            def send(self, mt, *fields):
                sent.append(mt)

        real_head = ctx.head
        ctx.head = _Recorder()
        prev = cfg.prefetch_hint_coalesce
        cfg.prefetch_hint_coalesce = False
        try:
            holder = SimpleNamespace(hinted=None)
            ctx._send_prefetch_hint(holder, self._fake_batch(b"d" * 16),
                                    "lease-2")
            ctx._send_prefetch_hint(holder, self._fake_batch(b"e" * 16),
                                    "lease-2")
            assert sent == [P.PREFETCH_HINT, P.PREFETCH_HINT]
        finally:
            cfg.prefetch_hint_coalesce = prev
            ctx.head = real_head

    def test_batch_frame_handled_by_head(self, ray_start):
        """PREFETCH_HINT_BATCH with unknown lease keys must be a no-op
        (not a head crash), same as the single-hint contract."""
        from ray_tpu_torch.core import protocol as P
        from ray_tpu_torch.core.context import get_context

        ctx = get_context()
        ctx.head.send(P.PREFETCH_HINT_BATCH,
                      [("no-such-lease", [b"q" * 16]),
                       ("actor:00ff", [b"r" * 16])])
        # round-trip to prove the head's loop survived the frame
        assert ctx.head.call(P.PING, timeout=10)[0] == "pong"


# ================================================== virtual-cluster


@deadline(120)
def test_pipeline_placement_modes(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    # auto: one stage per node round-robin over the 3 alive nodes
    pipe = pl.Pipeline(_mk_raw_stages(3), schedule="1f1b",
                       placement="auto")
    nodes = [p["node_idx"] for p in pipe.probe()]
    assert len(set(nodes)) == 3, nodes
    pipe.shutdown()
    # spread: placement group SPREAD puts the 2 stages on 2 nodes
    pipe = pl.Pipeline(_mk_raw_stages(2), schedule="gpipe",
                       placement="spread")
    nodes = [p["node_idx"] for p in pipe.probe()]
    assert len(set(nodes)) == 2, nodes
    pipe.shutdown()


@deadline(90)
def test_pipeline_microbatch_bound(ray_start):
    """A positive pipeline_max_inflight_microbatches gates stage-0
    admission without wedging or changing results."""
    pipe = pl.Pipeline(_mk_raw_stages(2), schedule="gpipe",
                       max_inflight_microbatches=2)
    out = pipe.run_batch([float(i) for i in range(6)],
                         by_ref_min_bytes=0)
    vals = ray_tpu_torch.get(out["outputs"], timeout=60)
    assert vals == [float(i) + 1.0 for i in range(6)]
    pipe.shutdown()


@deadline(120)
def test_pipeline_eager_activation_free(ray_start_cluster):
    """1F1B steady-state store footprint is O(stages): the driver drops
    each activation handle at consumer-submission time, so the owner
    free fires right after consumption (+ the ~1s borrow grace) and the
    head directory never accumulates O(microbatches) entries."""
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    S, M = 3, 8
    pipe = pl.Pipeline(_mk_raw_stages(S, fwd_s=0.25, bwd_s=0.12),
                       schedule="1f1b")
    peak = [0]
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            try:
                n = len(state.list_objects(limit=1000))
            except Exception:  # noqa: BLE001 — shutdown race
                break
            peak[0] = max(peak[0], n)
            time.sleep(0.1)

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    out = pipe.run_batch([float(i) for i in range(M)],
                         by_ref_min_bytes=0)
    vals = ray_tpu_torch.get(out["outputs"], timeout=120)
    stop.set()
    t.join(timeout=5)
    assert vals == [float(i) + 2.0 for i in range(M)]
    # O(stages) bound: live activations + grads in flight plus the
    # borrow-grace tail — far below the 2*(S-1)*M entries the run
    # creates in total (a leak shows up as ~32 here)
    bound = 4 * S + 4
    assert peak[0] <= bound, \
        f"peak store entries {peak[0]} > O(stages) bound {bound}"
    assert peak[0] >= 1  # the sampler actually saw the run
    pipe.shutdown()


# ================================================== real 2-node cluster


@deadline(180)
def test_pipeline_schedules_numerically_equivalent_2node():
    """GPipe, 1F1B and single-program execution of the same toy torch
    model produce identical losses and grads across 2 REAL nodes (one
    remote agent process), and all match the driver-side
    torch.autograd oracle."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2, "num_gpus": 0})
    handle = None
    try:
        handle = cluster.add_remote_node(num_cpus=2)
        stages, loss_fn, mbs, tgts = _tiny_torch_stages(2)
        ref_loss, ref_grads = pl.single_program_reference(
            stages, loss_fn, mbs, tgts)
        results = {}
        for schedule in ("1f1b", "gpipe"):
            pipe = pl.Pipeline(stages, loss_fn=loss_fn,
                               schedule=schedule)
            nodes = {p["node_idx"] for p in pipe.probe()}
            assert len(nodes) == 2, f"stages not spread: {nodes}"
            out = pipe.run_batch(mbs, tgts)
            results[schedule] = (out["loss"], pipe.grads())
            pipe.shutdown()
        sp = pl.SingleProgramPipeline(stages, loss_fn=loss_fn)
        out = sp.run_batch(mbs, tgts)
        results["single"] = (out["loss"], sp.grads())
        sp.shutdown()
        for name, (loss, grads) in results.items():
            assert abs(loss - ref_loss) < 1e-6, (name, loss, ref_loss)
            for k in range(len(stages)):
                err = _tree_max_err(grads[k], ref_grads[k])
                assert err < 1e-5, (name, k, err)
    finally:
        if handle is not None:
            handle.terminate()
        cluster.shutdown()


# ================================================== data-parallel (r18)


class TestReplicaOrders:
    def test_partition_validity_and_local_bound(self):
        S, R, M = 3, 2, 7
        ids = [[i for i in range(M) if i % R == rep] for rep in range(R)]
        orders = sched.replica_orders(sched.one_f_one_b_order, S, ids)
        sched.validate_replica_orders(orders)
        for k in range(S):
            # every global microbatch appears in exactly one replica's
            # lane, forward and backward once each
            fs = [mb for rep in range(R)
                  for op, mb in orders[k][rep] if op == "F"]
            assert sorted(fs) == list(range(M))
            for rep in range(R):
                assert {mb for _, mb in orders[k][rep]} == set(ids[rep])
                # the 1F1B O(stages) context bound holds per replica
                assert sched.max_live_contexts(orders[k][rep]) <= \
                    min(len(ids[rep]), S - k)

    def test_empty_replica_slice(self):
        # M < R edge: a replica with no microbatches gets empty orders
        # and validation skips it
        orders = sched.replica_orders(sched.gpipe_order, 2, [[0], []])
        sched.validate_replica_orders(orders)
        assert orders[0][1] == [] and orders[1][1] == []
        assert [mb for _, mb in orders[0][0]] == [0, 0]


@deadline(90)
def test_dp_pipeline_raw_mode(ray_start):
    """2 stages x 2 replicas, ODD microbatch count (uneven split 3/2):
    each microbatch flows through its own replica chain and outputs
    stay per-microbatch correct; grad-less raw stages sync without
    desync (the has-grads round agrees to skip buckets)."""
    pipe = pl.Pipeline(_mk_raw_stages(2), schedule="1f1b",
                       replicas_per_stage=2, placement="none")
    M = 5
    out = pipe.run_batch([float(i) for i in range(M)],
                         by_ref_min_bytes=0)
    vals = ray_tpu_torch.get(out["outputs"], timeout=60)
    assert vals == [float(i) + 1.0 for i in range(M)]
    st = pipe.stats()
    assert st["replicas_per_stage"] == 2
    assert st["grad_allreduces"] == 1
    assert pipe.grads() == [None, None]
    pipe.shutdown()


@deadline(150)
def test_dp_pipeline_equivalent_to_oracle(ray_start_cluster):
    """(2 stages x 2 replicas) on 3 virtual nodes: loss and SYNCED
    grads equal the 1-replica driver oracle, both replicas hold
    bit-identical grads after the batch-end all-reduce, and
    ``pipeline_stage_summary`` splits rows per (stage, replica)."""
    from ray_tpu_torch.core.context import get_context

    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    stages, loss_fn, mbs, tgts = _tiny_torch_stages(2)
    ref_loss, ref_grads = pl.single_program_reference(
        stages, loss_fn, mbs, tgts)
    pipe = pl.Pipeline(stages, loss_fn=loss_fn, schedule="1f1b",
                       replicas_per_stage=2, name_prefix="dp_")
    assert len(pipe.actors) == 4
    nodes = {p["node_idx"] for p in pipe.probe()}
    assert len(nodes) >= 2, f"gang not spread: {nodes}"
    out = pipe.run_batch(mbs, tgts, by_ref_min_bytes=0)
    assert abs(out["loss"] - ref_loss) < 1e-6
    grads = pipe.grads()
    for k in range(2):
        assert _tree_max_err(grads[k], ref_grads[k]) < 1e-5
    # post-AR the replica pair holds IDENTICAL (global-sum) grads
    g0, g1 = ray_tpu_torch.get([pipe.actors[0].grads.remote(True),
                          pipe.actors[1].grads.remote(True)],
                         timeout=60)
    assert _tree_max_err(g0, g1) == 0.0
    assert pipe.stats()["grad_allreduces"] == 1
    # cross-batch accumulation matches R=1 semantics: a SECOND
    # un-reset batch adds exactly one more batch's grads — the synced
    # base must not re-enter the next all-reduce (it would be counted
    # R times: total 3x after two identical batches instead of 2x)
    sum1 = pipe.grads(mean=False)
    pipe.run_batch(mbs, tgts, by_ref_min_bytes=0)
    sum2 = pipe.grads(mean=False)
    doubled = pl._tree_map(lambda a: 2 * a, sum1[0])
    assert _tree_max_err(sum2[0], doubled) < 1e-4, \
        "synced grads re-entered the second batch's all-reduce"
    # observability rider: per-(stage, replica) summary rows
    get_context().events.flush(sync=True)
    deadline = time.monotonic() + 25
    summ = {}
    while time.monotonic() < deadline:
        summ = state.pipeline_stage_summary(prefix="dp_")
        if all(k in summ and set(summ[k].get("replicas", {})) == {0, 1}
               for k in (0, 1)):
            break
        time.sleep(0.25)
    for k in (0, 1):
        reps = summ[k]["replicas"]
        assert set(reps) == {0, 1}, summ
        for rd in reps.values():
            assert "bubble_ms_p95" in rd and "exec_ms_p95" in rd
        # stage-level p95 aggregates over replicas (gang waits for the
        # slowest member)
        assert summ[k]["exec_ms_p95"] >= max(
            rd["exec_ms_p95"] for rd in reps.values()) - 1e-9
    pipe.shutdown()


@deadline(180)
def test_pipeline_2node_smoke():
    """Tier-1 handoff smoke: 2 stages x 3 microbatches over a real
    remote node — activations flow by-ref store-to-store (the head
    host's transfer server serves stage 0's outputs to the remote
    stage), dispatch hints drive the prefetch machinery, and the
    per-stage phase rows show up in ``state.summarize_tasks()`` and
    ``state.pipeline_stage_summary()`` (the reference reads them through
    its dashboard's /api/summary/tasks and /api/summary/pipeline)."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2, "num_gpus": 0})
    handle = None
    try:
        handle = cluster.add_remote_node(num_cpus=2)
        import ray_tpu_torch.core.api as core_api
        from ray_tpu_torch.core.context import get_context

        head = core_api._head
        served0 = head._transfer_server.bytes_served
        issued0 = head.prefetch_issued
        pipe = pl.Pipeline(_mk_raw_stages(2), schedule="1f1b")
        nodes = {p["node_idx"] for p in pipe.probe()}
        assert len(nodes) == 2, nodes
        out = pipe.run_batch([float(i) for i in range(3)],
                             by_ref_min_bytes=0)
        vals = ray_tpu_torch.get(out["outputs"], timeout=120)
        assert vals == [1.0, 2.0, 3.0]
        # by-ref activation handoff: ~280 KiB x 3 microbatches crossed
        # through the head host's transfer server
        moved = head._transfer_server.bytes_served - served0
        assert moved >= 3 * _ACT_N * 4, moved
        # the dispatch-time hints reached the prefetch machinery
        assert head.prefetch_issued - issued0 >= 1
        assert head.prefetch_wasted == 0
        get_context().events.flush(sync=True)
        want = ("stage0.fwd", "stage1.fwd", "stage0.bwd", "stage1.bwd")
        # stage WORKERS flush their event buffers on their own cadence
        # — poll until every stage's exec histogram landed at the head
        # with all three microbatches (a histogram can land with the
        # first two while the third's events wait for the next flush)
        t_end = time.monotonic() + 20
        phases = {}
        while time.monotonic() < t_end:
            phases = state.summarize_tasks()["phases"]
            if all(f in phases and "exec" in phases[f]
                   and phases[f]["exec"]["count"] >= 3 for f in want):
                break
            time.sleep(0.25)
        for func in want:
            assert func in phases, (func, sorted(phases))
            assert phases[func]["exec"]["count"] >= 3
        rows = state.pipeline_stage_summary()
        assert set(rows) == {0, 1}
        assert "transfer_ms_p95" in rows[1]
        pipe.shutdown()
    finally:
        if handle is not None:
            handle.terminate()
        cluster.shutdown()


# ================================================== chaos (slow tier)


@pytest.mark.slow
@deadline(120)
def test_pipeline_slow_stage_straggler_attribution(ray_start):
    """A deliberately slow stage must trip the r10 straggler detector
    exactly once, attributed to THAT stage's func name — the bubble
    shows up where it is caused, not where it is felt."""
    S, M = 3, 10
    slow_stage, slow_mb = 1, M - 1
    pipe = pl.Pipeline(_mk_raw_stages(S, fwd_s=0.03), schedule="1f1b")
    # build stage1.fwd's completed-exec distribution past the
    # min-sample gate, then stall one late microbatch 100x its p95
    ray_tpu_torch.get([pipe.actors[slow_stage].set_delay.remote(
        4.0, only_mb=slow_mb)], timeout=30)
    out = pipe.run_batch([float(i) for i in range(M)],
                         by_ref_min_bytes=0)
    ray_tpu_torch.get(out["outputs"], timeout=120)
    deadline = time.monotonic() + 20
    evs = []
    while time.monotonic() < deadline:
        evs = state.list_cluster_events(
            filters=[("type", "=", "task_straggler")])
        if evs:
            break
        time.sleep(0.3)
    assert len(evs) == 1, evs
    assert evs[0]["extra"]["func"] == f"stage{slow_stage}.fwd", evs
    # exactly one attribution: later sweeps must not re-flag, and no
    # other stage may be blamed
    time.sleep(2.5)
    evs = state.list_cluster_events(
        filters=[("type", "=", "task_straggler")])
    assert len(evs) == 1
    slow_rows = state.list_slow_tasks()
    assert slow_rows and all(
        r["name"] == f"stage{slow_stage}.fwd" for r in slow_rows), \
        slow_rows
    pipe.shutdown()
