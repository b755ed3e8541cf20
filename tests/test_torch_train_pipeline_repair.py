"""The port's elastic pipeline repair (ray_tpu_torch.train.pipeline): the
cases of tests/test_pipeline_repair.py, one for one, on ray_tpu_torch's
runtime with torch-autograd stages — repair-planner units, the actor-death
surface the planner relies on, graceful node drain, and inline-promoted
prefetch-hint tagging.

test_doctor_flags_stuck_drain reads the port's ``dashboard``
(``doctor_warnings``). The chaos cases (slow tier, as in the
reference) kill and drain REAL agent nodes of a
ray_tpu_torch.cluster_utils.Cluster.
"""

import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import state
from ray_tpu_torch.core.api import NodeAffinitySchedulingStrategy
from ray_tpu_torch.train import pipeline as pl
from torch_pipeline_stages import mk_raw_stages as _mk_raw_stages
from torch_pipeline_stages import tiny_torch_stages
from torch_pipeline_stages import tree_max_err as _tree_max_err
from torch_port_util import (  # noqa: F401 (fixtures)
    deadline, one_torch_thread, ray_start, ray_start_cluster)


# ===================================================== planner units


class TestPlanRepair:
    def test_deterministic_replacement_choice(self):
        """3 virtual nodes, stage k on node k, stage 1's node died:
        the survivors host one stage each — the tie breaks to the
        LOWEST node index, and repeated planning is identical."""
        plan = pl.plan_repair([1], [0, 1, 2], [0, 2], ckpt_wave=-1,
                              failed_wave=0, wave_sizes=[4, 4])
        assert plan["placement"] == {1: 0}
        again = pl.plan_repair([1], [0, 1, 2], [0, 2], ckpt_wave=-1,
                               failed_wave=0, wave_sizes=[4, 4])
        assert again == plan

    def test_least_loaded_spread_for_colocated_stages(self):
        """Two stages died with one node: they re-place least-loaded-
        first, spreading over the survivors instead of stacking."""
        plan = pl.plan_repair([1, 2], [0, 1, 1], [0, 2], ckpt_wave=0,
                              failed_wave=1, wave_sizes=[2, 2])
        # node 0 hosts stage 0 already -> stage 1 goes to empty node 2,
        # stage 2 then ties (1 each) and breaks to node 0
        assert plan["placement"] == {1: 2, 2: 0}

    def test_checkpoint_wave_selection_and_replay_set(self):
        plan = pl.plan_repair([0], [0, 1], [1], ckpt_wave=1,
                              failed_wave=3,
                              wave_sizes=[4, 4, 4, 4])
        assert plan["restore_wave"] == 1
        assert plan["replay_waves"] == [2, 3]
        assert plan["redo_microbatches"] == 8
        # batch-start checkpoint: everything replays
        plan = pl.plan_repair([0], [0, 1], [1], ckpt_wave=-1,
                              failed_wave=1, wave_sizes=[3, 3])
        assert plan["replay_waves"] == [0, 1]
        assert plan["redo_microbatches"] == 6

    def test_no_surviving_node_raises(self):
        with pytest.raises(ValueError, match="no surviving node"):
            pl.plan_repair([0], [0], [], ckpt_wave=-1, failed_wave=0,
                           wave_sizes=[1])


@deadline(60)
def test_doctor_flags_stuck_drain(monkeypatch, ray_start):
    """A node still `draining` past drain_deadline_s (+ escalation
    slack) means drain_forced never fired — doctor must flag it; a
    fresh drain inside the window must not."""
    from ray_tpu_torch.core.config import get_config
    from ray_tpu_torch.dashboard import doctor_warnings

    drain_s = get_config().drain_deadline_s
    rows = [{"node_idx": 7, "alive": True, "draining": True,
             "drain_age_s": drain_s + 30.0}]
    monkeypatch.setattr(state, "list_nodes", lambda *a, **k: rows)
    warns = [w for w in doctor_warnings() if "stuck draining" in w]
    assert len(warns) == 1 and "node 7" in warns[0], warns
    rows[0]["drain_age_s"] = drain_s * 0.5
    assert not [w for w in doctor_warnings() if "stuck draining" in w]


# ============================================= actor-death surface


class _Svc:
    def ping(self):
        return "pong"

    def slow(self, s):
        time.sleep(s)
        return s


@deadline(90)
def test_killed_actor_surfaces_actor_died_not_hang(ray_start_cluster):
    """The surface the repair planner relies on: when an actor's node
    is removed, pending callers — both the in-flight call and tasks
    queued behind it — get a prompt ActorDiedError instead of hanging
    to their timeout (the deliberate-kill path pre-marks workers dead,
    which used to suppress the actor-death notification entirely)."""
    cluster = ray_start_cluster
    idx = cluster.add_node(num_cpus=2)
    a = ray_tpu_torch.remote(_Svc).options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(idx)).remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=30) == "pong"
    inflight = a.slow.remote(30.0)
    queued = a.slow.remote(0.1)
    # a caller ALREADY blocked in get() must unblock with the error too
    blocked_err = {}

    def blocked_get():
        try:
            ray_tpu_torch.get(queued, timeout=25)
        except Exception as e:  # noqa: BLE001
            blocked_err["e"] = e

    t = threading.Thread(target=blocked_get, daemon=True)
    t.start()
    time.sleep(0.5)
    cluster.remove_node(idx)
    t0 = time.monotonic()
    with pytest.raises(ray_tpu_torch.ActorDiedError):
        ray_tpu_torch.get(inflight, timeout=20)
    assert time.monotonic() - t0 < 10.0, "death was not prompt"
    t.join(timeout=10)
    assert isinstance(blocked_err.get("e"), ray_tpu_torch.ActorDiedError), \
        blocked_err


# ======================================= virtual-cluster repair/drain


@deadline(150)
def test_pipeline_repairs_node_kill_virtual(ray_start_cluster):
    """Mid-batch kill of a stage's (virtual) node: the pipeline
    re-places the stage on a surviving node, restores the wave-boundary
    checkpoint, replays <= one wave, and the batch completes with
    correct outputs — one pipeline_stage_repaired event rides the
    cluster log."""
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    pipe = pl.Pipeline(_mk_raw_stages(3, fwd_s=0.25), schedule="1f1b",
                       max_inflight_microbatches=3)
    pipe._refresh_stage_nodes()
    assert len(set(pipe.stage_nodes)) == 3, pipe.stage_nodes
    victim = pipe.stage_nodes[1]
    out = {}

    def run():
        out["res"] = pipe.run_batch([float(i) for i in range(6)],
                                    by_ref_min_bytes=0)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(2.2)  # into the first wave
    cluster.remove_node(victim)
    t.join(timeout=90)
    assert not t.is_alive(), "repair did not complete"
    vals = ray_tpu_torch.get(out["res"]["outputs"], timeout=60)
    assert vals == [float(i) + 2.0 for i in range(6)], vals
    st = pipe.stats()
    assert st["pipeline_repairs"] == 1, st
    assert 0 < st["repair_redo_microbatches"] <= 3, st
    assert victim not in (pipe.stage_nodes or []), pipe.stage_nodes
    evs = state.list_cluster_events(
        filters=[("type", "=", "pipeline_stage_repaired")])
    assert len(evs) == 1 and evs[0]["extra"]["stages"] == [1], evs
    pipe.shutdown()


@deadline(180)
def test_dp_pipeline_repairs_replica_node_kill(ray_start_cluster):
    """The r18 NOTE's missing DP chaos leg: mid-batch node death of
    one replica's host in a (2 stages x 2 replicas) pipeline. The
    repair re-places the dead gang members, rebuilds every stage's
    replica collective group under a FRESH coordinator generation (a
    replaced actor's per-group sequence numbering restarts — rejoining
    the old group would rendezvous rounds out of step), replays, and
    the batch finishes with loss/grads equal to the 1-replica driver
    oracle and both replicas holding identical synced grads."""
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    stages, loss_fn, mbs, tgts = _tiny_torch_stages(2, fwd_sleep_s=0.3)
    ref_loss, ref_grads = pl.single_program_reference(
        stages, loss_fn, mbs, tgts)
    pipe = pl.Pipeline(stages, loss_fn=loss_fn, schedule="1f1b",
                       replicas_per_stage=2,
                       max_inflight_microbatches=4)
    assert len(pipe.actors) == 4
    pipe._refresh_stage_nodes()
    gen0 = pipe._group_gen
    # any non-bootstrap node hosting a gang member will do; 4 actors
    # over 3 nodes guarantee one exists
    victim = next(n for n in pipe.stage_nodes if n != 0)
    out = {}

    def run():
        out["res"] = pipe.run_batch(mbs, tgts, by_ref_min_bytes=0)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(1.2)  # into the first wave
    cluster.remove_node(victim)
    t.join(timeout=120)
    assert not t.is_alive(), "DP repair did not complete"
    st = pipe.stats()
    assert st["pipeline_repairs"] >= 1, st
    # the collective groups were rebuilt under a fresh generation —
    # grad sync after repair would otherwise wedge on stale seqnos
    assert pipe._group_gen > gen0, (pipe._group_gen, gen0)
    assert abs(out["res"]["loss"] - ref_loss) < 1e-6, \
        (out["res"]["loss"], ref_loss)
    grads = pipe.grads()
    for k in range(len(stages)):
        assert _tree_max_err(grads[k], ref_grads[k]) < 1e-5, k
    # post-AR both replicas of stage 0 hold IDENTICAL global-sum grads
    g0, g1 = ray_tpu_torch.get([pipe.actors[0].grads.remote(True),
                          pipe.actors[1].grads.remote(True)],
                         timeout=60)
    assert _tree_max_err(g0, g1) == 0.0
    evs = state.list_cluster_events(
        filters=[("type", "=", "pipeline_stage_repaired")])
    assert evs and evs[0]["extra"]["replicas_per_stage"] == 2, evs
    pipe.shutdown()


@deadline(120)
def test_drain_node_tier1_smoke(ray_start_cluster):
    """Tier-1 drain smoke: drain a 2nd node whose only occupants are
    an idle actor's lease and a sole object copy — the nodes row shows
    `draining` (excluded from new placements), the sole copy
    replicates off and stays fetchable, retiring the actor completes
    the drain (node_drained, NOT drain_forced), the row goes away, and
    no task failed."""
    cluster = ray_start_cluster
    idx = cluster.add_node(num_cpus=2)

    @ray_tpu_torch.remote
    def make(n):
        return np.full(n, 7.0, np.float32)

    # a plasma-resident object whose only copy lives on the 2nd node
    ref = make.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(idx)).remote(
        70000)
    assert ray_tpu_torch.get(ref, timeout=30).shape == (70000,)
    assert idx in ray_tpu_torch.object_locations(ref)["holders"]
    # an actor lease pins the node mid-drain so the draining state is
    # observable (an empty node drains within a housekeeping tick)
    a = ray_tpu_torch.remote(_Svc).options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(idx)).remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=30) == "pong"
    # the head's bootstrap node is never drainable (its removal would
    # take the driver's own arena down with it)
    assert ray_tpu_torch.drain_node(0) is False
    assert ray_tpu_torch.drain_node(idx) is True
    rows = [r for r in state.list_nodes() if r["node_idx"] == idx]
    assert rows and rows[0]["draining"] is True, rows
    # still listed, still alive: the lease holds the shutdown back
    time.sleep(1.0)
    rows = [r for r in state.list_nodes() if r["node_idx"] == idx]
    assert rows and rows[0]["alive"], rows
    ray_tpu_torch.kill(a)  # retire the occupant -> the drain can complete
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        rows = [r for r in state.list_nodes() if r["node_idx"] == idx]
        if not rows:
            break
        time.sleep(0.25)
    assert not rows, f"node {idx} never finished draining: {rows}"
    types = [e["type"] for e in state.list_cluster_events()]
    assert "node_draining" in types and "node_drained" in types, types
    assert "drain_forced" not in types, types
    io = state.io_loop_stats()[0]
    assert io["drains_completed"] >= 1 and io["drains_forced"] == 0, io
    assert io["drain_migrated_leases"] >= 1, io
    # the drained node's sole copy replicated off and is still served
    locs = ray_tpu_torch.object_locations(ref)
    assert locs["holders"] and idx not in locs["holders"], locs
    got = ray_tpu_torch.get(ref, timeout=30)
    assert float(got[0]) == 7.0 and got.shape == (70000,)
    # zero failed tasks attributable to the drain
    failed = [r for r in state.list_tasks(limit=1000)
              if r["state"] == "FAILED"]
    assert not failed, failed


# ====================================== inline-promoted hint tagging


class _RecorderConn:
    """Stands in for a head/agent channel, recording sends."""

    def __init__(self):
        self.sent = []

    def is_attached(self):
        return True

    def send(self, mt, *fields, **kw):
        self.sent.append((mt, fields))


class TestInlineHintTagging:
    def _fake_batch(self, *ids):
        from ray_tpu_torch.core.task_spec import ARG_REF

        class _Spec:
            def __init__(self, args):
                self.args = args

        return [_Spec([(ARG_REF, i, "owner") for i in ids])]

    def test_driver_tags_inline_promoted_ids(self, ray_start):
        """Hints carry the optional third field naming which ids are
        inline-promoted; frames with no inline ids stay 2-field
        (byte-identical to r15)."""
        from types import SimpleNamespace

        from ray_tpu_torch.core import protocol as P
        from ray_tpu_torch.core.context import get_context

        ctx = get_context()
        rec = _RecorderConn()
        real_head = ctx.head
        ctx.head = rec
        inline_id, real_id = b"i" * 16, b"r" * 16
        try:
            with ctx._hint_lock:
                ctx._hint_buf.clear()
                ctx._inline_promoted[inline_id] = None
            ctx._send_prefetch_hint(
                SimpleNamespace(hinted=None),
                self._fake_batch(inline_id, real_id), "lease-x")
            ctx._flush_prefetch_hints()
            assert len(rec.sent) == 1
            mt, fields = rec.sent[0]
            assert mt == P.PREFETCH_HINT
            assert fields == ("lease-x", [inline_id, real_id],
                              [inline_id])
            # no-inline destinations keep the 2-field r15 frame
            rec.sent.clear()
            ctx._send_prefetch_hint(
                SimpleNamespace(hinted=None),
                self._fake_batch(real_id), "lease-y")
            ctx._flush_prefetch_hints()
            assert rec.sent[0] == (P.PREFETCH_HINT,
                                   ("lease-y", [real_id]))
        finally:
            with ctx._hint_lock:
                ctx._inline_promoted.pop(inline_id, None)
            ctx.head = real_head

    def test_promote_if_needed_records_id(self, ray_start):
        """An owner value materialized by _promote_if_needed lands in
        the inline-promoted set the hint tagger reads (put() objects
        are plasma-resident from birth and are NOT tagged)."""
        from ray_tpu_torch.core.context import get_context

        ctx = get_context()

        @ray_tpu_torch.remote
        def tiny():
            return 123  # inline-sized return: lives in driver memory

        ref = tiny.remote()
        assert ray_tpu_torch.get(ref, timeout=30) == 123
        assert ref.id.binary() not in ctx._inline_promoted
        ctx._promote_if_needed(ref)
        assert ref.id.binary() in ctx._inline_promoted
        put_ref = ray_tpu_torch.put({"tiny": 1})
        ctx._promote_if_needed(put_ref)
        assert put_ref.id.binary() not in ctx._inline_promoted

    def test_head_counts_inline_pulls_apart(self, ray_start):
        """Inline-tagged pulls route to prefetch_issued_inline /
        prefetch_wasted_inline — the issued/wasted pair behind the
        doctor waste-ratio check measures only real speculation."""
        from ray_tpu_torch.core import protocol as P
        import ray_tpu_torch.core.api as core_api
        from ray_tpu_torch.core.head import NodeState
        from ray_tpu_torch.core.ids import ObjectID, _random_bytes
        from ray_tpu_torch.core.resources import ResourceSet, \
            detect_node_resources

        head = core_api._head
        head.enable_tcp(host="127.0.0.1")  # transfer addr for node 0
        rec = _RecorderConn()
        fake_idx = 990
        node = NodeState(idx=fake_idx,
                         resources=detect_node_resources(num_cpus=1),
                         store=None, store_name="fake",
                         agent_conn=rec, node_ip="127.0.0.1")
        head.nodes[fake_idx] = node
        oid_i = ObjectID(_random_bytes(ObjectID.SIZE))
        oid_r = ObjectID(_random_bytes(ObjectID.SIZE))
        try:
            for oid in (oid_i, oid_r):
                head.objects.record_sealed(oid, 0, 4096, "owner")
            head.leases["L-inline-test"] = (fake_idx, ResourceSet({}),
                                            "", None, None)
            base = (head.prefetch_issued, head.prefetch_issued_inline,
                    head.prefetch_wasted, head.prefetch_wasted_inline)
            head._h_prefetch_hint(
                rec, 0, "L-inline-test",
                [oid_i.binary(), oid_r.binary()], [oid_i.binary()])
            pulls = [s for s in rec.sent if s[0] == P.PULL_OBJECT]
            assert len(pulls) == 2, rec.sent
            assert head.prefetch_issued - base[0] == 1
            assert head.prefetch_issued_inline - base[1] == 1
            # teardown: the inline pull's abort is booked apart too
            head._abort_lease_prefetches("L-inline-test")
            assert head.prefetch_wasted - base[2] == 1
            assert head.prefetch_wasted_inline - base[3] == 1
        finally:
            head.leases.pop("L-inline-test", None)
            head.nodes.pop(fake_idx, None)

    def test_batch_frame_mixed_tuple_shapes(self, ray_start):
        """PREFETCH_HINT_BATCH entries may be r15 2-tuples or r16
        3-tuples — both decode, neither crashes the head loop."""
        from ray_tpu_torch.core import protocol as P
        from ray_tpu_torch.core.context import get_context

        ctx = get_context()
        ctx.head.send(P.PREFETCH_HINT_BATCH,
                      [("no-such-lease", [b"q" * 16]),
                       ("other-lease", [b"r" * 16], [b"r" * 16])])
        assert ctx.head.call(P.PING, timeout=10)[0] == "pong"


# ================================================= chaos (slow tier)


def _tiny_torch_stages(n_stages, fwd_sleep_s=0.0, seed=0):
    return tiny_torch_stages(n_stages, fwd_sleep_s, seed, n_mb=8)


@pytest.mark.slow
@deadline(300)
def test_pipeline_node_kill_chaos_real_agents():
    """kill -9 of a REAL agent node hosting a mid-pipeline stage during
    a 1F1B batch: the job completes with losses/grads numerically equal
    to the driver-side oracle and redo bounded by one wave."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2, "num_gpus": 0})
    handles = []
    try:
        handles = [cluster.add_remote_node(num_cpus=2)
                   for _ in range(2)]
        stages, loss_fn, mbs, tgts = _tiny_torch_stages(
            3, fwd_sleep_s=0.25)
        ref_loss, ref_grads = pl.single_program_reference(
            stages, loss_fn, mbs, tgts)
        pipe = pl.Pipeline(stages, loss_fn=loss_fn, schedule="1f1b",
                           max_inflight_microbatches=4)
        pipe._refresh_stage_nodes()
        assert len(set(pipe.stage_nodes)) == 3, pipe.stage_nodes
        victim_stage = 1
        victim = pipe.stage_nodes[victim_stage]
        handle = next(h for h in handles if h.node_idx == victim)
        out = {}

        def run():
            out["res"] = pipe.run_batch(mbs, tgts, by_ref_min_bytes=0)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        time.sleep(3.0)  # into the first wave
        handle.terminate()  # SIGKILL the agent process
        t.join(timeout=180)
        assert not t.is_alive(), "repair did not complete"
        st = pipe.stats()
        assert st["pipeline_repairs"] >= 1, st
        assert st["repair_redo_microbatches"] <= 4, st
        assert abs(out["res"]["loss"] - ref_loss) < 1e-6, \
            (out["res"]["loss"], ref_loss)
        grads = pipe.grads()
        for k in range(len(stages)):
            assert _tree_max_err(grads[k], ref_grads[k]) < 1e-5, k
        pipe.shutdown()
    finally:
        for h in handles:
            try:
                h.terminate()
            except Exception:  # noqa: BLE001
                pass
        cluster.shutdown()


@pytest.mark.slow
@deadline(300)
def test_pipeline_drain_chaos_real_agents():
    """Graceful drain of a real agent node hosting a live stage
    mid-run: the stage migrates at a wave boundary BEFORE the
    shutdown — zero failed tasks, drain_migrated_leases >= 1, grads
    still equal the oracle, and the drained node's copies were
    replicated off."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2, "num_gpus": 0})
    handles = []
    try:
        handles = [cluster.add_remote_node(num_cpus=2)
                   for _ in range(2)]
        stages, loss_fn, mbs, tgts = _tiny_torch_stages(
            3, fwd_sleep_s=0.2)
        ref_loss, ref_grads = pl.single_program_reference(
            stages, loss_fn, mbs, tgts)
        pipe = pl.Pipeline(stages, loss_fn=loss_fn, schedule="1f1b",
                           max_inflight_microbatches=2)
        pipe._refresh_stage_nodes()
        victim = pipe.stage_nodes[1]
        assert victim in {h.node_idx for h in handles}
        out = {}

        def run():
            out["res"] = pipe.run_batch(mbs, tgts, by_ref_min_bytes=0)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        time.sleep(2.0)
        assert ray_tpu_torch.drain_node(victim) is True
        t.join(timeout=180)
        assert not t.is_alive(), "drain migration wedged the batch"
        st = pipe.stats()
        assert st["stage_migrations"] >= 1, st
        assert st["pipeline_repairs"] == 0, st
        assert abs(out["res"]["loss"] - ref_loss) < 1e-6
        grads = pipe.grads()
        for k in range(len(stages)):
            assert _tree_max_err(grads[k], ref_grads[k]) < 1e-5, k
        # the drain completes gracefully once the batch's leases moved
        deadline = time.monotonic() + 60
        rows = True
        while time.monotonic() < deadline:
            rows = [r for r in state.list_nodes()
                    if r["node_idx"] == victim]
            if not rows:
                break
            time.sleep(0.5)
        assert not rows, rows
        io = state.io_loop_stats()[0]
        assert io["drain_migrated_leases"] >= 1, io
        failed = [r for r in state.list_tasks(limit=2000)
                  if r["state"] == "FAILED"]
        assert not failed, failed
        types = [e["type"] for e in state.list_cluster_events()]
        assert "node_drained" in types, types
        pipe.shutdown()
    finally:
        for h in handles:
            try:
                h.terminate()
            except Exception:  # noqa: BLE001
                pass
        cluster.shutdown()
