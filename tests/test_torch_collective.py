"""The port's host-plane collectives (ray_tpu_torch.collective): the cases of
tests/test_collective.py, one for one, on ray_tpu_torch's runtime, with
torch tensors where the reference passes jax arrays.

- TestCollective and the two virtual-cluster legs are here; TestRing-
  Collectives is in tests/test_torch_collective_ring.py, and the bit-for-bit
  parity with the reference's fold in tests/test_torch_collective_parity.py.
- TestJaxGang (two processes in one jax.distributed psum) becomes
  TestTorchGang: two actors in one gloo ``torch.distributed`` group run an
  ``all_reduce``.
- TestTpuChipAssignment's counterparts are
  tests/test_torch_runtime_gpu_leases.py::TestGpuLeases::
  test_gpus_assigned_and_released and ::test_actor_gpu_assignment.
"""

import numpy as np
import pytest

import ray_tpu_torch
from torch_collective_members import Member, oracle, cleanup, mk_group
from torch_port_util import deadline, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def rt():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


class TestCollective:
    @deadline(120)
    def test_allreduce_broadcast_allgather_barrier(self, rt):
        world = 3
        members = mk_group(world, "g1")
        try:
            outs = ray_tpu_torch.get(
                [m.do_allreduce.remote("g1") for m in members],
                timeout=120)
            expected = np.full(4, 1.0 + 2.0 + 3.0)
            for out in outs:
                np.testing.assert_allclose(out, expected)

            outs = ray_tpu_torch.get(
                [m.do_broadcast.remote("g1") for m in members],
                timeout=120)
            for out in outs:
                np.testing.assert_allclose(out, np.zeros(3))  # src 0

            outs = ray_tpu_torch.get(
                [m.do_allgather.remote("g1") for m in members],
                timeout=120)
            for out in outs:
                assert [int(x[0]) for x in out] == [0, 1, 2]

            assert all(ray_tpu_torch.get(
                [m.do_barrier.remote("g1") for m in members],
                timeout=120))
        finally:
            # leaked members starve later tests of worker slots (the
            # shared runtime caps workers per node)
            cleanup(members, "g1")

    @deadline(180)
    def test_object_plane_collectives(self, rt):
        """Sized payloads ride the object plane (reduce-scatter +
        allgather by slices; coordinator sees refs only) and must agree
        numerically with the inline path."""
        world = 3
        n = 200_000  # 800 KB float32: above OBJECT_TRANSPORT_THRESHOLD
        members = mk_group(world, "gbig")
        try:
            for transport in ("object", "inline"):
                outs = ray_tpu_torch.get(
                    [m.do_big_allreduce.remote("gbig", n, transport)
                     for m in members], timeout=180)
                for first, last, shape in outs:
                    assert first == last == 6.0  # 1+2+3
                    assert shape == (n,)

            outs = ray_tpu_torch.get(
                [m.do_big_broadcast.remote("gbig", n) for m in members],
                timeout=180)
            for second, last in outs:
                assert second == 1.0 and last == float(n - 1)

            outs = ray_tpu_torch.get(
                [m.do_big_allgather.remote("gbig", n) for m in members],
                timeout=180)
            for firsts in outs:
                assert firsts == [0.0, 1.0, 2.0]
        finally:
            cleanup(members, "gbig")

    @deadline(120)
    def test_mixed_transport_ranks_interoperate(self, rt):
        """Ranks choosing DIFFERENT transports must still rendezvous:
        the round structure is transport-independent and payloads
        self-describe (inline value vs nested ref)."""
        members = mk_group(2, "gmix")
        try:
            outs = ray_tpu_torch.get(
                [members[0].do_big_allreduce.remote("gmix", 1000,
                                                    "inline"),
                 members[1].do_big_allreduce.remote("gmix", 1000,
                                                    "object")],
                timeout=120)
            for first, last, shape in outs:
                assert first == last == 3.0 and shape == (1000,)
        finally:
            cleanup(members, "gmix")

    def test_invalid_transport_rejected(self, rt):
        from ray_tpu_torch import collective

        collective.init_collective_group(1, 0, group_name="gsolo")
        try:
            with pytest.raises(ValueError, match="transport"):
                collective.allreduce(np.ones(4), group_name="gsolo",
                                     transport="Object")
            with pytest.raises(ValueError, match="backend"):
                collective.init_collective_group(1, 0, backend="jax",
                                                 group_name="gjax")
        finally:
            collective.destroy_collective_group("gsolo")

    @deadline(120)
    def test_two_member_sum(self, rt):
        members = mk_group(2, "g2")
        try:
            outs = ray_tpu_torch.get([
                members[0].do_allreduce.remote("g2"),
                members[1].do_allreduce.remote("g2")], timeout=120)
            np.testing.assert_allclose(outs[0], np.full(4, 3.0))
        finally:
            cleanup(members, "g2")


class TestTorchGang:
    @deadline(120)
    def test_two_process_gloo_all_reduce(self, rt):
        """Two REAL worker processes rendezvous in one gloo
        torch.distributed group (tcp:// at a free local port) and
        all-reduce: the sum is the world size (the reference's
        two-process jax.distributed psum)."""
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        address = f"tcp://127.0.0.1:{port}"
        members = [ray_tpu_torch.remote(Member).options(
            num_cpus=0).remote(r, 2) for r in range(2)]
        try:
            outs = ray_tpu_torch.get(
                [m.gloo_all_reduce.remote(address, 2, r)
                 for r, m in enumerate(members)], timeout=90)
            assert [o["rank"] for o in outs] == [0, 1]
            for o in outs:
                assert o["world"] == 2 and o["sum"] == [2.0] * 4
        finally:
            cleanup(members, "none")


# ================================== r18 virtual-cluster legs (own
# clusters: they must not share the module fixture's runtime)


@deadline(120)
def test_rank_node_death_mid_ring_is_clean():
    """Chaos: a rank's NODE dying mid-collective surfaces a clean
    CollectiveError on the surviving ranks within the op timeout (no
    hang past the get bound), and a fresh group on the survivors still
    works — the dead round never wedges the coordinator."""
    import time

    from ray_tpu_torch import collective
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.api import NodeAffinitySchedulingStrategy

    ray_tpu_torch.shutdown()
    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2, "num_gpus": 0})
    try:
        n1 = cluster.add_node(num_cpus=2)
        n2 = cluster.add_node(num_cpus=2)
        g = "chaos_ring"
        strategies = [
            NodeAffinitySchedulingStrategy(0, soft=False),
            NodeAffinitySchedulingStrategy(n1, soft=False),
            NodeAffinitySchedulingStrategy(n2, soft=False),
        ]
        members = mk_group(3, g, num_cpus=1, strategies=strategies)
        # ranks 0/1 enter the ring immediately; rank 2 (on the doomed
        # node) stalls first, so the group is mid-collective when the
        # node dies and rank 2 never arrives
        refs = [members[0].do_slow_ar.remote(g, 4096, 0.0, 6.0),
                members[1].do_slow_ar.remote(g, 4096, 0.0, 6.0),
                members[2].do_slow_ar.remote(g, 4096, 3.0, 6.0)]
        time.sleep(0.8)
        t0 = time.monotonic()
        cluster.remove_node(n2)
        for ref in refs[:2]:
            with pytest.raises(Exception,
                               match="Collective|collective|died"):
                ray_tpu_torch.get(ref, timeout=45)
        elapsed = time.monotonic() - t0
        assert elapsed < 40, f"group wedged for {elapsed:.1f}s"
        # the surviving pair forms a fresh group and reduces cleanly
        g2 = "chaos_ring2"
        collective.create_collective_group(
            members[:2], 2, [0, 1], group_name=g2)
        outs = ray_tpu_torch.get([m.do_ar.remote(g2, 2048, "ring")
                                  for m in members[:2]], timeout=60)
        ref = np.asarray(oracle(2, 2048, "float32"), np.float64)
        for out in outs:
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        cleanup(members[:2], g2)
        cleanup(members, g)
    finally:
        cluster.shutdown()


@deadline(120)
def test_psum_numerics_via_ring_collective():
    """The psum numerics — every process contributes ones, the
    gang-reduce must equal the process count — driven through the ring
    on virtual nodes, with torch tensors in and out."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.api import NodeAffinitySchedulingStrategy

    ray_tpu_torch.shutdown()
    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2, "num_gpus": 0})
    try:
        n1 = cluster.add_node(num_cpus=2)
        g = "psum_ring"
        strategies = [NodeAffinitySchedulingStrategy(0, soft=False),
                      NodeAffinitySchedulingStrategy(n1, soft=False)]
        members = mk_group(2, g, num_cpus=1, strategies=strategies)
        try:
            outs = ray_tpu_torch.get([m.do_torch_ar.remote(g, 8192)
                                      for m in members], timeout=120)
            for first, last, dtype in outs:
                assert first == last == 2.0  # psum of ones over world
                assert dtype == "torch.float32"
        finally:
            cleanup(members, g)
    finally:
        cluster.shutdown()
