"""The port's object-plane transports (ray_tpu_torch.collective): the cases
of tests/test_collective.py::TestRingCollectives, one for one — chunked ring
and halving-doubling tree against a rank-order oracle across dtypes (bf16 as
torch tensors), rank counts and transports, plus the group-failure
contract."""

import numpy as np
import pytest

import ray_tpu_torch
from torch_collective_members import cleanup, mk_group, oracle
from torch_port_util import deadline, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def rt():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


class TestRingCollectives:
    @deadline(180)
    def test_ring_matrix_dtypes_and_ops(self, rt):
        """Worlds 2 and 3, ring transport: f32, bf16 and non-contiguous
        inputs must match the rank-order oracle (bf16 within
        reassociation tolerance — the ring folds in ring order)."""
        n = 4096
        for world in (2, 3):
            g = f"ring_m{world}"
            members = mk_group(world, g)
            try:
                for dtype, rtol, atol in (("float32", 1e-5, 1e-5),
                                          ("bfloat16", 5e-2, 5e-2)):
                    outs = ray_tpu_torch.get(
                        [m.do_ar.remote(g, n, "ring", dtype=dtype)
                         for m in members], timeout=120)
                    ref = np.asarray(oracle(world, n, dtype), np.float64)
                    for out in outs:
                        np.testing.assert_allclose(out, ref, rtol=rtol,
                                                   atol=atol)
                # max op rides the same ring
                outs = ray_tpu_torch.get(
                    [m.do_ar.remote(g, n, "ring", op="max")
                     for m in members], timeout=120)
                ref = np.asarray(oracle(world, n, "float32", op="max"),
                                 np.float64)
                for out in outs:
                    np.testing.assert_allclose(out, ref, rtol=1e-6)
                # non-contiguous INPUT LAYOUT (strided view), in-place
                # contract: same values as the f32 leg, so the same
                # oracle — only the memory layout differs
                outs = ray_tpu_torch.get(
                    [m.do_ar_inplace_noncontig.remote(g, n, "ring")
                     for m in members], timeout=120)
                ref = np.asarray(oracle(world, n, "float32"), np.float64)
                for out in outs:
                    np.testing.assert_allclose(out, ref, rtol=1e-5,
                                               atol=1e-5)
            finally:
                cleanup(members, g)

    @deadline(240)
    def test_ring_chunked_worlds_4_8_and_tree(self, rt):
        """Larger worlds: ring with a small chunk_bytes (multiple
        chunks per slice — the warmed streaming path) at 4 and 8 ranks,
        and the halving-doubling tree on the power-of-two worlds."""
        n = 50_000  # ~200 KB f32: 4 chunks per slice at 16 KiB chunks
        for world in (4, 8):
            g = f"ring_w{world}"
            members = mk_group(world, g)
            try:
                outs = ray_tpu_torch.get(
                    [m.do_ar.remote(g, n, "ring", chunk_bytes=16384)
                     for m in members], timeout=180)
                ref = np.asarray(oracle(world, n, "float32"), np.float64)
                for out in outs:
                    np.testing.assert_allclose(out, ref, rtol=1e-5,
                                               atol=1e-5)
                outs = ray_tpu_torch.get(
                    [m.do_ar.remote(g, n, "tree") for m in members],
                    timeout=180)
                for out in outs:
                    np.testing.assert_allclose(out, ref, rtol=1e-5,
                                               atol=1e-5)
            finally:
                cleanup(members, g)

    @deadline(90)
    def test_tree_rejects_non_power_of_two(self, rt):
        members = mk_group(3, "tree_np2")
        try:
            with pytest.raises(Exception, match="power-of-two"):
                ray_tpu_torch.get([m.do_ar.remote("tree_np2", 64, "tree")
                                   for m in members], timeout=60)
        finally:
            cleanup(members, "tree_np2")

    @deadline(150)
    def test_reduce_scatter_and_allgather_ring(self, rt):
        """reduce_scatter returns rank r's slice of the reduce
        (np.array_split convention); ring allgather returns every
        rank's tensor, in rank order — both store-to-store."""
        world, n = 3, 30_000
        g = "ring_rs"
        members = mk_group(world, g)
        try:
            outs = ray_tpu_torch.get([m.do_rs.remote(g, n, "ring")
                                      for m in members], timeout=120)
            ref = np.asarray(oracle(world, n, "float32"), np.float64)
            exp = np.array_split(ref, world)
            for r, out in enumerate(outs):
                np.testing.assert_allclose(out, exp[r], rtol=1e-5,
                                           atol=1e-5)
            # rendezvous escape hatch computes the same slices
            outs = ray_tpu_torch.get([m.do_rs.remote(g, n, "rendezvous")
                                      for m in members], timeout=120)
            for r, out in enumerate(outs):
                np.testing.assert_allclose(out, exp[r], rtol=1e-5,
                                           atol=1e-5)
            ag = ray_tpu_torch.get([m.do_ag.remote(g, 20_000, "ring")
                                    for m in members], timeout=120)
            for firsts in ag:
                assert firsts == [0.0, 1.0, 2.0]
        finally:
            cleanup(members, g)

    @deadline(150)
    def test_rendezvous_transport_full_matrix(self, rt):
        """The escape hatch stays green across the kinds: explicit
        transport="rendezvous" (inline under the threshold, slice
        exchange above) agrees with the oracle for allreduce, and the
        gather/broadcast/barrier kinds keep working through the same
        group."""
        world = 3
        g = "rdv_m"
        members = mk_group(world, g)
        try:
            for n in (512, 200_000):  # inline and slice-exchange legs
                outs = ray_tpu_torch.get(
                    [m.do_ar.remote(g, n, "rendezvous")
                     for m in members], timeout=120)
                ref = np.asarray(oracle(world, n, "float32"), np.float64)
                for out in outs:
                    np.testing.assert_allclose(out, ref, rtol=1e-5,
                                               atol=1e-5)
            outs = ray_tpu_torch.get([m.do_ag.remote(g, 256, "rendezvous")
                                      for m in members], timeout=120)
            for firsts in outs:
                assert firsts == [0.0, 1.0, 2.0]
            outs = ray_tpu_torch.get([m.do_broadcast.remote(g)
                                      for m in members], timeout=120)
            for out in outs:
                np.testing.assert_allclose(out, np.zeros(3))
            assert all(ray_tpu_torch.get([m.do_barrier.remote(g)
                                          for m in members], timeout=120))
        finally:
            cleanup(members, g)

    def test_rendezvous_incremental_reduce(self):
        """The coordinator folds reduce contributions as they LAND —
        after two of three ranks arrived the round holds one
        accumulator, not a per-rank parts map (O(1) payloads)."""
        import threading
        import time

        from ray_tpu_torch import collective

        rv = collective.Rendezvous(3)
        results = {}

        def contrib(rank):
            results[rank] = rv.contribute(
                "allreduce", 1, rank, np.full(4, rank + 1.0),
                op="sum", timeout=10)

        threads = [threading.Thread(target=contrib, args=(r,))
                   for r in (0, 1)]
        for t in threads:
            t.start()
        deadline_t = time.monotonic() + 5
        state = None
        while time.monotonic() < deadline_t:
            state = rv._rounds.get(("allreduce", 1))
            if state is not None and state["arrived"] == 2:
                break
            time.sleep(0.01)
        assert state is not None and state["arrived"] == 2
        assert state["parts"] == {}, "reduce kinds must not hold parts"
        assert state["acc"] is not None
        np.testing.assert_allclose(state["acc"], np.full(4, 3.0))
        contrib(2)
        for t in threads:
            t.join(timeout=5)
        for r in range(3):
            np.testing.assert_allclose(results[r], np.full(4, 6.0))
        assert rv._rounds == {}  # fully claimed -> dropped

    def test_rendezvous_timeout_drops_round(self):
        """A timed-out round is removed so the surviving group's next
        operation doesn't rendezvous with stale arrivals."""
        import threading

        from ray_tpu_torch import collective

        rv = collective.Rendezvous(2)
        with pytest.raises(TimeoutError):
            rv.contribute("allreduce", 1, 0, np.ones(2), timeout=0.2)
        assert rv._rounds == {}
        # the same seq can rendezvous cleanly afterwards
        out = {}

        def late():
            out["r"] = rv.contribute("allreduce", 1, 1, np.ones(2),
                                     timeout=5)

        t = threading.Thread(target=late)
        t.start()
        mine = rv.contribute("allreduce", 1, 0, np.ones(2), timeout=5)
        t.join(timeout=5)
        np.testing.assert_allclose(mine, np.full(2, 2.0))
        np.testing.assert_allclose(out["r"], np.full(2, 2.0))

    @deadline(90)
    def test_algorithm_desync_raises_clean(self, rt):
        """Ranks forcing DIFFERENT algorithms (ring vs inline) must
        fail with a clean CollectiveError on both sides — the tagged
        rounds detect the mismatch instead of wedging the group."""
        g = "desync"
        members = mk_group(2, g)
        try:
            refs = [members[0].do_ar.remote(g, 1000, "ring"),
                    members[1].do_ar.remote(g, 1000, "inline")]
            errs = 0
            for ref in refs:
                with pytest.raises(Exception, match="desync|slice"):
                    ray_tpu_torch.get(ref, timeout=60)
                errs += 1
            assert errs == 2
        finally:
            cleanup(members, g)
