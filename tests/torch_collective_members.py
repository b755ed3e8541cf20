"""Members and inputs of the port's collective tests
(tests/test_torch_collective*.py): the actor class and the seeded inputs,
in a module without JAX, so the workers that unpickle the members load
only torch."""

import contextlib

import numpy as np
import torch

import ray_tpu_torch


class Member:
    """Actor used by collective tests (init_collective in the actor)."""

    def __init__(self, rank: int, world: int):
        self.rank = rank
        self.world = world

    def init_collective(self, world_size, rank, group_name):
        from ray_tpu_torch import collective

        collective.init_collective_group(world_size, rank,
                                         group_name=group_name)
        return True

    def do_allreduce(self, group_name):
        from ray_tpu_torch import collective

        return collective.allreduce(
            np.full(4, self.rank + 1.0), group_name=group_name)

    def do_broadcast(self, group_name):
        from ray_tpu_torch import collective

        val = np.full(3, float(self.rank))
        return collective.broadcast(val, src_rank=0, group_name=group_name)

    def do_allgather(self, group_name):
        from ray_tpu_torch import collective

        return collective.allgather(np.asarray([self.rank]),
                                    group_name=group_name)

    def do_barrier(self, group_name):
        from ray_tpu_torch import collective

        collective.barrier(group_name=group_name)
        return True

    def do_big_allreduce(self, group_name, n, transport):
        from ray_tpu_torch import collective

        out = collective.allreduce(
            np.full(n, self.rank + 1.0, np.float32),
            group_name=group_name, transport=transport)
        return float(out[0]), float(out[-1]), out.shape

    def do_big_broadcast(self, group_name, n):
        from ray_tpu_torch import collective

        val = (np.arange(n, dtype=np.float32) if self.rank == 0
               else np.zeros(n, np.float32))
        out = collective.broadcast(val, src_rank=0,
                                   group_name=group_name,
                                   transport="object")
        return float(out[1]), float(out[-1])

    def do_big_allgather(self, group_name, n):
        from ray_tpu_torch import collective

        outs = collective.allgather(
            np.full(n, float(self.rank), np.float32),
            group_name=group_name, transport="object")
        return [float(o[0]) for o in outs]

    # ------------------------------------------ r18 ring/tree members

    def do_ar(self, group_name, n, transport, dtype="float32",
              op="sum", noncontig=False, chunk_bytes=None,
              timeout=60.0):
        """Seeded deterministic input per rank; returns the allreduce
        result as float64 (small n — rides the reply inline)."""
        from ray_tpu_torch import collective

        x = rank_input(self.rank, n, dtype, noncontig)
        out = collective.allreduce(x, group_name=group_name, op=op,
                                   transport=transport,
                                   timeout=timeout,
                                   chunk_bytes=chunk_bytes)
        return _f64(out)

    def do_ar_inplace_noncontig(self, group_name, n, transport):
        """In-place contract on a writable NON-contiguous view."""
        from ray_tpu_torch import collective

        base = np.zeros(2 * n, np.float32)
        view = base[::2]
        view[:] = rank_input(self.rank, n, "float32", False)
        collective.allreduce(view, group_name=group_name,
                             transport=transport, timeout=60)
        return np.asarray(view, np.float64)

    def do_rs(self, group_name, n, transport):
        from ray_tpu_torch import collective

        x = rank_input(self.rank, n, "float32", False)
        out = collective.reduce_scatter(x, group_name=group_name,
                                        transport=transport,
                                        timeout=60)
        return np.asarray(out, np.float64)

    def do_ag(self, group_name, n, transport):
        from ray_tpu_torch import collective

        x = np.full(n, float(self.rank), np.float32)
        outs = collective.allgather(x, group_name=group_name,
                                    transport=transport, timeout=60)
        return [float(o[0]) for o in outs]

    def do_slow_ar(self, group_name, n, delay_s, timeout):
        import time

        from ray_tpu_torch import collective

        time.sleep(delay_s)
        out = collective.allreduce(
            np.full(n, self.rank + 1.0, np.float32),
            group_name=group_name, transport="ring", timeout=timeout)
        return float(out[0])

    def do_torch_ar(self, group_name, n):
        """psum semantics through the ring: each process contributes a
        torch tensor of ones; the reduce must equal the world size, as a
        tensor of the same dtype."""
        from ray_tpu_torch import collective

        out = collective.allreduce(torch.ones(n, dtype=torch.float32),
                                   group_name=group_name,
                                   transport="ring", timeout=60)
        return float(out[0]), float(out[-1]), str(out.dtype)

    def do_fold(self, group_name, n, transport, cases):
        """Every (dtype, op) of ``cases`` on this rank's seeded input,
        through ``transport``: torch tensors in (bf16 and fp32 requiring
        grad), each result's bits and type out."""
        from ray_tpu_torch import collective

        out = []
        for dtype, op in cases:
            x = fold_input(self.rank, n, dtype)
            y = collective.allreduce(x, group_name=group_name, op=op,
                                     transport=transport, timeout=60)
            out.append({"type": type(y).__name__, "dtype": str(y.dtype),
                        "requires_grad": bool(y.requires_grad),
                        "bits": tensor_bits(y)})
        return out

    def gloo_all_reduce(self, address, world, rank):
        """Join a gloo torch.distributed group and all-reduce ones."""
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=address,
                                world_size=world, rank=rank)
        try:
            t = torch.ones(4)
            dist.all_reduce(t)
            return {"world": dist.get_world_size(),
                    "rank": dist.get_rank(), "sum": t.tolist()}
        finally:
            dist.destroy_process_group()


def _f64(out):
    if isinstance(out, torch.Tensor):
        return out.detach().float().numpy().astype(np.float64)
    return np.asarray(out, np.float64)


def rank_input(rank, n, dtype, noncontig):
    """Deterministic per-rank tensor shared by members and the oracle:
    bf16 as a torch tensor (numpy has no bf16 without ml_dtypes)."""
    rng = np.random.default_rng(1000 + rank)
    x = (rng.standard_normal(2 * n if noncontig else n)
         .astype(np.float32))
    if noncontig:
        x = x[::2]
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)
    return x.astype(dtype)


def fold_input(rank, n, dtype):
    """The parity cases' per-rank tensors: fp32 requiring grad, bf16, and
    small int32 (products stay in range)."""
    rng = np.random.default_rng(2000 + rank)
    if dtype == "int32":
        return torch.from_numpy(rng.integers(-3, 4, n).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    if dtype == "bfloat16":
        return x.to(torch.bfloat16)
    return x.requires_grad_(True)


def tensor_bits(t):
    """A tensor's elements as unsigned ints of their size (exact)."""
    t = t.detach().contiguous()
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()]).numpy().tolist()


def oracle(world, n, dtype, op="sum", noncontig=False):
    """numpy reference in the SAME dtype, rank order (bf16 folded as
    torch's bf16)."""
    import functools

    parts = [rank_input(r, n, dtype, noncontig) for r in range(world)]
    if dtype == "bfloat16":
        fn = {"sum": torch.add, "max": torch.maximum}[op]
        return functools.reduce(fn, parts).float().numpy()
    ufunc = {"sum": np.add, "max": np.maximum}[op]
    return functools.reduce(ufunc, [np.ascontiguousarray(p)
                                    for p in parts])


def mk_group(world, group_name, num_cpus=0, strategies=None):
    """Spawn world members + gang-init their collective group."""
    from ray_tpu_torch import collective

    cls = ray_tpu_torch.remote(Member)
    members = []
    for r in range(world):
        opts = {"num_cpus": num_cpus}
        if strategies is not None:
            opts["scheduling_strategy"] = strategies[r]
        members.append(cls.options(**opts).remote(r, world))
    collective.create_collective_group(
        members, world, list(range(world)), group_name=group_name)
    return members


def cleanup(members, group_name):
    from ray_tpu_torch import collective

    for m in members:
        with contextlib.suppress(Exception):
            ray_tpu_torch.kill(m)
    with contextlib.suppress(Exception):
        collective.destroy_collective_group(group_name)
