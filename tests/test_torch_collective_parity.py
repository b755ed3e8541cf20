"""The port's collective folds against the reference's, bit for bit: sum,
prod, max and min on fp32 (requiring grad), int32 and bf16 torch tensors
over worlds of 2, 3 and 4 with the ring and the tree, each result held
against the reference's fold (``ray_tpu.collective.collective._UFUNCS``:
numpy ufuncs, and ``ml_dtypes``' for bf16) applied in the transport's own
order. Tensors go in and come back as tensors of their dtype."""

import ml_dtypes
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.collective.collective import _UFUNCS
from torch_collective_members import cleanup, fold_input, mk_group
from torch_port_util import deadline, one_torch_thread  # noqa: F401

_N = 1001  # uneven ring slices
_CASES = [(d, op) for d in ("float32", "int32", "bfloat16")
          for op in ("sum", "prod", "max", "min")]


@pytest.fixture(scope="module")
def rt():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


def _reference_input(rank, dtype):
    """fold_input's values as the reference holds them: numpy arrays,
    bf16 as ml_dtypes.bfloat16."""
    x = fold_input(rank, _N, dtype).detach()
    if dtype == "bfloat16":
        return x.float().numpy().astype(ml_dtypes.bfloat16)
    return x.numpy()


def _ring_fold(xs, ufunc):
    """The chunked ring's order: slice j starts as rank j+1's part, and
    each next rank q folds its own part into the partial it pulled,
    ufunc(own, partial), ending at rank j."""
    W = len(xs)
    out = np.empty_like(xs[0])
    bounds = np.cumsum([0] + [len(p) for p in np.array_split(xs[0], W)])
    for j in range(W):
        sl = slice(bounds[j], bounds[j + 1])
        acc = xs[(j + 1) % W][sl]
        for step in range(2, W + 1):
            acc = ufunc(xs[(j + step) % W][sl], acc)
        out[sl] = acc
    return out


def _tree_fold(xs, ufunc):
    """Halving-doubling: at hop t every rank folds its partner r ^ 2^t's
    accumulator into its own, ufunc(own, partner)."""
    accs = list(xs)
    t = 1
    while t < len(xs):
        accs = [ufunc(accs[r], accs[r ^ t]) for r in range(len(xs))]
        t <<= 1
    return accs[0]


def _bits(a):
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize]).tolist()


@deadline(150)
@pytest.mark.parametrize("world,transport", [
    (2, "ring"), (3, "ring"), (4, "ring"), (2, "tree"), (4, "tree")])
def test_fold_bitwise_equals_reference(rt, world, transport):
    g = f"parity_{transport}{world}"
    members = mk_group(world, g)
    try:
        outs = ray_tpu_torch.get(
            [m.do_fold.remote(g, _N, transport, _CASES) for m in members],
            timeout=120)
    finally:
        cleanup(members, g)
    fold = _ring_fold if transport == "ring" else _tree_fold
    for i, (dtype, op) in enumerate(_CASES):
        want = fold([_reference_input(r, dtype) for r in range(world)],
                    _UFUNCS[op])
        for rank, out in enumerate(outs):
            got = out[i]
            assert (got["type"], got["dtype"], got["requires_grad"]) == \
                ("Tensor", f"torch.{dtype}", False), (dtype, op, got)
            assert got["bits"] == _bits(np.asarray(want)), \
                (transport, world, dtype, op, rank)


def test_bf16_fold_is_not_an_integer_sum():
    """The bf16 fold adds values, not the bits of a uint16 view: 1 + 1
    is 2 (bits 0x4000), where summing 0x3F80 twice would give 0x7F00."""
    from ray_tpu_torch.collective.collective import _bf16_fold

    one = torch.ones(3, dtype=torch.bfloat16).view(torch.int16).numpy() \
        .view(np.uint16)
    two = _bf16_fold("sum", one, one)
    assert two.tolist() == [0x4000] * 3
    out = one.copy()
    _bf16_fold("sum", out, one, out=out)
    assert out.tolist() == [0x4000] * 3
