"""The port's ring attention (``ray_tpu_torch.parallel.ring``) against the JAX
package's ``ring_attention`` and ``reference_attention`` on the CPU.

One gloo world of 8 ranks runs every case once (``tests/
torch_parallel_ranks.ring_rank``): each rank holds its batch rows and
sequence chunk of the same seeded fp32 q, k, v and output cotangent, runs
``ring_attention`` forward and backward (the plain versions of B1, B2 and
B3 per block, K/V by ``batch_isend_irecv``), and the same ring for all
its chunks in one process (``ring_forward_virtual``) on the same rows.
Before it, this process computes the JAX ring on its virtual 8-device mesh
(sequence=4, and sequence=2 x fsdp=2) with ``jax.grad``. The port's
meshes add a data axis so that they span all 8 ranks; the split of the
sequence is the same. Tolerance: fp32, 2e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.parallel import make_mesh as jax_make_mesh
from ray_tpu.parallel import reference_attention as jax_reference
from ray_tpu.parallel import ring_attention as jax_ring
from ray_tpu_torch.parallel import ring as R
from ray_tpu_torch.parallel.world import run_world
from torch_parallel_ranks import one_world_at_a_time, qkv, ring_rank
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

SHAPE, SEED, TOL = (8, 32, 4, 16), 0, 2e-4
# name -> (the port's mesh over 8 ranks, causal, the JAX mesh's axes)
CASES = {
    "causal_seq4": (dict(sequence=4, data=2), True, dict(sequence=4)),
    "causal_seq2_fsdp2": (dict(sequence=2, fsdp=2, data=2), True,
                          dict(sequence=2, fsdp=2)),
    "noncausal_seq4": (dict(sequence=4, data=2), False, dict(sequence=4)),
    "noncausal_seq2_fsdp2": (dict(sequence=2, fsdp=2, data=2), False,
                             dict(sequence=2, fsdp=2)),
    "single_chunk": (dict(fsdp=8), True, None),
}
RING = [n for n, c in CASES.items() if c[2] is not None]


def _assemble(results, name, key):
    """The ranks' shards of one output -> the global [B, T, H, D] array."""
    out = np.zeros(SHAPE, np.float32)
    for r in results:
        b, nb, s, ns = r[name]["coords"]
        rows, t = SHAPE[0] // nb, SHAPE[1] // ns
        out[b * rows:(b + 1) * rows, s * t:(s + 1) * t] = r[name][key]
    return out


def _jax_refs():
    """Each case's JAX output and vjp of sum(O * g), one jit per case."""
    q, k, v, g = (jnp.asarray(x) for x in qkv(SHAPE, SEED))
    refs = {}
    for name, (_, causal, jaxes) in CASES.items():
        if jaxes is None:
            fn = functools.partial(jax_reference, causal=causal)
        else:
            fn = functools.partial(jax_ring, mesh=jax_make_mesh(
                **{"fsdp": 1, **jaxes}), causal=causal)

        def run(q, k, v, g, fn=fn):
            out, vjp = jax.vjp(fn, q, k, v)
            return out, vjp(g), jax_reference(q, k, v, causal=causal)

        out, grads, ref = jax.jit(run)(q, k, v, g)
        refs[name] = {"o": np.asarray(out), "reference_o": np.asarray(ref),
                      **dict(zip(("dq", "dk", "dv"),
                                 (np.asarray(x) for x in grads)))}
    return refs


@pytest.fixture(scope="module")
def runs():
    """(the 8 ranks' results, the JAX references). The JAX side runs
    first, then the world, one test module's world at a time on the host
    (``one_world_at_a_time``)."""
    cases = [(n, sizes, causal) for n, (sizes, causal, _) in CASES.items()]
    refs = _jax_refs()
    with one_world_at_a_time():
        return run_world(ring_rank, 8, (cases, SHAPE, SEED), device="cpu",
                         timeout=240), refs


@pytest.mark.parametrize("name", RING)
def test_ring_forward_matches_jax_ring(runs, name):
    results, refs = runs
    got = _assemble(results, name, "o")
    assert np.abs(got - refs[name]["o"]).max() <= TOL


@pytest.mark.parametrize("name", RING)
def test_ring_forward_matches_reference_attention(runs, name):
    results, refs = runs
    got = _assemble(results, name, "o")
    assert np.abs(got - refs[name]["reference_o"]).max() <= TOL


@pytest.mark.parametrize("name", RING)
def test_ring_grads_match_jax_grad(runs, name):
    """dQ/dK/dV of sum(O * g) against jax.grad through the JAX ring's
    fori_loop/ppermute body (tests/test_parallel.py's grad test)."""
    results, refs = runs
    for key in ("dq", "dk", "dv"):
        got = _assemble(results, name, key)
        assert np.abs(got - refs[name][key]).max() <= TOL, key


def test_ring_single_chunk_is_plain_attention(runs):
    """sequence=1 (fsdp=8): one causal flash call and no communication; the
    output and grads against JAX's reference_attention and its vjp."""
    results, refs = runs
    for key in ("o", "dq", "dk", "dv"):
        got = _assemble(results, "single_chunk", key)
        assert np.abs(got - refs["single_chunk"][key]).max() <= TOL, key


@pytest.mark.parametrize("name", RING)
def test_virtual_ring_equals_gloo_run(runs, name):
    """ring_forward_virtual/ring_backward_virtual (P ranks in one process,
    as chip_smoke.py drives the ring on one card) give the gloo ring's
    output and gradients bit for bit: the same blocks, merged and
    accumulated in the same order."""
    results, _ = runs
    for r in results:
        for key in ("o", "dq", "dk", "dv"):
            np.testing.assert_array_equal(r[name]["virtual"][key],
                                          r[name][key])


@pytest.mark.parametrize("causal", [True, False])
def test_virtual_ring_matches_whole_sequence(causal):
    """In one process: the ring's blocks and LSE merge over 4 chunks give
    the plain B1's O and LSE over the whole sequence, and the per-block
    B2/B3 against the merged O and LSE give the whole-sequence dQ/dK/dV."""
    fa = R._fa
    rng = np.random.RandomState(3)
    bh, t, d, p = 6, 48, 16, 4
    q, k, v, do = (torch.from_numpy(rng.randn(bh, t, d).astype(np.float32))
                   for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd_reference(q, k, v, scale=scale,
                                              causal=causal)
    grads = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             scale=scale, causal=causal)
    chunks = [list(x.chunk(p, dim=1)) for x in (q, k, v, do)]
    chunks = [[c.contiguous() for c in x] for x in chunks]
    os_, lses = R.ring_forward_virtual(*chunks[:3], scale=scale,
                                       causal=causal)
    torch.testing.assert_close(torch.cat(os_, 1), o, rtol=0, atol=TOL)
    torch.testing.assert_close(torch.cat(lses, 2), lse, rtol=0, atol=TOL)
    got = R.ring_backward_virtual(*chunks[:3], os_, lses, chunks[3],
                                  scale=scale, causal=causal)
    for g, want in zip(got, grads):
        torch.testing.assert_close(torch.cat(g, 1), want, rtol=0, atol=TOL)


def test_merge_is_the_softmax_of_the_union():
    """merge() of two key sets' (O, LSE) is attention over their union;
    without the e^(lse_a - lse) rescale it is not."""
    fa = R._fa
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(2, 8, 16).astype(np.float32))
               for _ in range(3))
    o, lse = fa.flash_attention_fwd_reference(q, k, v, scale=0.25,
                                              causal=False)
    a = fa.flash_attention_fwd_reference(q, k[:, :3], v[:, :3], scale=0.25,
                                         causal=False)
    b = fa.flash_attention_fwd_reference(q, k[:, 3:], v[:, 3:], scale=0.25,
                                         causal=False)
    got_o, got_lse = R.merge(a[0], a[1], b[0], b[1])
    torch.testing.assert_close(got_o, o, rtol=0, atol=1e-5)
    torch.testing.assert_close(got_lse, lse, rtol=0, atol=1e-5)
    assert (a[0] + b[0] - o).abs().max() > 0.1
    assert R.block_kind(1, 1, True) is True
    assert R.block_kind(0, 2, True) is False
    assert R.block_kind(3, 2, True) is None
    assert R.block_kind(3, 2, False) is False
