"""The port's KV-cache generation against ``ray_tpu.models.generate`` on the
CPU: prefill and decode logits within fp32 tolerance, generated tokens
exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import config as jcfg
from ray_tpu.models import generate as JG
from ray_tpu.models.transformer import init_params as jax_init_params
from ray_tpu_torch.interop import params_from_numpy
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import generate as TG
from ray_tpu_torch.models.transformer import forward
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

_TOL = 2e-4  # fp32, as tests/test_ops.py


@pytest.fixture(scope="module")
def tiny():
    cj = jcfg.tiny_config()
    ct = tcfg.tiny_config()
    pj = jax_init_params(jax.random.key(0), cj)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), ct, device="cpu")
    return cj, ct, pj, pt


def _prompt(b, p, seed):
    return np.random.RandomState(seed).randint(0, 256, (b, p)).astype(
        np.int32)


def _jax_generate(pj, cj, prompt, n, **kw):
    return np.asarray(JG.generate(pj, jnp.asarray(prompt), cj,
                                  max_new_tokens=n, **kw))


def _port_generate(pt, ct, prompt, n, **kw):
    return TG.generate(pt, torch.from_numpy(prompt), ct, max_new_tokens=n,
                       **kw).numpy()


def test_prefill_and_decode_match_reference(tiny):
    cj, ct, pj, pt = tiny
    prompt = _prompt(2, 5, 1)
    lj, cache_j = JG.prefill(pj, jnp.asarray(prompt), cj, 16)
    lt, cache_t = TG.prefill(pt, torch.from_numpy(prompt), ct, 16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=_TOL,
                               atol=_TOL)
    assert cache_t["pos"] == int(cache_j["pos"]) == 5
    for name in ("k", "v"):
        assert tuple(cache_t[name].shape) == cache_j[name].shape
        np.testing.assert_allclose(cache_t[name].numpy(),
                                   np.asarray(cache_j[name]), rtol=_TOL,
                                   atol=_TOL)
    toks = _prompt(2, 3, 2)
    for i in range(3):
        dj, cache_j = JG.decode_step(pj, cache_j, jnp.asarray(toks[:, i]), cj)
        dt, cache_t = TG.decode_step(pt, cache_t, torch.from_numpy(toks[:, i]),
                                     ct)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=_TOL,
                                   atol=_TOL)
    assert cache_t["pos"] == int(cache_j["pos"]) == 8


def test_prefill_matches_forward(tiny):
    _, ct, _, pt = tiny
    prompt = torch.from_numpy(_prompt(2, 5, 1))
    lp, _ = TG.prefill(pt, prompt, ct, 16)
    torch.testing.assert_close(lp, forward(pt, prompt, ct), rtol=1e-4,
                               atol=1e-4)


def test_greedy_generate_matches_reference(tiny):
    cj, ct, pj, pt = tiny
    prompt = _prompt(2, 5, 1)
    want = _jax_generate(pj, cj, prompt, 6)
    got = _port_generate(pt, ct, prompt, 6)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


def test_left_padded_batch_matches_reference_and_solo_rows(tiny):
    cj, ct, pj, pt = tiny
    p1, p2 = _prompt(1, 3, 2), _prompt(1, 6, 3)
    N, P = 5, 6
    batch = np.zeros((2, P), np.int32)
    batch[0, P - 3:] = p1[0]
    batch[1] = p2[0]
    start = np.asarray([P - 3, 0], np.int32)
    want = _jax_generate(pj, cj, batch, N, start=jnp.asarray(start))
    got = _port_generate(pt, ct, batch, N, start=torch.from_numpy(start))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, P:],
                                  _port_generate(pt, ct, p1, N)[0, 3:])
    np.testing.assert_array_equal(got[1, P:],
                                  _port_generate(pt, ct, p2, N)[0, 6:])


def test_eos_freezes_sequence_like_reference(tiny):
    cj, ct, pj, pt = tiny
    prompt = _prompt(2, 5, 1)
    free = _port_generate(pt, ct, prompt, 6)[0, 5:]
    eos = int(free[1])  # row 0 hits eos at its second generated token
    want = _jax_generate(pj, cj, prompt, 6, eos_id=eos)
    got = _port_generate(pt, ct, prompt, 6, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 6:] == eos).all()


def test_undersized_cache_rejected(tiny):
    _, ct, _, pt = tiny
    prompt = torch.zeros((1, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_len"):
        TG.generate(pt, prompt, ct, max_new_tokens=8, max_len=10)
    with pytest.raises(ValueError, match="max_len"):
        TG.prefill(pt, prompt, ct, 4)


def test_encoder_config_rejected(tiny):
    _, ct, _, pt = tiny
    enc = dataclasses.replace(ct, causal=False)
    for n in (2, 0):
        with pytest.raises(ValueError, match="causal"):
            TG.generate(pt, torch.zeros((1, 4), dtype=torch.int32), enc,
                        max_new_tokens=n)


def test_sampled_generation_follows_the_generator(tiny):
    _, ct, _, pt = tiny
    prompt = _prompt(2, 4, 1)

    def run(seed):
        rng = torch.Generator().manual_seed(seed)
        return _port_generate(pt, ct, prompt, 6, greedy=False, rng=rng,
                              temperature=1.5)

    a, b, c = run(5), run(5), run(6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert ((a >= 0) & (a < ct.vocab_size)).all()
    np.testing.assert_array_equal(a[:, :4], prompt)


def test_zero_new_tokens_returns_prompt(tiny):
    _, ct, _, pt = tiny
    prompt = _prompt(1, 4, 1)
    np.testing.assert_array_equal(_port_generate(pt, ct, prompt, 0), prompt)
