"""The port's continuous-batching engine, case for case as
``tests/test_engine.py`` holds the JAX engine, with every request checked
token for token against the JAX package's one-shot ``generate()``."""

import threading

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import config as jcfg
from ray_tpu.models.generate import generate as jax_generate
from ray_tpu.models.transformer import init_params as jax_init_params
from ray_tpu_torch.interop import params_from_numpy
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models.engine import (InferenceEngine, init_slot_cache,
                                          prefill_slot)
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def model():
    cj = jcfg.tiny_config()
    pj = jax_init_params(jax.random.key(0), cj)
    ct = tcfg.tiny_config()
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), ct, device="cpu")
    return (cj, pj), ct, pt


_REF = {}


def _reference_tokens(model, prompt, max_new, eos_id=-1):
    """JAX one-shot generate() greedy output for a single prompt."""
    key = (tuple(prompt), max_new, eos_id)
    if key not in _REF:
        (cj, pj), _, _ = model
        out = jax_generate(pj, np.asarray([prompt], np.int32), cj,
                           max_new_tokens=max_new, greedy=True, eos_id=eos_id)
        toks = np.asarray(out)[0, len(prompt):].tolist()
        if eos_id in toks:
            toks = toks[:toks.index(eos_id) + 1]
        _REF[key] = toks
    return _REF[key]


def _engine(model, **kw):
    _, ct, pt = model
    return InferenceEngine(pt, ct, device="cpu", **kw)


def _drain(eng, reqs, steps):
    for _ in range(steps):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()


def test_single_request_matches_generate(model):
    eng = _engine(model, slots=2, max_prompt_len=16, max_new_tokens=8)
    prompt = [3, 1, 4, 1, 5]
    assert eng.generate(prompt) == _reference_tokens(model, prompt, 8)


def test_staggered_arrivals_decode_together(model):
    """Requests admitted mid-flight must not perturb running slots."""
    eng = _engine(model, slots=4, max_prompt_len=16, max_new_tokens=10)
    prompts = [[3, 1, 4], [15, 9, 2, 6, 5], [8, 9], [7, 9, 3, 2],
               [1, 2, 3, 4, 5, 6, 7], [11, 13]]
    reqs = [eng.submit(p) for p in prompts[:2]]
    for _ in range(3):
        eng.step()
    reqs += [eng.submit(p) for p in prompts[2:]]
    _drain(eng, reqs, 100)
    for p, r in zip(prompts, reqs):
        assert r.done.is_set() and r.error is None
        assert list(r.tokens) == _reference_tokens(model, p, 10)


def test_slot_churn_more_requests_than_slots(model):
    eng = _engine(model, slots=2, max_prompt_len=16, max_new_tokens=6)
    prompts = [[i + 1, (2 * i) % 19 + 1, (3 * i) % 7 + 1] for i in range(10)]
    reqs = [eng.submit(p) for p in prompts]
    _drain(eng, reqs, 300)
    for p, r in zip(prompts, reqs):
        assert list(r.tokens) == _reference_tokens(model, p, 6)
    assert eng.stats["prefills"] == 10
    assert eng.stats["requests_done"] == 10


def test_eos_frees_slot_early(model):
    prompt = [5, 4, 3]
    first = _reference_tokens(model, prompt, 1)[0]
    eng = _engine(model, slots=2, max_prompt_len=16, max_new_tokens=8,
                  eos_id=first)
    req = eng.submit(prompt)
    while not req.done.is_set():
        eng.step()
    assert list(req.tokens) == [first]
    assert req.finish_reason == "eos"
    assert eng._slot_req == [None, None]


def test_per_request_max_new_tokens(model):
    eng = _engine(model, slots=2, max_prompt_len=16, max_new_tokens=8)
    req = eng.submit([2, 7, 1], max_new_tokens=3)
    while not req.done.is_set():
        eng.step()
    assert len(req.tokens) == 3
    assert req.finish_reason == "length"
    assert list(req.tokens) == _reference_tokens(model, [2, 7, 1], 8)[:3]


def test_streaming_tokens_arrive_incrementally(model):
    eng = _engine(model, slots=2, max_prompt_len=16,
                  max_new_tokens=5).serve_forever()
    try:
        got = list(eng.submit_stream([9, 8, 7]))
        assert got == _reference_tokens(model, [9, 8, 7], 5)
    finally:
        eng.shutdown()


def test_background_thread_concurrent_submitters(model):
    prompts = [[i + 1, i + 2] for i in range(8)]
    want = [_reference_tokens(model, p, 6) for p in prompts]
    eng = _engine(model, slots=4, max_prompt_len=16,
                  max_new_tokens=6).serve_forever()
    try:
        results = {}

        def worker(i, p):
            results[i] = eng.generate(p, timeout=120)

        threads = [threading.Thread(target=worker, args=(i, p))
                   for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert [results[i] for i in range(len(prompts))] == want
    finally:
        eng.shutdown()


def test_chunked_decode_matches_single_step(model):
    prompts = [[3, 1, 4], [15, 9, 2, 6], [5, 3]]
    outs = {}
    for chunk in (1, 5):
        eng = _engine(model, slots=2, max_prompt_len=16, max_new_tokens=9,
                      decode_chunk=chunk)
        reqs = [eng.submit(p) for p in prompts]
        _drain(eng, reqs, 200)
        outs[chunk] = [list(r.tokens) for r in reqs]
    assert outs[1] == outs[5]
    for p, toks in zip(prompts, outs[1]):
        assert toks == _reference_tokens(model, p, 9)


def test_chunked_eos_freezes_on_device(model):
    prompt = [5, 4, 3]
    ref = _reference_tokens(model, prompt, 8)
    eos = ref[2]
    want = ref[:ref.index(eos) + 1]
    eng = _engine(model, slots=2, max_prompt_len=16, max_new_tokens=8,
                  eos_id=eos, decode_chunk=4)
    req = eng.submit(prompt)
    while not req.done.is_set():
        eng.step()
    assert list(req.tokens) == want
    assert req.finish_reason == "eos"


def test_fetch_batching_matches_unbatched(model):
    prompts = [[3, 1, 4], [15, 9, 2, 6], [5, 3], [8, 8, 8]]
    outs = {}
    for fe in (1, 3):
        eng = _engine(model, slots=2, max_prompt_len=16, max_new_tokens=9,
                      decode_chunk=2, fetch_every=fe)
        reqs = [eng.submit(p) for p in prompts]
        _drain(eng, reqs, 400)
        outs[fe] = [list(r.tokens) for r in reqs]
    assert outs[1] == outs[3]
    for p, toks in zip(prompts, outs[1]):
        assert toks == _reference_tokens(model, p, 9)


def test_oversized_prompt_rejected(model):
    eng = _engine(model, slots=2, max_prompt_len=8, max_new_tokens=4)
    with pytest.raises(ValueError, match="max_prompt_len"):
        eng.submit(list(range(1, 20)))


def test_long_generation_does_not_stall_batch(model):
    eng = _engine(model, slots=2, max_prompt_len=16, max_new_tokens=32)
    long_req = eng.submit([1, 2, 3], max_new_tokens=32)
    short_req = eng.submit([4, 5, 6], max_new_tokens=2)
    third = None
    done_at = {}
    for i in range(200):
        eng.step()
        if short_req.done.is_set() and third is None:
            third = eng.submit([7, 8], max_new_tokens=2)
        for name, r in [("short", short_req), ("long", long_req)] + \
                ([("third", third)] if third is not None else []):
            if r.done.is_set() and name not in done_at:
                done_at[name] = i
        if len(done_at) == 3:
            break
    assert done_at["short"] < done_at["long"]
    assert "third" in done_at and done_at["third"] < done_at["long"]
    assert list(third.tokens) == _reference_tokens(model, [7, 8], 32)[:2]
    assert list(long_req.tokens) == _reference_tokens(model, [1, 2, 3], 32)


def test_step_loop_death_fails_all_waiters(model):
    eng = _engine(model, slots=2, max_prompt_len=16, max_new_tokens=8)
    boom = RuntimeError("device lost")

    def exploding_step():
        raise boom
    eng.fetch_every = 4
    inflight_req = eng.submit([9, 9])
    eng._step_locked()  # admit + dispatch one chunk, no delivery yet
    assert eng._inflight, "precondition: an undelivered chunk exists"
    eng.step = exploding_step
    req = eng.submit([1, 2, 3])
    eng.serve_forever()
    assert req.done.wait(10)
    assert req.error is boom and req.finish_reason == "error"
    assert inflight_req.done.wait(10)
    assert inflight_req.error is boom
    eng._thread.join(timeout=10)
    assert not eng._thread.is_alive()
    with pytest.raises(RuntimeError, match="dead"):
        eng.submit([4, 5])
    with pytest.raises(RuntimeError, match="dead"):
        eng.submit_stream([4, 5])
    eng.shutdown()


def test_batched_prefill_groups_match_serial(model):
    eng = _engine(model, slots=6, max_prompt_len=16, max_new_tokens=6)
    prompts = [[i + 1, (3 * i) % 11 + 1] for i in range(6)]
    reqs = [eng.submit(p) for p in prompts]
    _drain(eng, reqs, 100)
    for p, r in zip(prompts, reqs):
        assert list(r.tokens) == _reference_tokens(model, p, 6)
    assert eng.stats["prefills"] == 6
    assert eng.stats["prefill_dispatches"] == 2  # groups of 4 + 2


def test_pipelined_fetcher_matches_inline(model):
    prompts = [[3, 1, 4], [15, 9, 2, 6], [5, 3], [8, 8, 8],
               [2, 7, 1, 8], [9, 9]]
    want = [_reference_tokens(model, p, 8) for p in prompts]
    eng = _engine(model, slots=2, max_prompt_len=16, max_new_tokens=8,
                  decode_chunk=3, max_inflight=2).serve_forever()
    try:
        reqs = [eng.submit(p) for p in prompts]
        for r in reqs:
            assert r.done.wait(120)
            assert r.error is None
        assert [list(r.tokens) for r in reqs] == want
        assert eng.stats["fetches"] >= 1
    finally:
        eng.shutdown()


def test_warmup_runs_and_resets(model):
    eng = _engine(model, slots=4, max_prompt_len=16, max_new_tokens=6)
    eng.warmup()
    assert int(eng.cache["pos"].abs().sum()) == 0
    req = eng.submit([3, 1, 4, 1, 5])
    _drain(eng, [req], 50)
    assert list(req.tokens) == _reference_tokens(model, [3, 1, 4, 1, 5], 6)


def test_sampled_engine_is_seeded(model):
    def run(seed):
        eng = _engine(model, slots=2, max_prompt_len=16, max_new_tokens=6,
                      greedy=False, temperature=1.5, seed=seed)
        return eng.generate([3, 1, 4])

    a, b, c = run(1), run(1), run(2)
    assert a == b and a != c and len(a) == 6
    assert all(0 <= t < 256 for t in a)


def test_prefill_slot_writes_one_row(model):
    """prefill_slot: a left-padded prompt lands in one slot row, and its
    first sampled token is the reference's first greedy token."""
    _, ct, pt = model
    prompt = [3, 1, 4, 1, 5]
    cache = init_slot_cache(ct, 3, 24, "cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    toks[0, 3:] = torch.tensor(prompt)
    cache, first = prefill_slot(pt, cache, toks, 2, 3, None, ct)
    assert int(first) == _reference_tokens(model, prompt, 1)[0]
    assert cache["pos"].tolist() == [0, 0, 8]
    assert cache["start"].tolist() == [0, 0, 3]
    assert cache["k"][:, 2, 3:8].abs().sum() > 0
    assert cache["k"][:, :2].abs().sum() == 0 and \
        cache["k"][:, 2, 8:].abs().sum() == 0
