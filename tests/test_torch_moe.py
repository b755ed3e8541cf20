"""The port's Mixture-of-Experts FFN (``ray_tpu_torch.models.moe``) against
``ray_tpu.models.moe`` on the CPU, and the MoE decoder through every entry
point that reaches it: forward and loss metrics, the train step, KV-cache
generation and the continuous-batching engine.

Layer weights and inputs are drawn with numpy from a seed; whole models
take the JAX init and go to the port through ``params_from_numpy``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import config as jcfg
from ray_tpu.models import engine as jengine
from ray_tpu.models import generate as JG
from ray_tpu.models import moe as jmoe
from ray_tpu.models import training as jtrain
from ray_tpu.models import transformer as jtr
from ray_tpu_torch.interop import params_from_numpy, tensor_from_numpy
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import engine as tengine
from ray_tpu_torch.models import generate as TG
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models import training as ttrain
from ray_tpu_torch.models import transformer as ttr
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
# moe_ffn against the reference: fp32 1e-5, bf16 5e-2
_TOL = {jnp.float32: 1e-5, jnp.bfloat16: 5e-2}
# tests/test_models.py::TestMoE's geometry
_BASE = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2, d_ff=32,
             dtype=jnp.float32, param_dtype=jnp.float32, remat=False,
             attention_impl="xla", moe_experts=4, moe_top_k=2)


def _cfgs(**kw):
    """(JAX cfg, port cfg) for _BASE updated by ``kw``."""
    kw = {**_BASE, **kw}
    return (jcfg.TransformerConfig(**kw),
            tcfg.TransformerConfig(**{k: _DT.get(v, v) if k.endswith("dtype")
                                      else v for k, v in kw.items()}))


def _layer(cfg, seed=0, router_scale=1.0):
    """One layer's MoE weights as numpy fp32, drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    return {"router": rng.randn(d, E).astype(np.float32) * router_scale,
            "w_gate": (rng.randn(E, d, ff) * d ** -0.5).astype(np.float32),
            "w_up": (rng.randn(E, d, ff) * d ** -0.5).astype(np.float32),
            "w_down": (rng.randn(E, ff, d) * ff ** -0.5).astype(np.float32)}


def _hidden(cfg, b=2, t=12, seed=1):
    return np.random.RandomState(seed).randn(b, t, cfg.d_model).astype(
        np.float32)


def _both(lp, h, dtype):
    """The same layer and input for JAX and the port, h in ``dtype``."""
    hj = jnp.asarray(h).astype(dtype)
    return ({k: jnp.asarray(v) for k, v in lp.items()}, hj,
            {k: torch.from_numpy(v) for k, v in lp.items()},
            tensor_from_numpy(np.asarray(hj), "cpu"))


def _jax_top_i(hj, router, k):
    probs = jax.nn.softmax(jnp.einsum("btd,de->bte", hj.astype(jnp.float32),
                                      router.astype(jnp.float32)), axis=-1)
    return np.asarray(jax.lax.top_k(probs, k)[1])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_ffn_matches_reference(dtype, capacity_factor):
    """Output and aux within fp32 1e-5 / bf16 5e-2, the same top-k experts,
    and at capacity factor 0.5 slots really dropped."""
    cj, ct = _cfgs(dtype=dtype, moe_capacity_factor=capacity_factor)
    lpj, hj, lpt, ht = _both(_layer(cj), _hidden(cj), dtype)
    yj, aux_j = jmoe.moe_ffn(hj, lpj, cj)
    yt, aux_t = tmoe.moe_ffn(ht, lpt, ct)
    assert yt.dtype == _DT[dtype] and tuple(yt.shape) == yj.shape
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32),
                               rtol=_TOL[dtype], atol=_TOL[dtype])
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    _, top_i = tmoe.top_k(tmoe.router_probs(ht, lpt["router"]), ct.moe_top_k)
    np.testing.assert_array_equal(top_i.numpy(),
                                  _jax_top_i(hj, lpj["router"], cj.moe_top_k))
    _, kept = tmoe.assign_slots(top_i, ct.moe_experts,
                                tmoe.capacity(ht.shape[1], ct))
    if capacity_factor == 0.5:  # E*C places for half of each row's slots
        assert (~kept).sum().item() >= kept.numel() // 2


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 8.0])
@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_index_form_matches_dense_form(capacity_factor, top_k):
    """moe_ffn (dispatch and combine by index) equals moe_ffn_dense (the
    reference's one-hot einsums) to 1e-6 in fp32, with the same experts and
    the same kept slots."""
    _, ct = _cfgs(moe_capacity_factor=capacity_factor, moe_top_k=top_k)
    lp = {k: torch.from_numpy(v) for k, v in _layer(ct, seed=2).items()}
    h = torch.from_numpy(_hidden(ct, b=3, t=10, seed=3))
    y, aux = tmoe.moe_ffn(h, lp, ct)
    y_d, aux_d, top_i_d, kept_d = tmoe.moe_ffn_dense(h, lp, ct)
    torch.testing.assert_close(y, y_d, rtol=0, atol=1e-6)
    torch.testing.assert_close(aux, aux_d, rtol=0, atol=1e-6)
    _, top_i = tmoe.top_k(tmoe.router_probs(h, lp["router"]), top_k)
    _, kept = tmoe.assign_slots(top_i, ct.moe_experts,
                                tmoe.capacity(h.shape[1], ct))
    assert torch.equal(top_i, top_i_d)
    assert torch.equal(kept, kept_d)


def test_identical_experts_match_dense_ffn():
    """Mirrors tests/test_models.py::TestMoE: every expert the same, nothing
    dropped -> the dense SwiGLU FFN."""
    _, ct = _cfgs(moe_capacity_factor=8.0)
    rng = np.random.RandomState(0)
    d, ff, E = ct.d_model, ct.d_ff, ct.moe_experts
    wg, wu = (torch.from_numpy(rng.randn(d, ff).astype(np.float32) * 0.1)
              for _ in range(2))
    wd = torch.from_numpy(rng.randn(ff, d).astype(np.float32) * 0.1)
    lp = {"router": torch.from_numpy(rng.randn(d, E).astype(np.float32)),
          "w_gate": wg.expand(E, d, ff), "w_up": wu.expand(E, d, ff),
          "w_down": wd.expand(E, ff, d)}
    h = torch.from_numpy(rng.randn(2, 8, d).astype(np.float32))
    out, aux = tmoe.moe_ffn(h, lp, ct)
    dense, _ = ttr.ffn_block(h, {"w_gate": wg, "w_up": wu, "w_down": wd},
                             dataclasses.replace(ct, moe_experts=0))
    torch.testing.assert_close(out, dense, rtol=0, atol=1e-5)
    assert float(aux) > 0


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_ties_go_to_the_lower_expert(top_k):
    """A zero router makes every probability 1/E: the reference's top_k
    picks experts 0..k-1 and so must the port (torch.topk need not)."""
    cj, ct = _cfgs(moe_top_k=top_k, moe_capacity_factor=8.0)
    lp = _layer(cj, router_scale=0.0)
    lpj, hj, lpt, ht = _both(lp, _hidden(cj), jnp.float32)
    _, top_i = tmoe.top_k(tmoe.router_probs(ht, lpt["router"]), top_k)
    assert (top_i == torch.arange(top_k)).all()
    np.testing.assert_array_equal(top_i.numpy(),
                                  _jax_top_i(hj, lpj["router"], top_k))
    yj, _ = jmoe.moe_ffn(hj, lpj, cj)
    yt, _ = tmoe.moe_ffn(ht, lpt, ct)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_gradients_match_reference(capacity_factor):
    """Gradients of sum(y * r) + aux with respect to the input, the router
    and every expert weight against jax.grad: the router is reached through
    the combine weights and through aux."""
    cj, ct = _cfgs(moe_capacity_factor=capacity_factor)
    lp, h = _layer(cj, seed=4), _hidden(cj, seed=5)
    r = np.random.RandomState(6).randn(*h.shape).astype(np.float32)

    def jloss(h, lp):
        y, aux = jmoe.moe_ffn(h, lp, cj)
        return jnp.sum(y * r) + aux

    gh_j, glp_j = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), {k: jnp.asarray(v) for k, v in lp.items()})
    ht = torch.from_numpy(h).requires_grad_(True)
    lpt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in lp.items()}
    y, aux = tmoe.moe_ffn(ht, lpt, ct)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh_j), rtol=1e-4,
                               atol=1e-5)
    for name in lp:
        np.testing.assert_allclose(lpt[name].grad.numpy(),
                                   np.asarray(glp_j[name]), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert lpt["router"].grad.abs().sum() > 0


def _model(**kw):
    """(JAX cfg, port cfg, JAX params, port params): an MoE tiny_config."""
    cj = jcfg.tiny_config(moe_experts=4, **kw)
    ct = tcfg.tiny_config(moe_experts=4, **{
        k: _DT.get(v, v) if k.endswith("dtype") else v for k, v in kw.items()})
    pj = jtr.init_params(jax.random.key(0), cj)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), ct, device="cpu")
    return cj, ct, pj, pt


def _tokens(b, t, seed=0, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(
        np.int32)


def test_param_shapes_and_init_scales_match_reference():
    cj = jcfg.tiny_config(moe_experts=4)
    ct = tcfg.tiny_config(moe_experts=4)
    pj = jtr.init_params(jax.random.key(0), cj)
    pt = ttr.init_params(torch.Generator().manual_seed(0), ct, device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), pj) == ttr.param_shapes(ct)
    assert jax.tree.map(lambda x: tuple(x.shape), pj) == \
        jax.tree.map(lambda x: tuple(x.shape), pt)
    for name in ("router", "w_gate", "w_up", "w_down"):
        a = float(np.asarray(pj["layers"][name]).std())
        b = float(pt["layers"][name].std())
        assert abs(a - b) / a < 0.1, name


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_and_loss_metrics_match_reference(impl):
    """Logits, summed aux, and loss_fn's loss, moe_aux and total_loss; loss
    stays the cross entropy and total_loss adds moe_aux_weight * aux."""
    cj, ct, pj, pt = _model(attention_impl=impl)
    toks = _tokens(2, 24)
    lj, aux_j = jtr.forward(pj, jnp.asarray(toks), cj, return_aux=True)
    lt, aux_t = ttr.forward(pt, torch.from_numpy(toks), ct, return_aux=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    total_j, mj = jtr.loss_fn(pj, {"tokens": jnp.asarray(toks)}, cj)
    total_t, mt = ttr.loss_fn(pt, {"tokens": torch.from_numpy(toks)}, ct)
    assert set(mt) == set(mj) == {"loss", "perplexity", "moe_aux",
                                  "total_loss"}
    for name in mj:
        np.testing.assert_allclose(float(mt[name]), float(mj[name]),
                                   rtol=2e-4, atol=2e-4, err_msg=name)
    np.testing.assert_allclose(float(total_t), float(total_j), rtol=2e-4)
    torch.testing.assert_close(
        mt["total_loss"], mt["loss"] + ct.moe_aux_weight * mt["moe_aux"])


def test_train_steps_match_reference():
    """5 MoE train steps from the same params and batch at lr 1e-3 (as
    tests/test_torch_training.py's): loss, moe_aux, total_loss and
    grad_norm at every step and the params after the last within 2e-4."""
    cj, ct, pj, _ = _model()
    kw = dict(warmup_steps=2, total_steps=10)
    jtx = jtrain.make_optimizer(1e-3, **kw)
    ttx = ttrain.make_optimizer(1e-3, **kw)
    jstate = jtrain.init_train_state(jax.random.key(0), cj, jtx)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]),
                               ct, device="cpu")
    tstate = {"step": torch.zeros((), dtype=torch.int32), "params": params,
              "opt_state": ttx.init(params)}
    toks = _tokens(2, 17, seed=7)
    jbatch = {"inputs": jnp.asarray(toks[:, :-1]),
              "targets": jnp.asarray(toks[:, 1:])}
    tbatch = {"inputs": torch.from_numpy(toks[:, :-1]),
              "targets": torch.from_numpy(toks[:, 1:])}
    jstep = jtrain.make_train_step(cj, jtx)
    tstep = ttrain.make_train_step(ct, ttx)
    names = ("loss", "moe_aux", "total_loss", "grad_norm")
    got, want = [], []
    for _ in range(5):
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, tbatch)
        want.append([float(jm[n]) for n in names])
        got.append([float(tm[n]) for n in names])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert got[-1][0] < got[0][0]
    for a, b in zip(jax.tree.leaves(jstate["params"]),
                    ttrain.tree_leaves(tstate["params"])):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 2e-4


def test_generate_matches_reference():
    """Greedy MoE generation token for token in fp32, a single prompt and a
    left-padded batch (at decode each row routes alone: C = 1)."""
    cj, ct, pj, pt = _model()
    prompt = _tokens(1, 7, seed=8)
    want = np.asarray(JG.generate(pj, jnp.asarray(prompt), cj,
                                  max_new_tokens=10))
    got = TG.generate(pt, torch.from_numpy(prompt), ct,
                      max_new_tokens=10).numpy()
    np.testing.assert_array_equal(got, want)
    batch = _tokens(2, 9, seed=9)
    start = np.asarray([4, 0], np.int32)
    want = np.asarray(JG.generate(pj, jnp.asarray(batch), cj,
                                  max_new_tokens=6, start=jnp.asarray(start)))
    got = TG.generate(pt, torch.from_numpy(batch), ct, max_new_tokens=6,
                      start=torch.from_numpy(start)).numpy()
    np.testing.assert_array_equal(got, want)


def _drain(eng, reqs, steps=400):
    for _ in range(steps):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert all(r.done.is_set() for r in reqs)
    return [list(r.tokens) for r in reqs]


def test_engine_matches_reference_with_pads_claiming_capacity():
    """The MoE engine against the JAX engine, prompts of mixed lengths in
    one prefill group (left-padded to one bucket): token for token. The
    reference's moe_ffn has no pad mask, so pads ahead of a prompt claim
    expert capacity; at capacity factor 0.5 that changes what some prompts
    generate against an unpadded generate(), the same way in both."""
    cj, ct, pj, pt = _model(moe_capacity_factor=0.5)
    prompts = [_tokens(1, n, seed=10 + n)[0].tolist() for n in (3, 5, 9, 14)]
    kw = dict(slots=4, max_prompt_len=16, max_new_tokens=8)
    jeng = jengine.InferenceEngine(pj, cj, **kw)
    teng = tengine.InferenceEngine(pt, ct, device="cpu", **kw)
    want = _drain(jeng, [jeng.submit(p) for p in prompts])
    got = _drain(teng, [teng.submit(p) for p in prompts])
    assert got == want
    solo = [TG.generate(pt, torch.tensor([p]), ct, max_new_tokens=8)[
        0, len(p):].tolist() for p in prompts]
    assert solo != got  # the pads' claim shows


def test_engine_prompts_without_pads_match_generate():
    """Prompts that fill their bucket carry no pads: the engine equals
    generate() token for token (chip_smoke.py's moe_engine phase)."""
    _, ct, _, pt = _model()
    prompts = [_tokens(1, 16, seed=20 + i)[0].tolist() for i in range(3)]
    eng = tengine.InferenceEngine(pt, ct, device="cpu", slots=4,
                                  max_prompt_len=16, max_new_tokens=8)
    got = _drain(eng, [eng.submit(p) for p in prompts])
    want = [TG.generate(pt, torch.tensor([p]), ct, max_new_tokens=8)[
        0, 16:].tolist() for p in prompts]
    assert got == want
