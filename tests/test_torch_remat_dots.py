"""``remat_policy="dots"`` in the port: each layer under
``torch.utils.checkpoint`` with a selective policy that keeps the outputs of
products without batch dimensions (``aten.mm``/``addmm``), the counterpart
of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``. Gradients
against JAX's ``"dots"`` step and against the port's ``"nothing"``, and what
the backward recomputes under each policy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from ray_tpu.models import config as jcfg
from ray_tpu.models import transformer as jtr
from ray_tpu_torch.interop import params_from_numpy
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import training as ttrain
from ray_tpu_torch.models import transformer as ttr
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

_VARIANTS = {
    "dense_xla": dict(attention_impl="xla"),
    "dense_pallas": dict(attention_impl="pallas"),
    "moe_xla": dict(attention_impl="xla", moe_experts=4),
    "moe_pallas": dict(attention_impl="pallas", moe_experts=4,
                       moe_capacity_factor=0.5),
}


def _model(**kw):
    cj = jcfg.tiny_config(remat=True, **kw)
    ct = tcfg.tiny_config(remat=True, **kw)
    pj = jtr.init_params(jax.random.key(0), cj)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), ct, device="cpu")
    return cj, ct, pj, pt


def _batch(vocab, b=2, t=16, seed=0):
    toks = np.random.RandomState(seed).randint(0, vocab, (b, t + 1)).astype(
        np.int32)
    return toks[:, :-1], toks[:, 1:]


def _port_grads(params, batch, cfg):
    leaves = [p.clone().requires_grad_(True)
              for p in ttrain.tree_leaves(params)]
    loss, metrics = ttr.loss_fn(ttrain._unflatten(params, leaves), batch, cfg)
    return loss, metrics, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_dots_gradients_match_reference_and_nothing(variant):
    """The port's "dots" loss and gradients against jax.grad of the
    reference's "dots" loss_fn (fp32 2e-4), and against the port's own
    "nothing" step (the policy changes what is kept, not what is
    computed: 1e-6)."""
    cj, ct, pj, pt = _model(**_VARIANTS[variant])
    cj = dataclasses.replace(cj, remat_policy="dots")
    dots = dataclasses.replace(ct, remat_policy="dots")
    inputs, targets = _batch(ct.vocab_size)
    jbatch = {"inputs": jnp.asarray(inputs), "targets": jnp.asarray(targets)}
    tbatch = {"inputs": torch.from_numpy(inputs),
              "targets": torch.from_numpy(targets)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtr.loss_fn(p, jbatch, cj), has_aux=True)(pj)
    loss, _, grads = _port_grads(pt, tbatch, dots)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-4,
                               atol=2e-4)
    for (path, gj), gt in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                              grads):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=2e-4,
                                   atol=2e-4, err_msg=str(path))
    loss_n, _, grads_n = _port_grads(pt, tbatch, ct)
    torch.testing.assert_close(loss, loss_n, rtol=0, atol=1e-6)
    for a, b in zip(grads, grads_n):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_policy_keeps_only_unbatched_products():
    policy = ttr._dots_policy
    aten = torch.ops.aten
    assert policy(None, aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert policy(None, aten.addmm.default) == CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.empty.memory_format, aten.exp.default,
               aten.mul.Tensor, aten.index.Tensor):
        assert policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE, op


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("moe", [False, True])
def test_dots_backward_recomputes_no_unbatched_product(moe):
    """The backward under "nothing" reruns each layer's forward products;
    under "dots" it runs none of the forward's aten.mm (the q/k/v/o
    projections, the dense FFN or the router) again, while the batched
    products (the MoE experts' bmm) are still recomputed."""
    kw = dict(attention_impl="pallas", moe_experts=4 if moe else 0)
    _, ct, _, pt = _model(**kw)
    inputs, targets = _batch(ct.vocab_size)
    batch = {"inputs": torch.from_numpy(inputs),
             "targets": torch.from_numpy(targets)}
    counts = {}
    for policy in ("nothing", "dots"):
        cfg = dataclasses.replace(ct, remat_policy=policy)
        leaves = [p.clone().requires_grad_(True)
                  for p in ttrain.tree_leaves(pt)]
        loss, _ = ttr.loss_fn(ttrain._unflatten(pt, leaves), batch, cfg)
        with _CountOps() as mode:
            torch.autograd.grad(loss, leaves)
        counts[policy] = mode.counts
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    # forward products per layer that "nothing" recomputes: q, k, v, o,
    # plus gate and up (dense) or the router (MoE). The down projection's
    # output is saved by no backward node, and the non-reentrant checkpoint
    # stops its recompute once every saved tensor is back. The experts' and
    # the flash plain versions' products are batched.
    per_layer = 5 if moe else 6
    assert counts["nothing"][mm] - counts["dots"][mm] == \
        per_layer * ct.n_layers
    assert counts["nothing"][bmm] == counts["dots"][bmm]
    assert counts["dots"][bmm] > 0
