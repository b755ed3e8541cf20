"""Learners: PyTorch updates on the learner's device (PPO clipped
surrogate, IMPALA V-trace).

Ref analogs: rllib/core/learner/learner.py:229 (Learner.update :1230) and
learner_group.py:61. Each learner keeps its params and Adam state on one
device (the card unless the caller passes ``device="cpu"``); a minibatch
step is forward + backward + Adam there. A LearnerGroup of N learner
actors does synchronous data-parallel updates by averaging grads on the
host (the reference's TorchDDPRLModule analog).

V-trace follows Espeholt et al. 2018 (IMPALA): a reverse loop over T.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.training import (AdamW, _unflatten, tree_leaves,
                                           tree_map)

from . import sample_batch as SB
from .models import (Params, entropy_of, forward, init_actor_critic, logp_of,
                     params_from_numpy, seeded, to_numpy)
from .sample_batch import SampleBatch


def adam(lr: float, grad_clip: Optional[float] = None) -> AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adam(lr))``, or
    ``optax.adam(lr)`` alone when ``grad_clip`` is None."""
    return AdamW(lr, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8,
                 grad_clip=grad_clip, mu_dtype=None)


def value_and_grad(fn, tree, *args):
    """``jax.value_and_grad(fn, has_aux=True)(tree, *args)`` for a tree
    (nested dicts, or one tensor) of leaves: -> (loss, aux, grads), the
    loss and aux detached, grads in ``tree``'s structure, contiguous; a
    leaf the loss leaves out gets zeros."""
    live = tree_map(lambda v: v.detach().requires_grad_(True), tree)
    with torch.enable_grad():
        loss, aux = fn(live, *args)
        grads = torch.autograd.grad(loss, tree_leaves(live),
                                    materialize_grads=True)
    return loss.detach(), detached(aux), _unflatten(
        tree, [g.contiguous() for g in grads])


def detached(tree):
    """Every tensor of a tree (dicts, tuples, lists) detached."""
    if isinstance(tree, dict):
        return {k: detached(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(detached(v) for v in tree)
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def huber(err: torch.Tensor) -> torch.Tensor:
    """``optax.huber_loss`` at delta 1 of an error (predictions minus
    targets), per element."""
    abs_err = torch.abs(err)
    quadratic = torch.clamp(abs_err, max=1.0)
    return 0.5 * quadratic ** 2 + (abs_err - quadratic)


def normalized(adv: torch.Tensor) -> torch.Tensor:
    """(adv - mean) / (std + 1e-8) with the population std (jnp.std's)."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def take(logps: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """logps[..., a] along the last axis for integer ``actions``."""
    return torch.gather(logps, -1, actions.long()[..., None]).squeeze(-1)


def _host(v: torch.Tensor):
    v = v.detach()
    return float(v) if v.dim() == 0 else v.cpu().numpy()


class Learner:
    """Params and Adam state on one device; a subclass gives ``loss(params,
    batch) -> (total, metrics)`` and the batch columns it reads."""

    columns: Tuple[str, ...] = ()

    def __init__(self, obs_dim: int, num_actions: int, *, lr: float,
                 grad_clip: Optional[float], hiddens, seed: int, device):
        self.device = resolve_device(device)
        self.params = init_actor_critic(seeded(seed), obs_dim, num_actions,
                                        hiddens, self.device)
        self.tx = adam(lr, grad_clip)
        self.opt_state = self.tx.init(self.params)

    def loss(self, params: Params, batch) -> Tuple[torch.Tensor, dict]:
        raise NotImplementedError

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        """The columns the loss reads, on the learner's device (actions
        stay int64, dones bool)."""
        return {k: torch.as_tensor(batch[k], device=self.device)
                for k in self.columns if k in batch}

    def _grads(self, batch) -> Tuple[Dict[str, torch.Tensor], dict]:
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in self.params.items()}
        with torch.enable_grad():
            total, metrics = self.loss(leaves, batch)
            # a leaf the loss leaves out (DQN's value head) gets zeros
            grads = torch.autograd.grad(total, list(leaves.values()),
                                        materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = total.detach()
        # contiguous, so the clip's norm sums them in the order it sums
        # grads that came back through numpy (apply_grads)
        return {k: g.contiguous() for k, g in zip(leaves, grads)}, metrics

    def _step(self, batch) -> dict:
        grads, metrics = self._grads(batch)
        self.tx.step_(grads, self.opt_state, self.params)
        return metrics

    def update(self, batch: SampleBatch) -> dict:
        metrics = self._step(self._batch(batch))
        return {k: _host(v) for k, v in metrics.items()}

    # ----- distributed (grad-averaging) path -----

    def compute_grads(self, batch: SampleBatch):
        grads, metrics = self._grads(self._batch(batch))
        return to_numpy(grads), {k: _host(v) for k, v in metrics.items()}

    def apply_grads(self, grads: Dict[str, np.ndarray]):
        self.tx.step_(params_from_numpy(grads, self.device), self.opt_state,
                      self.params)

    def get_weights(self) -> Dict[str, np.ndarray]:
        return to_numpy(self.params)

    def set_weights(self, weights: Dict[str, np.ndarray]):
        self.params = params_from_numpy(weights, self.device)


class PPOLearner(Learner):
    """Clipped-surrogate PPO (ref: rllib/algorithms/ppo/ppo_torch_policy.py
    loss; here one minibatch step on the learner's device)."""

    columns = (SB.OBS, SB.ACTIONS, SB.ACTION_LOGP, SB.ADVANTAGES,
               SB.VALUE_TARGETS)

    def __init__(self, obs_dim: int, num_actions: int, *, lr: float = 3e-4,
                 clip_param: float = 0.2, vf_coeff: float = 0.5,
                 entropy_coeff: float = 0.01, grad_clip: float = 0.5,
                 hiddens=(64, 64), seed: int = 0, device=None):
        super().__init__(obs_dim, num_actions, lr=lr, grad_clip=grad_clip,
                         hiddens=hiddens, seed=seed, device=device)
        self.clip_param = clip_param
        self.vf_coeff = vf_coeff
        self.entropy_coeff = entropy_coeff

    def loss(self, params, batch):
        logits, values = forward(params, batch[SB.OBS])
        logp = logp_of(logits, batch[SB.ACTIONS])
        ratio = torch.exp(logp - batch[SB.ACTION_LOGP])
        adv = normalized(batch[SB.ADVANTAGES])
        c = self.clip_param
        surr = torch.minimum(ratio * adv,
                             torch.clamp(ratio, 1 - c, 1 + c) * adv)
        pi_loss = -surr.mean()
        vf_loss = torch.mean((values - batch[SB.VALUE_TARGETS]) ** 2)
        ent = entropy_of(logits).mean()
        total = pi_loss + self.vf_coeff * vf_loss - self.entropy_coeff * ent
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": ent,
                       "kl": torch.mean(batch[SB.ACTION_LOGP] - logp)}

    def update(self, batch: SampleBatch, *, num_epochs: int = 4,
               minibatch_size: int = 128, seed: int = 0) -> dict:
        """``num_epochs`` passes over the batch in minibatches of
        ``minibatch_size``, shuffled by a numpy generator seeded from
        ``seed`` (the reference's permutations, applied on the device)."""
        rng = np.random.default_rng(seed)
        dev = self._batch(batch)
        n = SampleBatch(batch).count
        starts = range(0, n - minibatch_size + 1, minibatch_size)
        metrics = {}
        for _ in range(num_epochs):
            perm = torch.as_tensor(rng.permutation(n), device=self.device)
            for s in starts:
                idx = perm[s:s + minibatch_size]
                metrics = self._step({k: v[idx] for k, v in dev.items()})
            if not starts:  # batch smaller than one minibatch
                metrics = self._step(dev)
        return {k: _host(v) for k, v in metrics.items()}


@torch.no_grad()
def vtrace(behaviour_logp, target_logp, rewards, dones, values,
           bootstrap_value, gamma: float, clip_rho: float = 1.0,
           clip_c: float = 1.0):
    """V-trace targets (Espeholt et al. 2018, eqs. 1-2), time-major [T, N].

    Returns (vs [T,N], pg_advantages [T,N]), computed outside any graph
    (the reference's stop_gradient): no gradient flows through the inputs.
    """
    ratio = torch.exp(target_logp - behaviour_logp)
    rho = torch.clamp(ratio, max=clip_rho)
    c = torch.clamp(ratio, max=clip_c)
    discounts = gamma * (1.0 - dones.to(torch.float32))
    values_next = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = rho * (rewards + discounts * values_next - values)
    decay = discounts * c
    # the reverse scan, one launch a step: acc_t = delta_t + decay_t acc_t+1
    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v = [None] * deltas.shape[0]
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = torch.addcmul(deltas[t], decay[t], acc)
        vs_minus_v[t] = acc
    vs = values + torch.stack(vs_minus_v)
    vs_next = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_adv = rho * (rewards + discounts * vs_next - values)
    return vs, pg_adv


class _VtraceLearner(Learner):
    """Time-major [T, N] batches: the net's logits, values and the
    behaviour-corrected V-trace targets shared by IMPALA and APPO."""

    columns = (SB.OBS, SB.ACTIONS, SB.REWARDS, SB.DONES, SB.ACTION_LOGP,
               "bootstrap_obs")

    def __init__(self, obs_dim: int, num_actions: int, *, lr: float,
                 gamma: float, vf_coeff: float, entropy_coeff: float,
                 grad_clip: float, clip_rho: float, clip_c: float, hiddens,
                 seed: int, device):
        super().__init__(obs_dim, num_actions, lr=lr, grad_clip=grad_clip,
                         hiddens=hiddens, seed=seed, device=device)
        self.gamma, self.clip_rho, self.clip_c = gamma, clip_rho, clip_c
        self.vf_coeff, self.entropy_coeff = vf_coeff, entropy_coeff

    def _vtrace_terms(self, params, batch):
        T, N = batch[SB.ACTIONS].shape
        logits, values = forward(params, batch[SB.OBS].reshape(T * N, -1))
        logits = logits.reshape(T, N, -1)
        values = values.reshape(T, N)
        target_logp = take(torch.log_softmax(logits, dim=-1),
                           batch[SB.ACTIONS])
        with torch.no_grad():
            _, bootstrap_value = forward(params, batch["bootstrap_obs"])
        vs, pg_adv = vtrace(
            batch[SB.ACTION_LOGP], target_logp, batch[SB.REWARDS],
            batch[SB.DONES], values, bootstrap_value, self.gamma,
            self.clip_rho, self.clip_c)
        ent = entropy_of(logits.reshape(T * N, -1)).mean()
        return target_logp, values, vs, pg_adv, ent


class ImpalaLearner(_VtraceLearner):
    """V-trace actor-critic learner (ref: rllib/algorithms/impala/)."""

    def __init__(self, obs_dim: int, num_actions: int, *, lr: float = 5e-4,
                 gamma: float = 0.99, vf_coeff: float = 0.5,
                 entropy_coeff: float = 0.01, grad_clip: float = 40.0,
                 clip_rho: float = 1.0, clip_c: float = 1.0,
                 hiddens=(64, 64), seed: int = 0, device=None):
        super().__init__(obs_dim, num_actions, lr=lr, gamma=gamma,
                         vf_coeff=vf_coeff, entropy_coeff=entropy_coeff,
                         grad_clip=grad_clip, clip_rho=clip_rho,
                         clip_c=clip_c, hiddens=hiddens, seed=seed,
                         device=device)

    def loss(self, params, batch):
        target_logp, values, vs, pg_adv, ent = self._vtrace_terms(params,
                                                                  batch)
        pi_loss = -torch.mean(target_logp * pg_adv)
        vf_loss = 0.5 * torch.mean((values - vs) ** 2)
        total = pi_loss + self.vf_coeff * vf_loss - self.entropy_coeff * ent
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": ent}


class _LearnerActor:
    """A LearnerGroup member: builds its learner from the pickled factory
    (on its leased GPU when the learner is on the card)."""

    def __init__(self, payload):
        from ray_tpu_torch.core.serialization import loads
        self.learner = loads(payload)()

    def compute_grads(self, shard):
        return self.learner.compute_grads(shard)

    def set_weights(self, w):
        self.learner.set_weights(w)

    def get_weights(self):
        return self.learner.get_weights()

    def where(self) -> dict:
        """The learner's device and what the process sees of the cards."""
        import ray_tpu_torch
        return {"device": str(self.learner.device),
                "gpu_ids": ray_tpu_torch.get_gpu_ids(),
                "cuda_visible_devices": os.environ.get(
                    "CUDA_VISIBLE_DEVICES"),
                "device_count": torch.cuda.device_count()}

    def ping(self):
        return True


class LearnerGroup:
    """Synchronous data-parallel group over learner actors.

    Ref analog: rllib/core/learner/learner_group.py:61. ``num_learners=0``
    keeps a single local learner (in-process, on its device);
    ``num_learners>=1`` spawns learner actors that compute grads on batch
    shards, averaged here on the host and applied everywhere
    (DDP-equivalent update). A learner actor whose learner is on the card
    leases one GPU; on the CPU it leases nothing, as the reference's.
    """

    def __init__(self, make_learner, num_learners: int = 0):
        import ray_tpu_torch

        self.num_learners = num_learners
        self.local = make_learner()  # the learner, or the averaging site
        self.remotes = []
        if num_learners:
            from ray_tpu_torch.core.serialization import dumps

            gpus = 1 if self.local.device.type == "cuda" else None
            cls = ray_tpu_torch.remote(_LearnerActor)
            payload = dumps(make_learner)
            self.remotes = [cls.options(num_cpus=0, num_gpus=gpus)
                            .remote(payload) for _ in range(num_learners)]
            w = self.local.get_weights()
            ray_tpu_torch.get([r.set_weights.remote(w)
                               for r in self.remotes], timeout=300)

    def update(self, batch: SampleBatch, **kw) -> dict:
        import ray_tpu_torch

        if not self.remotes:
            return self.local.update(batch, **kw)
        n = len(self.remotes)
        size = batch.count // n
        shards = [batch.slice(i * size, (i + 1) * size) for i in range(n)]
        outs = ray_tpu_torch.get(
            [r.compute_grads.remote(s)
             for r, s in zip(self.remotes, shards)], timeout=300)
        grads = {k: np.mean([g[k] for g, _ in outs], axis=0)
                 for k in outs[0][0]}
        self.local.apply_grads(grads)
        w = self.local.get_weights()
        ray_tpu_torch.get([r.set_weights.remote(w) for r in self.remotes],
                          timeout=120)
        return outs[0][1]

    def get_weights(self):
        return self.local.get_weights()

    def set_weights(self, w):
        import ray_tpu_torch

        self.local.set_weights(w)
        if self.remotes:
            ray_tpu_torch.get([r.set_weights.remote(w)
                               for r in self.remotes], timeout=120)
