"""APPO: asynchronous PPO — IMPALA's pipelined sampling with the PPO
clipped-surrogate loss over V-trace-corrected advantages.

Ref analogs: rllib/algorithms/appo/appo.py (APPOConfig: use_kl_loss /
clip_param on top of ImpalaConfig) and appo_torch_policy.py's loss:
ratio = pi/behaviour, surrogate clipped at 1±clip, advantages and value
targets from V-trace (asynchronous off-policy data). The learner is
ImpalaLearner's shape with this loss; the async rollout pipeline is
inherited from IMPALA.
"""

from __future__ import annotations

import torch

from . import sample_batch as SB
from .impala import IMPALA, IMPALAConfig
from .learner import _VtraceLearner, normalized


class APPOConfig(IMPALAConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or APPO)
        self.clip_param = 0.2
        self.lr = 5e-4


class APPOLearner(_VtraceLearner):
    """V-trace advantages + PPO ratio clip in one update step."""

    def __init__(self, obs_dim: int, num_actions: int, *, lr: float = 5e-4,
                 gamma: float = 0.99, clip_param: float = 0.2,
                 vf_coeff: float = 0.5, entropy_coeff: float = 0.01,
                 grad_clip: float = 40.0, clip_rho: float = 1.0,
                 clip_c: float = 1.0, hiddens=(64, 64), seed: int = 0,
                 device=None):
        super().__init__(obs_dim, num_actions, lr=lr, gamma=gamma,
                         vf_coeff=vf_coeff, entropy_coeff=entropy_coeff,
                         grad_clip=grad_clip, clip_rho=clip_rho,
                         clip_c=clip_c, hiddens=hiddens, seed=seed,
                         device=device)
        self.clip_param = clip_param

    def loss(self, params, batch):
        target_logp, values, vs, pg_adv, ent = self._vtrace_terms(params,
                                                                  batch)
        adv = normalized(pg_adv)
        ratio = torch.exp(target_logp - batch[SB.ACTION_LOGP])
        c = self.clip_param
        surr = torch.minimum(ratio * adv,
                             torch.clamp(ratio, 1 - c, 1 + c) * adv)
        pi_loss = -surr.mean()
        vf_loss = 0.5 * torch.mean((values - vs) ** 2)
        total = pi_loss + self.vf_coeff * vf_loss - self.entropy_coeff * ent
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": ent, "mean_ratio": torch.mean(ratio)}


class APPO(IMPALA):
    """IMPALA's async pipeline, APPO's clipped loss."""

    _config_cls = APPOConfig

    def _make_learner_factory(self, cfg, obs_dim, num_actions):
        def make():
            return APPOLearner(
                obs_dim, num_actions, lr=cfg.lr, gamma=cfg.gamma,
                clip_param=cfg.clip_param, vf_coeff=cfg.vf_coeff,
                entropy_coeff=cfg.entropy_coeff, grad_clip=cfg.grad_clip,
                clip_rho=cfg.clip_rho, clip_c=cfg.clip_c,
                hiddens=cfg.model_hiddens, seed=cfg.seed, device=cfg.device)

        return make
