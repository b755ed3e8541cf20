"""DreamerV3: world-model RL — learn in imagination (Hafner et al. 2023).

Ref analog: rllib/algorithms/dreamerv3/ (the reference's TF
implementation of the same paper). The whole update — RSSM world model
(GRU recurrence + categorical latents with straight-through gradients,
symlog decoder/reward heads, KL balancing with free bits), imagination
rollout under the prior, symlog critic with an EMA target, and a
REINFORCE actor with return normalization — runs on the learner's device
(the card unless the caller asks for the CPU) over a batch of replayed
subsequences. The posterior unroll over real steps, the imagination
unroll over horizon steps and the lambda-return recursion are Python
loops, one step of ops a turn. The host side only steps the (CPU)
environment and maintains the sequence replay buffer; acting runs the
learner's ``act`` on its device.

Every categorical draw (posterior and imagined latents, imagined and
acted actions) is ``argmax(logits + g)`` on Gumbel noise ``g`` from the
learner's ``torch.Generator``, passed into the step, so a test can hand
two implementations the same draws.

Sized-down defaults (MLP encoder, 8x8 categorical latent) target the
CI-class envs in ``env.py``; the architecture is the paper's.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device

from .algorithm import Algorithm, AlgorithmConfig
from .env import make_env
from .learner import adam, detached, value_and_grad
from .models import (categorical_from_gumbel, clone_tree, gumbel,
                     params_from_numpy, polyak_, seeded, to_numpy)

# ------------------------------------------------------------ utilities


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def _lin(gen: torch.Generator, i: int, o: int) -> dict:
    """A Glorot-uniform layer {"w" [i, o], "b" [o]}."""
    limit = math.sqrt(6.0 / (i + o))
    w = (torch.rand((i, o), generator=gen) * 2.0 - 1.0) * limit
    return {"w": w, "b": torch.zeros(o)}


def mlp(p, n1: str, n2: str, x):
    x = F.silu(x @ p[n1]["w"] + p[n1]["b"])
    return x @ p[n2]["w"] + p[n2]["b"]


class DreamerLearner:
    """The world-model + actor-critic update on one device."""

    def __init__(self, obs_dim: int, num_actions: int, *,
                 deter: int = 128, groups: int = 8, classes: int = 8,
                 hidden: int = 128, horizon: int = 15,
                 gamma: float = 0.985, lam: float = 0.95,
                 wm_lr: float = 3e-4, ac_lr: float = 3e-4,
                 entropy_coef: float = 1e-3, free_bits: float = 1.0,
                 seed: int = 0, device=None):
        self.device = dev = resolve_device(device)
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.deter = deter
        self.groups = groups
        self.classes = classes
        self.stoch = groups * classes
        self.horizon = horizon
        self.gamma = gamma
        self.lam = lam
        self.entropy_coef = entropy_coef
        self.free_bits = free_bits

        gen = seeded(seed)
        h, D, S, A = hidden, deter, self.stoch, num_actions
        wm = {}
        for name, i, o in (
                ("enc1", obs_dim, h), ("enc2", h, h),
                # GRU over [stoch, action] -> deter
                ("gru_x", S + A, 3 * D), ("gru_h", D, 3 * D),
                ("prior1", D, h), ("prior2", h, S),
                ("post1", D + h, h), ("post2", h, S),
                ("dec1", D + S, h), ("dec2", h, obs_dim),
                ("rew1", D + S, h), ("rew2", h, 1),
                ("cont1", D + S, h), ("cont2", h, 1)):
            wm[name] = _lin(gen, i, o)
        ac = {}
        for name, i, o in (("actor1", D + S, h), ("actor2", h, A),
                           ("critic1", D + S, h), ("critic2", h, 1)):
            ac[name] = _lin(gen, i, o)
        wm = {k: {n: v.to(dev) for n, v in p.items()} for k, p in wm.items()}
        ac = {k: {n: v.to(dev) for n, v in p.items()} for k, p in ac.items()}
        # chain(clip_by_global_norm(100), adam(lr)), one for each net
        self.wm_tx = adam(wm_lr, 100.0)
        self.ac_tx = adam(ac_lr, 100.0)
        self._state = {
            "wm": wm, "ac": ac, "target": clone_tree(ac),
            "wm_opt": self.wm_tx.init(wm), "ac_opt": self.ac_tx.init(ac),
            # running return-scale for actor normalization (paper: S)
            "ret_scale": torch.ones((), device=dev),
        }
        self._gen = torch.Generator(dev).manual_seed(int(seed) + 1)

    # ------------------------------------------------------------ nets

    def gru(self, p, hprev, x):
        D = self.deter
        gx = x @ p["gru_x"]["w"] + p["gru_x"]["b"]
        gh = hprev @ p["gru_h"]["w"] + p["gru_h"]["b"]
        r = torch.sigmoid(gx[..., :D] + gh[..., :D])
        z = torch.sigmoid(gx[..., D:2 * D] + gh[..., D:2 * D])
        n = torch.tanh(gx[..., 2 * D:] + r * gh[..., 2 * D:])
        return (1 - z) * n + z * hprev

    def _probs(self, logits):
        """The paper's 1% uniform mix, per group -> (probs [..., G, C],
        mixed logits flat [..., S])."""
        G, C = self.groups, self.classes
        lg = logits.reshape(logits.shape[:-1] + (G, C))
        probs = 0.99 * torch.softmax(lg, dim=-1) + 0.01 / C
        return probs, torch.log(probs).reshape(logits.shape)

    def sample_latent(self, logits, g):
        """Straight-through categorical sample per group on Gumbel noise
        ``g`` [..., G, C] -> (sample flat [..., S], mixed logits)."""
        G, C = self.groups, self.classes
        probs, lg = self._probs(logits)
        idx = categorical_from_gumbel(lg.reshape(probs.shape), g)
        onehot = F.one_hot(idx, C).to(probs.dtype)
        st = onehot + probs - probs.detach()
        return st.reshape(logits.shape[:-1] + (G * C,)), lg

    def kl(self, lhs_logits, rhs_logits):
        """KL(lhs || rhs) summed over groups; inputs already mixed."""
        G, C = self.groups, self.classes
        a = lhs_logits.reshape(lhs_logits.shape[:-1] + (G, C))
        b = rhs_logits.reshape(rhs_logits.shape[:-1] + (G, C))
        pa = torch.softmax(a, dim=-1)
        return torch.sum(pa * (torch.log_softmax(a, dim=-1)
                               - torch.log_softmax(b, dim=-1)),
                         dim=(-2, -1))

    def observe(self, wm, obs_seq, act_seq, post_g):
        """Posterior unroll over a real subsequence, a loop over L.

        obs_seq [B,L,obs], act_seq [B,L,A] (action taken AT each step),
        post_g [L, B, G, C]. Returns deter/stoch/prior/post logits per
        step, [B, L, ...]."""
        B, L = obs_seq.shape[0], obs_seq.shape[1]
        embed = mlp(wm, "enc1", "enc2", symlog(obs_seq))
        h = obs_seq.new_zeros((B, self.deter))
        s = obs_seq.new_zeros((B, self.stoch))
        hs, ss, priors, posts = [], [], [], []
        for t in range(L):
            h = self.gru(wm, h, torch.cat([s, act_seq[:, t]], -1))
            prior_logits = mlp(wm, "prior1", "prior2", h)
            post_logits = mlp(wm, "post1", "post2",
                              torch.cat([h, embed[:, t]], -1))
            s, post_lg = self.sample_latent(post_logits, post_g[t])
            hs.append(h)
            ss.append(s)
            priors.append(self._probs(prior_logits)[1])
            posts.append(post_lg)
        stack = lambda xs: torch.stack(xs, dim=1)  # noqa: E731
        return stack(hs), stack(ss), stack(priors), stack(posts)

    def wm_loss(self, wm, obs, act, rew, cont, post_g):
        hs, ss, prior_lg, post_lg = self.observe(wm, obs, act, post_g)
        feat = torch.cat([hs, ss], -1)
        recon = mlp(wm, "dec1", "dec2", feat)
        rloss = torch.mean(torch.sum((recon - symlog(obs)) ** 2, -1))
        rpred = mlp(wm, "rew1", "rew2", feat)[..., 0]
        rew_loss = torch.mean((rpred - symlog(rew)) ** 2)
        cpred = mlp(wm, "cont1", "cont2", feat)[..., 0]
        cont_loss = torch.mean(
            torch.clamp(cpred, min=0) - cpred * cont
            + torch.log1p(torch.exp(-torch.abs(cpred))))
        fb = self.free_bits
        dyn = torch.clamp(torch.mean(self.kl(post_lg.detach(), prior_lg)),
                          min=fb)
        rep = torch.clamp(torch.mean(self.kl(post_lg, prior_lg.detach())),
                          min=fb)
        loss = rloss + rew_loss + cont_loss + 0.5 * dyn + 0.1 * rep
        return loss, (hs, ss, rloss, rew_loss, dyn)

    def imagine(self, wm, ac, h0, s0, act_g, img_g):
        """Roll the prior forward under the actor for H steps from every
        posterior state (flattened starts [N, ...]), a loop over H; act_g
        [H, N, A], img_g [H, N, G, C] -> feats, actions, logits [H, N, ...].
        """
        h, s = h0, s0
        feats, acts, logitss = [], [], []
        for t in range(self.horizon):
            feat = torch.cat([h, s], -1)
            logits = mlp(ac, "actor1", "actor2", feat)
            a = categorical_from_gumbel(logits.detach(), act_g[t])
            aoh = F.one_hot(a, self.num_actions).to(feat.dtype)
            h = self.gru(wm, h, torch.cat([s, aoh], -1))
            s, _ = self.sample_latent(mlp(wm, "prior1", "prior2", h),
                                      img_g[t])
            feats.append(feat)
            acts.append(a)
            logitss.append(logits)
        return torch.stack(feats), torch.stack(acts), torch.stack(logitss)

    def lambda_returns(self, rew, disc, tvalues):
        """R_t = r_{t+1} + d_{t+1} ((1-lam) v_{t+1} + lam R_{t+1}), a
        reverse loop from H-2 bootstrapping from the successor (same-step
        bootstrapping double-counts the current state and was measured
        leaving the actor at max entropy) -> [H-1, N]."""
        lam = self.lam
        nxt = tvalues[-1]
        rets = [None] * (self.horizon - 1)
        for t in range(self.horizon - 2, -1, -1):
            nxt = rew[t + 1] + disc[t + 1] * (
                (1 - lam) * tvalues[t + 1] + lam * nxt)
            rets[t] = nxt
        return torch.stack(rets)

    def ac_loss(self, ac, wm, target, ret_scale, h0, s0, act_g, img_g):
        wm = detached(wm)
        feats, acts, logitss = self.imagine(wm, ac, h0, s0, act_g, img_g)
        rew = symexp(mlp(wm, "rew1", "rew2", feats)[..., 0])
        cont = torch.sigmoid(mlp(wm, "cont1", "cont2", feats)[..., 0])
        disc = self.gamma * cont
        with torch.no_grad():
            tvalues = symexp(mlp(target, "critic1", "critic2",
                                 feats)[..., 0])  # [H, N]
            rets = self.lambda_returns(rew, disc, tvalues)
        # critic: symlog regression toward lambda-returns
        vpred = mlp(ac, "critic1", "critic2", feats[:-1])[..., 0]
        critic_loss = torch.mean((vpred - symlog(rets)) ** 2)
        # actor: REINFORCE on normalized advantage + entropy
        scale = torch.clamp(ret_scale, min=1.0)
        adv = ((rets - tvalues[:-1]) / scale).detach()
        logp = torch.log_softmax(logitss[:-1], dim=-1)
        taken = torch.gather(logp, -1, acts[:-1][..., None])[..., 0]
        probs = torch.softmax(logitss[:-1], dim=-1)
        ent = -torch.mean(torch.sum(probs * logp, -1))
        actor_loss = -torch.mean(taken * adv) - self.entropy_coef * ent
        # jnp.percentile: linear interpolation over the flattened returns
        flat = rets.reshape(-1)
        new_scale = (torch.quantile(flat, 0.95, interpolation="linear")
                     - torch.quantile(flat, 0.05, interpolation="linear"))
        return actor_loss + critic_loss, (
            critic_loss, actor_loss, ent, torch.mean(rets), new_scale)

    # ------------------------------------------------------------ update

    def draw_noise(self, B: int, L: int) -> Dict[str, torch.Tensor]:
        """Gumbel noise for one update: the posterior latents [L, B, G,
        C], the imagined actions [H, N, A] and latents [H, N, G, C],
        N = B L."""
        G, C, H, N = self.groups, self.classes, self.horizon, B * L
        return {"post": gumbel((L, B, G, C), self._gen),
                "act": gumbel((H, N, self.num_actions), self._gen),
                "img": gumbel((H, N, G, C), self._gen)}

    def train_step(self, obs, act_idx, rew, cont, noise) -> tuple:
        """One update on tensors on the device: obs [B, L, obs], act_idx
        [B, L] (the action taken AT each step), rew, cont [B, L] ->
        (metrics, grads {"wm", "ac"}). The world model steps first; the
        actor-critic loss then imagines on the UPDATED world model from
        the posterior states of the old one."""
        st = self._state
        D, S = self.deter, self.stoch
        # the transition INTO step t is driven by the action taken at
        # t-1; the buffer stores the action taken AT t
        taken = F.one_hot(act_idx.long(), self.num_actions).to(obs.dtype)
        act = torch.cat([torch.zeros_like(taken[:, :1]), taken[:, :-1]],
                        dim=1)
        wl, (hs, ss, rloss, rew_loss, dyn), gw = value_and_grad(
            self.wm_loss, st["wm"], obs, act, rew, cont, noise["post"])
        self.wm_tx.step_(gw, st["wm_opt"], st["wm"])
        h0 = hs.reshape(-1, D)
        s0 = ss.reshape(-1, S)
        al, (cl, aol, ent, mret, new_scale), ga = value_and_grad(
            self.ac_loss, st["ac"], st["wm"], st["target"],
            st["ret_scale"], h0, s0, noise["act"], noise["img"])
        self.ac_tx.step_(ga, st["ac_opt"], st["ac"])
        polyak_(st["target"], st["ac"], 0.02)
        st["ret_scale"] = 0.99 * st["ret_scale"] + 0.01 * new_scale
        metrics = {"wm_loss": wl, "recon_loss": rloss,
                   "reward_loss": rew_loss, "kl_dyn": dyn,
                   "critic_loss": cl, "actor_loss": aol,
                   "entropy": ent, "imag_return_mean": mret}
        return metrics, {"wm": gw, "ac": ga}

    def to_device(self, obs, actions, rewards, continues):
        dev = self.device
        return (torch.as_tensor(np.asarray(obs, np.float32), device=dev),
                torch.as_tensor(np.asarray(actions, np.int64), device=dev),
                torch.as_tensor(np.asarray(rewards, np.float32), device=dev),
                torch.as_tensor(np.asarray(continues, np.float32),
                                device=dev))

    def update(self, obs, actions, rewards, continues) -> Dict[str, float]:
        batch = self.to_device(obs, actions, rewards, continues)
        B, L = batch[1].shape
        metrics, _ = self.train_step(*batch, self.draw_noise(B, L))
        return {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------ acting

    def init_policy_state(self):
        z = lambda n: torch.zeros((1, n), device=self.device)  # noqa: E731
        return z(self.deter), z(self.stoch), z(self.num_actions)

    def policy_step(self, wm, ac, h, s, obs, aprev, g_latent, g_act,
                    greedy: bool):
        """Posterior filter for one env step (batch 1), on given Gumbel
        noise for the latent [1, G, C] and the action [1, A]."""
        embed = mlp(wm, "enc1", "enc2", symlog(obs))
        h = self.gru(wm, h, torch.cat([s, aprev], -1))
        post_logits = mlp(wm, "post1", "post2", torch.cat([h, embed], -1))
        s, _ = self.sample_latent(post_logits, g_latent)
        logits = mlp(ac, "actor1", "actor2", torch.cat([h, s], -1))
        a = (torch.argmax(logits, -1) if greedy
             else categorical_from_gumbel(logits, g_act))
        return h, s, a

    @torch.no_grad()
    def act(self, pol_state, obs, greedy: bool = False):
        h, s, _aprev = pol_state
        g_latent = gumbel((1, self.groups, self.classes), self._gen)
        g_act = gumbel((1, self.num_actions), self._gen)
        obs = torch.as_tensor(np.asarray(obs, np.float32),
                              device=self.device)[None]
        h, s, a = self.policy_step(self._state["wm"], self._state["ac"], h,
                                   s, obs, pol_state[2], g_latent, g_act,
                                   greedy)
        action = int(a[0])
        aoh = torch.zeros((1, self.num_actions), device=self.device)
        aoh[0, action] = 1.0
        return (h, s, aoh), action


# --------------------------------------------------------------- replay


class SequenceBuffer:
    """Ring buffer of (obs, action, reward, continue) steps; samples
    fixed-length subsequences for the world model."""

    def __init__(self, capacity: int, obs_dim: int, seed: int = 0):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.act = np.zeros(capacity, np.int32)
        self.rew = np.zeros(capacity, np.float32)
        self.cont = np.ones(capacity, np.float32)
        self.idx = 0
        self.full = False
        self._rng = np.random.default_rng(seed)

    def add(self, obs, action, reward, cont):
        i = self.idx
        self.obs[i] = obs
        self.act[i] = action
        self.rew[i] = reward
        self.cont[i] = cont
        self.idx = (i + 1) % self.capacity
        self.full = self.full or self.idx == 0

    def __len__(self):
        return self.capacity if self.full else self.idx

    def sample(self, batch: int, length: int):
        n = len(self)
        # logical time order starts at the write head once the ring has
        # wrapped — physical windows crossing the seam would stitch the
        # newest steps onto the oldest with no cont=0 separator
        base = self.idx if self.full else 0
        starts = self._rng.integers(0, n - length + 1, batch)
        sel = (base + starts[:, None]
               + np.arange(length)[None, :]) % self.capacity
        return (self.obs[sel], self.act[sel], self.rew[sel],
                self.cont[sel])


# ------------------------------------------------------------ algorithm


class DreamerV3Config(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DreamerV3)
        self.env = "CartPole-v1"
        self.batch_size = 16
        self.seq_length = 32
        self.replay_capacity = 50_000
        self.env_steps_per_iter = 500
        self.updates_per_iter = 8
        self.warmup_steps = 1000
        self.horizon = 15
        self.deter = 128
        self.hidden = 128
        self.train_ratio_note = ("updates_per_iter/env_steps_per_iter "
                                 "is the paper's train ratio knob")


class DreamerV3(Algorithm):
    """Single-process Dreamer: the env is cheap and the learner acts on
    its own device; rollout actors would add only IPC here (the
    reference's DreamerV3 likewise defaults to 0 rollout workers)."""

    _config_cls = DreamerV3Config

    def setup(self, config: dict):
        cfg = config.get("__algo_config__") or self.get_default_config()
        cfg = cfg.copy()
        cfg.update_from_dict(
            {k: v for k, v in config.items() if k != "__algo_config__"})
        self.algo_config = cfg
        resolve_device(cfg.device)
        self.env = make_env(cfg.env)
        self.learner = DreamerLearner(
            self.env.observation_dim, self.env.num_actions,
            deter=cfg.deter, hidden=cfg.hidden, horizon=cfg.horizon,
            seed=cfg.seed, device=cfg.device)
        self.buffer = SequenceBuffer(cfg.replay_capacity,
                                     self.env.observation_dim,
                                     seed=cfg.seed)
        self._obs = self.env.reset(seed=cfg.seed)
        self._pol = self.learner.init_policy_state()
        self._episode_return = 0.0
        self._episode_returns: list = []
        self._num_env_steps = 0

    def training_step(self) -> dict:
        cfg = self.algo_config
        for _ in range(cfg.env_steps_per_iter):
            if self._num_env_steps < cfg.warmup_steps:
                action = int(np.random.default_rng(
                    self._num_env_steps).integers(self.env.num_actions))
            else:
                self._pol, action = self.learner.act(self._pol, self._obs)
            nxt, rew, done, info = self.env.step(action)
            truncated = bool(info.get("truncated"))
            self.buffer.add(self._obs, action, rew,
                            0.0 if (done and not truncated) else 1.0)
            self._episode_return += rew
            self._num_env_steps += 1
            if done:
                self._episode_returns.append(self._episode_return)
                self._episode_return = 0.0
                self._obs = self.env.reset()
                self._pol = self.learner.init_policy_state()
            else:
                self._obs = nxt
        metrics: dict = {}
        if len(self.buffer) > max(cfg.warmup_steps,
                                  cfg.seq_length * cfg.batch_size // 4):
            for _ in range(cfg.updates_per_iter):
                obs, act, rew, cont = self.buffer.sample(
                    cfg.batch_size, cfg.seq_length)
                metrics = self.learner.update(obs, act, rew, cont)
        metrics["env_steps_this_iter"] = cfg.env_steps_per_iter
        if self._episode_returns:
            recent = self._episode_returns[-20:]
            metrics["episode_reward_mean"] = float(np.mean(recent))
        return metrics

    def step(self) -> dict:
        metrics = self.training_step()
        metrics["num_env_steps_sampled"] = self._num_env_steps
        return metrics

    def evaluate(self, episodes: int = 5) -> float:
        """Greedy-policy mean return."""
        total = 0.0
        for e in range(episodes):
            obs = self.env.reset(seed=10_000 + e)
            pol = self.learner.init_policy_state()
            done, ret = False, 0.0
            while not done:
                pol, action = self.learner.act(pol, obs, greedy=True)
                obs, rew, done, _ = self.env.step(action)
                ret += rew
            total += ret
        self._obs = self.env.reset()
        self._pol = self.learner.init_policy_state()
        return total / episodes

    def save_checkpoint(self):
        return {"state": to_numpy(self.learner._state),
                "num_env_steps": self._num_env_steps}

    def load_checkpoint(self, checkpoint):
        if checkpoint:
            self.learner._state = params_from_numpy(checkpoint["state"],
                                                    self.learner.device)
            self._num_env_steps = checkpoint.get("num_env_steps", 0)

    def cleanup(self):
        pass
