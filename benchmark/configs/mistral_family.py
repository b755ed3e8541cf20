"""Plain PyTorch reference of the Mistral family's decoder (Mistral-7B,
Mixtral-8x7B), written from the published description and imported by
nothing of the program it judges.

The block: RMSNorm (statistics in fp32, ``x * rsqrt(mean(x^2) + eps)``,
then times gamma in the compute dtype), rotary embeddings on q and k
(inverse frequencies ``theta^(-2i/hd)``, halves rotated as
``[x1 cos - x2 sin, x2 cos + x1 sin]``, computed in fp32), grouped-query
attention (each kv head serves ``H/KV`` consecutive query heads), causal,
scores and softmax in fp32; SwiGLU ``w_down(silu(x w_gate) * (x w_up))``;
an untied LM head in fp32. Mixtral's FFN: router softmax over all experts
(in fp32), the top ``k`` renormalised to sum to 1, each token's output the
weighted sum of its ``k`` experts' SwiGLU, nothing dropped. Departures
from the published implementation: the router product and the rotary
embedding run in fp32 where it runs them in bf16 (more precise, not less).

``compute`` is the dtype of the matmul operands: the configuration's
``torch_dtype`` for training, fp32 for the serving check. ``fp8=True`` is
the control: every matmul operand rounded to float8 e4m3 with a per-tensor
scale first (in a backward, the incoming gradient to e5m2), the step that
would tempt a program below a bf16 configuration.

Weights come from ``benchmark.weights`` (the run's seed), in the stacked
layout; the model takes one dict of tensors per layer.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _round(x, fmt, top):
    scale = x.detach().abs().amax().float().clamp(min=1e-12) / top
    return ((x.float() / scale).to(fmt).float() * scale).to(x.dtype)


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)


def split_layers(params: dict, n_layers: int) -> List[Dict[str, torch.Tensor]]:
    """The stacked ``layers`` leaves as one dict of views per layer."""
    return [{k: w[i] for k, w in params["layers"].items()}
            for i in range(n_layers)]


class Model:
    def __init__(self, cfg: dict, embed, layers: List[dict], final_norm,
                 lm_head, compute=torch.bfloat16, fp8: bool = False,
                 attn_block: int = 512, remat: bool = False):
        self.cfg = cfg
        self.d = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.KV = cfg.get("num_key_value_heads") or self.H
        self.hd = cfg.get("head_dim") or self.d // self.H
        self.E = cfg.get("num_local_experts") or 0
        self.k = cfg.get("num_experts_per_tok") or 0
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]
        self.embed, self.layers = embed, layers
        self.final_norm, self.lm_head = final_norm, lm_head
        self.ct, self.fp8 = compute, fp8
        self.block, self.remat = attn_block, remat

    # ---- pieces ----------------------------------------------------------
    def _q(self, x):
        return _FP8.apply(x) if self.fp8 else x

    def mm(self, x, w, dtype=None):
        dt = dtype or self.ct
        return self._q(x.to(dt)) @ self._q(w.to(dt))

    def norm(self, x, gamma):
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return x32.to(self.ct) * gamma.to(self.ct)

    def rope(self, x, pos):
        half = self.hd // 2
        inv = self.theta ** (-torch.arange(0, half, dtype=torch.float32,
                                           device=x.device) * 2 / self.hd)
        ang = pos.float()[:, None] * inv[None]
        cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(self.ct)

    def attention(self, q, k, v):
        """q [B, T, H, hd], k/v [B, T, KV, hd] -> [B, T, H, hd]; causal,
        scores, softmax and the products in fp32, by blocks of queries."""
        B, T = q.shape[:2]
        reps = self.H // self.KV
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
        q, k, v = (self._q(t).float().transpose(1, 2) for t in (q, k, v))
        scale = self.hd ** -0.5
        outs = []
        for s in range(0, T, self.block):
            e = min(T, s + self.block)
            sc = (q[:, :, s:e] @ k[:, :, :e].transpose(-1, -2)) * scale
            keep = (torch.arange(s, e, device=q.device)[:, None]
                    >= torch.arange(e, device=q.device)[None, :])
            sc = sc.masked_fill(~keep, float("-inf"))
            p = torch.softmax(sc, dim=-1)
            outs.append(self._q(p) @ v[:, :, :e])
        o = torch.cat(outs, dim=2).transpose(1, 2)
        return o.to(self.ct)

    def swiglu(self, x, wg, wu, wd):
        return self.mm(F.silu(self.mm(x, wg)) * self.mm(x, wu), wd)

    def moe(self, h, lp):
        """h [N, d] -> [N, d]: top-k experts of each token, renormalised."""
        probs = torch.softmax(self.mm(h, lp["router"], torch.float32), -1)
        top_p, top_i = torch.topk(probs, self.k, dim=-1)
        top_p = top_p / top_p.sum(-1, keepdim=True)
        y = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        for e in range(self.E):
            rows, slot = torch.nonzero(top_i == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            out = self.swiglu(h[rows], lp["w_gate"][e], lp["w_up"][e],
                              lp["w_down"][e])
            y = y.index_add(0, rows, out.float() * top_p[rows, slot, None])
        return y.to(self.ct)

    def block_fn(self, x, lp, pos):
        B, T, d = x.shape
        h = self.norm(x, lp["attn_norm"]).reshape(B * T, d)
        q = self.mm(h, lp["wq"].reshape(d, -1)).reshape(B, T, self.H, self.hd)
        k = self.mm(h, lp["wk"].reshape(d, -1)).reshape(B, T, self.KV,
                                                         self.hd)
        v = self.mm(h, lp["wv"].reshape(d, -1)).reshape(B, T, self.KV,
                                                         self.hd)
        o = self.attention(self.rope(q, pos), self.rope(k, pos), v)
        x = x + self.mm(o.reshape(B * T, -1),
                        lp["wo"].reshape(-1, d)).reshape(B, T, d)
        h = self.norm(x, lp["mlp_norm"]).reshape(B * T, d)
        if self.E:
            f = self.moe(h, lp)
        else:
            f = self.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
        return x + f.reshape(B, T, d)

    # ---- the model -------------------------------------------------------
    def hidden(self, tokens):
        """tokens [B, T] -> the last layer's output [B, T, d]."""
        x = self.embed[tokens].to(self.ct)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        for lp in self.layers:
            if self.remat and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint

                x = checkpoint(self.block_fn, x, lp, pos, use_reentrant=False)
            else:
                x = self.block_fn(x, lp, pos)
        return x

    def logits(self, x):
        """Final norm and the LM head in fp32: x [..., d] -> [..., V]."""
        h = self.norm(x, self.final_norm)
        return self.mm(h, self.lm_head, torch.float32)

    def loss(self, inputs, targets):
        """Mean next-token cross entropy over every position, fp32."""
        lg = self.logits(self.hidden(inputs))
        lg = lg.reshape(-1, lg.shape[-1])
        t = targets.reshape(-1, 1).long()
        return (torch.logsumexp(lg, -1) - lg.gather(1, t)[:, 0]).mean()


def model_from_params(cfg: dict, params: dict, **kw) -> Model:
    return Model(cfg, params["embed"],
                 split_layers(params, cfg["num_hidden_layers"]),
                 params["final_norm"], params["lm_head"], **kw)


# ---- serving: the gap of each served token below the reference's best -------

@torch.no_grad()
def served_gaps(model: Model, prompt: Sequence[int], served: Sequence[int],
                control: Optional[Model] = None):
    """For each served token i (greedy), the reference's best logit at its
    position minus the reference's logit of that token: 0 where the served
    token is the reference's own choice. With ``control``, the gap of the
    token ``control`` puts first instead. -> [len(served)] fp32."""
    dev = model.embed.device
    seq = torch.tensor(list(prompt) + list(served[:-1]), device=dev)[None]
    first = len(prompt) - 1
    ref = model.logits(model.hidden(seq)[0, first:]).float()
    if control is None:
        pick = torch.tensor(list(served), device=dev)
    else:
        pick = control.logits(control.hidden(seq)[0, first:]).argmax(-1)
    return ref.max(-1).values - ref.gather(1, pick[:, None])[:, 0]


# ---- training: three steps of the configuration's AdamW ---------------------

def _w(x: float, dtype) -> float:
    """A Python scalar rounded to ``dtype`` before it multiplies, as the
    optimizer's definition (optax under JAX's weak typing) computes."""
    return torch.tensor(x, dtype=dtype).item()


_STACKED = ("attn_norm", "mlp_norm", "w_down", "w_gate", "w_up", "wk", "wo",
            "wq", "wv", "router")


def _tree_order(names: Sequence[str]) -> List[str]:
    """Leaf names in the order the optimizer sums the global norm: sorted
    keys, depth first (``embed``, ``final_norm``, ``layers/...``,
    ``lm_head``)."""
    top = sorted({n.split("/")[0] for n in names})
    out = []
    for t in top:
        out += sorted(n for n in names if n.split("/")[0] == t)
    return out


def train_steps(cfg: dict, params: dict, batches, opt: dict,
                remake: Callable[[str], torch.Tensor],
                compute=torch.bfloat16, fp8: bool = False,
                attn_block: int = 1024) -> dict:
    """``len(batches)`` steps of clip-by-global-norm + AdamW from
    ``params`` (the stacked tree, consumed: its layer leaves are split into
    per-layer tensors and dropped). ``batches``: [(inputs, targets)], each
    [B, T]. ``remake(name)`` gives a starting leaf again, stacked.

    -> {"loss": [per step], "grad_norm": the first step's global norm,
    "grad": {leaf: norm of the first step's clipped gradient, as the first
    moment holds it, divided by (1 - b1)}, "change": {leaf: norm of the
    weights' change after the last step}}, leaves named as ``benchmark.
    weights`` names them."""
    L = cfg["num_hidden_layers"]
    leaves: Dict[str, List[torch.Tensor]] = {}
    for name in ("embed", "final_norm", "lm_head"):
        leaves[name] = [params.pop(name).detach().requires_grad_(True)]
    stacked = params.pop("layers")
    for key in sorted(stacked):
        w = stacked.pop(key)
        leaves[f"layers/{key}"] = [w[i].clone().requires_grad_(True)
                                   for i in range(L)]
        del w
    order = _tree_order(list(leaves))
    flat = [t for n in order for t in leaves[n]]
    model = Model(cfg, leaves["embed"][0],
                  [{k.split("/")[1]: leaves[k][i] for k in leaves
                    if k.startswith("layers/")} for i in range(L)],
                  leaves["final_norm"][0], leaves["lm_head"][0],
                  compute=compute, fp8=fp8, attn_block=attn_block,
                  remat=True)
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd, clip = opt["learning_rate"], opt["weight_decay"], opt["grad_clip"]
    mu_dt = {"bfloat16": torch.bfloat16, None: None}[opt.get("mu_dtype")]
    mu = [torch.zeros_like(p, dtype=mu_dt or p.dtype) for p in flat]
    nu = [torch.zeros_like(p) for p in flat]
    out = {"loss": [], "grad_norm": None, "grad": {}, "change": {}}
    for count, (inputs, targets) in enumerate(batches, start=1):
        with torch.enable_grad():
            loss = model.loss(inputs, targets)
            grads = list(torch.autograd.grad(loss, flat))
        out["loss"].append(loss.item())
        # global norm: each leaf's sum of squares in its dtype, added in order
        total = None
        i = 0
        for n in order:
            parts = leaves[n]
            sq = sum((g.float() * g.float()).sum()
                     for g in grads[i:i + len(parts)])
            sq = sq.to(grads[i].dtype)
            total = sq if total is None else total + sq
            i += len(parts)
        g_norm = torch.sqrt(total)
        if count == 1:
            out["grad_norm"] = g_norm.item()
        c = torch.tensor(float(count))
        bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** c).item()
        bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** c).item()
        with torch.no_grad():
            for j, (g, p) in enumerate(zip(grads, flat)):
                dt = g.dtype
                if clip is not None and not bool(g_norm < clip):
                    g = (g / g_norm.to(dt)) * _w(clip, dt)
                m = _w(1 - b1, dt) * g + _w(b1, mu[j].dtype) * mu[j]
                v = _w(1 - b2, dt) * (g * g) + _w(b2, nu[j].dtype) * nu[j]
                m_hat = m / _w(bc1, m.dtype)
                v_hat = v / _w(bc2, v.dtype)
                u = m_hat / (torch.sqrt(v_hat) + _w(eps, v_hat.dtype))
                mu[j] = m.to(mu_dt) if mu_dt is not None else m
                nu[j] = v
                u = u + _w(wd, p.dtype) * p
                u = _w(-lr, u.dtype) * u
                p.copy_((p + u).to(p.dtype))
        del grads
        if count == 1:
            i = 0
            one_m_b1 = _w(1 - b1, mu[0].dtype)
            for n in order:
                k = len(leaves[n])
                sq = sum((m.float() ** 2).sum() for m in mu[i:i + k])
                out["grad"][n] = math.sqrt(sq.item()) / one_m_b1
                i += k
    with torch.no_grad():
        for n in order:
            start = remake(n)
            now = torch.stack(leaves[n]) if n.startswith("layers/") \
                else leaves[n][0]
            out["change"][n] = torch.linalg.vector_norm(
                now.float() - start.reshape(now.shape).float()).item()
            del start
    return out
