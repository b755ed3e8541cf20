"""Stage programs of the port's pipeline tests (tests/test_torch_train_
pipeline*.py), in a module without JAX, so the stage actors that unpickle
them load only torch. They pickle by value: a remote node agent's workers
cannot import this module (their path holds only the package's parent)."""

import sys
import time

import cloudpickle

import numpy as np
import torch

from ray_tpu_torch.train import pipeline as pl

ACT_N = 70000  # ~280 KiB fp32 activation: plasma-resident (> inline cap)


def mk_raw_stages(n_stages, fwd_s=0.0, bwd_s=0.0):
    def fwd_mid(params, x):
        if fwd_s:
            time.sleep(fwd_s)
        a = x if isinstance(x, np.ndarray) else np.full(
            ACT_N, float(x), np.float32)
        return a + 1.0, None

    def fwd_last(params, x):
        if fwd_s:
            time.sleep(fwd_s)
        return float(np.asarray(x).ravel()[0]), None

    def bwd_mid(params, saved, g):
        if bwd_s:
            time.sleep(bwd_s)
        return None, (g if isinstance(g, np.ndarray)
                      else np.ones(ACT_N, np.float32))

    def bwd_first(params, saved, g):
        if bwd_s:
            time.sleep(bwd_s)
        return None, None

    stages = []
    for k in range(n_stages):
        fwd = fwd_last if k == n_stages - 1 else fwd_mid
        bwd = bwd_first if k == 0 else bwd_mid
        stages.append(pl.PipelineStage(fwd=fwd, bwd=bwd))
    return stages


class TanhStage:
    """``tanh(x @ w + b)``, optionally paced by a sleep (a picklable
    callable: the stage actors import it from this module)."""

    def __init__(self, sleep_s: float = 0.0):
        self.sleep_s = sleep_s

    def __call__(self, p, x):
        if self.sleep_s:
            time.sleep(self.sleep_s)
        return torch.tanh(x @ p["w"] + p["b"])


def mse(y, t):
    return torch.mean((y - t) ** 2)


def tiny_numpy(n_stages, n_mb, seed=0, D=8):
    """The tanh stack's params, microbatches and targets as numpy, in
    tests/test_pipeline.py's draw order."""
    rng = np.random.default_rng(seed)
    params = [{"w": rng.normal(size=(D, D)).astype(np.float32),
               "b": rng.normal(size=(D,)).astype(np.float32)}
              for _ in range(n_stages)]
    mbs = [rng.normal(size=(4, D)).astype(np.float32) for _ in range(n_mb)]
    tgts = [rng.normal(size=(4, D)).astype(np.float32)
            for _ in range(n_mb)]
    return params, mbs, tgts


def tiny_torch_stages(n_stages, fwd_sleep_s=0.0, seed=0, n_mb=4):
    """tests/test_pipeline.py's _tiny_jax_stages on torch tensors."""
    params, mbs, tgts = tiny_numpy(n_stages, n_mb, seed)
    fn = TanhStage(fwd_sleep_s)
    stages = [pl.PipelineStage(fn=fn, params={
        k: torch.from_numpy(v) for k, v in p.items()}) for p in params]
    return (stages, mse, [torch.from_numpy(m) for m in mbs],
            [torch.from_numpy(t) for t in tgts])


def tree_max_err(a, b):
    la, lb = pl._tree_leaves(a), pl._tree_leaves(b)
    assert len(la) == len(lb)
    return max(float(np.max(np.abs(_np(x) - _np(y))))
               for x, y in zip(la, lb))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


cloudpickle.register_pickle_by_value(sys.modules[__name__])
