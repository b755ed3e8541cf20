"""The one traffic generator: it reads a mix's parameters from
``benchmark/traffic/<name>.json`` and makes that mix from the run's seed.

Every seed gets the same work in another order. Lengths are a fixed pool
of stratified quantiles of the mix's distribution (the pool's i-th of n at
quantile (i + 1/2) / n), and so are the gaps between Poisson arrivals; the
seed permutes them and draws the token ids. So runs on different seeds
differ by order and content, not by how much there is to do.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 64), stream])


def quantiles(spec: dict, n: int) -> np.ndarray:
    """n stratified quantiles of a length distribution, clipped and rounded
    to whole tokens: {"dist": "lognormal", "median", "sigma", "min", "max"}
    or {"dist": "uniform", "min", "max"} (both ends included)."""
    u = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(x) for x in u])
        x = spec["median"] * np.exp(spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        x = spec["min"] + u * (spec["max"] + 1 - spec["min"]) - 0.5
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def _tokens(rng, n: int, first: int, vocab: int) -> np.ndarray:
    return rng.integers(first, vocab, size=n, dtype=np.int64).astype(np.int32)


# ---- training rows ----------------------------------------------------------

def train_rows(mix: dict, vocab: int, seed: int, n_rows: int) -> np.ndarray:
    """[n_rows, row_tokens] int32: documents (lengths from the pool, in the
    seed's order) packed end to end, each followed by the separator, cut
    into rows; a document that does not fit runs on into the next row."""
    rng = _rng(seed, 1)
    row = mix["row_tokens"]
    need = n_rows * row
    pool = quantiles(mix["doc_tokens"], mix["pool"])
    lengths = []
    total = 0
    while total < need:
        for n in rng.permutation(pool):
            lengths.append(int(n))
            total += int(n) + 1
            if total >= need:
                break
    stream = _tokens(rng, total, mix["first_token_id"], vocab)
    ends = np.cumsum(np.array(lengths) + 1) - 1
    stream[ends] = mix["separator_id"]
    return stream[:need].reshape(n_rows, row)


# ---- serving requests -------------------------------------------------------

def request_lengths(mix: dict, seed: int, n: int) -> List[Tuple[int, int]]:
    """n (prompt tokens, output tokens) pairs: the pools of both, each in
    its own seeded order, cycled."""
    rng = _rng(seed, 2)
    size = mix["pool"]
    p = rng.permutation(quantiles(mix["prompt_tokens"], size))
    o = rng.permutation(quantiles(mix["output_tokens"], size))
    return [(int(p[i % size]), int(o[i % size])) for i in range(n)]


def prompts(mix: dict, vocab: int, seed: int,
            lengths: List[Tuple[int, int]]) -> List[np.ndarray]:
    rng = _rng(seed, 3)
    return [_tokens(rng, n, mix["first_token_id"], vocab)
            for n, _ in lengths]


def arrivals(rate: float, seed: int, start: float, end: float,
             kind: str = "poisson") -> np.ndarray:
    """Due times in [start, end) of a Poisson process of ``rate`` per
    second: the gaps are the stratified quantiles of the exponential, in
    the seed's order."""
    if kind != "poisson":
        raise ValueError(f"unknown arrival process {kind!r}")
    n = int(math.ceil(rate * (end - start) * 1.2)) + 8
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) / rate
    gaps = _rng(seed, 4).permutation(gaps)
    due = start + np.cumsum(gaps)
    return due[due < end]


def summary(lengths: List[Tuple[int, int]]) -> Dict[str, float]:
    if not lengths:
        return {}
    p = np.array([a for a, _ in lengths])
    o = np.array([b for _, b in lengths])
    return {"requests": len(lengths), "prompt_median": float(np.median(p)),
            "prompt_min": int(p.min()), "prompt_max": int(p.max()),
            "output_median": float(np.median(o)), "output_min": int(o.min()),
            "output_max": int(o.max())}
