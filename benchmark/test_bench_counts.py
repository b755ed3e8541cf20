"""The yardstick's counts against the numbers the cells were defined by."""

import json
from pathlib import Path

import pytest

from benchmark import counts

CONFIGS = Path(__file__).resolve().parent / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_mistral_16_layers_train_flops():
    cfg = _cfg("mistral-7b-16l")
    assert counts.matmul_params(cfg) == pytest.approx(3.624e9, rel=1e-3)
    per_token = counts.train_flops_per_token(cfg, 4096)
    assert per_token == pytest.approx(23.35e9, rel=1e-3)
    assert per_token * 4 * 4096 == pytest.approx(382.6e12, rel=1e-3)
    attn = per_token - 6 * counts.matmul_params(cfg)
    assert attn == pytest.approx(1.61e9, rel=1e-2)


@pytest.mark.parametrize("name,layers,params", [
    ("mistral-7b-16l", 32, 7.248e9),  # all of Mistral-7B
    ("mixtral-8x7b-8l", 8, 11.87e9)])
def test_total_params(name, layers, params):
    cfg = dict(_cfg(name), num_hidden_layers=layers)
    assert counts.total_params(cfg) == pytest.approx(params, rel=1e-3)


def test_moe_counts_top_k_experts_only():
    cfg = _cfg("mixtral-8x7b-8l")
    dense = dict(cfg, num_local_experts=0)
    extra = counts.matmul_params(cfg) - counts.matmul_params(dense)
    per_layer = 3 * 4096 * 14336 + 4096 * 8  # a second expert and the router
    assert extra == 8 * per_layer


def test_flash_bounds_match_the_chip_checks():
    # chip_smoke.py's published bounds at [128, 2048, 64] bf16 causal
    b1, by = counts.flash_fwd_bound(128, 2048, 2048, 64, "bfloat16", True)
    assert b1 * 1e3 == pytest.approx(0.06952, rel=1e-3) and by == "operations"
    bwd = counts.flash_bwd_bounds(128, 2048, 2048, 64, "bfloat16", True)
    assert bwd["flash_bwd_dq"][0] * 1e3 == pytest.approx(0.1043, rel=1e-3)
    assert bwd["flash_bwd_dkv"][0] * 1e3 == pytest.approx(0.1390, rel=1e-3)


def test_pairs_closed_form():
    for t, tk in ((5, 5), (7, 3), (3, 7), (1, 1)):
        want = sum(min(q + 1, tk) for q in range(t))
        assert counts._pairs(t, tk, True) == want
    assert counts._pairs(4, 6, False) == 24
