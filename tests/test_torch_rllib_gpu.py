"""The port's RLlib learners on the card, at a small width: each learner on
the card against the same learner on the CPU (chip_smoke.rllib_parity; part
2's learners by chip_smoke.rllib2_parity), and a LearnerGroup of two GPU
learner actors on a cluster of two logical GPU nodes
(chip_smoke.rllib_group_check). chip_smoke.py's phases rllib and rllib2 run
the same checks at bench_rllib.py's width.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_rllib_gpu.py
"""

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.gpu

_OBS, _ACTS, _HIDDENS = 16, 3, (32, 32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("name", chip_smoke._RL_LEARNERS)
def test_learner_on_card_matches_cpu(card, name):
    row = chip_smoke.rllib_parity(name, _OBS, _ACTS, _HIDDENS, seed=0)
    print(row)
    assert row["ok"], row


def test_learner_group_on_two_gpu_nodes(card):
    row = chip_smoke.rllib_group_check(_OBS, _ACTS, _HIDDENS, seed=0,
                                       rows=256)
    print(row)
    assert row["ok"], row


@pytest.mark.parametrize("name", chip_smoke._RL2_LEARNERS)
def test_part2_learner_on_card_matches_cpu(card, name):
    """Phase rllib2 (a) at a small width: SAC, TD3, DDPG, R2D2, BC, CQL,
    MARWIL, Dreamer and AlphaZero, stage by stage (chip_smoke.rllib2_parity).
    """
    row = chip_smoke.rllib2_parity(name, chip_smoke._RL2_SMALL, seed=0)
    print(row)
    assert row["ok"], row
