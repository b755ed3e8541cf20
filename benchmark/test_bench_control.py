"""The control must fail where the program passes: on the card, each cell
at its own size, one seed, with ``--control 1``. The control is the plain
reference with every matmul operand rounded to fp8 (e4m3), the step below
the configurations' bf16; the harness judges it in the program's place,
with the same verdict, and reports the program's own beside it. Run on
the card:

    python -m pytest --noconftest -m gpu benchmark/test_bench_control.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CELLS = {"mistral-7b.train.4k": ("5", "3300000041"),
         "mixtral-8x7b.serve.chat": ("10", "3300000049")}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_fails_where_program_passes(card, workload):
    seconds, seed = CELLS[workload]
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload,
         "--seed", seed, "--seconds", seconds, "--trace", "0",
         "--control", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["program_correct"] is True, res["program_checked"]
    assert res["correct"] is False, res["checked"]
