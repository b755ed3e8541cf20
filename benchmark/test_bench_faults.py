"""The check catches a broken timed path: a run of the harness with the
card check skipped (on the CPU, at a tiny size of each cell's
configuration, with the cell's own limits), the program broken underneath
in each way the cell can break, must print ``correct: false``; the same
run unbroken, ``correct: true`` where a tiny model's rounding keeps inside
the limits.

Each case runs in a process of its own (the harness refuses to judge in a
process that holds JAX, as a test process of the repo's other tests may).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

TINY = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "vocab_size": 256}
TRAIN = {"config": TINY,
         "cell": {"batch_rows": 2, "max_seq_len": 64, "max_steps_per_s": 100,
                  "ref_attn_block": 16},
         "traffic": {"row_tokens": 65,
                     "doc_tokens": {"dist": "lognormal", "median": 30,
                                    "sigma": 1.0, "min": 4, "max": 200}}}
SERVE = {"config": TINY,
         "cell": {"slots": 4, "max_prompt_len": 64, "max_new_tokens": 48,
                  "min_bucket": 16, "max_seq_len": 112, "warm_seconds": 1,
                  "grace_seconds": 60, "rate_per_s": 3.0,
                  "max_requests": 200, "check_requests": 6},
         "traffic": {"prompt_tokens": {"dist": "uniform", "min": 8, "max": 64},
                     "output_tokens": {"dist": "uniform", "min": 24,
                                       "max": 48},
                     "clients": 6}}


def run_tiny(workload: str, *args: str) -> subprocess.CompletedProcess:
    """One harness run on the CPU at the tiny size."""
    over = TRAIN if ".train." in workload else SERVE
    argv = ["--workload", workload, "--seed", "3000000017", "--seconds", "2",
            *args]
    code = ("import sys, json; from benchmark import run; "
            f"sys.exit(run.main({argv!r}, device='cpu', "
            f"overrides=json.loads({json.dumps(over)!r})))")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def rehearse(workload: str, *args: str) -> dict:
    """-> the result line of ``run_tiny``."""
    out = run_tiny(workload, *args)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload,fault", [
    ("mistral-7b.train.4k", "unchanged"),
    ("mistral-7b.train.4k", "half"),
    ("mixtral-8x7b.serve.chat", "answer"),
    ("mixtral-8x7b.serve.chat", "unchanged"),
])
def test_fault_is_not_correct(workload, fault):
    res = rehearse(workload, "--fault", fault)
    assert res["correct"] is False, res["checked"]
    assert res["checked"]


@pytest.mark.parametrize("workload,where", [
    ("mistral-7b.train.4k", "worker"),
    ("mixtral-8x7b.serve.chat", "replica"),
])
def test_jax_in_the_program_process_refuses_the_run(workload, where):
    """A module named ``jax`` in the process that runs the program (the
    train worker, the serving replica), not in the harness's own: the run
    ends without a result and names it."""
    out = run_tiny(workload, "--fault", "jax")
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines()
                if ln.startswith("{")], out.stdout[-2000:]
    assert f"'{where}': ['jax']" in out.stderr, out.stderr[-3000:]


def test_unbroken_train_is_correct():
    res = rehearse("mistral-7b.train.4k")
    assert res["correct"] is True, res["checked"]
    assert set(res["checked"]) == {"grad_gap", "change_gap"}
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_unbroken_chat_is_correct():
    res = rehearse("mixtral-8x7b.serve.chat")
    assert res["correct"] is True, res["checked"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"tpot_p95_ms", "setup_s"}
    assert res["extra"]["ttft_p95_ms"] > 0
