"""The benchmark's readers of the serving engine's counters
(``benchmark/metrics/prefill_ms.chat.py``, ``decode_substep_ms.chat.py``)
on made-up results, and once through the harness's CPU rehearsal of the
chat cell with ``--trace 1``, in a process of its own (the harness refuses
to run in a process that holds JAX, as this one may)."""

import json

import pytest

from benchmark.run import _reader
from benchmark.test_bench_faults import run_tiny

CHAT = "mixtral-8x7b.serve.chat"
# reader -> (seconds key, count key)
READERS = {"prefill_ms.chat": ("prefill_device_s", "prefills"),
           "decode_substep_ms.chat": ("decode_device_s", "decode_steps")}


def _res(engine: dict) -> dict:
    return {"kind": "serve", "extra": {"replica": {"engine": engine}}}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_device_ms_per_unit_of_work(name):
    secs, count = READERS[name]
    engine = {"prefills": 8, "decode_steps": 40, "prefill_device_s": 1.2,
              "decode_device_s": 2.0}
    assert _reader(name).read(None, _res(engine)) == pytest.approx(
        1e3 * engine[secs] / engine[count])


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("missing", ["seconds", "count", "engine"])
def test_reader_reads_nothing_where_the_program_counts_nothing(name,
                                                               missing):
    """A parent commit's engine has no device-time counters; an engine
    that served nothing has counts of 0; a result without the replica's
    counters has neither."""
    secs, count = READERS[name]
    engine = {"prefills": 8, "decode_steps": 40, "prefill_device_s": 1.2,
              "decode_device_s": 2.0}
    if missing == "seconds":
        del engine[secs]
        res = _res(engine)
    elif missing == "count":
        engine[count] = 0
        res = _res(engine)
    else:
        res = {"kind": "serve", "extra": {}}
    assert _reader(name).read(None, res) is None


def test_traced_chat_rehearsal_prints_both_metrics():
    out = run_tiny(CHAT, "--trace", "1")
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checked"]
    for name in READERS:
        assert res["metrics"][name]["value"] > 0, res["metrics"]
        assert res["metrics"][name]["unit"] == "ms"
