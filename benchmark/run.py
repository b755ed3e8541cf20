"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s workload, its
file under ``benchmark/cells/``, its configuration and traffic files)
names a driver under ``benchmark/drivers/``; the driver sets up the
program from the seed, measures for ``--seconds`` and returns what it
saw. Then the check: the plain reference judges what the timed path
produced. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checked``: each compared number
beside its limit); the compared numbers are also the last lines of
standard error. With ``--trace 0`` the metrics are the cell's end-to-end
ones, with ``--trace 1`` its per-layer ones, each read by the file of its
name under ``benchmark/metrics/``.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

from benchmark import harness  # noqa: E402


def _reader(name: str):
    path = harness.HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _verdict(failed: int, numbers: dict) -> bool:
    """Correct: nothing failed, and every compared number within its
    limit."""
    return failed == 0 and all(lim is not None and v <= lim
                               for v, lim in numbers.values())


def _forbidden(res: dict) -> dict:
    """Forbidden modules by process: this one's, and those each of the
    program's processes on the card reported once the window had closed."""
    found = {"harness": harness.forbidden_modules(),
             **res.get("forbidden", {})}
    return {k: v for k, v in found.items() if v}


def main(argv=None, *, device: str = "cuda",
         overrides: Optional[dict] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a planted fault, for the harness's own tests of its check
    p.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    # judge the control in the program's place: ``correct`` is then the
    # control's verdict, the program's under ``program_correct``
    p.add_argument("--control", type=int, default=0, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    harness.set_cache_dirs()
    ctx = harness.load_context(a.workload, a.seed, a.seconds, bool(a.trace),
                               T_START, overrides, device=device,
                               fault=a.fault, control=bool(a.control))
    if device == "cuda":
        import torch

        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < ctx.chips:
            print(f"{ctx.name} needs {ctx.chips} CUDA device(s); "
                  f"available: {torch.cuda.is_available()}, count: "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
    driver = importlib.import_module(f"benchmark.drivers.{ctx.cell['driver']}")
    res = driver.run(ctx)
    bad = _forbidden(res)
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    t_check = time.monotonic()
    chk = driver.check(ctx, res)
    check_s = time.monotonic() - t_check
    bad = _forbidden(res)
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3

    numbers = chk["numbers"]
    correct = _verdict(res["failed"], numbers)
    program = None
    if a.control:
        program = {"correct": correct, "checked": numbers}
        numbers = {k: [chk["control"][k], lim]
                   for k, (_, lim) in numbers.items()}
        correct = _verdict(res["failed"], numbers)
    names = harness.metric_names(ctx.name)
    metrics = {}
    listed = {m["name"] for m in names["end_to_end"]}
    unlisted = {k: v for k, v in res["end_to_end"].items() if k not in listed}
    if not a.trace:
        for m in names["end_to_end"]:
            v = res["setup_s"] if m["name"] == "setup_s" \
                else res["end_to_end"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in names["per_layer"]:
            v = _reader(m["name"]).read(ctx, res)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": res["device_kind"], "count": ctx.chips,
           "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    tr = res.get("trace")
    if a.trace and tr:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["extra"] = {"check_s": check_s, **unlisted, **chk.get("extra", {}),
                    **res.get("extra", {})}
    for key in ("control", "fault_half", "witness_bf16"):
        if key in chk:
            out[key] = chk[key]
    if program is not None:
        out["program_correct"] = program["correct"]
        out["program_checked"] = {k: {"value": v, "limit": lim} for k, (
            v, lim) in program["checked"].items()}
    out["checked"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in numbers.items()}
    for k, (v, lim) in numbers.items():
        print(f"checked {k}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
