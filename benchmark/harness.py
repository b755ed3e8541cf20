"""What every driver shares: the cell's files, the program's configuration
built from them, percentiles, and the run's context."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent

# top-level module names no process of the harness may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden
    (``ray_tpu_torch`` is not ``ray_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Context:
    """One run: the workload's entry in BENCHMARK.json, its cell file, its
    configuration file and the run's arguments. ``device`` is "cuda" for a
    measured run; tests rehearse on "cpu" with small overrides."""

    workload: dict
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    t_start: float                 # time.monotonic() at the process's start
    device: str = "cuda"
    fault: Optional[str] = None    # a planted fault (the harness's tests)
    control: bool = False          # also read the control (not in runs)
    chips: int = 1
    traffic_overrides: dict = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.workload["name"]

    def mix(self) -> dict:
        """The cell's traffic mix, from its file."""
        from benchmark import traffic

        return {**traffic.load(self.workload["traffic"]),
                **self.traffic_overrides}


def load_context(workload: str, seed: int, seconds: float, trace: bool,
                 t_start: float, overrides: Optional[dict] = None,
                 **kw) -> Context:
    bench = load_json(ROOT / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {[w['name'] for w in bench['workloads']]}")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = load_json(ROOT / conf["file"])
    cell = load_json(HERE / "cells" / f"{workload}.json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    cell.update(overrides.get("cell", {}))
    return Context(workload=w, cell=cell, config=config, seed=int(seed),
                   seconds=float(seconds), trace=bool(trace),
                   t_start=t_start, chips=int(w["chips"]),
                   traffic_overrides=overrides.get("traffic", {}), **kw)


def metric_names(workload: str) -> Dict[str, List[dict]]:
    """The end-to-end and per-layer metrics BENCHMARK.json gives this
    workload."""
    bench = load_json(ROOT / "BENCHMARK.json")

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def port_config(config: dict, cell: dict):
    """The program's TransformerConfig for this configuration and cell."""
    import torch

    from ray_tpu_torch.models.config import TransformerConfig

    dtype = {"bfloat16": torch.bfloat16,
             "float32": torch.float32}[config["torch_dtype"]]
    assumed = config.get("assumed", {})
    return TransformerConfig(
        vocab_size=config["vocab_size"], d_model=config["hidden_size"],
        n_layers=config["num_hidden_layers"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        d_ff=config["intermediate_size"],
        max_seq_len=cell["max_seq_len"], rope_theta=config["rope_theta"],
        rms_eps=config["rms_norm_eps"], dtype=dtype, param_dtype=dtype,
        tie_embeddings=config["tie_word_embeddings"],
        remat=cell.get("remat", True),
        remat_policy=cell.get("remat_policy", "nothing"),
        moe_experts=config.get("num_local_experts") or 0,
        moe_top_k=config.get("num_experts_per_tok") or 2,
        moe_capacity_factor=assumed.get("moe_capacity_factor", 1.25),
        moe_aux_weight=config.get("router_aux_loss_coef", 0.01))


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernels build into ``.build/ray_tpu_torch`` there)."""
    build = ROOT / ".build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(build / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def wait_device_free(device: str, timeout_s: float = 60.0) -> None:
    """After the program's processes are gone, wait until the card's
    memory is back (a worker may take a moment to exit)."""
    if device != "cuda":
        return
    import torch

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        free, total = torch.cuda.mem_get_info()
        if free > 0.9 * total:
            return
        time.sleep(0.25)
