"""What the serving drivers share: the replica, its deployment, and the
check of what it served.

The replica is the port's continuous-batching replica with three methods
added: ``generate_timed`` drains ``engine.submit_stream(prompt, n)`` and
returns the tokens, the host's monotonic time of each and of the call's
entry and return; ``profile(seconds)`` traces the card for the window;
``memory_peak``, called once the window has closed, reads the allocator's
peak and the forbidden modules the replica's process holds. Its weights
come from the run's seed (``benchmark.weights``), on its card, and its
engine warms the cell's own prefill buckets and a decode chunk before it
serves. The request path is the port's: handle, router, replica, engine.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

from benchmark.harness import Context, port_config, wait_device_free
from ray_tpu_torch.serve.llm import _ContinuousLLMReplica


class BenchReplica(_ContinuousLLMReplica):
    def __init__(self, config: dict, tcfg, seed: int, engine_kw: dict,
                 device: str, traced: bool, fault: Optional[str] = None):
        if traced:
            # imported here, before the engine's threads run: the profiler
            # imports torch.distributed.tensor when it starts, and the
            # engine's is_dtensor, finding it half imported from another
            # thread, would fail the step
            import torch.distributed.tensor  # noqa: F401
            import torch.profiler  # noqa: F401

        from benchmark import weights
        from ray_tpu_torch._device import resolve_device
        from ray_tpu_torch.models import engine as E

        if fault == "unchanged":  # planted by the harness's tests only
            E._write_rows = lambda layer_cache, kv, pos: None
        if fault == "jax":  # a stub of the forbidden name, in the replica
            import sys
            import types

            sys.modules["jax"] = types.ModuleType("jax")
        self._fault = fault
        self._world = None
        self._calls = {"entered": 0, "returned": 0}
        self._calls_lock = threading.Lock()
        dev = resolve_device(device)
        params = weights.make_params(config, seed, dev)
        self.engine = E.InferenceEngine(params, tcfg, seed=seed, device=dev,
                                        **engine_kw)
        del params
        self.engine.warmup()
        self.engine.serve_forever()

    def generate_timed(self, prompt: List[int], n: int) -> dict:
        t_in = time.monotonic()
        with self._calls_lock:
            self._calls["entered"] += 1
        toks, times = [], []
        for tok in self.engine.submit_stream(prompt, n):
            toks.append(int(tok))
            times.append(time.monotonic())
        if self._fault == "answer":
            toks = [(t + 1) % self.engine.cfg.vocab_size for t in toks]
        with self._calls_lock:
            self._calls["returned"] += 1
        return {"tokens": toks, "times": times, "t_in": t_in,
                "t_out": time.monotonic()}

    def profile(self, seconds: float) -> Optional[dict]:
        """Trace the card for ``seconds`` (the first of the window: the
        profiler's stop builds an event object for each kernel under the
        interpreter's lock, which stalls the engine's threads meanwhile)."""
        from benchmark import trace as TRC

        window = TRC.Window(True, host_ops=False)
        with window:
            time.sleep(seconds)
        return window.summary()

    def memory_peak(self) -> dict:
        """The allocator's peak, the card's name, the calls and the
        engine's counters so far, and the forbidden modules loaded here."""
        import torch

        from benchmark import harness

        out = {"calls": dict(self._calls), "engine": dict(self.engine.stats),
               "bytes": 0, "device": "cpu",
               "forbidden": harness.forbidden_modules()}
        if self.engine.device.type == "cuda":
            out.update(bytes=int(torch.cuda.max_memory_allocated()),
                       device=torch.cuda.get_device_name(0))
        return out


def deploy(ctx: Context, name: str):
    """Start the runtime and the cell's one replica -> its handle."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.deployment import deployment
    from ray_tpu_torch.serve.llm import REPLICA_START_S

    c = ctx.cell
    gpu = ctx.device == "cuda"
    rt.init(num_cpus=4, num_gpus=1 if gpu else 0,
            object_store_memory=c["object_store_bytes"],
            log_to_driver=False)
    opts = {"health_check_timeout_s": REPLICA_START_S}
    if gpu:
        opts["ray_actor_options"] = {"num_gpus": 1}
    engine_kw = dict(slots=c["slots"], max_prompt_len=c["max_prompt_len"],
                     max_new_tokens=c["max_new_tokens"], greedy=True,
                     decode_chunk=c["decode_chunk"],
                     min_bucket=c["min_bucket"])
    dep = deployment(BenchReplica, name=name).options(
        num_replicas=1, max_concurrent_queries=c["max_concurrency"], **opts)
    app = dep.bind(ctx.config, port_config(ctx.config, c), ctx.seed,
                   engine_kw, ctx.device, ctx.trace, ctx.fault)
    return serve.run(app, name=name, route_prefix=None,
                     timeout_s=REPLICA_START_S)


def shutdown() -> None:
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    try:
        serve.shutdown()
    finally:
        rt.shutdown()


# ---- the check --------------------------------------------------------------

def check_sample(ctx: Context, done: List[dict]) -> List[dict]:
    """The requests the check judges: ``check_requests`` of the finished
    ones drawn from the seed, with the one that served the most tokens."""
    if not done:
        return []
    rng = np.random.default_rng([ctx.seed % (2 ** 64), 5])
    longest = max(range(len(done)), key=lambda i: len(done[i]["tokens"]))
    k = min(ctx.cell["check_requests"], len(done))
    pick = set(rng.choice(len(done), size=k, replace=False).tolist())
    pick.add(longest)
    return [done[i] for i in sorted(pick)]


def check(ctx: Context, done: List[dict]) -> dict:
    """Judge a sample (``check_sample``) of the finished requests ``done``:
    the gaps, over its served tokens, between the reference's
    best logit and its logit of the served token (fp32, TF32 off): the
    widest (``max_gap``) and the share over 1 logit (``share_over_1``);
    the cell's limits say which are compared. With ``ctx.control``, also
    the control's (the gap of the token the fp8 reference puts first at
    the same positions) and a witness's (the plain reference in the
    configuration's precision, bf16, in the program's place)."""
    import torch

    from benchmark import weights
    from benchmark.configs import mistral_family as REF

    sample = check_sample(ctx, done)
    if not sample:
        return {"numbers": {"checked_requests": [0, None]}, "extra": {}}
    wait_device_free(ctx.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = weights.make_params(ctx.config, ctx.seed, ctx.device)
    ref = REF.model_from_params(ctx.config, params, compute=torch.float32)
    ctl = (REF.model_from_params(ctx.config, params,
                                 compute=weights.DTYPES[
                                     ctx.config["torch_dtype"]], fp8=True)
           if ctx.control else None)
    wit = (REF.model_from_params(ctx.config, params,
                                 compute=weights.DTYPES[
                                     ctx.config["torch_dtype"]])
           if ctx.control else None)
    gaps, ctl_gaps, wit_gaps = [], [], []
    for r in sample:
        gaps.append(REF.served_gaps(ref, r["prompt"], r["tokens"]))
        if ctl is not None:
            ctl_gaps.append(REF.served_gaps(ref, r["prompt"], r["tokens"],
                                            control=ctl))
            wit_gaps.append(REF.served_gaps(ref, r["prompt"], r["tokens"],
                                            control=wit))
    gaps = torch.cat(gaps)
    readings = {"max_gap": float(gaps.max()),
                "share_over_1": float((gaps > 1).float().mean())}
    limits = ctx.cell["limits"]
    out = {"numbers": {k: [readings[k], limits[k]] for k in limits},
           "extra": {"sample_requests": len(sample),
                     "sample_served_tokens": int(gaps.numel()),
                     **{k: v for k, v in readings.items()
                        if k not in limits},
                     "gap_share_over_0.1": float((gaps > 0.1).float().mean())}}
    if ctl is not None:
        ctl_gaps = torch.cat(ctl_gaps)
        wit_gaps = torch.cat(wit_gaps)
        out["witness_bf16"] = {"max_gap": float(wit_gaps.max()),
                               "share_over_1": float(
                                   (wit_gaps > 1).float().mean())}
        out["control"] = {"max_gap": float(ctl_gaps.max()),
                          "share_over_1": float(
                              (ctl_gaps > 1).float().mean()),
                          "gap_share_over_0.1": float(
                              (ctl_gaps > 0.1).float().mean())}
    return out


# ---- the client side --------------------------------------------------------

def call(gen, prompt: np.ndarray, n: int, deadline: float) -> dict:
    """One blocking call of ``generate_timed`` through the handle; the
    record holds the client's send and receive times beside the
    replica's stamps."""
    rec = {"prompt": prompt.tolist(), "n": n, "ok": False}
    rec["t_send"] = time.monotonic()
    try:
        out = gen.remote(rec["prompt"], n).result(
            timeout_s=max(1.0, deadline - rec["t_send"]))
    except Exception as e:  # the run counts it as failed
        rec["error"] = repr(e)[:300]
        return rec
    rec["t_recv"] = time.monotonic()
    rec.update(out)
    rec["ok"] = len(out["tokens"]) == n
    if not rec["ok"]:
        rec["error"] = f"served {len(out['tokens'])} tokens of {n}"
    return rec


def stats_delta(s0: dict, s1: dict) -> dict:
    return {k: s1[k] - s0[k] for k in ("tokens_out", "decode_steps",
                                       "prefills", "prefill_dispatches")}


def finish(ctx: Context, handle, prof_resp) -> dict:
    """After the load: the replica's peak memory and trace, then the
    runtime down."""
    peak = handle.options(method_name="memory_peak").remote().result(
        timeout_s=60)
    trace = prof_resp.result(timeout_s=120) if prof_resp is not None \
        else None
    return {"memory_peak_bytes": peak["bytes"], "device_kind": peak["device"],
            "trace": trace, "forbidden": {"replica": peak["forbidden"]},
            "replica": {"calls": peak["calls"], "engine": peak["engine"]}}

