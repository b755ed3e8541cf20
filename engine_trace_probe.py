"""Probe of the serving engine's spans and counters on a CUDA card, outside
the benchmark. Three parts, one JSON line each:

  annotations  whether a CUDA-only ``torch.profiler`` trace (the benchmark's
               ``host_ops=False``) records ``record_function`` ranges as GPU
               annotations, and whether ``benchmark.trace``'s busy time
               leaves them out (it should equal the kernels' merged time);
  host_cost    the host cost of the instrumentation: one range's enter and
               exit, one event pair of the engine's device clock, one host
               stamp, with the profiler off, on with CUDA only and on with
               CPU and CUDA; and the host time of dispatching a decode chunk
               with the ranges and with them replaced by a no-op, on an
               engine of the chat cell's depth, experts and chunk at a width
               small enough that the host, not the card, paces it;
  chat         the chat cell's engine (``mixtral-8x7b.serve.chat``: its
               configuration, weights from the seed and engine settings)
               under the cell's Poisson arrivals, served in this process.
               Between two edges taken in the engine's dispatch thread (the
               card drained, every finished reading counted), the engine's
               device seconds against a CUDA-only trace's busy time; then a
               trace with host operations, started in that thread, that
               splits each decode chunk's and prefill group's device time by
               range.

    python3 engine_trace_probe.py [--seed N] [--warm S] [--window S]
                                  [--split S] > chiprun_out/probe.jsonl
"""

from __future__ import annotations

import argparse
import gc
import json
import threading
import time
from contextlib import contextmanager

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import harness, traffic, weights
from benchmark import trace as TRC
from ray_tpu_torch.models import engine as E
from ray_tpu_torch.models import generate as G
from ray_tpu_torch.models import moe as M
from ray_tpu_torch.models.transformer import init_params

CHAT = "mixtral-8x7b.serve.chat"
RANGES = ("attn", "ffn", "head", "moe.route", "moe.experts")
NAMES = ("engine.prefill", "engine.decode", "engine.deliver") + RANGES
KEYS = ("prefill_device_s", "decode_device_s")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card() -> dict:
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


# ---- annotations ------------------------------------------------------------

def annotations() -> dict:
    x = torch.randn(2048, 2048, device="cuda")
    out = {}
    for label, acts in (("cuda_only", [ProfilerActivity.CUDA]),
                        ("cpu_and_cuda", [ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA])):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with profile(activities=acts) as prof:
            for _ in range(4):
                with record_function("attn"):
                    y = x @ x
                    y = y.relu()
                time.sleep(0.002)  # an idle gap between ranges
            torch.cuda.synchronize()
        host_s = time.monotonic() - t0
        events = list(prof.profiler.kineto_results.events())
        kernels, annots = [], {}
        for e in events:
            if TRC._on_device(e):
                if TRC._annotation(e):
                    annots[e.name()] = annots.get(e.name(), 0) + 1
                else:
                    kernels.append((e.start_ns(),
                                    e.start_ns() + e.duration_ns()))
        merged = sum(b - a for a, b in TRC._merge(kernels)) / 1e9
        summary = TRC.reduce_events(events, host_s)
        out[label] = {"device_annotations": annots,
                      "host_ranges": sum(1 for e in events
                                         if e.name() == "attn"
                                         and not TRC._on_device(e)),
                      "kernels": len(kernels), "kernels_merged_s": merged,
                      "trace_busy_s": summary["busy_s"]}
    return out


# ---- host cost --------------------------------------------------------------

@contextmanager
def _profiler(mode: str):
    if mode == "off":
        yield
        return
    acts = [ProfilerActivity.CUDA] if mode == "cuda" else \
        [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        yield
        torch.cuda.synchronize()


@contextmanager
def _unguarded():
    """The ranges as plain ``record_function``, profiler or not."""
    saved = E.profiled, G.profiled, M.profiled
    E.profiled = G.profiled = M.profiled = record_function
    try:
        yield
    finally:
        E.profiled, G.profiled, M.profiled = saved


def _per_call_us(fn, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def _unit_costs(n: int) -> dict:
    def ranged(make):
        def one():
            with make("attn"):
                pass
        return one

    clock = E._DeviceClock(torch.device("cuda"))
    t0 = time.perf_counter()
    pairs = [clock.stop(clock.start()) for _ in range(200)]
    pair = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    read = _per_call_us(lambda: clock.seconds(pairs.pop()), 200)
    stats, req = {"queue_wait_s": 0.0}, E._Request(0, [1], 1)

    def stamp():
        stats["queue_wait_s"] += time.monotonic() - req.t_submit

    return {"range_us": _per_call_us(ranged(E.profiled), n),
            "record_function_us": _per_call_us(ranged(record_function), n),
            "event_pair_us": pair, "event_pair_read_us": read,
            "stamp_us": _per_call_us(stamp, n)}


def _chunk_host_ms(eng, chunks: int) -> float:
    """Median host time of dispatching one decode chunk over every slot."""
    slots = list(range(eng.slots))
    eng._decode(slots)
    torch.cuda.synchronize()
    times = []
    for _ in range(chunks):
        t0 = time.perf_counter()
        eng._decode(slots)
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return 1e3 * float(np.median(times))


def host_cost(chat_cfg) -> dict:
    import dataclasses

    narrow = dataclasses.replace(chat_cfg, d_model=256, d_ff=512,
                                 n_heads=8, n_kv_heads=2, vocab_size=1024)
    params = init_params(torch.Generator(device="cuda").manual_seed(0),
                         narrow, device="cuda")
    eng = E.InferenceEngine(params, narrow, device="cuda", slots=16,
                            max_prompt_len=64, max_new_tokens=64,
                            decode_chunk=4, min_bucket=64).warmup()
    out = {"ranges_per_chunk": 1 + eng.decode_chunk * (
        narrow.n_layers * (4 if narrow.moe_experts else 2) + 1),
        "event_pairs_per_chunk": 1, "n_layers": narrow.n_layers,
        "moe_experts": narrow.moe_experts}
    gc.collect()
    gc.disable()
    try:
        for mode, rounds, chunks, n in (("off", 3, 10, 20000),
                                        ("cuda", 3, 10, 20000),
                                        ("cpu_and_cuda", 1, 5, 4000)):
            with _profiler(mode):
                unit = _unit_costs(n)
                built, plain = [], []
                for _ in range(rounds):  # in turns
                    built.append(_chunk_host_ms(eng, chunks))
                    with _unguarded():
                        plain.append(_chunk_host_ms(eng, chunks))
            out[mode] = {**unit, "chunk_dispatch_ms": built,
                         "chunk_dispatch_ms_record_function": plain}
    finally:
        gc.enable()
    return out


# ---- the chat cell's engine -------------------------------------------------

def _unread_s(eng) -> dict:
    """Device seconds of readings not yet counted (their ops are done), by
    stats key."""
    out = dict.fromkeys(KEYS, 0.0)
    readings = [kr for chunk in eng._inflight for kr in chunk.readings]
    for key, (start, end) in readings + eng._prefill_readings:
        out[key] += start.elapsed_time(end) / 1e3
    return out


class Edges:
    """Runs a function in the engine's dispatch thread between two of its
    steps (so a profiler started there records that thread's ranges),
    once the card has drained and the fetcher has counted what it held:
    ``run(fn)`` -> (device seconds so far by stats key, stats, fn())."""

    def __init__(self, eng):
        self._eng, self._fn, self._out = eng, None, None
        self._done = threading.Event()
        step = eng.step

        def edge_then_step():
            fn, self._fn = self._fn, None
            if fn is not None:
                torch.cuda.synchronize()
                time.sleep(0.3)
                with eng._lock:
                    st = dict(eng.stats)
                    done = {k: st[k] + v for k, v in _unread_s(eng).items()}
                self._out = (done, st, fn())
                self._done.set()
            return step()

        eng.step = edge_then_step

    def run(self, fn):
        self._done.clear()
        self._fn = fn
        self._eng._work.set()
        if not self._done.wait(120):
            raise TimeoutError("the engine's thread took no step")
        return self._out


def _device_us(e) -> float:
    """Device time of the kernels ``e`` and its descendants launched. A
    range's own entry in ``kernels`` is its GPU annotation, which spans
    its kernels: left out."""
    return sum(k.duration for k in e.kernels if k.name not in NAMES) + \
        sum(_device_us(c) for c in e.cpu_children)


def _named_below(e, names):
    """The outermost descendants of ``e`` whose name is in ``names``."""
    found, stack = [], list(e.cpu_children)
    while stack:
        c = stack.pop()
        if c.name in names:
            found.append(c)
        else:
            stack.extend(c.cpu_children)
    return found


def split(events) -> dict:
    """Device time of each decode chunk and prefill group by range. A
    range's GPU annotation is an event of the same name on the device:
    only the host's ranges are taken."""
    cpu = torch.autograd.DeviceType.CPU
    host = [e for e in events if e.device_type == cpu]
    out = {}
    for phase in ("engine.decode", "engine.prefill"):
        tops = [e for e in host if e.name == phase]
        sums = {k: 0.0 for k in ("total",) + RANGES}
        for t in tops:
            sums["total"] += _device_us(t)
            for part in _named_below(t, ("attn", "ffn", "head")):
                sums[part.name] += _device_us(part)
                if part.name == "ffn":
                    for sub in _named_below(part, ("moe.route",
                                                   "moe.experts")):
                        sums[sub.name] += _device_us(sub)
        n = max(1, len(tops))
        out[phase] = {"count": len(tops),
                      "totals_ms": sorted(round(_device_us(t) / 1e3, 3)
                                          for t in tops),
                      **{f"{k}_ms_each": v / 1e3 / n for k, v in
                         sums.items()},
                      "other_ms_each": (sums["total"] - sums["attn"]
                                        - sums["ffn"] - sums["head"])
                      / 1e3 / n}
    dec = out["engine.decode"]["total_ms_each"] * out["engine.decode"][
        "count"]
    pre = out["engine.prefill"]["total_ms_each"] * out["engine.prefill"][
        "count"]
    out["prefill_share_of_engine_device_time"] = pre / (dec + pre) \
        if dec + pre else None
    return out


def chat(seed: int, warm: float, window: float, split_s: float) -> dict:
    ctx = harness.load_context(CHAT, seed, window, True, time.monotonic())
    c, mix = ctx.cell, ctx.mix()
    cfg = harness.port_config(ctx.config, c)
    t0 = time.monotonic()
    params = weights.make_params(ctx.config, seed, torch.device("cuda"))
    eng = E.InferenceEngine(
        params, cfg, seed=seed, device="cuda", slots=c["slots"],
        max_prompt_len=c["max_prompt_len"],
        max_new_tokens=c["max_new_tokens"], greedy=True,
        decode_chunk=c["decode_chunk"], min_bucket=c["min_bucket"])
    del params
    eng.warmup()
    setup = time.monotonic() - t0
    horizon = warm + window + split_s + 30.0
    due = traffic.arrivals(c["rate_per_s"], seed, 0.0, horizon,
                           mix["arrivals"])
    lengths = traffic.request_lengths(mix, seed, len(due))
    prompts = traffic.prompts(mix, ctx.config["vocab_size"], seed, lengths)
    stop = threading.Event()

    def arrive():
        start = time.monotonic()
        for d, (_, n), p in zip(due, lengths, prompts):
            time.sleep(max(0.0, start + d - time.monotonic()))
            if stop.is_set():
                return
            eng.submit(p.tolist(), n)

    edges = Edges(eng)
    eng.serve_forever()
    feeder = threading.Thread(target=arrive, daemon=True)
    feeder.start()
    time.sleep(warm)
    win = TRC.Window(True, host_ops=False)
    a0, s0, _ = edges.run(win.__enter__)
    time.sleep(window)
    a1, s1, _ = edges.run(lambda: win.__exit__(None, None, None))
    summary = win.summary()
    engine_s = {k: a1[k] - a0[k] for k in KEYS}
    total = sum(engine_s.values())
    agree = {"engine_device_s": engine_s, "trace_busy_s": summary["busy_s"],
             "trace_window_s": summary["window_s"],
             "ratio": total / summary["busy_s"]
             if summary["busy_s"] else None,
             "prefills": s1["prefills"] - s0["prefills"],
             "decode_steps": s1["decode_steps"] - s0["decode_steps"],
             "tokens_out": s1["tokens_out"] - s0["tokens_out"],
             "device_ops": summary["device_ops"],
             "idle_gaps": summary["idle_gaps"]}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    b0, _, _ = edges.run(prof.__enter__)
    time.sleep(split_s)
    b1, _, _ = edges.run(lambda: prof.__exit__(None, None, None))
    stop.set()
    t_read = time.monotonic()
    parts = split(prof.events())
    parts["engine_device_s_in_trace"] = {k: b1[k] - b0[k] for k in KEYS}
    parts["events_read_s"] = time.monotonic() - t_read
    st = dict(eng.stats)
    eng.shutdown()
    life = dict(st)
    life["prefill_ms"] = 1e3 * st["prefill_device_s"] / max(1, st["prefills"])
    life["decode_substep_ms"] = 1e3 * st["decode_device_s"] / max(
        1, st["decode_steps"])
    life["queue_wait_ms_mean"] = 1e3 * st["queue_wait_s"] / max(
        1, st["prefills"])
    life["first_token_ms_mean"] = 1e3 * st["first_token_s"] / max(
        1, st["first_tokens"])
    life["dispatch_ms_per_chunk"] = 1e3 * st["dispatch_wall_s"] / max(
        1, st["decode_steps"] / eng.decode_chunk)
    return {"setup_s": setup, "rate_per_s": c["rate_per_s"],
            "agreement": agree, "split": parts, "life": life,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=4100000021)
    p.add_argument("--warm", type=float, default=20.0)
    p.add_argument("--window", type=float, default=20.0)
    p.add_argument("--split", type=float, default=8.0)
    a = p.parse_args()
    harness.set_cache_dirs()
    emit({"part": "card", **card()})
    # first, before any profiler session has run in this process
    ctx = harness.load_context(CHAT, a.seed, a.window, True, 0.0)
    emit({"part": "host_cost",
          **host_cost(harness.port_config(ctx.config, ctx.cell))})
    torch.cuda.empty_cache()
    emit({"part": "annotations", **annotations()})
    emit({"part": "chat", **chat(a.seed, a.warm, a.window, a.split)})


if __name__ == "__main__":
    main()
