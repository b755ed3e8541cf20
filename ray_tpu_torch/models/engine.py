"""Continuous-batching inference engine: the port of ``ray_tpu/models/engine.py``.

The same slot scheduler over the same device functions:

  - The KV cache is a fixed pool of B *slots* over one [L, B, S, KV, hd]
    tensor per k/v. A slot is a row; admission writes a new prompt's K/V into
    a freed row, eviction is host bookkeeping. Writes are in place (where the
    reference donated its buffers to XLA).
  - Each decode chunk advances EVERY active slot by ``decode_chunk`` tokens,
    with per-row cache positions and RoPE; between chunks the host admits
    queued prompts into slots whose planned occupancy ran out.
  - Queued prompts are prefilled in groups of up to 4, each group padded to
    one power-of-two bucket.
  - Sampling stays on the device and the token chain never leaves it: the
    host learns tokens from a device->host copy queued right after each
    chunk into pinned memory, and a CUDA event recorded after that copy says
    when the chunk is ready. Under ``serve_forever`` a fetcher thread waits
    on those events so the dispatch loop never blocks on a transfer.

With a ``mesh`` (the reference's tensor-parallel engine,
``ray_tpu/models/engine.py:315-322``): each rank keeps its own heads, kv
heads, d_ff columns, vocabulary rows and experts (the ``tensor`` and
``expert`` axes; every other axis is a replica of the engine) and its kv
heads' part of the cache; decode and prefill sum the attention and FFN
outputs over the ranks and gather the logits before sampling. The
reference is one controller; here every rank runs its own engine, so all
ranks must run the same schedule: drive it by ``step()`` with the same
submissions on every rank, and the same ``seed`` (the sampling draws then
agree). ``serve_forever`` admits requests as they come and would need rank
0's admissions broadcast: on more than one rank it is refused (ROADMAP
A1c).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.config import TransformerConfig
from ray_tpu_torch.models.generate import (_attn_sum, _ffn, _final_logits,
                                           _gqa_attention, _prefill_hidden,
                                           sample)
from ray_tpu_torch.models.transformer import (Params, embed_tokens, layer,
                                              param_logical_axes, qkv_proj,
                                              rms_norm)
from ray_tpu_torch.parallel.mesh import check_supported, mesh_device
from ray_tpu_torch.parallel.sharding import local_shard, logical_placements

SlotCache = Dict[str, torch.Tensor]
# {"k"/"v": [L, B, S, KV, hd], "pos": [B], "start": [B]}: pos[b] is slot b's
# next write position; start[b] its first real (non-pad) position.


def init_slot_cache(cfg: TransformerConfig, slots: int, max_len: int,
                    device, kv_heads=None) -> SlotCache:
    """``kv_heads``: this rank's, on a tensor mesh (default all)."""
    shape = (cfg.n_layers, slots, max_len, kv_heads or cfg.kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": torch.zeros(slots, dtype=torch.int32, device=device),
            "start": torch.zeros(slots, dtype=torch.int32, device=device)}


def _sample(logits, rng, greedy: bool, temperature):
    return sample(logits, greedy, temperature, rng).to(torch.int32)


@torch.no_grad()
def prefill_slot(params: Params, cache: SlotCache, tokens, slot, start,
                 rng, cfg: TransformerConfig, greedy: bool = True,
                 temperature: float = 1.0, mesh=None):
    """Run the prompt ``tokens`` [1, P] (left-padded to its bucket, first
    real token at ``start``) and write its K/V into slot row ``slot``;
    -> (cache, first sampled token [])."""
    dev = cache["pos"].device
    cache, toks = prefill_slots(
        params, cache, tokens, torch.as_tensor([slot], device=dev),
        torch.as_tensor([start], device=dev), rng, cfg, greedy, temperature,
        mesh)
    return cache, toks[0]


@torch.no_grad()
def prefill_slots(params: Params, cache: SlotCache, tokens, slots, starts,
                  rng, cfg: TransformerConfig, greedy: bool = True,
                  temperature: float = 1.0, mesh=None):
    """Batched prefill: ``tokens`` [K, P] (left-padded to one shared bucket,
    first real token of row i at ``starts[i]``) lands in cache rows
    ``slots`` [K]; -> (cache, first sampled tokens [K]). The cache is
    updated in place. ``mesh``: the engine's (module docstring)."""
    K, P = tokens.shape
    x, cK = _prefill_hidden(params, tokens, cfg, P, starts, mesh)
    last = _final_logits(params, x[:, -1:], cfg, mesh)[:, 0]  # [K, V]
    toks = _sample(last, rng, greedy, temperature)      # [K]
    slots = slots.to(cache["pos"].device).long()
    cache["k"][:, slots, :P] = cK["k"].to(cache["k"].dtype)
    cache["v"][:, slots, :P] = cK["v"].to(cache["v"].dtype)
    cache["pos"][slots] = P
    cache["start"][slots] = starts.to(cache["start"].device,
                                      cache["start"].dtype)
    return cache, toks


def _write_rows(layer_cache, kv, pos):
    """Per-row cache write, in place: layer_cache [B, S, KV, hd] <- kv
    [B, 1, KV, hd] at per-row seq positions ``pos`` [B]. A row whose
    position is past the end writes nothing, as the reference's one-hot
    select does (junk substeps of a finished row may run past max_len)."""
    B, S = layer_cache.shape[:2]
    rows = torch.arange(B, device=layer_cache.device)
    at = pos.long().clamp(max=S - 1)
    inside = (pos < S)[:, None, None]
    layer_cache[rows, at] = torch.where(
        inside, kv[:, 0].to(layer_cache.dtype), layer_cache[rows, at])


def _decode_one(params: Params, cache: SlotCache, tokens,
                cfg: TransformerConfig, mesh=None):
    """One decode step for every slot: tokens [B] (each slot's pending
    token) -> (cache with pos advanced, logits [B, V]). pos, RoPE and the
    attention masks are per row, so slots admitted at different times
    decode together."""
    pos, start = cache["pos"], cache["start"]
    x = embed_tokens(params, tokens[:, None], cfg, mesh)  # [B, 1, d]
    positions = pos[:, None]  # [B, 1] per-row RoPE
    S = cache["k"].shape[2]
    kpos = torch.arange(S, device=x.device)[None, None, None, None, :]
    mask = (kpos <= pos[:, None, None, None, None]) & \
        (kpos >= start[:, None, None, None, None])
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = qkv_proj(h, lp, cfg, positions)
        k_layer, v_layer = cache["k"][i], cache["v"][i]
        _write_rows(k_layer, k, pos)
        _write_rows(v_layer, v, pos)
        o = _gqa_attention(q, k_layer, v_layer, mask)
        x = x + _attn_sum(o, lp, cfg, mesh)
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + _ffn(h, lp, cfg, mesh)
    logits = _final_logits(params, x, cfg, mesh)[:, 0]  # [B, V]
    cache["pos"] = pos + 1
    return cache, logits


@torch.no_grad()
def decode_slots(params: Params, cache: SlotCache, tokens, active, rng,
                 cfg: TransformerConfig, greedy: bool = True,
                 temperature: float = 1.0, eos_id: int = -1,
                 steps: int = 1, mesh=None):
    """``steps`` decode substeps for every slot: tokens [B] (pending
    sampled-but-not-decoded tokens), active [B] bool; -> (cache,
    [B, steps+1]) where column 0 echoes the INPUT tokens and columns
    1..steps are the new samples.

    Rows whose input is ``eos_id`` or that hit it mid-chunk freeze (keep
    emitting eos, like generate()); inactive slots compute junk into a
    position the next real write or prefill overwrites, their positions
    don't advance, and the host ignores their samples.
    """
    pos0 = cache["pos"]
    tok = tokens
    done = tokens == eos_id
    out = [tokens]
    for _ in range(steps):
        cache, logits = _decode_one(params, cache, tok, cfg, mesh)
        nxt = _sample(logits, rng, greedy, temperature)
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        done = done | (nxt == eos_id)
        tok = nxt
        out.append(nxt)
    active = active.to(pos0.device)
    cache["pos"] = torch.where(active, cache["pos"], pos0).to(torch.int32)
    return cache, torch.stack(out, dim=1)


# ---- host-side scheduler ----------------------------------------------------

_FINISH_EOS = "eos"
_FINISH_LENGTH = "length"


@dataclass
class _Chunk:
    """One dispatched decode chunk: its tokens' host copy (pinned, filled
    by a copy queued behind the chunk) and the event recorded after it."""
    host: torch.Tensor
    ready: Optional[torch.cuda.Event]
    snapshot: list


def _chunk_ready(chunk: _Chunk) -> bool:
    """True when the device has finished the chunk and its copy to the host
    (non-blocking). Always true on the CPU, where the copy is synchronous."""
    return chunk.ready is None or chunk.ready.query()


@dataclass
class _Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    tokens: List[int] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    stream_q: Optional[queue.Queue] = None
    finish_reason: Optional[str] = None
    error: Optional[BaseException] = None

    def emit(self, tok: int):
        self.tokens.append(tok)
        if self.stream_q is not None:
            self.stream_q.put(tok)

    def finish(self, reason: str):
        self.finish_reason = reason
        if self.stream_q is not None:
            self.stream_q.put(None)  # sentinel: stream closed
        self.done.set()


class InferenceEngine:
    """Slot scheduler over ``prefill_slots``/``decode_slots``.

    ``step()`` is one engine iteration: admit queued prompts into free
    slots (prefill), then advance every active slot (decode).
    ``serve_forever`` runs steps on a background thread; ``submit`` /
    ``submit_stream`` are thread-safe entry points. The engine runs on
    ``device``, CUDA unless the caller asks for the CPU; with a ``mesh`` on
    the mesh's device, holding this rank's part of ``params`` (the full
    params, plain or DTensors, the same on every rank; module docstring).
    """

    def __init__(self, params: Params, cfg: TransformerConfig, *,
                 slots: int = 8, max_prompt_len: int = 64,
                 max_new_tokens: int = 32, greedy: bool = True,
                 temperature: float = 1.0, eos_id: int = -1,
                 pad_id: int = 0, mesh=None, seed: int = 0,
                 min_bucket: int = 16, decode_chunk: int = 4,
                 fetch_every: int = 1, max_inflight: int = 6,
                 device=None):
        self.mesh, self._ranks = None, 1
        if mesh is not None:
            check_supported(mesh, cfg)
            self.mesh, params = _model_part(mesh, params, cfg)
            self._ranks = mesh.size()
            self.device = mesh_device(mesh)
        else:
            self.device = resolve_device(device)
        self.cfg = cfg
        self.slots = int(slots)
        self.max_prompt_len = int(max_prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.greedy = bool(greedy)
        self.temperature = float(temperature)
        self.eos_id = int(eos_id)
        self.pad_id = int(pad_id)
        # multi-step scheduling: decode_chunk substeps per dispatch;
        # admission happens between chunks
        self.decode_chunk = max(1, int(decode_chunk))
        # inline step() mode: deliver once this many chunks are pending.
        # Under serve_forever the fetcher thread paces itself instead.
        self.fetch_every = max(1, int(fetch_every))
        # pipelined mode: dispatched-but-undelivered chunks allowed before
        # the dispatch loop waits for the fetcher (bounds delivery latency)
        self.max_inflight = max(1, int(max_inflight))
        self._max_len = self.max_prompt_len + self.max_new_tokens
        self._buckets = []
        b = max(8, int(min_bucket))
        while b < self.max_prompt_len:
            self._buckets.append(b)
            b *= 2
        self._buckets.append(self.max_prompt_len)

        self.params = _to_device(params, self.device)
        self.cache = init_slot_cache(cfg, self.slots, self._max_len,
                                     self.device,
                                     self.params["layers"]["wk"].shape[2])
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._rid = itertools.count()
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._slot_req: List[Optional[_Request]] = [None] * self.slots
        # planned-occupancy scheduling: _slot_left[s] is how many tokens the
        # resident request is still OWED BY DISPATCH (not by fetch), so
        # admission never waits for a device->host copy; eos can only
        # shorten a plan and is reclaimed when delivery reveals it
        self._slot_left: List[int] = [0] * self.slots
        # slots admitted but not yet decoded once: their next chunk's echo
        # column carries the prefill-sampled token (emit from col 0)
        self._slot_new: List[bool] = [False] * self.slots
        # the token chain lives ON DEVICE: chunk N+1's inputs are chunk N's
        # last samples, or a prefill's first samples merged in by index
        self._next_tok_dev = torch.zeros(self.slots, dtype=torch.int32,
                                         device=self.device)
        self._inflight: List[_Chunk] = []
        self._work = threading.Event()  # set when there may be work
        self._lock = threading.Lock()   # guards step() vs concurrent step()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fetcher: Optional[threading.Thread] = None
        self._fetch_evt = threading.Event()   # work for the fetcher
        # set when the step loop died on an unrecoverable error; submit()
        # raises from then on. _death_lock orders submit's check+enqueue
        # against _die's drain (not _lock, which a whole step() holds)
        self._fatal: Optional[BaseException] = None
        self._death_lock = threading.Lock()
        self.stats = {"prefills": 0, "prefill_dispatches": 0,
                      "decode_steps": 0, "fetches": 0, "tokens_out": 0,
                      "requests_done": 0, "fetch_wall_s": 0.0,
                      "cap_stalls": 0, "dispatch_wall_s": 0.0}
        self._at_cap = False

    # -------------------------------------------------------- submission

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None) -> _Request:
        """Enqueue a prompt; returns the request (wait on ``req.done``)."""
        req = self._make_request(prompt, max_new_tokens, stream=False)
        with self._death_lock:
            self._check_alive()
            self._queue.put(req)
        self._work.set()
        return req

    def submit_stream(self, prompt: Sequence[int],
                      max_new_tokens: Optional[int] = None):
        """Enqueue a prompt; returns an iterator of token ids that ends
        when the sequence finishes (eos or length)."""
        req = self._make_request(prompt, max_new_tokens, stream=True)
        with self._death_lock:
            self._check_alive()
            self._queue.put(req)
        self._work.set()

        def gen():
            while True:
                tok = req.stream_q.get()
                if tok is None:
                    if req.error is not None:
                        raise req.error
                    return
                yield tok
        return gen()

    def _make_request(self, prompt, max_new_tokens, stream: bool):
        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.max_prompt_len:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds this engine's "
                f"max_prompt_len={self.max_prompt_len}")
        mnt = self.max_new_tokens if max_new_tokens is None \
            else min(int(max_new_tokens), self.max_new_tokens)
        if mnt <= 0:
            raise ValueError("max_new_tokens must be >= 1")
        return _Request(rid=next(self._rid), prompt=prompt,
                        max_new_tokens=mnt,
                        stream_q=queue.Queue() if stream else None)

    # ------------------------------------------------------------- engine

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self.max_prompt_len

    def _tensor(self, arr):
        """A host array on the engine's device. To CUDA it goes from pinned
        memory without blocking: a plain copy would wait for the stream to
        drain and stall dispatching ahead of the device."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _admit_group(self, group: List[tuple]):
        """Dispatch ONE batched prefill for ``group`` = [(slot, req)]; the
        sampled first tokens join the device-side chain and reach the host
        in the next chunk's echo column. All rows pad to the largest
        member's bucket."""
        K = len(group)
        P = max(self._bucket(len(req.prompt)) for _, req in group)
        toks = np.full((K, P), self.pad_id, np.int32)
        slots = np.zeros(K, np.int64)
        starts = np.zeros(K, np.int32)
        for i, (slot, req) in enumerate(group):
            toks[i, P - len(req.prompt):] = req.prompt
            slots[i] = slot
            starts[i] = P - len(req.prompt)
        slots_dev = self._tensor(slots)
        self.cache, first = prefill_slots(
            self.params, self.cache, self._tensor(toks), slots_dev,
            self._tensor(starts), self._rng, self.cfg, self.greedy,
            self.temperature, self.mesh)
        self._next_tok_dev[slots_dev] = first
        for slot, req in group:
            self._slot_req[slot] = req
        self.stats["prefills"] += K
        self.stats["prefill_dispatches"] += 1

    _GROUP_SIZES = (4, 2, 1)  # prefill batch sizes, largest first

    def warmup(self):
        """Run every (bucket, group size) prefill and one decode chunk once,
        so first-call costs (cuBLAS handles, allocator growth, kernel
        builds) land before serving. Resets slot state afterwards."""
        sizes = [s for s in self._GROUP_SIZES if s <= self.slots]
        with torch.no_grad():
            for bucket in self._buckets:
                for K in sizes:
                    toks = np.full((K, bucket), self.pad_id, np.int32)
                    toks[:, -1] = 1
                    slots = torch.arange(K, device=self.device)
                    self.cache, first = prefill_slots(
                        self.params, self.cache, self._tensor(toks), slots,
                        torch.full((K,), bucket - 1, dtype=torch.int32,
                                   device=self.device),
                        self._rng, self.cfg, self.greedy, self.temperature,
                        self.mesh)
                    self._next_tok_dev[slots] = first
            self.cache, toks = decode_slots(
                self.params, self.cache, self._next_tok_dev,
                torch.ones(self.slots, dtype=torch.bool, device=self.device),
                self._rng, self.cfg, self.greedy, self.temperature,
                self.eos_id, steps=self.decode_chunk, mesh=self.mesh)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # reset bookkeeping: positions to zero, junk K/V is unreachable
        self.cache["pos"].zero_()
        self.cache["start"].zero_()
        self._next_tok_dev.zero_()
        return self

    def _emit_to(self, req: _Request, slot: int, tok: int):
        """Record one generated token; on an eos finish, reclaim the slot's
        remaining planned occupancy."""
        req.emit(tok)
        self.stats["tokens_out"] += 1
        reason = None
        if tok == self.eos_id:
            reason = _FINISH_EOS
        elif len(req.tokens) >= req.max_new_tokens:
            reason = _FINISH_LENGTH
        if reason is not None:
            if self._slot_req[slot] is req:
                self._slot_req[slot] = None
                self._slot_left[slot] = 0
            self.stats["requests_done"] += 1
            req.finish(reason)

    def step(self) -> bool:
        """One engine iteration; returns True if any work was done."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> bool:
        # 1) admission into planned-free slots (no fetch needed to know)
        admitted = self._admit_locked()
        # 2) dispatch one full-width decode chunk when there is planned
        #    work and (pipelined mode) room under the in-flight cap
        dispatched = self._dispatch_locked()
        # 3) delivery: inline mode delivers here once fetch_every chunks
        #    are pending; pipelined mode hands them to the fetcher thread
        processed = False
        if self._fetcher is None:
            if self._inflight and (len(self._inflight) >= self.fetch_every
                                   or not dispatched):
                pending, self._inflight = self._inflight, []
                self._deliver_locked(self._fetch_chunks(pending), pending)
                processed = True
        elif self._inflight:
            self._fetch_evt.set()
        return bool(admitted or dispatched or processed)

    def _admit_locked(self) -> int:
        """Admit queued prompts into planned-free slots; one batched
        prefill per power-of-two group. Returns #admitted."""
        take: List[tuple] = []
        for slot in range(self.slots):
            if self._slot_left[slot] > 0:
                continue
            if self._slot_req[slot] is not None:
                # planned release: dispatching for it is complete
                self._slot_req[slot] = None
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            take.append((slot, req))
        i = 0
        while i < len(take):
            K = next(k for k in self._GROUP_SIZES if k <= len(take) - i)
            group = take[i:i + K]
            i += K
            try:
                self._admit_group(group)
            except BaseException as e:
                # a failed prefill poisons the engine: fail this group AND
                # every later dequeued-but-ungrouped request, which neither
                # the queue nor a slot holds any more, then re-raise
                for _slot, req in group + take[i:]:
                    req.error = e
                    req.finish("error")
                raise
            for slot, req in group:
                # the plan includes the prefill-sampled first token
                self._slot_left[slot] = req.max_new_tokens
                self._slot_new[slot] = True
        return len(take)

    def _dispatch_locked(self) -> bool:
        active_slots = [s for s in range(self.slots)
                        if self._slot_left[s] > 0]
        if not active_slots:
            return False
        if self._fetcher is not None and \
                len(self._inflight) >= self.max_inflight:
            # count stall EPISODES, not the parked loop's wakeups
            if not self._at_cap:
                self.stats["cap_stalls"] += 1
                self._at_cap = True
            return False  # dispatch-ahead cap: wait for the fetcher
        self._at_cap = False
        t0 = time.perf_counter()
        width = self.decode_chunk
        snapshot = []
        for slot in active_slots:
            new = self._slot_new[slot]
            self._slot_new[slot] = False
            take = min(self._slot_left[slot], width + (1 if new else 0))
            snapshot.append((slot, self._slot_req[slot],
                             0 if new else 1, take))
            self._slot_left[slot] = max(
                0, self._slot_left[slot] - (width + 1 if new else width))
        active = np.zeros(self.slots, bool)
        active[active_slots] = True
        self.cache, toks = decode_slots(
            self.params, self.cache, self._next_tok_dev,
            self._tensor(active), self._rng, self.cfg, self.greedy,
            self.temperature, self.eos_id, steps=width, mesh=self.mesh)
        self._next_tok_dev = toks[:, -1].contiguous()
        self._inflight.append(self._queue_copy(toks, snapshot))
        self.stats["decode_steps"] += width
        self.stats["dispatch_wall_s"] += time.perf_counter() - t0
        return True

    def _queue_copy(self, toks, snapshot) -> _Chunk:
        """Queue the chunk's device->host copy behind it on the stream."""
        if toks.device.type != "cuda":
            return _Chunk(toks, None, snapshot)
        host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return _Chunk(host, ready, snapshot)

    def _fetch_chunks(self, pending: List[_Chunk]) -> np.ndarray:
        """Wait for ``pending`` chunks' host copies; -> [B, n*(chunk+1)].
        Called outside the lock by the fetcher; inline mode calls it under
        the lock."""
        t0 = time.perf_counter()
        for c in pending:
            if c.ready is not None:
                c.ready.synchronize()
        parts = [c.host.numpy() for c in pending]
        big = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
        self.stats["fetches"] += 1
        self.stats["fetch_wall_s"] += time.perf_counter() - t0
        return big

    def _deliver_locked(self, big: np.ndarray, pending: List[_Chunk]):
        W = self.decode_chunk + 1
        for i, chunk in enumerate(pending):
            seg = big[:, i * W:(i + 1) * W]
            for slot, req, from_col, take in chunk.snapshot:
                if req.done.is_set():
                    continue  # finished in an earlier chunk
                for t in range(from_col, from_col + take):
                    self._emit_to(req, slot, int(seg[slot, t]))
                    if req.done.is_set():
                        break  # rest of the row is frozen eos/junk

    # ---------------------------------------------------- background loop

    def serve_forever(self):
        """Run the engine on a daemon thread until ``shutdown()``, plus a
        fetcher thread that waits for chunks' host copies behind the
        dispatch loop."""
        if self._thread is not None:
            return self
        if self._ranks > 1:
            raise NotImplementedError(
                "serve_forever on a mesh of more than one rank needs rank "
                "0's admission decisions broadcast to every rank: ROADMAP "
                "A1c; drive the engine by step() with the same submissions "
                "on every rank")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if self._fatal is not None:
                    return
                try:
                    busy = self.step()
                except BaseException as e:
                    # an error escaping step() kills the engine: error out
                    # every in-flight and queued request so no waiter hangs,
                    # and refuse new submissions
                    self._die(e)
                    return
                if not busy:
                    # idle or at the dispatch-ahead cap: PARK until state
                    # can change (submit, the fetcher taking chunks, or
                    # delivery all set _work); a busy-spin would take the
                    # host core the fetcher and client threads need
                    self._work.clear()
                    self._work.wait(timeout=0.05)

        def fetch_loop():
            while True:
                if self._fatal is not None:
                    return
                if self._stop.is_set() and not self._inflight:
                    return
                self._fetch_evt.wait(timeout=0.05)
                with self._lock:
                    if not self._inflight:
                        self._fetch_evt.clear()
                        pending = []
                    else:
                        # the OLDEST chunk (delivery must advance) plus any
                        # younger ones already finished; waiting for the
                        # whole backlog would stretch delivery latency
                        pending = [self._inflight.pop(0)]
                        while self._inflight and \
                                _chunk_ready(self._inflight[0]):
                            pending.append(self._inflight.pop(0))
                if not pending:
                    continue
                # room under the cap: wake the dispatch loop before waiting
                self._work.set()
                try:
                    big = self._fetch_chunks(pending)
                    with self._lock:
                        self._deliver_locked(big, pending)
                except BaseException as e:
                    self._die(e)
                    return
                self._work.set()

        self._thread = threading.Thread(target=loop, name="llm-engine",
                                        daemon=True)
        self._fetcher = threading.Thread(target=fetch_loop,
                                         name="llm-engine-fetch",
                                         daemon=True)
        self._thread.start()
        self._fetcher.start()
        return self

    def _check_alive(self):
        if self._fatal is not None:
            raise RuntimeError(
                "InferenceEngine is dead (step loop failed)") \
                from self._fatal

    def _die(self, exc: BaseException):
        """Mark the engine dead and fail every known request."""
        failed = [r for r in self._slot_req if r is not None]
        self._slot_req = [None] * self.slots
        self._slot_left = [0] * self.slots
        self._slot_new = [False] * self.slots
        with self._death_lock:
            # after this block no submit() can enqueue: _fatal is visible
            # to every later check, and the queue is drained
            self._fatal = exc
            while True:
                try:
                    failed.append(self._queue.get_nowait())
                except queue.Empty:
                    break
        for chunk in self._inflight:
            failed.extend(req for _, req, _, _ in chunk.snapshot)
        self._inflight = []
        for req in failed:
            if not req.done.is_set():
                req.error = exc
                req.finish("error")

    def shutdown(self):
        self._stop.set()
        self._work.set()
        self._fetch_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._fetcher is not None:
            self._fetcher.join(timeout=10)
            self._fetcher = None

    # ------------------------------------------------------- conveniences

    def generate(self, prompt: Sequence[int],
                 max_new_tokens: Optional[int] = None,
                 timeout: float = 300.0) -> List[int]:
        """Blocking single-prompt helper (drives steps inline if no
        background thread is running)."""
        req = self.submit(prompt, max_new_tokens)
        if self._thread is None:
            while not req.done.is_set():
                if not self.step():
                    break
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return list(req.tokens)


def _model_part(mesh, params: Params, cfg: TransformerConfig):
    """The engine's mesh, the mesh's ``expert`` and ``tensor`` dims (the
    others are replicas), and this rank's part of the full ``params``
    (plain tensors, or DTensors taken whole) on it."""
    from torch.distributed.tensor import DTensor

    names = tuple(n for n in ("expert", "tensor")
                  if n in (mesh.mesh_dim_names or ()))
    sub = mesh[names[0] if len(names) == 1 else names]

    def part(x, axes):
        if isinstance(x, dict):
            return {k: part(x[k], axes[k]) for k in x}
        if isinstance(x, DTensor):
            x = x.full_tensor()
        return local_shard(x, sub, logical_placements(sub, axes)).contiguous()

    return sub, part(params, param_logical_axes(cfg))


def _to_device(params: Params, device: torch.device) -> Params:
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in params.items()}
