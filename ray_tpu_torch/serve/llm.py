"""LLM serving: a batched autoregressive-generation deployment.

The port of ``ray_tpu/serve/llm.py`` onto the port's model stack. Ref
analog: the reference's Serve LLM path (python/ray/serve + the "Ray Serve:
Llama-3 inference deployment (batched)" BASELINE.json config, served there
via vLLM-on-GPU workers). Replicas hold the params and run
``ray_tpu_torch.models.generate`` (or the continuous-batching engine) on
their GPU; ``@serve.batch`` coalesces concurrent single-prompt requests
into one [B, P] generate call. Prompts are left-padded into a fixed bucket
and batches padded to ``max_batch_size``, as in the reference, so each
row's numbers are those of the reference's one compiled shape.

Replicas run on CUDA unless given ``device="cpu"``; the device is resolved
inside the replica, after its lease exported ``CUDA_VISIBLE_DEVICES``, and a
replica that finds no card raises. So the builders request
``num_gpus=tensor_parallel`` for the replica, and a start deadline that
covers a fresh worker's torch import and CUDA context, unless
``device="cpu"``. This module imports torch only inside the replicas.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np

from ray_tpu_torch.serve.deployment import deployment


def _model_config(model):
    from ray_tpu_torch.models.config import TransformerConfig, get_config

    return (model if isinstance(model, TransformerConfig)
            else get_config(model))


def _load_params(cfg, checkpoint_dir: Optional[str], seed: int, device):
    """The replica's params: the reference's pickled numpy tree at
    ``checkpoint_dir``, or random from ``seed`` (not JAX's bits)."""
    import torch

    if checkpoint_dir is not None:
        import pickle

        from ray_tpu_torch.interop import params_from_numpy

        with open(checkpoint_dir, "rb") as f:
            return params_from_numpy(pickle.load(f), cfg, device)
    from ray_tpu_torch.models.transformer import init_params

    return init_params(torch.Generator(device).manual_seed(seed), cfg,
                       device)


class _LLMReplica:
    """Replica body: owns params + batched generate for one model config.

    ``model`` is a config name from ``ray_tpu_torch.models.config.get_config``
    (e.g. "gpt2-small", "llama3-1b") or a TransformerConfig; weights are
    randomly initialized unless ``checkpoint_dir`` (a pickled numpy tree of
    the reference's params) is given — serving infrastructure is what's
    under test here, not weights.
    """

    def __init__(self, model="tiny", *, max_batch_size: int = 8,
                 max_prompt_len: int = 64, max_new_tokens: int = 32,
                 batch_wait_timeout_s: float = 0.02,
                 checkpoint_dir: Optional[str] = None,
                 greedy: bool = True, temperature: float = 1.0,
                 pad_id: int = 0, eos_id: int = -1, seed: int = 0,
                 device=None):
        import torch

        from ray_tpu_torch._device import resolve_device

        cfg = _model_config(model)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_new_tokens = int(max_new_tokens)
        self.max_prompt_len = int(max_prompt_len)
        self.greedy = greedy
        self.temperature = float(temperature)
        self.pad_id = int(pad_id)
        # -1 (never sampled for non-negative vocabularies) disables the
        # eos freeze; when set, generate() stops extending finished rows
        # and stream() ends at the model's natural stop
        self.eos_id = int(eos_id)
        # stream() runs on caller threads while _generate runs on the
        # batcher's drainer thread: handing out generators must be atomic
        # or two concurrent sampling requests share one
        self._rng_lock = threading.Lock()
        self._rng = torch.Generator(self.device).manual_seed(seed)
        self.params = _load_params(cfg, checkpoint_dir, seed, self.device)
        self._max_bs = int(max_batch_size)
        # the batcher cap and the padded batch shape MUST be the same
        # number, so the batcher is built per-instance from the
        # constructor arg (a class-level @serve.batch would freeze its
        # own cap). Held on self — not the module-global registry — so
        # replica teardown releases the params it closes over.
        from ray_tpu_torch.serve.batching import _Batcher

        self._batcher = _Batcher(self._max_bs, batch_wait_timeout_s)

    def _pad_batch(self, prompts: Sequence[Sequence[int]]):
        """Left-pad to the bucket so the last prompt token sits at the
        cache's write position for every row; returns (tokens [B,P],
        start [B]) where start marks each row's first real token (pad
        positions are masked out of attention by generate)."""
        P = self.max_prompt_len
        out = np.full((len(prompts), P), self.pad_id, np.int32)
        start = np.zeros(len(prompts), np.int32)
        for i, p in enumerate(prompts):
            p = list(p)  # oversized prompts were rejected in __call__
            out[i, P - len(p):] = p
            start[i] = P - len(p)
        return out, start

    def _next_rng(self):
        """A fresh generator seeded from the master's next draw (the
        reference's ``jax.random.split``)."""
        import torch

        with self._rng_lock:
            seed = int(torch.randint(2**62, (), generator=self._rng,
                                     device=self.device))
        return torch.Generator(self.device).manual_seed(seed)

    def _generate(self, prompts: List[Sequence[int]]) -> List[dict]:
        import torch

        from ray_tpu_torch.models.generate import generate

        toks, start = self._pad_batch(prompts)
        # pad the BATCH to max_batch_size too, as the reference pads it to
        # its one compiled shape
        B = toks.shape[0]
        if B < self._max_bs:
            toks_full = np.resize(toks, (self._max_bs, toks.shape[1]))
            start_full = np.resize(start, (self._max_bs,))
        else:
            toks_full, start_full = toks, start
        out = generate(self.params, toks_full, self.cfg,
                       max_new_tokens=self.max_new_tokens,
                       greedy=self.greedy, temperature=self.temperature,
                       eos_id=self.eos_id, rng=self._next_rng(),
                       start=torch.as_tensor(start_full, device=self.device))
        out = out.cpu().numpy()[:B, toks.shape[1]:]
        # trim each row at its first eos so the batched contract matches
        # stream(): output ends AT the natural stop, no eos-padded tail
        results = []
        for row in out:
            ids = row.tolist()
            if self.eos_id in ids:
                ids = ids[:ids.index(self.eos_id) + 1]
            results.append({"token_ids": ids})
        return results

    def stream(self, prompt: Sequence[int]):
        """Token-by-token generation: a generator the router streams back
        chunk-wise (``handle.options(method_name='stream', stream=True)``
        or chunked HTTP). Per-request B=1 decode via the stepwise
        prefill/decode_step API — streaming trades the batched program
        for first-token latency, the same trade the reference's streaming
        LLM responses make (serve/_private/replica.py generator path)."""
        import torch

        from ray_tpu_torch.models.generate import (decode_step, prefill,
                                                   sample)

        if len(prompt) > self.max_prompt_len:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds this deployment's "
                f"max_prompt_len={self.max_prompt_len}")
        # left-pad into the same fixed bucket as the batched path
        P = self.max_prompt_len
        toks = np.full((1, P), self.pad_id, np.int32)
        toks[0, P - len(prompt):] = list(prompt)
        start = torch.as_tensor([P - len(prompt)], dtype=torch.int32,
                                device=self.device)
        toks = torch.as_tensor(toks, device=self.device)
        max_len = P + self.max_new_tokens
        logits, cache = prefill(self.params, toks, self.cfg, max_len,
                                start)
        last = logits[:, -1]
        for i in range(self.max_new_tokens):
            rng = None if self.greedy else self._next_rng()
            tok = sample(last, self.greedy, self.temperature, rng).to(
                torch.int32)
            yield {"token_id": int(tok[0])}
            if int(tok[0]) == self.eos_id:  # natural stop
                return
            if i + 1 < self.max_new_tokens:  # last step has no consumer
                last, cache = decode_step(self.params, cache, tok,
                                          self.cfg, start)

    def __call__(self, prompt: Sequence[int]) -> dict:
        if len(prompt) > self.max_prompt_len:
            # refuse rather than silently conditioning on a clipped
            # prompt; the per-request check keeps one oversized prompt
            # from failing a whole coalesced batch
            raise ValueError(
                f"prompt length {len(prompt)} exceeds this deployment's "
                f"max_prompt_len={self.max_prompt_len}")
        return self._batcher.submit(self._generate, prompt)


def _tp_mesh(n: int, device):
    from ray_tpu_torch.parallel.mesh import MeshSpec

    return MeshSpec(data=1, fsdp=1, tensor=n).build(device)


def _tp_follower(rank: int, n: int, model, checkpoint_dir, seed: int,
                 device_type: str, engine_kw: dict):
    """Rank ``rank`` of a tensor-parallel replica's world: the same params
    from the same constructor arguments (no weights cross the world), its
    part of them, and rank 0's step plans until rank 0 stops."""
    from ray_tpu_torch.models.engine import InferenceEngine
    from ray_tpu_torch.parallel.mesh import mesh_device

    cfg = _model_config(model)
    mesh = _tp_mesh(n, device_type)
    params = _load_params(cfg, checkpoint_dir, seed, mesh_device(mesh))
    InferenceEngine(params, cfg, mesh=mesh, seed=seed, **engine_kw).follow()


class _ContinuousLLMReplica:
    """Continuous-batching replica: slot-level admission/eviction.

    Ref analog: the reference's request-cohort `@serve.batch`
    (python/ray/serve/batching.py:337) holds a batch until every member
    finishes decoding; this replica instead owns an
    `ray_tpu_torch.models.engine.InferenceEngine` whose decode loop refills
    a finished sequence's slot on the very next step — one long generation
    no longer stalls its batchmates (the vLLM-style redesign: static slot
    shapes, sampling on the device).

    ``tensor_parallel`` > 1 shards the model over that many GPUs of the
    replica's lease (a `num_gpus=N` replica). The reference runs one
    program over its local devices; here this process is rank 0 of a world
    of N (``parallel.world.World``) whose ranks 1..N-1 are follower
    processes on ``cuda:1``..``cuda:N-1`` (gloo ranks with
    ``device="cpu"``), each running the engine's ``follow()`` over rank 0's
    step plans. They end with the replica: ``__del__`` stops them, and a
    killed replica takes them along (``World``).
    """

    def __init__(self, model="tiny", *, slots: int = 8,
                 max_prompt_len: int = 64, max_new_tokens: int = 32,
                 checkpoint_dir: Optional[str] = None,
                 greedy: bool = True, temperature: float = 1.0,
                 pad_id: int = 0, eos_id: int = -1, seed: int = 0,
                 tensor_parallel: int = 1, decode_chunk: int = 4,
                 fetch_every: int = 1, device=None):
        import torch

        from ray_tpu_torch._device import resolve_device
        from ray_tpu_torch.models.engine import InferenceEngine

        cfg = _model_config(model)
        dev = resolve_device(device)
        engine_kw = dict(slots=slots, max_prompt_len=max_prompt_len,
                         max_new_tokens=max_new_tokens, greedy=greedy,
                         temperature=temperature, eos_id=eos_id,
                         pad_id=pad_id, decode_chunk=decode_chunk,
                         fetch_every=fetch_every)
        self._world = mesh = None
        if tensor_parallel > 1:
            from ray_tpu_torch.parallel.world import World

            if dev.type == "cuda" and \
                    torch.cuda.device_count() < tensor_parallel:
                raise ValueError(
                    f"tensor_parallel={tensor_parallel} but only "
                    f"{torch.cuda.device_count()} local devices")
            self._world = World(
                _tp_follower, tensor_parallel,
                (tensor_parallel, model, checkpoint_dir, seed, dev.type,
                 engine_kw), device=dev.type)
            mesh = _tp_mesh(tensor_parallel, dev.type)
        params = _load_params(cfg, checkpoint_dir, seed, dev)
        self.engine = InferenceEngine(
            params, cfg, mesh=mesh, seed=seed, device=dev,
            **engine_kw).serve_forever()

    def __call__(self, prompt: Sequence[int],
                 max_new_tokens: Optional[int] = None) -> dict:
        toks = self.engine.generate(prompt, max_new_tokens)
        return {"token_ids": toks}

    def stream(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None):
        for tok in self.engine.submit_stream(prompt, max_new_tokens):
            yield {"token_id": tok}

    def engine_stats(self) -> dict:
        return dict(self.engine.stats)

    def follower_pids(self) -> List[int]:
        """The tensor-parallel followers' process ids (none for one rank)."""
        return self._world.pids if self._world is not None else []

    def __del__(self):
        eng = getattr(self, "engine", None)
        if eng is not None:
            eng.shutdown()
        world = getattr(self, "_world", None)
        if world is not None:
            world.shutdown()


# How long a replica on the card may take to start (the controller's start
# deadline is the deployment's health_check_timeout_s, 10 s by default): a
# fresh worker imports torch, makes its CUDA context and builds or loads
# the params (with tensor_parallel, its followers do so too) before it
# answers its first ping.
GPU_REPLICA_START_S = 300.0


def _replica_options(device, tensor_parallel: int = 1) -> dict:
    """A replica on the card leases its GPUs (a worker without a GPU lease
    sees ``CUDA_VISIBLE_DEVICES=""`` and would find no card) and gets
    GPU_REPLICA_START_S to start."""
    if device is not None and str(device) == "cpu":
        return {}
    return {"ray_actor_options": {"num_gpus": tensor_parallel},
            "health_check_timeout_s": GPU_REPLICA_START_S}


def build_continuous_llm_deployment(model="tiny", *, name: str = "llm",
                                    num_replicas: int = 1,
                                    max_concurrency: int = 32,
                                    **replica_kwargs):
    """-> an Application whose replicas continuously batch generations.

    ``max_concurrency`` lifts the replica's query cap (and with it the
    actor's thread cap) so many callers can block in ``__call__`` while
    the engine thread interleaves them — admission happens per decode
    step, not per cohort. Each replica leases ``tensor_parallel`` GPUs
    and has GPU_REPLICA_START_S to start, unless ``device="cpu"``.
    """
    dep = deployment(_ContinuousLLMReplica, name=name) \
        .options(num_replicas=num_replicas,
                 max_concurrent_queries=max_concurrency,
                 **_replica_options(replica_kwargs.get("device"),
                                    replica_kwargs.get("tensor_parallel",
                                                       1)))
    return dep.bind(model, **replica_kwargs)


def build_llm_deployment(model="tiny", *, name: str = "llm",
                         num_replicas: int = 1, **replica_kwargs):
    """-> an Application serving ``{prompt token ids} -> {token_ids}``.
    Each replica leases one GPU and has GPU_REPLICA_START_S to start,
    unless ``device="cpu"``.

    Usage::

        app = build_llm_deployment("gpt2-small", max_new_tokens=16)
        handle = serve.run(app, name="llm")
        out = handle.remote([1, 2, 3]).result()
    """
    dep = deployment(_LLMReplica, name=name) \
        .options(num_replicas=num_replicas,
                 **_replica_options(replica_kwargs.get("device")))
    return dep.bind(model, **replica_kwargs)
