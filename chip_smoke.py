#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds every CUDA kernel of the port from the sources in this checkout, then
drives the port's serving and training paths on llama3-1b at full width
(d_model 2048, 16 layers, 32 heads / 8 KV heads, d_ff 8192, vocab 128,256,
tied embeddings; random weights and tokens from --seed), one JSON line per
phase:

  build     nvcc for every csrc/*.cu, all started together; ptxas'
            registers, shared memory and spills of every kernel (the phase
            fails if any kernel spills)
  device    the card, its count and power limit
  kernels   each kernel against its plain PyTorch version at the main
            paths' shapes and more: errors beside tolerances, kernel / plain
            / PyTorch-library times (CUDA events) and the card's bound;
            B1 (flash_fwd), then B2 and B3 (flash_bwd_dq, flash_bwd_dkv);
            for bf16 all three are sm_90a designs (TMA tile rings gated by
            mbarriers, wgmma)
  ring      ring attention (ray_tpu_torch.parallel.ring) for P = 4
            virtual ranks in one process at llama3-1b's attention width,
            bf16: [4, 2048, 32, 64] causal and non-causal, [1, 8192, 32,
            64] causal; the ring's block steps (B1 forward, B2/B3 backward
            per visited block, LSE merge) against B1 and B2/B3 over the
            whole sequence (ring_check), launches counted, both timed
  entry     ray_tpu_torch.entry.entry(): the GPT-2-small forward at
            [4, 512], finite logits of the right shape
  runtime   the port's runtime (ray_tpu_torch.init with the GPU count left
            to detection, which must equal nvidia-smi -L's): a 1 GiB bf16
            CUDA tensor put and read by a num_gpus=1 task in another
            process (checksums equal); a num_gpus=1 actor that sees GPU 0
            runs the forward at [4, 2048] through B1 (16 launches counted
            in the actor) and returns the last position's logits as a CUDA
            tensor, held against the driver's own forward within 1e-3; the
            actor returns a 256 MiB CUDA tensor (bitwise equal); GB/s of
            each transfer; no worker process left after shutdown()
  forward   forward(params, tokens[4, 2048]) in bf16 through the flash
            kernel (launches counted), against plain attention and the
            fp32 forward
  engine    InferenceEngine in fp32 (no TF32), token for token against the
            port's own generate()
  serving   InferenceEngine in bf16 at bench_serve.py's settings under
            serve_forever: 8 client threads, 32 requests
  serve     the port's Serve (ray_tpu_torch.serve) on its runtime: (1) the
            fp32 llama3-1b continuous replica of
            build_continuous_llm_deployment (num_gpus=1, params from the
            seed), phase engine's prompts, token for token against the
            in-process engine through handle.remote and a stream; (2)
            phase serving's bf16 cell through a handle from 8 driver
            threads (streamed: tokens/s, latency, TTFT, the replica's
            engine_stats and decode-chunk host/device ms, the ratio of its
            tokens/s to phase serving's in this run), and one request
            through the HTTP proxy equal to the handle's answer; (3) a
            num_gpus=1 deployment bound with the driver's bf16 params (CUDA
            tensors, sent by reference leaf by leaf) runs the forward at
            [4, 2048] through B1 (16 launches counted in the replica),
            logits bitwise equal to the driver's; deploy-to-ready seconds
            split into digest, put, the replica's start and fetch, and
            init; (4) no worker process left after serve.shutdown() and
            shutdown()
  moe_layer one Mixture-of-Experts layer of llama3-1b with 8 experts, top 2
            (capacity factor 1.25) at [4, 2048] bf16: moe_ffn (dispatch by
            index) against moe_ffn_dense (the reference's one-hot einsums):
            the same experts and kept slots exactly, the output within a
            per-element bf16 bound; both timed beside the layer's bound
  moe_forward  the 16-layer MoE model's forward at [4, 2048] bf16 through
            B1 (launches counted), against plain attention as distances from
            the fp32 forward; tokens that route differently
  moe_serving  the bf16 MoE model at 4 layers (moe_engine's and
            moe_train's) under serve_forever at bench_serve.py's settings,
            as phase serving
  moe_engine   the MoE model at 4 layers in fp32, the engine token for token
            against generate() on prompts that fill their bucket (no pads)
  moe_train    the MoE model at 4 layers, batch 4 x 2048, bf16, remat: the
            train check (a) and five AdamW steps with launches counted; ms
            per step and MFU of the active work
  moe_parallel the MoE layer at [4, 2048] on 4 virtual expert ranks (2
            experts each) and on 2 virtual sequence ranks, at capacity
            factor 1.25 and 0.5, against the unsharded layer by moe_layer's
            checks
  engine_mesh  the fp32 engine on make_mesh(tensor=1), an NCCL world of one,
            token for token against the unmeshed engine (the meshed
            engine's code path only: no split over ranks on one card)
  tensor    the train cell on 4 virtual tensor ranks (VirtualMesh: each
            rank's heads through B1/B2/B3 at [32, 2048, 64], the partial
            sums added in one process): the forward check and train check
            (a) against the unmeshed plain and fp32 runs, launches 64 /
            128/64/64, times and a rank's share
  pipeline  the train cell in 4 virtual GPipe stages of 4 layers on 4
            microbatches of [1, 2048] (bubble ticks skipped): the same
            checks and launches, times, the bubble share
  train_mesh   phase train's cell on make_mesh(fsdp=1), an NCCL world of
            one: params and moments as DTensors, each layer's weights
            gathered at use; one step's loss and gradient against the
            unmeshed step's (equal within 1e-6), then five AdamW steps with
            launches counted, ms per step and peak memory
  train_dots   phase train's cell with remat_policy="dots": one step's loss
            and gradient against the "nothing" step's; two timed optimizer
            steps each way and a third under the profiler: launches, ms per
            step, device time and peak memory
  train     bench.py's llama3-1b training cell (batch 4 x 2048, bf16
            params, remat, AdamW with a bf16 first moment): one step's loss
            and gradient through the kernels and through plain attention,
            each against the fp32 step; five optimizer steps through the
            kernels with their launches counted; ms per step, tokens/s, MFU,
            peak memory and the device's busy share
  trainer   the train cell at 4 of its 16 layers (full width) through
            the port's Train library, after the driver's state is freed:
            the driver runs the cut cell's five steps first, then
            ray_tpu_torch.train.TorchTrainer with one num_gpus=1 worker
            (trainer_loop) builds the state from --seed, runs steps 1-5
            reporting each loss, B1-B3 launches and wall, reports the whole
            state as a checkpoint at step 3 (to the driver through the
            object plane, then to disk) and fails once after step 4's
            report; the gang restart reads the step-3 checkpoint back onto
            the card in a new worker and runs steps 4-5. Checks: no error;
            the worker sees GPU 0 alone; 8/4/4 launches every step; six
            reports (steps 1, 2, 3, 4, 4, 5); the losses equal the
            driver's, and the restart's step 4 the first attempt's, within
            1e-6 relative; the kept checkpoint's per-leaf
            checksums equal the step-3 state's; no worker left. Numbers:
            the worker's start split, ms per step, peak memory, the
            checkpoint's bytes and seconds (device to host, the report to
            the driver, the write) and the restart's split
  data      a shuffled Dataset feeding the train cell through the port's
            Data library: 1,024 rows of an int64 id and 2,049 int32 tokens
            (8.4 MB, numpy from --seed) in 16 blocks through
            ray_tpu_torch.data.from_numpy, random_shuffle(seed) through the
            pipelined exchange, a TorchTrainer with one num_gpus=1 worker
            (data_trainer_loop) and datasets={"train": ...}, so the dataset
            reaches it through streaming_split. The worker builds phase
            train's cell from --seed, takes iter_torch_batches(batch_size=4)
            with no device (the port's default, CUDA), runs 5 train steps
            on the first 5 batches (inputs tokens[:, :-1], targets
            tokens[:, 1:]) and drains the rest of the epoch onto the card.
            Checks: no error; the worker sees GPU 0 alone; every batch on
            cuda:0; 32/16/16 launches each step; finite losses; every id
            once, in the order the driver gets from the same plan; each
            row's tokens bitwise (checksums); data_shuffle_summary shows
            both exchanges; no worker left. Numbers: the shuffle's seconds
            and rows/s, the worker's start, each batch's wait beside its
            step's ms and the step's ms beside phase train's (the same
            cell) and phase trainer's (4 layers), the drain's batches/s and
            host-to-device GB/s, the phase's wall
  dag_workflow  the port's DAG and Workflow on its runtime: a diamond of
            num_gpus=1 steps (every one leases the whole card, so they run
            one after another): dag_forward_step builds llama3-1b in bf16
            at full width and 4 layers (_TRAINER_LAYERS) from --seed and
            returns counted_forward's dict (the last position's logits, a
            CUDA tensor [4, 128256] bf16, and B1's launches);
            dag_reduce_step takes it and returns the argmax and fp32 row
            sums; dag_join_step takes both. Each step's run is logged to a
            marker file. (a) dag.execute(seed) through InputNode: the
            logits bitwise equal to counted_forward in the driver at the
            same seed and depth, B1 4 launches in the step, the forward
            step ran once; (b) workflow.run(dag, input=seed) into a fresh
            storage directory: SUCCESSFUL, the output bitwise equal to
            (a)'s, the forward step's checkpoint loaded here a tensor on
            cuda:0 bitwise equal to (a)'s logits; (c) a second workflow
            whose join raises on its first call: RESUMABLE, then
            workflow.resume runs the join alone (the forward does not run
            again, no B1 launch in the resumed run) and ends SUCCESSFUL
            with the output bitwise equal to (a)'s; no worker left.
            Numbers: the first step's start after execute() (its worker's
            start), the forward's seconds, each workflow's wall, the
            resume's wall
  microbenchmark  python -m ray_tpu_torch.utils.microbenchmark --quick in
            a subprocess (120 s timeout): its JSON on a line of its own,
            every metric name of the reference's main, every rate
            positive, no worker left. These are the runtime's host rates
            on the card's machine (no GPU is leased)
  ops_layer the port's ops layer, each GPU step ops_forward_task: a
            num_gpus=1 task that builds llama3-1b in bf16 at full width
            and 4 layers (_TRAINER_LAYERS) from --seed on cuda:0 and runs
            counted_forward at [4, 2048] (B1 4 launches), returning the
            logits' SHA-256. (a) python -m ray_tpu_torch start --head
            --num-cpus 2 with no --num-gpus: `status` prints GPU a / t
            with t equal to nvidia-smi -L's count, `list nodes` shows it
            on the head's node; (b) JobSubmissionClient on that head
            submits an entrypoint (written to a temp dir) that attaches
            through RAY_TPU_ADDRESS and runs the task: SUCCEEDED, its logs
            (also through `job logs`) carry a checksum equal to the
            driver's own forward at the same seed and depth, B1 4; a
            second job (sleep 600) stopped through `job stop`: STOPPED,
            no process of its group left; (c) start_dashboard(port=0) in
            a driver attached to that head: /api/cluster's GPU total the
            card count and GPU available back at it, /api/jobs both jobs,
            / the UI with "GPU avail / total", every doctor endpoint 200;
            `doctor` exits 0; `stop` ends the head; (d) an in-process head
            without a GPU, an Autoscaler over BatchingNodeProvider(
            FakeGkeGpuCloud(num_gpus_per_node=1)): the task's lease
            queues, the pool grows one node (GPU 1, accelerator
            nvidia-h100-80gb), the task runs there with GPU 0 (bitwise
            the driver's, B1 4), then the pool shrinks to zero through
            one request that names the drained node; (e)
            utils.spark.setup_ray_cluster(num_gpus_per_node=1) through
            subprocess_launcher: the joined node declares GPU 1, a
            num_gpus=1 task placed on it sees one device named as
            nvidia-smi names the card, shutdown_ray_cluster() leaves no
            agent. After every step no head, agent, worker or job process
            is left. Numbers: the walls of (a)-(e), each fresh process's
            start, the job's submit-to-result, the pool's scale-up and
            scale-down seconds
  clients   the port's C++ and Java clients against its cross-language
            gateway: (a) native/build.py builds task_client and
            client_example (g++); (b) ray_tpu_torch.init(num_gpus=<the
            card count>) and head.enable_tcp: the gateway's cluster op
            reports GPU equal to the card count; (c) task_client
            actor-create chip_smoke:ClientsActor with num_gpus=1, then
            actor-call forward [seed]: the actor runs ops_forward_task's
            forward (4 layers) on cuda:0 and replies in JSON: the logits'
            SHA-256 equal to the driver's forward at the same seed and
            depth, B1 4, get_gpu_ids() [0]; (d) client_example puts the
            forward's [4, 2048] tokens as decimal text into the node's
            arena, actor-call forward_from_store reads them with get_raw,
            runs the same forward (bitwise the driver's, B1 4) and puts the
            4 rows' last-position argmax as text, which client_example
            gets: equal to the driver's argmax; (e) a CPU task by
            descriptor over the head's unix socket, a missing function
            (exit 1, "error" on stderr), actor-kill, after which
            actor-call exits 1; (f) with a JDK, (c)'s actor-call through
            RayTpuClient.java, else {"java": "no JDK"}; (g) shutdown()
            leaves no worker. Numbers: each step's wall, the actor's
            import, CUDA context, params and first forward; the phase's
            budget is 45 s
  train_pipeline  the train cell at 4 of its 16 layers (full width) as
            the port's MPMD pipeline (ray_tpu_torch.train.Pipeline) on a
            cluster_utils.Cluster whose head has no GPU and whose four
            logical nodes each declare one (all lease the card as GPU 0): 4
            num_gpus=1 stage actors of 1 layer (LlamaStage: the embedding on the first, the final norm
            and the tied head on the last; the table and the head are two
            stage params), 4 microbatches of [1, 2048], GPipe then 1F1B on
            one set of actors; elastic checkpoints off. Then 2 stages of 2
            layers x 2 replicas (1F1B), one replica a node, whose bf16 CUDA
            grads sum through ray_tpu_torch.collective. Checks: every stage
            actor leases GPU 0 and sees one device; GPipe's and 1F1B's
            loss and each stage's grads within 1e-6 relative of
            single_program_reference run here on the card, folding the
            microbatches in the schedule's backward order (expected
            bitwise), the two embedding copies each; B1/B2/B3 4/4/4 a
            batch in each stage actor (1 layer x 4 microbatches, and 2 x 2
            in the 2 x 2 run), counted there and read through probe(); the
            2 x 2 run's grads within _TPIPE_DP_BOUND of its oracle, per
            element, and its two replicas' grads equal bit for bit; no
            activation through the driver; no worker left. Numbers: the
            batch wall of each run, each stage's fwd/bwd exec, sched_wait
            (the bubble) and arg_fetch (the hop) from the phase rows, the
            stage actors' start, the grads' fetch, the oracle's wall, the
            card's peak use, the 2 x 2 run's all-reduce seconds, the
            embedding copies' sum against the whole batch's tied
            gradient
  rllib     the port's RLlib (ray_tpu_torch.rllib), fp32, TF32 off, at
            bench_rllib.py's cell (Breakout-Mini-v0: obs 400, 3 actions,
            hiddens (256, 256)): (a) PPO (batch 4096), IMPALA and APPO (T =
            N = 64), A2C (4096 rows) and DQN (its 64-row replay batch):
            each learner on the card against the same learner on the CPU
            from the same params on the same batch (rllib_parity): loss
            metrics within 1e-5 relative, each grad leaf within 1e-5 as
            |d|/|g|, the params after one Adam step within 1e-6 absolute
            plus lr |f(g_card) - f(g_cpu)|, f(g) = g / (|g| + eps): Adam's
            first step on the two sides' grads (adam_first_step_bound,
            at most 2 lr where |g| is near eps); (b) each
            learner's ms per update and env-steps/s consumed (PPO: 4
            epochs of 4096 in minibatches of 1024), one PPO update under
            torch.profiler (busy share, launches per minibatch step), the
            V-trace loop's share of an IMPALA update; (c) a LearnerGroup of
            2 learner actors on a cluster_utils.Cluster whose two logical
            nodes declare one GPU each (rllib_group_check): each sees GPU 0
            alone, its shard's grads equal the driver's learner's bit for
            bit, the averaged update leaves local and remote weights equal;
            (d) on ray_tpu_torch.init(num_cpus=8): PPO on CartPole-v1 at
            tests/test_rllib.py's settings with 2 CPU rollout workers must
            reach episode_reward_mean 130 within 150 iterations; PPO on
            Breakout-Mini-v0 at bench_rllib.py's end-to-end settings for 3
            iterations (env-steps/s, each iteration's sampling, update and
            weight sync), each worker's weights equal to the learner's
            after a sync; (e) a Tuner of PPO, 2 trials x 2 iterations with
            resources_per_trial {"CPU": 1, "GPU": 1}: both report, each
            learner on the card with GPU 0 leased; no worker left
  rllib2    RLlib part 2, fp32, TF32 off: (a) SAC, TD3 and DDPG at
            Pendulum's shapes (hiddens (256, 256), batch 128), R2D2 (obs
            400, 3 actions, GRU 64, 32 sequences of burn-in 4 + 16), BC,
            CQL and MARWIL (Breakout-Mini, batch 256), DreamerV3 at
            bench_rllib.py's cell (deter 128, hidden 128, 16 x 32 steps,
            horizon 15) and AlphaZero (TicTacToe, (64, 64), batch 256):
            each learner on the card against the same learner on the CPU
            from the same state, batch and noise, stage by stage
            (rllib2_parity: a second stage, SAC's and TD3's actor or
            Dreamer's actor-critic, against the CPU's loss at the inputs
            the card's saw), by phase rllib (a)'s bars; (b) ms per update
            and env-steps/s of each, SAC's and Dreamer's update under
            torch.profiler, Dreamer's three loops and its act per env
            step; (c) on ray_tpu_torch.init(num_cpus=8), every learner on
            the card: SAC on Pendulum to -900 within 100 iterations,
            DreamerV3 on CartPole to final > 60 and > early + 20 at
            iteration 30 (the reference tests' bars), Ape-X with 2 workers
            and 2 replay shards for 3 learning iterations (priorities
            reach the shards, workers' weights equal the learner's),
            MultiAgentPPO (two policies) and AlphaZero (2 self-play
            workers, their weights equal the learner's) for 2 iterations,
            CQL and MARWIL 64 updates on a 4096-step dataset; no worker
            left

After each phase a line {"phase_wall": name, "s": seconds}, after the last
the script's wall ({"script_wall_s": ...}). Then the kernel summary line, the card's nvidia-smi line, and as the last
line {"ok": true, "device": {...}}. Any failure exits non-zero before that
line. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import math
import os
import random
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

_ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): bf16 on the
# tensor cores, fp32 outside them (the fp32 kernel uses no TF32), HBM rate.
_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
_HBM_BYTES_PER_S = 3.35e12

# The kernel against its plain version: flash_attention.check_fwd, whose
# per-element bound on O follows each output's size (P rounded to bf16,
# O rounded to bf16) and whose LSE bound is 2e-4 + 2e-4 |lse|.
# Forward through the kernel vs through plain attention, as a relative
# distance of the logits: the two differ by the kernel's rounding (P in
# bf16, fp32 sums in another order) in each of 16 layers.
_FWD_REL_TOL = 1e-2
# The bf16 forward through the kernel may be at most 2% further from the
# fp32 forward than the plain-attention bf16 forward is (measured on the
# H100: 1.0045 times as far).
_FWD_BF16_RATIO = 1.02
# The train step's loss and gradients through the kernels may be at most
# this many times as far from the fp32 step as the plain-attention bf16
# step's are. Set from the plain bf16 step's own noise, measured on the H100
# over two weight seeds x two batches (kernel_mutants.py's baseline): the
# flattened gradient's distance held at 0.04350-0.04356 while the kernels'
# stayed 1.0039-1.0069 times it, so 1.05; the loss's distance is a scalar
# at bf16's floor and ranged 5.75e-6 to 4.38e-5, 7.6-fold, so 8. The loss
# reads the forward only. The leaves that B2's dQ and B3's dK, dV reach
# first are held on their own ("attn_grad": the largest ratio among
# _ATTN_GRAD_LEAVES): plain 0.0443-0.0450 from fp32, kernels 0.9941-1.0094
# times it, so 1.05. Mutants of B2 and B3 reach 8.45 and 3.48 there.
_TRAIN_BF16_RATIO = {"loss": 8.0, "grad": 1.05, "attn_grad": 1.05}
_ATTN_GRAD_LEAVES = ("layers.wq", "layers.wk", "layers.wv")
_TRAIN_STEPS = 5
_TRAIN_LAUNCHES = {"flash_fwd": 32, "flash_bwd_dq": 16, "flash_bwd_dkv": 16}

# The MoE configuration: llama3-1b at full width with 8 experts, top 2, the
# reference's capacity factor and aux weight. Training runs 4 of its 16
# layers (params, grads and both moments in bf16 are 8 B a parameter: 55 GB
# at 16 layers, 15 GB at 4).
_MOE = dict(moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
            moe_aux_weight=0.01)
_MOE_TRAIN_LAYERS = 4
_MOE_TRAIN_LAUNCHES = {"flash_fwd": 8, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}
# moe_layer: moe_ffn against moe_ffn_dense per element. Both gather the same
# bf16 rows (exactly) and run the same three products; they may differ only
# where a product's fp32 sum runs in another order and flips a bf16
# rounding of gate, up, the op-by-op SwiGLU (a few roundings) or the
# expert's output. With u = 2^-8 and A = sum over a token's kept slots of
# p * (|act| @ |W_down|) (the size the output's rounding follows), the bound
# is 2u|y| (y's own rounding, twice) + 6u A, with 5% and 1e-6 of slack, as
# check_fwd scales its bound; as a whole ||dy|| / ||y|| <= 1e-2.
_MOE_LAYER_UNIT = 2.0 ** -8
_MOE_LAYER_REL_TOL = 1e-2
# moe_layer's second case: a capacity factor under which about half the
# slots drop (C = 256 places an expert a row for 4,096 slots a row), so the
# dropped-slot path runs at full width too
_MOE_LAYER_DROP_CF = 0.5
# moe_forward: routing is a discontinuity. A token near a tie between two
# experts changes its experts when attention's rounding changes, and the
# change spreads to later layers and tokens: the bf16 forwards keep 0.37-
# 0.40 from the fp32 one with 10-11% of token-layers routed differently,
# and even fp32 through B1 and through plain attention route 0-107 of
# 131,072 token-layers differently. Measured on the H100 over 2 weight
# seeds x 2 batches of the unbroken kernels (kernel_mutants.py's baseline):
# the bf16 kernel/plain ratio of distances from the fp32 forward 0.9864-
# 1.0409, so 1.10 (B1's mutant: 3.09); fp32 kernel vs plain 1.1e-5 to
# 3.09e-2 (the largest with 107 flips), so 0.1.
_MOE_FWD_BF16_RATIO = 1.10
_MOE_FWD_FP32_REL_TOL = 0.1
# train_dots: "dots" only chooses which results the backward keeps and
# which it recomputes, from the same ops on the same inputs, so its step
# must equal "nothing"'s: loss (absolute) and flattened gradient (relative)
# within 1e-6, as tests/test_torch_remat_dots.py holds them on the CPU.
_DOTS_TOL = 1e-6
# ring: P virtual ranks; causal runs P(P+1)/2 blocks (the diagonal and the
# blocks below it), non-causal P^2. Cases: name, B, T, H, D, causal.
_RING_P = 4
_RING_CASES = (("main", 4, 2048, 32, 64, True),
               ("long", 1, 8192, 32, 64, True),
               ("noncausal", 4, 2048, 32, 64, False))
# Each side within the kernel checks' 1e-2 of the plain version, so the ring
# and the whole-sequence kernels within 2e-2 of each other, as a whole.
_RING_REL_NORM_TOL = 2e-2
# train_mesh: on a mesh of one every collective is skipped and the DTensor
# wrapper computes the same ops on the same tensors as the unmeshed step
_MESH_TOL = 1e-6
# tensor and pipeline: the model's ranks run in turn on the one card
# (VirtualMesh): 4 tensor ranks (8 of the 32 heads, 2 of the 8 kv heads,
# 2048 of the 8192 d_ff columns, 32,064 of the vocabulary rows each), or 4
# pipeline stages of 4 layers on 4 microbatches of [1, 2048]. The kernel
# side runs there, the plain bf16 and the fp32 truth unmeshed; the forward
# and train checks' ratios are set from the unbroken code over 2 weight
# seeds x 2 batches (kernel_mutants.py's baseline, on the H100). Tensor:
# the four ranks' bf16 partial sums of the output projections (attention
# and SwiGLU) round to bf16 each and add in bf16, as a bf16 psum does, so
# the forward keeps 1.0877-1.0899 times as far from fp32 as the unmeshed
# plain bf16 one, the gradient 1.0919-1.0945 (wq/wk/wv at most 1.0970),
# the loss 0.28-9.31 (a scalar at bf16's floor); in fp32 the split forward
# is 1.02e-5 from the unmeshed one. So 1.15, 1.15 and 16: the mutant that
# drops a rank's partial reaches 42.7 forward, 33.1 gradient. Pipeline:
# the same math a row, 1.0038-1.0050 forward, 1.0067-1.0089 gradient,
# wq/wk/wv at most 1.0158, loss 0.54-2.67: the unmeshed bars hold (the
# mutant that skips a stage: 40.2 forward, 33.3 gradient).
_TP, _PP, _PP_MICRO = 4, 4, 4
_TP_FWD_RATIO = 1.15
_TP_TRAIN_RATIO = {"loss": 16.0, "grad": 1.15, "attn_grad": 1.15}
_PP_FWD_RATIO = _FWD_BF16_RATIO
_PP_TRAIN_RATIO = _TRAIN_BF16_RATIO
# B1 / B2 / B3 launches, each at [B*H/t = 32, 2048, 64]: a forward runs 16
# layers x 4 ranks (or x 4 microbatches: the port skips the bubble ticks),
# a remat train step that forward, its recompute, and one B2 and B3 each
# runtime: the object store's arena, the tensors moved (bf16), and the
# actor's logits against the driver's, as a relative distance (the same
# kernels on the same inputs: equal unless a library picks another
# algorithm in the worker)
_RUNTIME_STORE_BYTES = 4 << 30
_RUNTIME_PUT_BYTES = 1 << 30
_RUNTIME_RETURN_BYTES = 256 << 20
_RUNTIME_REL_TOL = 1e-3
_WORKER_PROBE = "ray_tpu_torch[.]core[.]worker_main"
# trainer: the runtime's arena holds the step-3 checkpoint once on its way
# to the driver (llama3-1b's bf16 params, bf16 mu and bf16 nu: 7.4 GB) with
# headroom. The host needs room for the arena, the worker's host copy of
# the state and the copy read back from disk at once; the disk for one
# checkpoint (num_to_keep=1) while the next is written. The worker's
# losses must equal phase train's, which runs the same arithmetic on the
# same card (B1-B3 use no atomics), and the restart's step the first
# attempt's, to within _TRAINER_REL_TOL each.
_TRAINER_STORE_BYTES = 12 << 30
_TRAINER_HOST_BYTES = 40 << 30
_TRAINER_DISK_BYTES = 16 << 30
_TRAINER_CKPT_STEP = 3
_TRAINER_FAIL_STEP = 4
_TRAINER_REL_TOL = 1e-6
# the trainer's cell is cut to 4 of llama3-1b's 16 layers (full width):
# its checkpoint (3.0 GB, against 7.4 GB at 16) and restart set the
# phase's wall, and the script must leave room for phase data within its
# time limit. Per step: B1 twice a layer (forward and remat), B2, B3 once
_TRAINER_LAYERS = 4
_TRAINER_LAUNCHES = {"flash_fwd": 2 * _TRAINER_LAYERS,
                     "flash_bwd_dq": _TRAINER_LAYERS,
                     "flash_bwd_dkv": _TRAINER_LAYERS}
# data: a pre-tokenized shard of 1,024 rows (an int64 id, 2,049 int32
# tokens below the vocabulary; 8.4 MB) in 16 blocks, random_shuffle(seed)
# through the pipelined exchange, streaming_split to one num_gpus=1
# TorchTrainer worker whose iter_torch_batches(batch_size=4) has no device
# (CUDA): 5 train steps of phase train's cell on the first 5 batches, then
# the rest of the epoch drained onto the card
_DATA_ROWS = 1024
_DATA_BLOCKS = 16
_DATA_SEQ = 2049
_DATA_BATCH = 4
_DATA_STEPS = 5
_DATA_STORE_BYTES = 2 << 30
# dag_workflow: a diamond of num_gpus=1 steps over llama3-1b's bf16 forward
# at full width and _TRAINER_LAYERS layers (B1 once a layer); the phase's
# budget is 60 s of the script's 1,200
_DAG_LAUNCHES = {"flash_fwd": _TRAINER_LAYERS, "flash_bwd_dq": 0,
                 "flash_bwd_dkv": 0}
_DAG_STORE_BYTES = 1 << 30
# microbenchmark: `python -m ray_tpu_torch.utils.microbenchmark --quick` in
# a subprocess; every metric name of the reference's main
# (ray_tpu/utils/microbenchmark.py; tests/test_torch_ecosystem.py holds
# this list to it)
_MICROBENCH_TIMEOUT_S = 120
_MICROBENCH_METRICS = (
    "single_client_tasks_sync", "single_client_tasks_async",
    "single_client_tasks_with_arg_async", "1_1_actor_calls_sync",
    "1_1_actor_calls_async", "1_1_actor_calls_concurrent",
    "n_n_actor_calls_async", "single_client_put_calls",
    "single_client_get_calls", "single_client_get_calls_uncached",
    "single_client_put_100mb_calls", "single_client_put_gigabytes",
    "placement_group_create/removal")
# ops_layer: the CLI, jobs, the dashboard and doctor, the autoscaler with a
# fake GKE GPU pool and the Spark shim, each GPU step llama3-1b's bf16
# forward at full width and _TRAINER_LAYERS layers (B1 once a layer); the
# phase's budget is 75 s of the script's 1,200
_OPS_LAUNCHES = _DAG_LAUNCHES
_OPS_BUDGET_S = 75.0
_OPS_POOL_ACCELERATOR = "nvidia-h100-80gb"
_OPS_TIMEOUT_S = 300
# every process the phase may start: heads and agents (`python -m
# ray_tpu_torch start`, node agents), workers, the job's entrypoint
_OPS_PROBES = (_WORKER_PROBE, "ray_tpu_torch[.]core[.]node_agent",
               "ray_tpu_torch [s]tart", "ops_layer_[j]ob")
# clients: the C++-created actor's forward as ops_layer's (B1 4); the
# phase's budget is 45 s; the processes it may start: workers and the
# native and Java clients
_CLIENTS_BUDGET_S = 45.0
_CLIENTS_ACTOR = "cpp-forward"
_CLIENTS_TIMEOUT_S = 120
_CLIENTS_PROBES = (_WORKER_PROBE, "[t]ask_client-", "[c]lient_example-",
                   "[R]ayTpuClient")
# serve: phase engine's prompt lengths and new tokens (its fp32 check), and
# the 8 warm-up requests the bf16 replica serves before the timed ones
# (phase serving warms its engine up in process; a replica cannot be)
_ENGINE_PROMPT_LENS = (5, 17, 40, 64)
_ENGINE_MAX_NEW = 32
_SERVE_WARMUP_LENS = (8, 16, 24, 32, 40, 48, 56, 64)
_AXIS_LAUNCHES = {
    "forward": {"flash_fwd": 64, "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
    "train": {"flash_fwd": 128, "flash_bwd_dq": 64, "flash_bwd_dkv": 64}}

# train_pipeline: the train cell as an MPMD pipeline of stage actors
# (ray_tpu_torch.train.pipeline) on logical nodes of a cluster_utils.Cluster
# that each declare the one card. 4 stages of 4 layers (no remat inside a
# stage: B1 runs once a layer and microbatch, so each stage launches B1, B2
# and B3 exactly 4 x 4 = 16 times a batch), 4 microbatches of [1, 2048].
# GPipe and 1F1B against single_program_reference on the card: the same
# kernels on the same inputs, and a stage folds each microbatch's grads as
# its backward runs, so the oracle that folds in the schedule's backward
# order (reversed for GPipe) is expected equal bit for bit; 1e-6 relative is
# the bar. 2 stages x 2 replicas (here and in the 4-card test): each
# replica sums its two microbatches' bf16 grads, the collective adds the
# two sums (bf16), the oracle adds the four in turn. Both are sums of the same four terms, with
# unit roundoff u = 2^-8 per bf16 add: 2 adds' worth (2u sum|g_i|) against
# 3 (3u sum|g_i|), so per element |dp - oracle| <= 5u sum_i|g_i| / M to
# first order; 1.05 of that is the bar (written before the first run).
# the pipeline's cell is cut to 4 of the 16 layers (full width), one a
# stage (2 a stage in the 2 x 2 run), for the script's time limit: the
# stage actors' start, the grads' fetch and the all-reduce scale with it.
# Per stage and batch: each layer's B1, B2, B3 once a microbatch (no remat
# in a stage); 4 stages x 1 layer x 4 microbatches, or 2 x 2 x 2
_TPIPE_STAGES, _TPIPE_MICRO, _TPIPE_DEPTH = 4, 4, 4
_TPIPE_LAYERS = _TPIPE_DEPTH // _TPIPE_STAGES
_TPIPE_REL_TOL = 1e-6
_TPIPE_LAUNCHES = {k: _TPIPE_LAYERS * _TPIPE_MICRO
                   for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
_TPIPE_DP_BOUND = 1.05 * 5 * 2.0 ** -8
_TPIPE_HEAD_STORE = 8 << 30
_TPIPE_NODE_STORE = 8 << 30
# phase rllib: bench_rllib.py's cell (:116-151) and end-to-end run
# (:175-192); the learning bar of tests/test_rllib.py:133-150
_RL_HIDDENS = (256, 256)
_RL_PPO_BATCH, _RL_PPO_MINIBATCH, _RL_PPO_EPOCHS = 4096, 1024, 4
_RL_T = _RL_N = 64
_RL_REL_TOL = 1e-5
_RL_ADAM_ABS = 1e-6
_ADAM_EPS = 1e-8
_RL_LEARNERS = ("ppo", "impala", "appo", "a2c", "dqn")
_RL_CARTPOLE_BAR, _RL_CARTPOLE_ITERS = 130.0, 150
_RL_BREAKOUT_ITERS = 3
# phase rllib2: RLlib part 2's learners at bench_rllib.py's width and the
# reference tests' settings.
# (a) holds each learner on the card against the same learner on the CPU
# by phase rllib's bars, stage by stage: a stage's loss metrics and grads
# at the inputs the card's stage saw (the second stage of SAC, TD3/DDPG
# and Dreamer on the card's state after the first), then the params after
# the whole step by adam_first_step_bound on each side's own grads.
_RL2_LEARNERS = ("sac", "td3", "ddpg", "r2d2", "bc", "cql", "marwil",
                 "dreamer", "alphazero")
# the full cell: Pendulum's shapes (obs 3, action 1) for the continuous
# learners; Breakout-Mini's (obs 400, 3 actions) for R2D2, the offline
# learners and Dreamer (bench_rllib.py:153-170: deter 128, hidden 128,
# B 16 x L 32, horizon 15); TicTacToe for AlphaZero
_RL2_CELL = {"obs": 400, "acts": 3, "hiddens": (256, 256),
             "offline_env": "Breakout-Mini-v0", "cont_batch": 128,
             "r2d2_hidden": 64, "seqs": 32, "offline_batch": 256,
             "deter": 128, "dreamer_hidden": 128, "B": 16, "L": 32,
             "az_hiddens": (64, 64), "az_batch": 256}
# the same checks at a small width (tests/test_torch_rllib_gpu.py)
_RL2_SMALL = {"obs": 16, "acts": 3, "hiddens": (32, 32),
              "offline_env": "CartPole-v1", "cont_batch": 32,
              "r2d2_hidden": 16, "seqs": 8, "offline_batch": 64,
              "deter": 32, "dreamer_hidden": 32, "B": 4, "L": 8,
              "az_hiddens": (32, 32), "az_batch": 64}
_RL2_BURN_IN, _RL2_SEQ_LEN = 4, 16
# (c): SAC on Pendulum at tests/test_rllib_sac.py:184-205 (best >= -900
# within 100 iterations); DreamerV3 on CartPole at
# tests/test_rllib_dreamer.py:99-115 (at iteration 30: final > 60 and
# final > early + 20); Ape-X 3 iterations after its shards fill;
# MultiAgentPPO and AlphaZero 2 iterations; CQL and MARWIL 64 updates on
# a 4096-step dataset
_RL2_SAC_BAR, _RL2_SAC_ITERS = -900.0, 100
_RL2_DREAMER_ITERS, _RL2_DREAMER_BAR, _RL2_DREAMER_GAIN = 30, 60.0, 20.0
_RL2_APEX_ITERS = 3
_RL2_DATASET_STEPS = 4096


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _smi_cards() -> int:
    """The card count as ``nvidia-smi -L`` lists it."""
    out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return sum(1 for line in out.splitlines() if line.startswith("GPU "))


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _pairs(t, t_k, causal):
    """(q, k) pairs the mask keeps: top-left causal keeps min(q + 1, T_k)."""
    return sum(min(q + 1, t_k) for q in range(t)) if causal else t * t_k


def _bound(flops, nbytes, dtype_name):
    t_ops = flops / _PEAK_FLOPS[dtype_name]
    t_mem = nbytes / _HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem else "bytes"


def _flash_bound(bh, t, t_k, d, dtype_name, causal):
    """(bound_ms, bound_by, flops, bytes) of one flash forward: QK^T and PV
    over the (q, k) pairs this mask keeps, against each input read once and
    each output written once."""
    flops = 4.0 * d * bh * _pairs(t, t_k, causal)
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = elt * d * bh * (2 * t + 2 * t_k) + 4 * bh * t
    return (*_bound(flops, nbytes, dtype_name), flops, nbytes)


def _bwd_bounds(bh, t, t_k, d, dtype_name, causal):
    """{kernel: (bound_ms, bound_by, flops, bytes)} of B2 and B3. B2: QK^T,
    dO V^T and dS K (2 D FLOPs a kept pair each) and Delta (2 D a row);
    reads q, k, v, O, dO and LSE, writes dQ and Delta. B3: QK^T, P^T dO,
    dO V^T and dS^T Q; reads q, k, v, dO, LSE and Delta, writes dK, dV."""
    pairs = _pairs(t, t_k, causal)
    elt = 2 if dtype_name == "bfloat16" else 4
    dq_flops = 6.0 * d * bh * pairs + 2.0 * d * bh * t
    dq_bytes = elt * d * bh * (4 * t + 2 * t_k) + 8 * bh * t
    dkv_flops = 8.0 * d * bh * pairs
    dkv_bytes = elt * d * bh * (2 * t + 4 * t_k) + 8 * bh * t
    return {"flash_bwd_dq": (*_bound(dq_flops, dq_bytes, dtype_name),
                             dq_flops, dq_bytes),
            "flash_bwd_dkv": (*_bound(dkv_flops, dkv_bytes, dtype_name),
                              dkv_flops, dkv_bytes)}


def _sdpa_bwd_ms(q, k, v, do, scale, causal, iters):
    """PyTorch's fused attention backward at the same shape, timed as a
    yardstick only: the port never calls it. One call gives dQ, dK and dV."""
    import torch
    import torch.nn.functional as F

    leaves = [x[None].detach().requires_grad_(True) for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                         scale=scale)
    ms = _time_ms(lambda: torch.autograd.grad(out, leaves, do[None],
                                              retain_graph=True), iters)
    del out, leaves
    return ms


def phase_kernels_bwd(fa, seed: int):
    """B2 and B3 against their plain versions (check_bwd) at the training
    shape and six more (tp_shard: a tensor=4 rank's or a pipeline
    microbatch's shape); each kernel's time, its plain version's, SDPA's
    backward and the bound."""
    import torch

    cases = [
        # name, bh, t, t_k, d, dtype, causal
        ("main", 128, 2048, 2048, 64, torch.bfloat16, True),  # llama3-1b train
        ("d128", 64, 2048, 2048, 128, torch.bfloat16, True),
        ("noncausal", 96, 512, 512, 64, torch.bfloat16, False),
        ("fp32", 32, 1024, 1024, 128, torch.float32, True),
        ("ragged_t48", 128, 48, 48, 64, torch.bfloat16, True),
        ("tq_ne_tk", 32, 1000, 1536, 64, torch.bfloat16, True),
        ("tp_shard", 32, 2048, 2048, 64, torch.bfloat16, True),  # tensor=4
    ]
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    rows = []
    for name, bh, t, t_k, d, dtype, causal in cases:
        q, do = (torch.randn(bh, t, d, generator=g, device="cuda").to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(bh, t_k, d, generator=g, device="cuda").to(dtype)
                for _ in range(2))
        scale = d ** -0.5
        o, lse = fa.flash_attention_fwd(q, k, v, scale=scale, causal=causal)
        dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, scale=scale,
                                    causal=causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, lse, delta, do, scale=scale,
                                  causal=causal)
        torch.cuda.synchronize()
        check = fa.check_bwd(dq, dk, dv, q, k, v, o, lse, do, scale=scale,
                             causal=causal)
        dn = str(dtype).split(".")[-1]
        iters = 20 if t >= 512 else 100
        plain_iters = max(3, iters // 5)
        times = {
            "flash_bwd_dq": (
                _time_ms(lambda: fa.flash_bwd_dq(
                    q, k, v, o, lse, do, scale=scale, causal=causal), iters),
                _time_ms(lambda: fa.flash_bwd_dq_reference(
                    q, k, v, o, lse, do, scale=scale, causal=causal),
                    plain_iters, 1)),
            "flash_bwd_dkv": (
                _time_ms(lambda: fa.flash_bwd_dkv(
                    q, k, v, lse, delta, do, scale=scale, causal=causal),
                    iters),
                _time_ms(lambda: fa.flash_bwd_dkv_reference(
                    q, k, v, lse, delta, do, scale=scale, causal=causal),
                    plain_iters, 1)),
        }
        lib_ms = _sdpa_bwd_ms(q, k, v, do, scale, causal, iters)
        bounds = _bwd_bounds(bh, t, t_k, d, dn, causal)
        row = {"case": name, "shape": [bh, t, t_k, d], "dtype": dn,
               "causal": causal, **check,
               "library_ms_dq_dk_dv": lib_ms}
        for kern, (ms, plain_ms) in times.items():
            bound_ms, bound_by, flops, nbytes = bounds[kern]
            row[kern] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "flops": flops, "bytes": nbytes,
                         "tflops_per_s": flops / ms / 1e9}
        rows.append(row)
        del q, k, v, do, o, lse, dq, dk, dv, delta
        torch.cuda.empty_cache()
    _emit({"phase": "kernels", "kernel": "flash_bwd_dq+flash_bwd_dkv",
           "cases": rows})
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_bwd disagrees with its plain version: "
                             f"{bad}")
    return rows


def phase_kernels(fa, seed: int):
    """B1 against its plain version at the forward's shape and six more."""
    import torch
    import torch.nn.functional as F

    cases = [
        # name, bh, t, t_k, d, dtype, causal
        ("main", 128, 2048, 2048, 64, torch.bfloat16, True),  # llama3-1b forward
        ("d128", 64, 2048, 2048, 128, torch.bfloat16, True),
        ("noncausal", 96, 512, 512, 64, torch.bfloat16, False),  # bert-base-like
        ("fp32", 32, 1024, 1024, 128, torch.float32, True),
        ("ragged_t48", 128, 48, 48, 64, torch.bfloat16, True),
        ("tq_ne_tk", 32, 1000, 1536, 64, torch.bfloat16, True),
        # a tensor=4 rank's heads, or a pipeline microbatch: [1*32, 2048]
        ("tp_shard", 32, 2048, 2048, 64, torch.bfloat16, True),
    ]
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, bh, t, t_k, d, dtype, causal in cases:
        q = torch.randn(bh, t, d, generator=g, device="cuda").to(dtype)
        k, v = (torch.randn(bh, t_k, d, generator=g, device="cuda").to(dtype)
                for _ in range(2))
        scale = d ** -0.5
        o, lse = fa.flash_attention_fwd(q, k, v, scale=scale, causal=causal)
        check = fa.check_fwd(o, lse, q, k, v, scale=scale, causal=causal)
        dn = str(dtype).split(".")[-1]
        iters = 20 if t >= 512 else 100
        ms = _time_ms(lambda: fa.flash_attention_fwd(
            q, k, v, scale=scale, causal=causal), iters)
        plain_ms = _time_ms(lambda: fa.flash_attention_fwd_reference(
            q, k, v, scale=scale, causal=causal), max(3, iters // 5), 1)
        # measurement only: the port never calls PyTorch's fused attention
        q4, k4, v4 = q[None], k[None], v[None]  # [1, BH, T, D]: SDPA's layout
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale), iters)
        bound_ms, bound_by, flops, nbytes = _flash_bound(
            bh, t, t_k, d, dn, causal)
        row = {"case": name, "shape": [bh, t, t_k, d], "dtype": dn,
               "causal": causal, **check, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes, "tflops_per_s": flops / ms / 1e9}
        rows.append(row)
        del q, k, v, q4, k4, v4, o, lse
        torch.cuda.empty_cache()
    _emit({"phase": "kernels", "kernel": "flash_fwd", "cases": rows})
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_fwd disagrees with its plain version: "
                             f"{bad}")
    return rows


def _ring_blocks(causal: bool) -> int:
    return _RING_P * (_RING_P + 1) // 2 if causal else _RING_P * _RING_P


def _chunks(x, n: int):
    return [c.contiguous() for c in x.chunk(n, dim=1)]


def _finite(x) -> bool:
    import torch

    return bool(torch.isfinite(x.float()).all())


def check_ring_fwd(o, lse, o_w, lse_w, q, k, v, *, scale: float,
                   causal: bool) -> dict:
    """The ring's (O, LSE) against B1's over the whole sequence (O_w,
    LSE_w), [B*H, T, D] and [B*H, 1, T].

    With u = 2^-8 and O the exact output: B1 over the whole sequence is
    within u|O| (its output's rounding) + u (P|V|) (P rounded to bf16) of
    O, as check_fwd bounds it. The ring rounds each block's P and each
    block's output O_b to bf16 before the fp32 merge; the merge weights
    e^(lse_b - lse) are a convex combination and |O_b| <= P_b|V|, so the
    blocks' roundings add up to at most u (P|V|) each, and the merged O is
    within u|O| + 2u (P|V|). Between the two:
        |O_ring - O_w| <= 2u|O| + 3u (P|V|),
    checked as 1.05 (2u|O_w| + 3u (P|V|)) + 1e-6 per element (P|V|: the
    plain version on |V|, fp32), ||O_ring - O_w|| / ||O_w|| <= 2e-2, and
    LSE (fp32 on both sides) within 2e-4 + 2e-4 |lse|."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    u = 2.0 ** -8
    bh, t, _ = q.shape
    step = max(1, (1 << 26) // (t * t))
    excess = d_max = d2 = r2 = 0.0
    for i in range(0, bh, step):
        sl = slice(i, i + step)
        pv_abs, _ = fa.flash_attention_fwd_reference(
            q[sl].float(), k[sl].float(), v[sl].float().abs(), scale=scale,
            causal=causal)
        ref, d = o_w[sl].float(), o[sl].float() - o_w[sl].float()
        tol = 1.05 * (2 * u * ref.abs() + 3 * u * pv_abs) + 1e-6
        excess = max(excess, (d.abs() / tol).max().item())
        d_max = max(d_max, d.abs().max().item())
        d2 += d.double().pow(2).sum().item()
        r2 += ref.double().pow(2).sum().item()
    rel = (d2 / r2) ** 0.5
    d_lse = (lse - lse_w).abs()
    lse_ok = bool((d_lse <= 2e-4 + 2e-4 * lse_w.abs()).all())
    finite = bool(_finite(o) and _finite(lse))
    return {"o_max_abs_err": d_max, "o_err_over_tol": excess,
            "o_tol": f"1.05*(2u|O_w| + 3u*(P|V|)) + 1e-6, u={u}",
            "o_rel_norm_err": rel, "o_rel_norm_tol": _RING_REL_NORM_TOL,
            "lse_max_abs_err": d_lse.max().item(),
            "lse_tol": "2e-4 + 2e-4*|lse|",
            "ok": (finite and excess <= 1.0 and lse_ok
                   and rel <= _RING_REL_NORM_TOL)}


def check_ring_bwd(grads, grads_w, q, k, v, o_w, lse, lse_w, do, *,
                   scale: float, causal: bool) -> dict:
    """The ring's (dQ, dK, dV) against B2/B3 over the whole sequence
    (``grads_w``, from B1's whole-sequence O_w and LSE_w); ``lse`` is the
    ring's merged LSE.

    check_bwd bounds one kernel's dQ against the exact one by u|dQ| +
    scale (u|dS| + w M)|K| (dS and P rounded to bf16 as operands, fp32 sums
    in another order; u = 2^-8, w = 2^-14, M and A as in check_bwd). The
    ring adds, over its blocks, one more rounding of each block's dQ, dK or
    dV partial to bf16 before the fp32 sums: at most u scale |dS||K| for
    dQ (|dQ_b| <= scale |dS_b||K_b|), u scale |dS|^T|Q| for dK, u P^T|dO|
    for dV. The two sides also start from different O and LSE: B2's Delta =
    rowsum(dO O) moves by at most 5u R (R = rowsum(P o |dO||V|^T), from
    the forward's |O_ring - O_w| <= 5u (P|V|)), which moves dS by P 5u R;
    an LSE apart by e moves P, and so dS and dV, by a factor e. So
        |dQ - dQ_w| <= 2u|dQ_w| + scale E |K|,
        |dK - dK_w| <= 2u|dK_w| + scale E^T |Q|,
        |dV - dV_w| <= 2u|dV_w| + ((3u + e) P + 2w P A)^T |dO|,
        E = (3u + e)|dS| + 2w M + 5u P R,
    each times 1.05, + 1e-6, with e the per-row |lse - lse_w|; and each
    output within 2e-2 of the whole-sequence one as a whole."""
    u, w = 2.0 ** -8, 2.0 ** -14
    bh, t, _ = q.shape
    step = max(1, (1 << 26) // (t * t))
    names = ("dq", "dk", "dv")
    stats = {n: {"max": 0.0, "excess": 0.0, "d2": 0.0, "r2": 0.0}
             for n in names}
    finite = all(_finite(g) for g in grads)
    import torch

    for i in range(0, bh, step):
        sl = slice(i, i + step)
        qs, ks, vs, os_, dos = (x[sl].float() for x in (q, k, v, o_w, do))
        s = torch.matmul(qs, ks.transpose(1, 2)) * scale
        if causal:
            keep = (torch.arange(t, device=q.device)[:, None]
                    >= torch.arange(t, device=q.device)[None, :])
            s = torch.where(keep, s, torch.full_like(s, -1e30))
        p = torch.exp(s - lse_w[sl].float()[:, 0, :, None])
        del s
        delta = (dos * os_).sum(dim=-1)[:, :, None]
        dp = torch.matmul(dos, vs.transpose(1, 2))
        ds = p * (dp - delta)
        dov = torch.matmul(dos.abs(), vs.abs().transpose(1, 2))
        a = scale * torch.matmul(qs.abs(), ks.abs().transpose(1, 2))
        m = p * (dov + delta.abs() + a * (dp - delta).abs())
        r = (p * dov).sum(dim=-1, keepdim=True)
        e_lse = (lse[sl] - lse_w[sl]).abs()[:, 0, :, None]
        big_e = (3 * u + e_lse) * ds.abs() + 2 * w * m + 5 * u * p * r
        del dp, ds, dov, m
        comp = {"dq": scale * torch.matmul(big_e, ks.abs()),
                "dk": scale * torch.matmul(big_e.transpose(1, 2), qs.abs()),
                "dv": torch.matmul(((3 * u + e_lse) * p + 2 * w * p * a)
                                   .transpose(1, 2), dos.abs())}
        del big_e, p, a
        for name, got, ref in zip(names, grads, grads_w):
            got, ref = got[sl].float(), ref[sl].float()
            d = got - ref
            tol = 1.05 * (2 * u * ref.abs() + comp[name]) + 1e-6
            st = stats[name]
            st["max"] = max(st["max"], d.abs().max().item())
            st["excess"] = max(st["excess"], (d.abs() / tol).max().item())
            st["d2"] += d.double().pow(2).sum().item()
            st["r2"] += ref.double().pow(2).sum().item()
    out, ok = {"finite": finite}, finite
    for name, st in stats.items():
        rel = (st["d2"] ** 0.5) / max(st["r2"] ** 0.5, 1e-30)
        out.update({f"{name}_max_abs_err": st["max"],
                    f"{name}_err_over_tol": st["excess"],
                    f"{name}_rel_norm_err": rel})
        ok = ok and st["excess"] <= 1.0 and rel <= _RING_REL_NORM_TOL
    out.update({"tol": "1.05*(2u|ref| + companion) + 1e-6, E = (3u + e)|dS|"
                       f" + 2wM + 5u P R, u={u}, w={w}",
                "rel_norm_tol": _RING_REL_NORM_TOL, "ok": ok})
    return out


def ring_check(fa, R, case, seed: int, timed: bool = True) -> dict:
    """One ring case: the ring's forward and backward for _RING_P virtual
    ranks (launches counted around each), B1 and B2/B3 over the whole
    sequence on the same inputs, check_ring_fwd and check_ring_bwd, and
    (``timed``) both sides' times beside the whole-sequence bounds."""
    import torch

    name, b, t, h, d, causal = case
    bh, n = b * h, _RING_P
    g = torch.Generator(device="cuda").manual_seed(seed + 31)
    q, k, v, do = (torch.randn(bh, t, d, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    qs, ks, vs, dos = (_chunks(x, n) for x in (q, k, v, do))

    def ring_fwd():
        return R.ring_forward_virtual(qs, ks, vs, scale=scale, causal=causal)

    _zero_counts(fa)
    os_, lses = ring_fwd()
    torch.cuda.synchronize()
    fwd_launches = _counts(fa)

    def ring_bwd():
        return R.ring_backward_virtual(qs, ks, vs, os_, lses, dos,
                                       scale=scale, causal=causal)

    _zero_counts(fa)
    grads = ring_bwd()
    torch.cuda.synchronize()
    bwd_launches = _counts(fa)
    o, lse = torch.cat(os_, 1), torch.cat(lses, 2)
    grads = [torch.cat(x, 1) for x in grads]
    # the whole sequence through the same kernels (not counted)
    o_w, lse_w = fa.flash_attention_fwd(q, k, v, scale=scale, causal=causal)
    grads_w = fa.flash_attention_bwd(q, k, v, o_w, lse_w, do, scale=scale,
                                     causal=causal)
    torch.cuda.synchronize()
    fwd = check_ring_fwd(o, lse, o_w, lse_w, q, k, v, scale=scale,
                         causal=causal)
    bwd = check_ring_bwd(grads, grads_w, q, k, v, o_w, lse, lse_w, do,
                         scale=scale, causal=causal)
    want = _ring_blocks(causal)
    launches_ok = (fwd_launches == {"flash_fwd": want, "flash_bwd_dq": 0,
                                    "flash_bwd_dkv": 0}
                   and bwd_launches == {"flash_fwd": 0, "flash_bwd_dq": want,
                                        "flash_bwd_dkv": want})
    row = {"case": name, "shape_bthd": [b, t, h, d], "dtype": "bfloat16",
           "causal": causal, "virtual_ranks": n, "block_t": t // n,
           "fwd": fwd, "bwd": bwd, "fwd_launches": fwd_launches,
           "bwd_launches": bwd_launches, "launches_want": want,
           "ok": fwd["ok"] and bwd["ok"] and launches_ok}
    if timed:
        iters = 10
        fb_ms, fb_by, _, _ = _flash_bound(bh, t, t, d, "bfloat16", causal)
        bb = _bwd_bounds(bh, t, t, d, "bfloat16", causal)
        row.update({
            "ring_fwd_ms": _time_ms(ring_fwd, iters),
            "whole_fwd_ms": _time_ms(lambda: fa.flash_attention_fwd(
                q, k, v, scale=scale, causal=causal), iters),
            "ring_bwd_ms": _time_ms(ring_bwd, iters),
            "whole_bwd_ms": _time_ms(lambda: fa.flash_attention_bwd(
                q, k, v, o_w, lse_w, do, scale=scale, causal=causal), iters),
            "fwd_bound_ms": fb_ms, "fwd_bound_by": fb_by,
            "bwd_bound_ms": sum(x[0] for x in bb.values()),
            "bwd_bound_by": "+".join(x[1] for x in bb.values())})
    return row


def phase_ring(fa, R, seed: int):
    """ring_check on each of _RING_CASES; -> the main case's launches."""
    import torch

    rows = []
    for case in _RING_CASES:
        rows.append(ring_check(fa, R, case, seed))
        _emit({"phase": "ring", **rows[-1]})
        torch.cuda.empty_cache()
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"ring attention disagrees with the whole-"
                             f"sequence kernels: {bad}")
    main = rows[0]
    return {"ring_forward": main["fwd_launches"]["flash_fwd"],
            "ring_backward": main["bwd_launches"]["flash_bwd_dq"],
            "ring_backward_dkv": main["bwd_launches"]["flash_bwd_dkv"]}


def _rel(x, ref) -> float:
    return ((x - ref).norm() / ref.norm()).item()


def forward_parity(T, cfg, params, p32, tokens,
                   ratio_tol: float = _FWD_BF16_RATIO,
                   rel_tol: float = _FWD_REL_TOL, mesh=None) -> dict:
    """The forward through the kernel (``cfg``) held against plain
    attention two ways:
      - fp32: the same forward in fp32 through the kernel against fp32
        plain attention, within ``rel_tol``;
      - bf16: both bf16 forwards against the fp32 one; the kernel's forward
        may be at most ``ratio_tol`` times as far from it as the
        plain-attention forward is.
    ``p32`` may be the bf16 params themselves: the fp32 configs cast every
    weight to fp32 where it is used, and bf16 values are exact in fp32.
    A direct bf16-vs-bf16 bound cannot hold: this random-weight model is
    chaotic in bf16. Measured on the H100 with P.V made exact to fp32 in
    the kernel, the two bf16 forwards still differed by 2.5%, while each
    kept 3.05% from the fp32 forward (printed as rel_bf16_*). With a
    ``mesh`` (a VirtualMesh) both kernel forwards run on it; the plain and
    the fp32 truth stay unmeshed.
    -> the distances, their ratio, the logits' shape, "finite" and "ok"."""
    import torch

    logits = T.forward(params, tokens, cfg, mesh)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(logits).all())
    plain_cfg = dataclasses.replace(cfg, attention_impl="xla")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    plain32_cfg = dataclasses.replace(cfg32, attention_impl="xla")
    ref = T.forward(params, tokens, plain_cfg)
    truth = T.forward(p32, tokens, plain32_cfg)
    rel_bf16 = {"kernel_vs_fp32": _rel(logits, truth),
                "plain_vs_fp32": _rel(ref, truth),
                "kernel_vs_plain": _rel(logits, ref)}
    shape = list(logits.shape)
    del ref, logits
    rel_fp32 = _rel(T.forward(p32, tokens, cfg32, mesh), truth)
    del truth
    ratio = rel_bf16["kernel_vs_fp32"] / rel_bf16["plain_vs_fp32"]
    return {"logits_shape": shape, "finite": finite,
            "rel_fp32_kernel_vs_plain": rel_fp32, "rel_tol": rel_tol,
            **{f"rel_bf16_{k}": v for k, v in rel_bf16.items()},
            "bf16_kernel_over_plain": ratio,
            "bf16_ratio_tol": ratio_tol,
            "ok": (finite and rel_fp32 <= rel_tol
                   and ratio <= ratio_tol)}


def forward_tokens(cfg, seed: int):
    """The forward phase's [4, 2048] random tokens on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab_size, (4, 2048), generator=g,
                         device="cuda", dtype=torch.int32)


def phase_forward(fa, T, cfg, params, p32, seed: int):
    """The main path: forward at [4, 2048] in bf16 through the kernel, its
    launches counted in that one call, then held against plain attention
    (forward_parity) and timed."""
    import torch

    tokens = forward_tokens(cfg, seed)
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    T.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.n_layers:
        raise AssertionError(f"forward launched flash_fwd {launches} times, "
                             f"want {cfg.n_layers} (one per layer)")
    parity = forward_parity(T, cfg, params, p32, tokens)
    plain_cfg = dataclasses.replace(cfg, attention_impl="xla")
    ms = _time_ms(lambda: T.forward(params, tokens, cfg), 3, 1)
    plain_ms = _time_ms(lambda: T.forward(params, tokens, plain_cfg), 3, 1)
    _emit({"phase": "forward", "tokens": [4, 2048], "dtype": "bfloat16",
           "attention_impl": "auto", "flash_launches": launches, **parity,
           "ms": ms, "plain_attention_ms": plain_ms,
           "tokens_per_s": 4 * 2048 / ms * 1e3,
           "peak_mem_gib": peak / 2**30})
    if not parity["ok"]:
        raise AssertionError("forward through the kernel disagrees with "
                             "plain attention")
    return launches


def fp32_config(cfg):
    import torch

    return dataclasses.replace(cfg, dtype=torch.float32,
                               param_dtype=torch.float32)


def engine_prompts(cfg, seed: int):
    """Phase engine's prompts, one of each of _ENGINE_PROMPT_LENS."""
    rng = random.Random(seed)
    return [[rng.randint(1, cfg.vocab_size - 1) for _ in range(n)]
            for n in _ENGINE_PROMPT_LENS]


def engine_tokens(E, params, cfg, prompts, seed: int):
    """Greedy tokens of phase engine's in-process engine (slots 8,
    max_prompt 64, _ENGINE_MAX_NEW new tokens; the prompts submitted
    together and driven by step())."""
    eng = E.InferenceEngine(params, cfg, slots=8, max_prompt_len=64,
                            max_new_tokens=_ENGINE_MAX_NEW, greedy=True,
                            seed=seed)
    reqs = [eng.submit(p) for p in prompts]
    for _ in range(1000):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    return [list(r.tokens) for r in reqs]


def phase_engine_fp32(E, G, cfg, p32, seed: int):
    """The fp32 engine token for token against the port's generate()."""
    import torch

    cfg32 = fp32_config(cfg)
    prompts = engine_prompts(cfg, seed)
    want = [G.generate(p32, torch.tensor([p], device="cuda"), cfg32,
                       max_new_tokens=_ENGINE_MAX_NEW)[0, len(p):].tolist()
            for p in prompts]
    t0 = time.perf_counter()
    got = engine_tokens(E, p32, cfg32, prompts, seed)
    wall = time.perf_counter() - t0
    match = [a == b for a, b in zip(got, want)]
    _emit({"phase": "engine", "dtype": "float32", "tf32": False,
           "prompt_lens": [len(p) for p in prompts], "max_new_tokens": 32,
           "match_generate": match, "wall_s": wall,
           "first_mismatch": next(
               ([i, [j for j, (x, y) in enumerate(zip(a, b)) if x != y][:1]]
                for i, (a, b) in enumerate(zip(got, want)) if a != b), None)})
    if not all(match):
        raise AssertionError("fp32 engine tokens differ from generate()")


def _workload(rng_seed: int, max_prompt: int, max_new: int):
    """bench_serve.py's request stream: (prompt, max_new). 80% short answers
    (U[max/16, max/4]) and 20% long generations (U[max/2, max])."""
    rng = random.Random(rng_seed)

    def next_request():
        plen = rng.randint(max(4, max_prompt // 8), max_prompt)
        if rng.random() < 0.8:
            want = rng.randint(max(2, max_new // 16), max(4, max_new // 4))
        else:
            want = rng.randint(max_new // 2, max_new)
        return [rng.randint(1, 200) for _ in range(plen)], want
    return next_request


def _pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p / 100 * len(xs)))]


def _decode_chunk_profile(E, eng, cfg, steps: int):
    """Host wall and device busy time of one full-width decode chunk: the
    wall without the profiler, the device time (sum of kernel times) from
    torch.profiler; "not measured" if the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    active = torch.ones(eng.slots, dtype=torch.bool, device="cuda")

    def chunk():
        E.decode_slots(eng.params, eng.cache, eng._next_tok_dev, active,
                       eng._rng, cfg, True, 1.0, -1, steps=steps)
        torch.cuda.synchronize()

    chunk()
    t0 = time.perf_counter()
    chunk()
    wall = time.perf_counter() - t0
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            chunk()
        dev_us = sum(e.device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
    except Exception:  # the profiler is a probe here, not a phase
        traceback.print_exc()
        dev_us = 0
    eng.cache["pos"].zero_()
    return {"steps": steps, "host_ms_per_step": wall / steps * 1e3,
            "device_ms_per_step": (dev_us / steps / 1e3 if dev_us
                                   else "not measured"),
            "device_busy_share": (dev_us / 1e6 / wall if dev_us
                                  else "not measured")}


def phase_serving(E, cfg, params, seed: int, name: str = "serving"):
    """bf16 engine at bench_serve.py's settings, 8 clients x 4 requests."""
    import torch

    clients, per_client, max_new = 8, 4, 64
    eng = E.InferenceEngine(params, cfg, slots=8, max_prompt_len=64,
                            max_new_tokens=max_new, decode_chunk=16,
                            fetch_every=4, max_inflight=6, seed=seed)
    eng.warmup()
    torch.cuda.reset_peak_memory_stats()
    eng.serve_forever()
    results, errors, lock = [], [], threading.Lock()

    def client(cid):
        nxt = _workload(seed + 17 + cid, 64, max_new)
        try:
            for _ in range(per_client):
                prompt, want = nxt()
                t0 = time.perf_counter()
                ttft, toks = None, []
                for tok in eng.submit_stream(prompt, want):
                    if ttft is None:
                        ttft = time.perf_counter() - t0
                    toks.append(tok)
                with lock:
                    results.append((want, toks, ttft,
                                    time.perf_counter() - t0))
        except BaseException as e:  # reported below, fails the phase
            with lock:
                errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        hung = sum(t.is_alive() for t in threads)
    finally:
        eng.shutdown()
    n_tok = sum(len(r[1]) for r in results)
    bad_len = sum(len(toks) != want for want, toks, _, _ in results)
    bad_vocab = sum(any(not 0 <= x < cfg.vocab_size for x in toks)
                    for _, toks, _, _ in results)
    lat = [r[3] for r in results]
    ttft = [r[2] for r in results if r[2] is not None]
    _emit({"phase": name, "dtype": "bfloat16", "n_layers": cfg.n_layers,
           "moe_experts": cfg.moe_experts, "clients": clients,
           "requests": len(results), "want_requests": clients * per_client,
           "errors": errors, "hung_clients": hung,
           "wrong_length": bad_len, "out_of_vocab": bad_vocab,
           "generated_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "latency_p50_s": _pct(lat, 50) if lat else None,
           "latency_p95_s": _pct(lat, 95) if lat else None,
           "ttft_p50_s": _pct(ttft, 50) if ttft else None,
           "ttft_p95_s": _pct(ttft, 95) if ttft else None,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "engine_stats": eng.stats,
           "decode_chunk": _decode_chunk_profile(E, eng, cfg, 16)})
    if errors or hung or bad_len or bad_vocab or \
            len(results) != clients * per_client:
        raise AssertionError(f"{name} phase failed")
    return n_tok / wall



def moe_config(C, n_layers: int = 16, **kw):
    """llama3-1b at full width with _MOE's experts, bf16 params."""
    import torch

    return C.get_config("llama3-1b", param_dtype=torch.bfloat16,
                        n_layers=n_layers, **_MOE, **kw)


def moe_train_config(C):
    """moe_train's cell: _MOE_TRAIN_LAYERS layers, T = 2048, remat
    "nothing", as train_config."""
    return moe_config(C, _MOE_TRAIN_LAYERS, max_seq_len=2048, remat=True,
                      remat_policy="nothing")


def _moe_abs_path(M, h, lp, cfg):
    """A [B, T, d] fp32: over each token's kept slots, p * (|act| @
    |W_down|) of its expert, where act is the expert's SwiGLU of the token:
    the size moe_layer's per-element bound follows. Expert by expert,
    from the routing moe_ffn uses."""
    import torch

    B, t, d = h.shape
    k = cfg.moe_top_k
    top_p, top_i = M.top_k(M.router_probs(h, lp["router"]), k)
    _, kept = M.assign_slots(top_i, cfg.moe_experts, M.capacity(t, cfg))
    rows = h[:, :, None, :].expand(B, t, k, d).reshape(-1, d)
    ids, p, kept = top_i.reshape(-1), top_p.reshape(-1), kept.reshape(-1)
    out = torch.zeros(B * t * k, d, device=h.device)
    for e in range(cfg.moe_experts):
        sel = (ids == e) & kept
        x = rows[sel]
        act = M._silu(x @ lp["w_gate"][e]) * (x @ lp["w_up"][e])
        out[sel] = p[sel, None] * (act.abs().float()
                                   @ lp["w_down"][e].abs().float())
    return out.reshape(B, t, k, d).sum(dim=2)


def phase_moe_layer(M, cfg, params, seed: int):
    """One MoE layer (layer 0 of ``params``) at [4, 2048] bf16: moe_ffn
    against moe_ffn_dense on the same h, at ``cfg``'s capacity factor and at
    _MOE_LAYER_DROP_CF. In each case expert ids and kept slots must be
    equal exactly, the output within 1.05 (2u|y| + 6u A) + 1e-6 per element
    (_MOE_LAYER_UNIT; A from _moe_abs_path) and 1e-2 as a whole; the second
    case must drop slots. Both forms timed (CUDA events) beside the layer's
    bound: the three products over the kept slots at 989 TFLOP/s against
    the expert weights', h's and y's bytes at 3.35 TB/s. The bmm also
    multiplies the empty places of its E*B*C rows ("bmm_flops")."""
    import torch

    lp = {k: params["layers"][k][0] for k in ("router", "w_gate", "w_up",
                                              "w_down")}
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    B, t, d = 4, 2048, cfg.d_model
    h = torch.randn(B, t, d, generator=g, device="cuda").to(cfg.dtype)
    E, k, u = cfg.moe_experts, cfg.moe_top_k, _MOE_LAYER_UNIT
    nbytes = (3.0 * E * d * cfg.d_ff + 2.0 * B * t * d) * h.element_size()
    ok = True
    for cf in (cfg.moe_capacity_factor, _MOE_LAYER_DROP_CF):
        c = dataclasses.replace(cfg, moe_capacity_factor=cf)
        C = M.capacity(t, c)
        with torch.no_grad():
            y, aux = M.moe_ffn(h, lp, c)
            top_p, top_i = M.top_k(M.router_probs(h, lp["router"]), k)
            _, kept = M.assign_slots(top_i, E, C)
            y_d, aux_d, top_i_d, kept_d = M.moe_ffn_dense(h, lp, c)
            torch.cuda.synchronize()
            same_ids = torch.equal(top_i, top_i_d)
            same_kept = torch.equal(kept, kept_d)
            tol = 1.05 * (2 * u * y_d.float().abs()
                          + 6 * u * _moe_abs_path(M, h, lp, c)) + 1e-6
            dy = (y.float() - y_d.float())
            err_over_tol = (dy.abs() / tol).max().item()
            rel = (dy.norm() / y_d.float().norm()).item()
            finite = bool(torch.isfinite(y.float()).all())
            ms = _time_ms(lambda: M.moe_ffn(h, lp, c), 10)
            dense_ms = _time_ms(lambda: M.moe_ffn_dense(h, lp, c), 5)
        kept_rows = int(kept.sum().item())
        dropped = 1 - kept_rows / kept.numel()
        flops = 6.0 * d * cfg.d_ff * kept_rows
        bmm_flops = 6.0 * d * cfg.d_ff * E * B * C
        bound_ms, bound_by = _bound(flops, nbytes, "bfloat16")
        case_ok = (finite and same_ids and same_kept and err_over_tol <= 1.0
                   and rel <= _MOE_LAYER_REL_TOL
                   and (cf == cfg.moe_capacity_factor or dropped > 0))
        _emit({"phase": "moe_layer", "shape": [B, t, d], "dtype": "bfloat16",
               **_MOE, "moe_capacity_factor": cf, "capacity": C,
               "same_expert_ids": same_ids, "same_kept": same_kept,
               "kept_rows": kept_rows, "dropped_share": dropped,
               "max_abs_err": dy.abs().max().item(),
               "err_over_tol": err_over_tol,
               "tol": f"1.05*(2u|y| + 6u*sum_k p|act|@|W_down|) + 1e-6, "
                      f"u={u}",
               "rel_norm_err": rel, "rel_norm_tol": _MOE_LAYER_REL_TOL,
               "aux": aux.item(), "aux_dense": aux_d.item(),
               "ms": ms, "dense_ms": dense_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "flops": flops, "bytes": nbytes,
               "ops_ms": flops / _PEAK_FLOPS["bfloat16"] * 1e3,
               "bytes_ms": nbytes / _HBM_BYTES_PER_S * 1e3,
               "bmm_flops": bmm_flops,
               "tflops_per_s": flops / ms / 1e9, "ok": case_ok})
        ok = ok and case_ok
    if not ok:
        raise AssertionError("moe_ffn disagrees with moe_ffn_dense")


@contextlib.contextmanager
def _routing_recorder(M):
    """Collects the expert ids [B, T, k] of every moe.top_k call while
    active (a measurement wrapper; the model is unchanged)."""
    seen, top_k = [], M.top_k

    def record(probs, k):
        p, i = top_k(probs, k)
        seen.append(i)
        return p, i

    M.top_k = record
    try:
        yield seen
    finally:
        M.top_k = top_k


def moe_forward_tokens(cfg, seed: int):
    """moe_forward's [4, 2048] random tokens on the card."""
    return forward_tokens(cfg, seed + 20)


def moe_forward_parity(T, M, cfg, params, tokens) -> dict:
    """forward_parity of the MoE model within _MOE_FWD_BF16_RATIO and
    _MOE_FWD_FP32_REL_TOL, with the token-layers whose expert set differs
    from the fp32 forward's in each bf16 forward and in the fp32 forward
    through B1."""
    with _routing_recorder(M) as seen:
        par = forward_parity(T, cfg, params, params, tokens,
                             _MOE_FWD_BF16_RATIO, _MOE_FWD_FP32_REL_TOL)
    L = cfg.n_layers
    # forward_parity's order: bf16 B1, bf16 plain, fp32 plain, fp32 B1
    sets = [[i.sort(dim=-1).values for i in seen[j * L:(j + 1) * L]]
            for j in range(4)]

    def differ(j):
        return sum(int((a != b).any(dim=-1).sum().item())
                   for a, b in zip(sets[j], sets[2]))

    par["routed_differently_vs_fp32"] = {
        "bf16_kernel": differ(0), "bf16_plain": differ(1),
        "fp32_kernel": differ(3), "of_token_layers": L * tokens.numel()}
    return par


def phase_moe_forward(fa, T, M, cfg, params, seed: int):
    """The 16-layer MoE forward at [4, 2048] bf16 through B1 (16 launches
    counted in that one call), moe_forward_parity, ms (kernel and plain
    attention) and peak memory."""
    import torch

    tokens = moe_forward_tokens(cfg, seed)
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    with torch.no_grad():
        logits = T.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()
    shape_ok = list(logits.shape) == [4, 2048, cfg.vocab_size]
    del logits
    if launches != cfg.n_layers:
        raise AssertionError(f"the MoE forward launched flash_fwd {launches}"
                             f" times, want {cfg.n_layers}")
    parity = moe_forward_parity(T, M, cfg, params, tokens)
    plain_cfg = dataclasses.replace(cfg, attention_impl="xla")
    ms = _time_ms(lambda: T.forward(params, tokens, cfg), 3, 1)
    plain_ms = _time_ms(lambda: T.forward(params, tokens, plain_cfg), 3, 1)
    _emit({"phase": "moe_forward", "tokens": [4, 2048], "dtype": "bfloat16",
           **_MOE, "n_layers": cfg.n_layers, "flash_launches": launches,
           **parity, "ms": ms, "plain_attention_ms": plain_ms,
           "tokens_per_s": 4 * 2048 / ms * 1e3, "peak_mem_gib": peak / 2**30})
    if not (parity["ok"] and shape_ok):
        raise AssertionError("the MoE forward through the kernel disagrees "
                             "with plain attention")
    return launches


def phase_moe_engine(E, G, cfg, params, seed: int):
    """The MoE model in fp32 (no TF32): the engine token for token against
    generate(). Every prompt is max_prompt_len (64) long, so no row carries
    pads: the reference's moe_ffn has no pad mask and pads would claim
    expert capacity in the engine's prefill and not in generate()'s (the
    CPU tests hold mixed lengths against the JAX engine instead)."""
    import torch

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    p32 = {"embed": params["embed"].float(),
           "final_norm": params["final_norm"].float(),
           "layers": {k: w.float() for k, w in params["layers"].items()}}
    rng = random.Random(seed + 7)
    prompts = [[rng.randint(1, cfg.vocab_size - 1) for _ in range(64)]
               for _ in range(4)]
    want = [G.generate(p32, torch.tensor([p], device="cuda"), cfg32,
                       max_new_tokens=32)[0, 64:].tolist() for p in prompts]
    eng = E.InferenceEngine(p32, cfg32, slots=8, max_prompt_len=64,
                            max_new_tokens=32, greedy=True, seed=seed)
    t0 = time.perf_counter()
    reqs = [eng.submit(p) for p in prompts]
    for _ in range(1000):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    wall = time.perf_counter() - t0
    got = [list(r.tokens) for r in reqs]
    match = [a == b for a, b in zip(got, want)]
    _emit({"phase": "moe_engine", "dtype": "float32", "tf32": False, **_MOE,
           "n_layers": cfg.n_layers, "prompt_lens": [64] * len(prompts),
           "max_new_tokens": 32, "match_generate": match, "wall_s": wall})
    if not all(match):
        raise AssertionError("fp32 MoE engine tokens differ from generate()")


def phase_entry():
    """ray_tpu_torch.entry.entry() on the card: the GPT-2-small forward at
    [4, 512], finite fp32 logits of shape [4, 512, vocab]."""
    import torch

    from ray_tpu_torch.entry import entry

    fn, args = entry()
    with torch.no_grad():
        logits = fn(*args)
    torch.cuda.synchronize()
    ok = (list(logits.shape) == [4, 512, 50304]
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()))
    _emit({"phase": "entry", "config": "gpt2-small", "tokens": [4, 512],
           "logits_shape": list(logits.shape), "ok": ok})
    if not ok:
        raise AssertionError("entry()'s forward is wrong")


def _runtime_tensor(nbytes: int, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(nbytes // 2, generator=g, device="cuda",
                       dtype=torch.bfloat16)


def _row_sums(t):
    """Exact integer sums of the bits of 64 slices of a bf16 tensor, in
    order: the checksum both processes compute."""
    import torch

    return t.view(torch.int16).reshape(64, -1).sum(
        dim=1, dtype=torch.int64).tolist()


def runtime_receive(refs):
    """The runtime phase's num_gpus=1 task: get the driver's tensor (a
    ref inside a list, so the get is timed here, after the worker's CUDA
    context is made) and report what came."""
    import torch

    import ray_tpu_torch

    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t = ray_tpu_torch.get(refs[0], timeout=300)
    torch.cuda.synchronize()
    get_s = time.perf_counter() - t0
    return {"device": t.device.type, "dtype": str(t.dtype),
            "gpu_ids": ray_tpu_torch.get_gpu_ids(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "row_sums": _row_sums(t), "get_s": get_s}


def _llama_bf16(**kw):
    import torch

    from ray_tpu_torch.models import config as C

    return C.get_config("llama3-1b", param_dtype=torch.bfloat16, **kw)


def counted_forward(params, cfg, seed: int, tokens=None) -> dict:
    """The forward at [4, 2048] (phase forward's tokens, or ``tokens``) in
    this process, TF32 off, B1's launches counted around it: {"launches",
    "logits" (the last position's, fp32 from the forward as the
    reference's, in bf16), "s"}."""
    import torch

    from ray_tpu_torch.models import transformer as T
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if tokens is None:
        tokens = forward_tokens(cfg, seed)
    _zero_counts(fa)
    t0 = time.perf_counter()
    logits = T.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    return {"launches": _counts(fa), "s": time.perf_counter() - t0,
            "logits": logits[:, -1].to(torch.bfloat16)}


class RuntimeActor:
    """The runtime phase's num_gpus=1 actor. Defined here and referenced
    as ``chip_smoke.RuntimeActor``, so it pickles by reference."""

    def lease(self):
        import torch

        import ray_tpu_torch

        return {"gpu_ids": ray_tpu_torch.get_gpu_ids(),
                "cuda_visible_devices":
                    os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device_count": torch.cuda.device_count(),
                "pid": os.getpid()}

    def forward(self, seed: int):
        """llama3-1b's bf16 forward at [4, 2048] from the phase's seed,
        B1's launches counted around it (counted_forward)."""
        import torch

        from ray_tpu_torch.models import transformer as T

        cfg = _llama_bf16()
        params = T.init_params(torch.Generator(
            device="cuda").manual_seed(seed), cfg, device="cuda")
        return counted_forward(params, cfg, seed)

    def tensor(self, nbytes: int, seed: int):
        return _runtime_tensor(nbytes, seed)


def _workers_left() -> list:
    out = subprocess.run(["pgrep", "-f", _WORKER_PROBE],
                         capture_output=True, text=True)
    return out.stdout.split()


def phase_runtime(T, cfg, params, seed: int):
    """The port's runtime on the card (the module's docstring, runtime).
    Returns the actor's B1 launches."""
    import torch

    import chip_smoke as CS  # by reference, not as __main__
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import serialization

    cards = _smi_cards()
    gb = 1e9
    row = {"phase": "runtime", "card": _nvidia_smi()}
    rt.init(num_cpus=4, object_store_memory=_RUNTIME_STORE_BYTES,
            log_to_driver=False)
    try:
        row["gpus_detected"] = rt.cluster_resources().get("GPU", 0)
        row["nvidia_smi_cards"] = cards
        # a 1 GiB bf16 CUDA tensor: put, then a num_gpus=1 task gets it
        x = _runtime_tensor(_RUNTIME_PUT_BYTES, seed + 200)
        want = _row_sums(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = serialization.serialize(x).frames  # put's first half
        serialize_s = time.perf_counter() - t0
        del frames
        t0 = time.perf_counter()
        ref = rt.put(x)
        put_s = time.perf_counter() - t0
        task = rt.remote(num_gpus=1, num_cpus=0)(CS.runtime_receive)
        got = rt.get(task.remote([ref]), timeout=600)
        del ref, x
        row["put"] = {"bytes": _RUNTIME_PUT_BYTES, "s": put_s,
                      "GB_per_s": _RUNTIME_PUT_BYTES / put_s / gb,
                      "serialize_s": serialize_s}
        row["task_get"] = {
            "bytes": _RUNTIME_PUT_BYTES, "s": got["get_s"],
            "GB_per_s": _RUNTIME_PUT_BYTES / got["get_s"] / gb,
            "device": got["device"], "dtype": got["dtype"],
            "gpu_ids": got["gpu_ids"],
            "cuda_visible_devices": got["cuda_visible_devices"],
            "checksum_equal": got["row_sums"] == want}

        # the num_gpus=1 actor: its lease, the forward through B1, and
        # the last position's logits back as a CUDA tensor
        actor = rt.remote(num_gpus=1)(CS.RuntimeActor).remote()
        row["actor_lease"] = rt.get(actor.lease.remote(), timeout=600)
        out = rt.get(actor.forward.remote(seed), timeout=600)
        logits = out["logits"]
        tokens = forward_tokens(cfg, seed)
        ref_logits = T.forward(params, tokens, cfg)[:, -1].to(
            torch.bfloat16)
        torch.cuda.synchronize()
        row["actor_forward"] = {
            "tokens": [4, 2048], "launches": out["launches"],
            "logits_shape": list(logits.shape), "dtype": str(logits.dtype),
            "device": logits.device.type,
            "rel_to_driver": _rel(logits.float(), ref_logits.float()),
            "rel_tol": _RUNTIME_REL_TOL,
            "bitwise_equal": bool(torch.equal(logits, ref_logits))}
        del logits, ref_logits, out

        # a 256 MiB CUDA tensor returned by the actor
        r = actor.tensor.remote(_RUNTIME_RETURN_BYTES, seed + 300)
        rt.wait([r], timeout=600)
        t0 = time.perf_counter()
        y = rt.get(r, timeout=600)
        torch.cuda.synchronize()
        ret_s = time.perf_counter() - t0
        row["actor_return"] = {
            "bytes": _RUNTIME_RETURN_BYTES, "s": ret_s,
            "GB_per_s": _RUNTIME_RETURN_BYTES / ret_s / gb,
            "device": y.device.type, "dtype": str(y.dtype),
            "bitwise_equal": bool(torch.equal(
                y, _runtime_tensor(_RUNTIME_RETURN_BYTES, seed + 300)))}
        del y, r
        rt.kill(actor)
    finally:
        rt.shutdown()
    for _ in range(100):
        left = _workers_left()
        if not left:
            break
        time.sleep(0.1)
    row["workers_left"] = left
    lease, fwd = row["actor_lease"], row["actor_forward"]
    tg, ar = row["task_get"], row["actor_return"]
    checks = {
        "gpus_detected": row["gpus_detected"] == cards == 1,
        "task_tensor": (tg["device"], tg["dtype"], tg["gpu_ids"],
                        tg["cuda_visible_devices"], tg["checksum_equal"])
        == ("cuda", "torch.bfloat16", [0], "0", True),
        "actor_lease": (lease["gpu_ids"], lease["cuda_visible_devices"],
                        lease["device_count"]) == ([0], "0", 1),
        "actor_launches": fwd["launches"] == {
            "flash_fwd": cfg.n_layers, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0},
        "actor_logits": (fwd["logits_shape"] == [4, cfg.vocab_size]
                         and fwd["dtype"] == "torch.bfloat16"
                         and fwd["device"] == "cuda"
                         and fwd["rel_to_driver"] <= _RUNTIME_REL_TOL),
        "actor_return": (ar["device"], ar["dtype"], ar["bitwise_equal"])
        == ("cuda", "torch.bfloat16", True),
        "no_worker_left": not left}
    row["checks"] = checks
    row["ok"] = all(checks.values())
    _emit(row)
    if not row["ok"]:
        raise AssertionError(f"runtime phase failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return fwd["launches"]["flash_fwd"]


class ServeForward:
    """Phase serve's weights-by-reference deployment: bound with the
    driver's llama3-1b bf16 params (CUDA tensors), which serve.run puts
    into the object plane leaf by leaf and the replica fetches before this
    class is built. Defined here and referenced as
    ``chip_smoke.ServeForward``, so it pickles by reference."""

    def __init__(self, params):
        self._entered = time.time()
        self.params = params
        self._ready = time.time()

    def timings(self) -> dict:
        """Stamps on the host's wall clock: this class's __init__ entry and
        end; where the params landed."""
        return {"init_entry": self._entered, "init_end": self._ready,
                "param_devices": sorted({str(w.device) for w in
                                         _tensor_leaves(self.params)}),
                "cuda_visible_devices":
                    os.environ.get("CUDA_VISIBLE_DEVICES")}

    def forward(self, seed: int) -> dict:
        return counted_forward(self.params, _llama_bf16(), seed)

    def fetch(self, refs) -> float:
        """Seconds to get ``refs`` (a list, so they arrive unresolved: new
        objects of the same bytes) onto the card in this process, whose
        torch and CUDA context are made by now."""
        import torch

        import ray_tpu_torch

        t0 = time.perf_counter()
        ray_tpu_torch.get(refs, timeout=600)
        torch.cuda.synchronize()
        return time.perf_counter() - t0


def _tensor_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensor_leaves(v)
        else:
            yield v


class ServeLLMProbe:
    """Phase serve's bf16 replica: build_continuous_llm_deployment's
    replica, plus the decode-chunk probe phase serving takes in process
    (_decode_chunk_profile; it stops the replica's engine, so it runs after
    the requests). Referenced as ``chip_smoke.ServeLLMProbe``."""

    def __init__(self, *args, **kwargs):
        from ray_tpu_torch.serve.llm import _ContinuousLLMReplica

        self.replica = _ContinuousLLMReplica(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        return self.replica(*args, **kwargs)

    def stream(self, *args, **kwargs):
        return self.replica.stream(*args, **kwargs)

    def engine_stats(self) -> dict:
        return self.replica.engine_stats()

    def decode_chunk_profile(self, steps: int) -> dict:
        from ray_tpu_torch.models import engine as E

        eng = self.replica.engine
        eng.shutdown()
        return _decode_chunk_profile(E, eng, eng.cfg, steps)


def _timed(fn, into: list):
    """``fn`` adding each call's seconds to ``into``."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        into.append(time.perf_counter() - t0)
        return result
    return wrapper


def _serve_fp32(E, T, cfg, seed: int) -> dict:
    """Check 1: the fp32 continuous replica against the in-process engine."""
    import torch

    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import build_continuous_llm_deployment

    cfg32 = fp32_config(cfg)
    prompts = engine_prompts(cfg, seed)
    t0 = time.perf_counter()
    app = build_continuous_llm_deployment(
        cfg32, name="fp32", slots=8, max_prompt_len=64,
        max_new_tokens=_ENGINE_MAX_NEW, seed=seed)
    h = serve.run(app, name="fp32", route_prefix="/fp32", timeout_s=600)
    ready_s = time.perf_counter() - t0
    futs = [h.remote(p) for p in prompts]
    called = [f.result(timeout_s=600)["token_ids"] for f in futs]
    streamed = [[c["token_id"] for c in h.options(
        method_name="stream", stream=True).remote(p)] for p in prompts]
    serve.delete("fp32")
    p32 = T.init_params(torch.Generator(device="cuda").manual_seed(seed),
                        cfg32, device="cuda")
    want = engine_tokens(E, p32, cfg32, prompts, seed)
    del p32
    torch.cuda.empty_cache()
    return {"n_layers": cfg32.n_layers, "dtype": "float32",
            "prompt_lens": [len(p) for p in prompts],
            "max_new_tokens": _ENGINE_MAX_NEW,
            "lease": app.deployment.config.ray_actor_options,
            "deploy_to_ready_s": ready_s,
            "call_matches_engine": [a == b for a, b in zip(called, want)],
            "stream_matches_engine": [a == b for a, b in
                                      zip(streamed, want)]}


def _serve_bf16(cfg, seed: int, serving_tps) -> dict:
    """Check 2: phase serving's cell through a handle, and one request
    through the HTTP proxy."""
    import urllib.request

    import chip_smoke as CS  # by reference, not as __main__
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import build_continuous_llm_deployment

    clients, per_client, max_new = 8, 4, 64
    app = build_continuous_llm_deployment(
        cfg, name="bf16", slots=8, max_prompt_len=64, max_new_tokens=max_new,
        decode_chunk=16, fetch_every=4, seed=seed)
    app.deployment.func_or_class = CS.ServeLLMProbe  # the same replica
    h = serve.run(app, name="bf16", route_prefix="/bf16", timeout_s=600)
    stream = h.options(method_name="stream", stream=True)
    rng = random.Random(seed + 3)
    warm = [h.remote([rng.randint(1, 200) for _ in range(n)], 4)
            for n in _SERVE_WARMUP_LENS]
    for f in warm:
        f.result(timeout_s=600)
    results, errors, lock = [], [], threading.Lock()

    def client(cid):
        nxt = _workload(seed + 17 + cid, 64, max_new)
        try:
            for _ in range(per_client):
                prompt, want = nxt()
                t0 = time.perf_counter()
                ttft, toks = None, []
                for chunk in stream.remote(prompt, want):
                    if ttft is None:
                        ttft = time.perf_counter() - t0
                    toks.append(chunk["token_id"])
                with lock:
                    results.append((want, toks, ttft,
                                    time.perf_counter() - t0))
        except BaseException as e:  # reported below, fails the phase
            with lock:
                errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    hung = sum(t.is_alive() for t in threads)
    stats = h.options(method_name="engine_stats").remote().result(
        timeout_s=60)

    # one request through the HTTP proxy, then the same through the handle
    prompt = [rng.randint(1, 200) for _ in range(20)]
    port = serve.start(serve.HTTPOptions(port=0))
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/bf16", data=json.dumps(prompt).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        http_tokens = json.loads(r.read())["token_ids"]
    handle_tokens = h.remote(prompt).result(timeout_s=300)["token_ids"]
    profile = h.options(method_name="decode_chunk_profile").remote(
        16).result(timeout_s=300)
    serve.delete("bf16")

    n_tok = sum(len(r[1]) for r in results)
    lat = [r[3] for r in results]
    ttft = [r[2] for r in results if r[2] is not None]
    tps = n_tok / wall
    return {
        "dtype": "bfloat16", "n_layers": cfg.n_layers, "clients": clients,
        "requests": len(results), "want_requests": clients * per_client,
        "warmup_requests": len(warm), "errors": errors,
        "hung_clients": hung,
        "wrong_length": sum(len(t) != w for w, t, _, _ in results),
        "out_of_vocab": sum(any(not 0 <= x < cfg.vocab_size for x in t)
                            for _, t, _, _ in results),
        "generated_tokens": n_tok, "wall_s": wall, "tokens_per_s": tps,
        "serving_tokens_per_s": serving_tps,
        "ratio_to_serving": tps / serving_tps if serving_tps else None,
        "latency_p50_s": _pct(lat, 50) if lat else None,
        "latency_p95_s": _pct(lat, 95) if lat else None,
        "ttft_p50_s": _pct(ttft, 50) if ttft else None,
        "ttft_p95_s": _pct(ttft, 95) if ttft else None,
        "engine_stats": stats,
        "host_ms_per_decode_substep_dispatch": (
            stats["dispatch_wall_s"] / stats["decode_steps"] * 1e3
            if stats["decode_steps"] else None),
        "decode_chunk": profile,
        "http": {"prompt_len": len(prompt), "tokens": len(http_tokens),
                 "equal_to_handle": http_tokens == handle_tokens}}


def _serve_by_ref(T, cfg, params, seed: int) -> dict:
    """Check 3: the driver's bf16 params by reference into a num_gpus=1
    replica, its forward through B1."""
    import torch

    import chip_smoke as CS
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve import api as serve_api

    nbytes = sum(w.numel() * w.element_size()
                 for w in _tensor_leaves(params))
    digest_s, put_s = [], []
    digest, put = serve_api._weights_digest, serve_api._put_weights
    serve_api._weights_digest = _timed(digest, digest_s)
    serve_api._put_weights = _timed(put, put_s)
    # the replica's start includes fetching 2.47 GB: a start deadline past
    # the 10 s default
    dep = serve.deployment(CS.ServeForward, name="by_ref",
                           ray_actor_options={"num_gpus": 1},
                           health_check_timeout_s=300)
    t0, wall0 = time.perf_counter(), time.time()
    try:
        h = serve.run(dep.bind(params), name="by_ref",
                      route_prefix="/by_ref", timeout_s=600)
    finally:
        serve_api._weights_digest, serve_api._put_weights = digest, put
    ready_s = time.perf_counter() - t0
    stamps = h.timings.remote().result(timeout_s=60)
    # two of the leaves again as new objects (a get of the replica's own
    # refs would find them in its process; two, 1.07 GB, fit the arena
    # beside the first put), fetched by the warm replica
    again_leaves = [params["layers"][k] for k in ("w_gate", "w_up")]
    again_bytes = sum(w.numel() * w.element_size() for w in again_leaves)
    t0 = time.perf_counter()
    fresh = [rt.put(w) for w in again_leaves]
    reput_s = time.perf_counter() - t0
    fetch_s = h.fetch.remote(fresh).result(timeout_s=600)
    del fresh
    out = h.forward.remote(seed).result(timeout_s=600)
    again = h.forward.remote(seed).result(timeout_s=600)
    serve.delete("by_ref")
    ref_logits = T.forward(params, forward_tokens(cfg, seed), cfg)[:, -1] \
        .to(torch.bfloat16)
    torch.cuda.synchronize()
    logits = out["logits"]
    put_done = wall0 + sum(put_s)
    return {
        "bytes": nbytes, "leaves": len(put_s),
        "deploy_to_ready_s": ready_s,
        "digest_s": sum(digest_s), "put_s": sum(put_s) - sum(digest_s),
        "put_GB_per_s": nbytes / (sum(put_s) - sum(digest_s)) / 1e9,
        # from the last put to the class's __init__: the replica's
        # placement, its worker's torch import and CUDA context, and the
        # fetch of every leaf onto the card
        "start_and_fetch_s": stamps["init_entry"] - put_done,
        # new objects of two leaves' bytes: put by the driver, fetched by
        # the warm replica
        "again_bytes": again_bytes, "reput_s": reput_s,
        "reput_GB_per_s": again_bytes / reput_s / 1e9, "fetch_s": fetch_s,
        "fetch_GB_per_s": again_bytes / fetch_s / 1e9,
        "init_s": stamps["init_end"] - stamps["init_entry"],
        "init_to_ready_s": wall0 + ready_s - stamps["init_end"],
        "param_devices": stamps["param_devices"],
        "cuda_visible_devices": stamps["cuda_visible_devices"],
        "first_forward_s": out["s"], "second_forward_s": again["s"],
        "launches": out["launches"], "launches_again": again["launches"],
        "logits_shape": list(logits.shape), "dtype": str(logits.dtype),
        "device": logits.device.type,
        "bitwise_equal": bool(torch.equal(logits, ref_logits))}


def phase_serve(E, T, cfg, params, seed: int, serving_tps):
    """The port's Serve on the card (the module's docstring, serve).
    Returns the by-reference replica's B1 launches."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    row = {"phase": "serve", "card": _nvidia_smi()}
    rt.init(num_cpus=4, object_store_memory=_RUNTIME_STORE_BYTES,
            log_to_driver=False)
    try:
        row["gpus_detected"] = rt.cluster_resources().get("GPU", 0)
        for name, check, args in (
                ("fp32", _serve_fp32, (E, T, cfg, seed)),
                ("bf16", _serve_bf16, (cfg, seed, serving_tps)),
                ("by_ref", _serve_by_ref, (T, cfg, params, seed))):
            try:
                row[name] = check(*args)
            except Exception:  # recorded; the checks below fail on it
                traceback.print_exc()
                row[name] = {"error": traceback.format_exc(limit=2)}
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    for _ in range(100):
        left = _workers_left()
        if not left:
            break
        time.sleep(0.1)
    row["workers_left"] = left
    f32, b16, ref = row["fp32"], row["bf16"], row["by_ref"]
    checks = {"ran": not any("error" in r for r in (f32, b16, ref))}
    if checks["ran"]:
        checks.update(_serve_checks(cfg, f32, b16, ref))
    checks["no_worker_left"] = not left
    row["checks"] = checks
    row["ok"] = all(checks.values())
    _emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve phase failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return ref["launches"]["flash_fwd"]


def _serve_checks(cfg, f32, b16, ref) -> dict:
    return {
        "fp32_call": all(f32["call_matches_engine"]),
        "fp32_stream": all(f32["stream_matches_engine"]),
        "fp32_lease": f32["lease"] == {"num_gpus": 1},
        "bf16_served": (not b16["errors"] and not b16["hung_clients"]
                        and not b16["wrong_length"]
                        and not b16["out_of_vocab"]
                        and b16["requests"] == b16["want_requests"]),
        "http_equals_handle": b16["http"]["equal_to_handle"],
        "by_ref_launches": ref["launches"] == ref["launches_again"] == {
            "flash_fwd": cfg.n_layers, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0},
        "by_ref_on_card": (ref["param_devices"] == ["cuda:0"]
                           and ref["cuda_visible_devices"] == "0"),
        "by_ref_logits": (ref["logits_shape"] == [4, cfg.vocab_size]
                          and ref["dtype"] == "torch.bfloat16"
                          and ref["device"] == "cuda"
                          and ref["bitwise_equal"])}


def _grads(T, TR, params, batch, cfg, mesh=None):
    """(loss, grads) of one step's loss_fn, leaves in tree order; on a
    DeviceMesh (DTensor params) the grads' local shards."""
    import torch

    leaves = TR.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = T.loss_fn(params, batch, cfg, mesh)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    # a DeviceMesh gives DTensor grads, a VirtualMesh plain ones
    grads = [g.to_local() if hasattr(g, "to_local") else g for g in grads]
    return loss.detach(), grads


def _tree_rel(xs, refs) -> float:
    """||x - ref|| / ||ref|| over all leaves, flattened, in fp64 sums."""
    num = den = 0.0
    for x, r in zip(xs, refs):
        r = r.float()
        num += (x.float() - r).double().pow(2).sum().item()
        den += r.double().pow(2).sum().item()
    return (num / den) ** 0.5


def _leaf_names(tree, prefix=""):
    """Dotted names of a tree's leaves, in TR.tree_leaves order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def train_config(C, **kw):
    """bench.py's llama3-1b training cell: bf16 params, T = 2048, remat
    with policy "nothing" (``n_layers=`` cuts its depth)."""
    import torch

    return C.get_config("llama3-1b", param_dtype=torch.bfloat16,
                        max_seq_len=2048, remat=True, remat_policy="nothing",
                        **kw)


def train_batch(cfg, seed: int):
    """One random batch of 4 x 2048 tokens on the card, from ``seed``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (4, 2049), generator=g,
                         device="cuda", dtype=torch.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def train_parity(T, TR, cfg, params, batch, mesh=None,
                 ratio_tol=None) -> dict:
    """One step's loss and gradients three ways on identical weights and
    batch: bf16 through the kernels (``cfg``), bf16 through plain attention,
    and fp32 with plain attention as the truth (the caller turns TF32 off).
    -> each bf16 step's relative distance from the fp32 step for the loss,
    the flattened gradient of all leaves, and each leaf of _ATTN_GRAD_LEAVES;
    the kernel step's distance over the plain step's ("kernel_over_plain":
    loss, grad, and attn_grad, the largest of the leaves'); the three
    losses; and "ok", whether every ratio is within ``ratio_tol`` (default
    _TRAIN_BF16_RATIO). With a ``mesh`` (a VirtualMesh) the kernel step
    runs on it; the plain and the fp32 steps stay unmeshed."""
    import torch

    ratio_tol = ratio_tol or _TRAIN_BF16_RATIO
    names = _leaf_names(params)
    attn = [names.index(n) for n in _ATTN_GRAD_LEAVES]
    plain_cfg = dataclasses.replace(cfg, attention_impl="xla")
    cfg32 = dataclasses.replace(plain_cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    loss_k, grads_k = _grads(T, TR, params, batch, cfg, mesh)
    loss_p, grads_p = _grads(T, TR, params, batch, plain_cfg)
    p32 = TR.tree_map(lambda w: w.float(), params)
    loss_32, grads_32 = _grads(T, TR, p32, batch, cfg32)
    del p32
    losses = {"fp32": loss_32.item(), "bf16_kernel": loss_k.item(),
              "bf16_plain": loss_p.item()}
    rel = {"loss_kernel": abs(losses["bf16_kernel"] - losses["fp32"])
           / abs(losses["fp32"]),
           "loss_plain": abs(losses["bf16_plain"] - losses["fp32"])
           / abs(losses["fp32"]),
           "grad_kernel": _tree_rel(grads_k, grads_32),
           "grad_plain": _tree_rel(grads_p, grads_32),
           "grad_kernel_vs_plain": _tree_rel(grads_k, grads_p)}
    leaf_ratio = {}
    for i in attn:
        name = names[i].split(".")[-1]
        rel[f"{name}_kernel"] = _tree_rel([grads_k[i]], [grads_32[i]])
        rel[f"{name}_plain"] = _tree_rel([grads_p[i]], [grads_32[i]])
        leaf_ratio[name] = rel[f"{name}_kernel"] / rel[f"{name}_plain"]
    del grads_k, grads_p, grads_32
    torch.cuda.empty_cache()
    ratio = {k: rel[f"{k}_kernel"] / max(rel[f"{k}_plain"], 1e-30)
             for k in ("loss", "grad")}
    ratio["attn_grad"] = max(leaf_ratio.values())
    return {"rel_to_fp32": rel, "attn_leaf_ratio": leaf_ratio,
            "kernel_over_plain": ratio, "losses": losses,
            "ratio_tol": ratio_tol,
            "ok": all(ratio[k] <= ratio_tol[k] for k in ratio)}


def _counts(fa):
    return {"flash_fwd": fa.launches, "flash_bwd_dq": fa.launches_dq,
            "flash_bwd_dkv": fa.launches_dkv}


def _zero_counts(fa):
    fa.launches = fa.launches_dq = fa.launches_dkv = 0


def _step_profile(step):
    """Device busy share of one step and its ten largest kernels by device
    time, from torch.profiler; "not measured" if it sees no device time.
    A failure of the step itself propagates."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    try:
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        dev_us = sum(e.device_time_total for e in events)
        top = sorted(events, key=lambda e: -e.device_time_total)[:10]
        top = [{"name": e.key[:80], "ms": e.device_time_total / 1e3,
                "count": e.count} for e in top]
    except Exception:  # reading the profile is a probe here, not a phase
        traceback.print_exc()
        dev_us, top, events = 0, [], []
    return {"profiled_wall_ms": wall * 1e3,
            "device_ms": dev_us / 1e3 if dev_us else "not measured",
            "device_launches": (sum(e.count for e in events) if dev_us
                                else "not measured"),
            "device_busy_share": (dev_us / 1e6 / wall if dev_us
                                  else "not measured"),
            "top_kernels": top}


def _train_steps(fa, TR, cfg, params, batch, steps: int, profile: bool,
                 mesh=None):
    """``steps`` AdamW steps (lr 3e-4, bf16 first moment) through the
    kernels on one fixed batch, in place on ``params``; each step's
    metrics, launches and host wall (synchronized), the peak memory, and
    with ``profile`` the last step under torch.profiler (_step_profile).
    With a ``mesh`` the state is sharded on it (interop.shard_state) and
    the step is the meshed one."""
    import torch

    tx = TR.make_optimizer(3e-4, mu_dtype=torch.bfloat16)
    state = {"step": torch.zeros((), dtype=torch.int32, device="cuda"),
             "params": params, "opt_state": tx.init(params)}
    if mesh is not None:
        from ray_tpu_torch.interop import shard_state

        state = shard_state(mesh, state, cfg, tx)
    step_fn = TR.make_train_step(cfg, tx, mesh)
    metrics, launches, walls, prof = [], [], [], None
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        def one():
            _, m = step_fn(state, batch)
            metrics.append({k: v.item() for k, v in m.items()})
        _zero_counts(fa)
        torch.cuda.synchronize()
        if profile and i == steps - 1:
            prof = _step_profile(one)
        else:
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches.append(_counts(fa))
    peak = torch.cuda.max_memory_allocated()
    del state, tx
    torch.cuda.empty_cache()
    if not len(metrics) == len(launches) == steps:
        raise AssertionError(f"{len(metrics)} of {steps} train steps "
                             f"reported their metrics")
    losses = [m["loss"] for m in metrics]
    norms = [m["grad_norm"] for m in metrics]
    return {"losses": losses, "grad_norms": norms,
            "finite": all(math.isfinite(x) for x in losses + norms),
            "falling": losses[-1] < losses[0], "launches_per_step": launches,
            "walls_ms": [w * 1e3 for w in walls],
            "peak_mem_gib": peak / 2**30, "profile_last_step": prof,
            "metrics": metrics}


def phase_train(fa, T, TR, C, params, seed: int):
    """bench.py's llama3-1b training cell on the port:
      (a) one step's loss, flattened gradient and wq/wk/wv gradients in
          bf16 through the kernels and through plain attention, each as a
          relative distance from the same step in fp32 with plain attention
          and no TF32 (train_parity); the kernels' may be at most
          _TRAIN_BF16_RATIO times the plain one's, and this step launches
          the kernels as a train step does;
      (b) _TRAIN_STEPS AdamW steps through the kernels on one fixed batch:
          every loss finite, the last below the first;
      (c) launches of each kernel in every step, against _TRAIN_LAUNCHES
          (B1 16 forward + 16 remat recomputes, B2 and B3 16);
      (d) ms per step (steps 2-4, host clock around synchronized steps),
          tokens/s, MFU against 989 TFLOP/s from cfg.flops_per_token, peak
          memory, and the busy share of step 5 from torch.profiler.
    Params are updated in place: no later phase uses them. Returns the
    first step's launches, the five losses and ms per step."""
    cfg = train_config(C)
    batch = train_batch(cfg, seed + 3)

    # (a) three ways on identical weights and batch
    _zero_counts(fa)
    parity = train_parity(T, TR, cfg, params, batch)
    grad_launches = _counts(fa)  # the plain and fp32 steps launch nothing

    # (b), (c), (d): optimizer steps through the kernels
    run = _train_steps(fa, TR, cfg, params, batch, _TRAIN_STEPS, True)
    walls = run.pop("walls_ms")
    step_ms = sum(walls[1:]) / len(walls[1:])
    flops_step = cfg.flops_per_token(2048) * 4 * 2048
    launches_ok = all(c == _TRAIN_LAUNCHES
                      for c in [grad_launches, *run["launches_per_step"]])
    run["profile_step5"] = run.pop("profile_last_step")
    del run["metrics"]
    _emit({"phase": "train", "config": "llama3-1b", "batch": [4, 2048],
           "param_dtype": "bfloat16", "mu_dtype": "bfloat16", "remat": True,
           "lr": 3e-4, "parity": parity, "ratio_tol": _TRAIN_BF16_RATIO,
           "grad_launches": grad_launches, **run,
           "launches_want": _TRAIN_LAUNCHES, "first_step_ms": walls[0],
           "ms_per_step": step_ms,
           "tokens_per_s": 4 * 2048 / step_ms * 1e3,
           "flops_per_step": flops_step,
           "mfu": flops_step / step_ms * 1e3 / _PEAK_FLOPS["bfloat16"]})
    if not (parity["ok"] and run["finite"] and run["falling"]
            and launches_ok):
        raise AssertionError("train phase failed")
    return {"launches": run["launches_per_step"][0],
            "losses": run["losses"], "ms_per_step": step_ms}


def _proc_start_time() -> float:
    """This process's start, in seconds since the epoch (/proc: clock
    ticks since boot, 10 ms)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def _leaf_checksums(tree) -> list:
    """The exact integer sum of each leaf's bit patterns, in tree_leaves
    order: the checksums the worker and the driver compare."""
    import torch

    from ray_tpu_torch.models.training import tree_leaves

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return [x.reshape(-1).view(ints[x.element_size()]).sum(
        dtype=torch.int64).item() for x in tree_leaves(tree)]


def trainer_loop(config):
    """Phase trainer's loop, in the TorchTrainer's num_gpus=1 worker
    (referenced as ``chip_smoke.trainer_loop``, so it pickles by
    reference): phase train's cell, the state from the seed as ``run``
    builds ``params`` (or, after the gang restart, from the checkpoint),
    steps up to _TRAIN_STEPS with each loss, launches and wall reported;
    the whole state reported as a checkpoint at _TRAINER_CKPT_STEP with
    its per-leaf checksums; on the first attempt a failure right after
    _TRAINER_FAIL_STEP's report."""
    entered = time.time()
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import train
    from ray_tpu_torch.models import config as C
    from ray_tpu_torch.models import training as TR
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.ops import _build
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    imported = time.time()
    for name in _build.sources():
        _build.load(name)
    ready = time.time()
    free, _ = torch.cuda.mem_get_info()
    start = {"process_start_t": _proc_start_time(), "loop_entry_t": entered,
             "imports_s": imported - entered,
             "kernel_libraries_s": ready - imported, "ready_t": ready,
             "card_free_gib": free / 2**30,
             "gpu_ids": ray_tpu_torch.get_gpu_ids(),
             "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
             "device_count": torch.cuda.device_count(),
             "current_device": torch.cuda.current_device(),
             "pid": os.getpid()}
    seed = config["seed"]
    cfg = train_config(C, n_layers=_TRAINER_LAYERS)
    tx = TR.make_optimizer(3e-4, mu_dtype=torch.bfloat16)
    batch = train_batch(cfg, seed + 3)
    restored = train.get_checkpoint()
    if restored is None:
        params = T.init_params(torch.Generator(device="cuda").manual_seed(
            seed), _llama_bf16(n_layers=_TRAINER_LAYERS), device="cuda")
        state = {"step": torch.zeros((), dtype=torch.int32, device="cuda"),
                 "params": params, "opt_state": tx.init(params)}
        del params
    else:
        t0 = time.perf_counter()
        tree, _ = restored.to_pytree()
        t1 = time.perf_counter()
        state = TR.tree_map(lambda x: x.to("cuda"), tree)
        torch.cuda.synchronize()
        start["restore"] = {"read_s": t1 - t0,
                            "h2d_s": time.perf_counter() - t1}
        del tree
    step_fn = TR.make_train_step(cfg, tx)
    torch.cuda.reset_peak_memory_stats()
    first = int(state["step"]) + 1
    for i in range(first, _TRAIN_STEPS + 1):
        _zero_counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step_fn(state, batch)
        loss, norm = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        metrics = {"step": i, "loss": loss, "grad_norm": norm,
                   "launches": _counts(fa),
                   "wall_ms": (time.perf_counter() - t0) * 1e3,
                   "end_t": time.time(), "restart": restored is not None}
        if i == first:
            metrics["start"] = start
        checkpoint = None
        if i == _TRAINER_CKPT_STEP:
            metrics["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
            metrics["checksums"] = _leaf_checksums(state)
            metrics["ckpt_bytes"] = sum(x.numel() * x.element_size()
                                        for x in TR.tree_leaves(state))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint = train.Checkpoint.from_pytree(state)
            metrics["d2h_s"] = time.perf_counter() - t0
            metrics["report_t"] = time.time()
        fail = (i == _TRAINER_FAIL_STEP
                and not os.path.exists(config["marker"]))
        if fail:
            metrics["raise_t"] = time.time()
        train.report(metrics, checkpoint=checkpoint)
        if fail:
            open(config["marker"], "w").close()
            raise RuntimeError("phase trainer: the injected worker failure")


def _mem_available() -> int:
    with open("/proc/meminfo") as f:
        kib = next(int(line.split()[1]) for line in f
                   if line.startswith("MemAvailable:"))
    return kib << 10


def phase_trainer(fa, T, TR, C, seed: int):
    """Phase train's cell at _TRAINER_LAYERS layers through the port's
    Train library: a TorchTrainer with one num_gpus=1 worker (the module's
    docstring, trainer). Returns the worker's launches in its first step
    and its ms per step."""
    import torch

    import chip_smoke as CS  # by reference, not as __main__
    import ray_tpu_torch as rt
    from ray_tpu_torch import train

    # the same five steps in the driver first, from the seed
    cfg = train_config(C, n_layers=_TRAINER_LAYERS)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(
        seed), _llama_bf16(n_layers=_TRAINER_LAYERS), device="cuda")
    ref = _train_steps(fa, TR, cfg, params, train_batch(cfg, seed + 3),
                       _TRAIN_STEPS, False)
    walls = ref["walls_ms"][1:-1]  # steps 2-4, as phase train's
    driver = {"losses": ref["losses"],
              "ms_per_step": sum(walls) / len(walls)}
    del params, ref
    torch.cuda.empty_cache()
    avail = _mem_available()
    if avail < _TRAINER_HOST_BYTES:
        raise AssertionError(f"trainer phase: {avail / 2**30:.1f} GiB of "
                             f"host memory available, needs "
                             f"{_TRAINER_HOST_BYTES / 2**30:.0f}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    row = {"phase": "trainer", "card": _nvidia_smi(),
           "host_mem_available_gib": avail / 2**30,
           "disk_free_gib": shutil.disk_usage(tmp).free / 2**30}
    try:
        if shutil.disk_usage(tmp).free < _TRAINER_DISK_BYTES:
            raise AssertionError(f"trainer phase: {row['disk_free_gib']:.1f}"
                                 f" GiB free under {tmp}")
        rt.init(num_cpus=4, object_store_memory=_TRAINER_STORE_BYTES,
                log_to_driver=False)
        try:
            t0 = time.time()
            result = train.TorchTrainer(
                CS.trainer_loop,
                train_loop_config={
                    "seed": seed,
                    "marker": os.path.join(tmp, "failed_once")},
                scaling_config=train.ScalingConfig(num_workers=1,
                                                   use_gpu=True),
                run_config=train.RunConfig(
                    name="trainer", storage_path=tmp,
                    checkpoint_config=train.CheckpointConfig(num_to_keep=1),
                    failure_config=train.FailureConfig(
                        max_failures=1))).fit()
            row["fit_s"] = time.time() - t0
            # fit's own spans, (start, end) in seconds on the driver's
            # clock, in order of start
            spans: dict = {}
            for e in sorted(rt.tracing.timeline(), key=lambda e: e["ts"]):
                if e["cat"] == "span" and e["name"].startswith("train."):
                    spans.setdefault(e["name"][len("train."):], []).append(
                        (e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6))
        finally:
            rt.shutdown()
        row["error"] = None if result.error is None else repr(result.error)
        hist = result.metrics_history
        ckpt_sums = None
        if result.checkpoint is not None:
            t0 = time.perf_counter()
            tree, _ = result.checkpoint.to_pytree(device="cuda")
            torch.cuda.synchronize()
            row["driver_load_s"] = time.perf_counter() - t0
            ckpt_sums = _leaf_checksums(tree)
            del tree
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for _ in range(100):
        left = _workers_left()
        if not left:
            break
        time.sleep(0.1)
    row["workers_left"] = left

    steps = [m["step"] for m in hist]
    first = [m for m in hist if not m["restart"]]
    again = [m for m in hist if m["restart"]]
    losses = [m["loss"] for m in first] + [m["loss"] for m in again[1:]]
    ref = driver["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    restart_rel = (abs(again[0]["loss"] - first[-1]["loss"])
                   / abs(first[-1]["loss"]) if again and first
                   else float("inf"))
    starts = [m["start"] for m in hist if "start" in m]
    ck = next((m for m in hist if "checksums" in m), None)
    row.update({
        "n_layers": _TRAINER_LAYERS, "steps": steps, "losses": losses,
        "driver_losses": ref, "rel_to_driver": rel,
        "max_rel_to_driver": max(rel, default=float("inf")),
        "restart_step_rel": restart_rel, "tol": _TRAINER_REL_TOL,
        "launches_per_step": [m["launches"] for m in hist],
        "launches_want": _TRAINER_LAUNCHES,
        "leases": [{k: s[k] for k in ("gpu_ids", "cuda_visible_devices",
                                      "device_count", "current_device",
                                      "pid", "card_free_gib")}
                   for s in starts],
        "checksums_equal": ck is not None and ckpt_sums == ck["checksums"]})
    if ck is not None and len(starts) == 2 and len(again) >= 2:
        s0, s1 = starts
        (start0, start0_end), (start1, _) = spans["executor_start"][:2]
        reg = spans["checkpoint_register"][0]
        down = spans["executor_shutdown"][0]
        fail = next(m for m in first if "raise_t" in m)
        gb = ck["ckpt_bytes"] / 1e9
        walls = {m["step"]: m["wall_ms"] for m in first}
        row["numbers"] = {
            "worker_start_s": s0["ready_t"] - start0,
            "worker_start_split_s": {
                # negative: the runtime had started the process before
                # the lease (a pooled worker)
                "process_start_after_start": s0["process_start_t"] - start0,
                "torch_import_and_cuda_context": start0_end - max(
                    start0, s0["process_start_t"]),
                "session_to_loop": s0["loop_entry_t"] - start0_end,
                "port_imports_and_first_cuda_op": s0["imports_s"],
                "kernel_libraries": s0["kernel_libraries_s"]},
            "ms_per_step_steps_2_3": (walls[2] + walls[3]) / 2,
            "first_step_ms": walls[1],
            "driver_ms_per_step": driver["ms_per_step"],
            "peak_mem_gib": ck["peak_mem_gib"],
            "checkpoint": {
                "bytes": ck["ckpt_bytes"], "d2h_s": ck["d2h_s"],
                "d2h_GB_per_s": gb / ck["d2h_s"],
                "report_to_driver_s": reg[0] - ck["report_t"],
                "report_GB_per_s": gb / (reg[0] - ck["report_t"]),
                "to_directory_s": reg[1] - reg[0],
                "to_directory_GB_per_s": gb / (reg[1] - reg[0])},
            "restart": {
                "to_first_step_s": again[0]["end_t"] - fail["raise_t"],
                # the worker runs ahead of the driver's result pump: it can
                # fail while the driver still takes in step 3's checkpoint
                "driver_busy_after_failure_s": max(
                    0.0, reg[1] - fail["raise_t"]),
                "failure_seen_to_shutdown_s": down[0] - max(
                    reg[1], fail["raise_t"]),
                "from_shutdown_to_first_step_s": (again[0]["end_t"]
                                                  - down[0]),
                "executor_shutdown_s": down[1] - down[0],
                "shutdown_to_new_start_s": start1 - down[1],
                "new_worker_start_s": s1["ready_t"] - start1,
                "to_pytree_read_s": s1["restore"]["read_s"],
                "read_GB_per_s": gb / s1["restore"]["read_s"],
                "h2d_s": s1["restore"]["h2d_s"],
                "h2d_GB_per_s": gb / s1["restore"]["h2d_s"],
                "first_step_ms": again[0]["wall_ms"]}}
    checks = {
        "no_error": result.error is None,
        "lease": len(starts) == 2 and all(
            s["gpu_ids"] == [0] and s["device_count"] == 1
            and s["current_device"] == 0
            and len((s["cuda_visible_devices"] or "").split(",")) == 1
            and s["cuda_visible_devices"] != "" for s in starts),
        "launches": bool(hist) and all(m["launches"] == _TRAINER_LAUNCHES
                                       for m in hist),
        "six_reports": steps == [1, 2, 3, _TRAINER_FAIL_STEP,
                                 _TRAINER_FAIL_STEP, 5],
        "losses_equal_driver": (len(losses) == len(ref) == _TRAIN_STEPS
                                     and max(rel) <= _TRAINER_REL_TOL),
        "restart_step_equal": restart_rel <= _TRAINER_REL_TOL,
        "checkpoint_checksums": row["checksums_equal"],
        "no_worker_left": not left}
    row["checks"] = checks
    row["ok"] = all(checks.values())
    _emit(row)
    if not row["ok"]:
        raise AssertionError(f"trainer phase failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return {"launches": hist[0]["launches"],
            "ms_per_step": row.get("numbers", {}).get(
                "ms_per_step_steps_2_3")}


def data_rows(vocab_size: int, seed: int):
    """Phase data's shard, made with numpy from ``seed``: ids and tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab_size, (_DATA_ROWS, _DATA_SEQ),
                          dtype=np.int32)
    return np.arange(_DATA_ROWS, dtype=np.int64), tokens


def data_row_sums(tokens):
    """Each row's checksum: sum_j (j + 1) * tokens[j] in int64, exact (the
    largest is below 2^39), from a numpy array or a CUDA tensor: a changed
    or moved token changes it."""
    import numpy as np

    if isinstance(tokens, np.ndarray):
        w = np.arange(1, tokens.shape[-1] + 1, dtype=np.int64)
        return (tokens.astype(np.int64) * w).sum(-1)
    import torch

    w = torch.arange(1, tokens.shape[-1] + 1, dtype=torch.int64,
                     device=tokens.device)
    return (tokens.to(torch.int64) * w).sum(-1)


def data_trainer_loop(config):
    """Phase data's loop in the TorchTrainer's num_gpus=1 worker (by
    reference as ``chip_smoke.data_trainer_loop``): phase train's cell from
    the seed, fed by the dataset shard's ``iter_torch_batches`` with no
    device; _DATA_STEPS steps on the first batches (launches, the wait for
    each batch and each step's wall), then the rest of the epoch drained.
    Reports every batch's devices, ids and row checksums."""
    entered = time.time()
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import train
    from ray_tpu_torch.models import config as C
    from ray_tpu_torch.models import training as TR
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.ops import _build
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    for name in _build.sources():
        _build.load(name)
    start = {"loop_entry_t": entered, "ready_t": time.time(),
             "gpu_ids": ray_tpu_torch.get_gpu_ids(),
             "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
             "device_count": torch.cuda.device_count(),
             "current_device": torch.cuda.current_device()}
    cfg = train_config(C)
    tx = TR.make_optimizer(3e-4, mu_dtype=torch.bfloat16)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(
        config["seed"]), _llama_bf16(), device="cuda")
    state = {"step": torch.zeros((), dtype=torch.int32, device="cuda"),
             "params": params, "opt_state": tx.init(params)}
    del params
    step_fn = TR.make_train_step(cfg, tx)
    torch.cuda.synchronize()
    start["state_ready_t"] = time.time()

    devices, ids, sums = set(), [], []

    def take(batch):
        devices.update(str(t.device) for t in batch.values())
        ids.append(batch["id"])
        sums.append(data_row_sums(batch["tokens"]))

    batches = iter(train.get_dataset_shard("train").iter_torch_batches(
        batch_size=_DATA_BATCH))
    steps = []
    for i in range(_DATA_STEPS):
        t0 = time.perf_counter()
        batch = next(batches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        take(batch)
        toks = batch["tokens"]
        _zero_counts(fa)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _, m = step_fn(state, {"inputs": toks[:, :-1],
                               "targets": toks[:, 1:]})
        loss = m["loss"].item()
        torch.cuda.synchronize()
        steps.append({"step": i + 1, "loss": loss,
                      "batch_wait_ms": (t1 - t0) * 1e3,
                      "ms": (time.perf_counter() - t2) * 1e3,
                      "launches": _counts(fa)})
    del state
    t0 = time.perf_counter()
    drained = nbytes = 0
    for batch in batches:
        take(batch)
        drained += 1
        nbytes += sum(t.numel() * t.element_size() for t in batch.values())
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    train.report({"start": start, "steps": steps, "devices": sorted(devices),
                  "ids": torch.cat(ids).tolist(),
                  "row_sums": torch.cat(sums).tolist(),
                  "drain": {"batches": drained, "bytes": nbytes,
                            "s": drain_s}})


def phase_data(seed: int, trainer_row, train_row):
    """A shuffled Dataset feeding the train step in a TorchTrainer worker
    (the module's docstring, data). Returns the worker's launches in its
    first step."""
    import chip_smoke as CS  # by reference, not as __main__
    import ray_tpu_torch as rt
    from ray_tpu_torch import data, state, train
    from ray_tpu_torch.data.executor import SHUFFLE_STATS
    from ray_tpu_torch.models import config as C

    t_phase = time.perf_counter()
    vocab = C.get_config("llama3-1b").vocab_size
    ids, tokens = data_rows(vocab, seed)
    want_sums = data_row_sums(tokens)
    per = _DATA_ROWS // _DATA_BLOCKS
    blocks = [{"id": ids[i:i + per], "tokens": tokens[i:i + per]}
              for i in range(0, _DATA_ROWS, per)]
    row = {"phase": "data", "card": _nvidia_smi(), "rows": _DATA_ROWS,
           "blocks": _DATA_BLOCKS, "bytes": int(ids.nbytes + tokens.nbytes),
           "batch_size": _DATA_BATCH}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        rt.init(num_cpus=8, object_store_memory=_DATA_STORE_BYTES,
                log_to_driver=False)
        try:
            before = dict(SHUFFLE_STATS)
            # the driver's order: the same plan, run here
            t0 = time.perf_counter()
            ref = data.from_numpy(blocks).random_shuffle(seed=seed) \
                .materialize()
            shuffle_s = time.perf_counter() - t0
            order = [int(x) for b in ref.iter_batches(batch_size=_DATA_ROWS)
                     for x in b["id"]]
            del ref
            shuffled = data.from_numpy(blocks).random_shuffle(seed=seed)
            t0 = time.time()
            result = train.TorchTrainer(
                CS.data_trainer_loop, train_loop_config={"seed": seed},
                scaling_config=train.ScalingConfig(num_workers=1,
                                                   use_gpu=True),
                run_config=train.RunConfig(name="data", storage_path=tmp),
                datasets={"train": shuffled}).fit()
            fit_s = time.time() - t0
            summary = state.data_shuffle_summary()
            spans = sorted((e["ts"] / 1e6 for e in rt.tracing.timeline()
                            if e["cat"] == "span"
                            and e["name"] == "train.executor_start"))
        finally:
            rt.shutdown()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for _ in range(100):
        left = _workers_left()
        if not left:
            break
        time.sleep(0.1)
    wall_s = time.perf_counter() - t_phase
    got = (result.metrics_history or [{}])[-1]
    steps = got.get("steps", [])
    got_ids = got.get("ids", [])
    start = got.get("start", {})
    drain = got.get("drain", {})
    delta = {k: summary["driver"][k] - before.get(k, 0)
             for k in ("exchanges", "splits", "merges",
                       "parts_freed_eagerly")}
    row.update({
        "error": None if result.error is None else repr(result.error),
        "losses": [s["loss"] for s in steps],
        "launches_per_step": [s["launches"] for s in steps],
        "launches_want": _TRAIN_LAUNCHES, "devices": got.get("devices"),
        "lease": {k: start.get(k) for k in (
            "gpu_ids", "cuda_visible_devices", "device_count",
            "current_device")},
        "shuffle_summary": summary, "shuffle_delta": delta,
        "workers_left": left})
    ms = [s["ms"] for s in steps]
    row["numbers"] = {
        "shuffle_s": shuffle_s, "shuffle_rows_per_s": _DATA_ROWS / shuffle_s,
        "fit_s": fit_s,
        "worker_start_s": (start["ready_t"] - spans[0]
                           if spans and start else None),
        "state_init_s": (start["state_ready_t"] - start["ready_t"]
                         if start else None),
        "batch_wait_ms": [s["batch_wait_ms"] for s in steps],
        "step_ms": ms,
        "ms_per_step_steps_2_5": (sum(ms[1:]) / len(ms[1:])
                                  if len(ms) > 1 else None),
        "phase_trainer_ms_per_step": (trainer_row or {}).get("ms_per_step"),
        "phase_trainer_layers": _TRAINER_LAYERS,
        "phase_train_ms_per_step": (train_row or {}).get("ms_per_step"),
        "drain_batches": drain.get("batches"),
        "drain_s": drain.get("s"),
        "drain_batches_per_s": (drain["batches"] / drain["s"]
                                if drain.get("s") else None),
        "drain_h2d_GB_per_s": (drain["bytes"] / drain["s"] / 1e9
                               if drain.get("s") else None),
        "wall_s": wall_s}
    checks = {
        "no_error": result.error is None,
        "lease": (start.get("gpu_ids") == [0]
                  and start.get("device_count") == 1
                  and start.get("current_device") == 0
                  and len((start.get("cuda_visible_devices") or ""
                           ).split(",")) == 1
                  and start.get("cuda_visible_devices") != ""),
        "batches_on_cuda0": got.get("devices") == ["cuda:0"],
        "launches": (len(steps) == _DATA_STEPS
                     and all(s["launches"] == _TRAIN_LAUNCHES
                             for s in steps)),
        "losses_finite": (len(steps) == _DATA_STEPS
                          and all(math.isfinite(s["loss"]) for s in steps)),
        "ids_once_in_driver_order": (got_ids == order
                                     and sorted(got_ids) == ids.tolist()),
        "tokens_bitwise": (sorted(got_ids) == ids.tolist()
                           and got.get("row_sums") ==
                           want_sums[got_ids].tolist()),
        "shuffle_summary": (delta["exchanges"] >= 2
                            and delta["splits"] >= 2 * _DATA_BLOCKS
                            and summary["driver"]["exchanges"] >= 2),
        "no_worker_left": not left}
    row["checks"] = checks
    row["ok"] = all(checks.values())
    _emit(row)
    if not row["ok"]:
        raise AssertionError(f"data phase failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return steps[0]["launches"]


def _dag_log(log: str, step: str, t0: float, b1: int, **kw):
    """One line per run of a dag_workflow step: the marker file the phase
    counts each step's runs (and their B1 launches) from."""
    with open(log, "a") as f:
        f.write(json.dumps({"step": step, "pid": os.getpid(), "t0": t0,
                            "t1": time.time(), "b1": b1, **kw}) + "\n")


def dag_forward_step(seed: int, log: str) -> dict:
    """The dag_workflow phase's forward step (a num_gpus=1 task):
    llama3-1b in bf16 at full width and _TRAINER_LAYERS layers from
    ``seed``, counted_forward's dict (the last position's logits on the
    card, B1's launches in this process)."""
    t0 = time.time()
    import torch

    from ray_tpu_torch.models import transformer as T

    cfg = _llama_bf16(n_layers=_TRAINER_LAYERS)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(seed),
                           cfg, device="cuda")
    out = counted_forward(params, cfg, seed)
    _dag_log(log, "forward", t0, out["launches"]["flash_fwd"],
             proc_start=_proc_start_time())
    return out


def dag_reduce_step(fwd: dict, log: str) -> dict:
    """The second num_gpus=1 step: the forward's logits' argmax and fp32
    row sums, on the card."""
    t0 = time.time()
    import torch

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    b1 = fa.launches
    x = fwd["logits"]
    out = {"argmax": x.argmax(dim=-1), "row_sums": x.float().sum(dim=-1)}
    torch.cuda.synchronize()
    _dag_log(log, "reduce", t0, fa.launches - b1)
    return out


def dag_join_step(fwd: dict, red: dict, log: str, fail_flag=None) -> dict:
    """The join of both: the logits, B1's launches and seconds in the
    forward step, the argmax and the row sums. Raises once, and deletes
    ``fail_flag``, if that file exists (phase dag_workflow (c))."""
    t0 = time.time()
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    b1 = fa.launches
    if fail_flag is not None and os.path.exists(fail_flag):
        os.unlink(fail_flag)
        _dag_log(log, "join", t0, 0, failed=True)
        raise RuntimeError("dag_workflow: the join step's injected failure")
    out = {"logits": fwd["logits"], "launches": fwd["launches"],
           "forward_s": fwd["s"], "argmax": red["argmax"],
           "row_sums": red["row_sums"]}
    _dag_log(log, "join", t0, fa.launches - b1)
    return out


def dag_graph(log: str, fail_flag=None):
    """The diamond: forward(seed) feeds reduce, and join takes both. Every
    step leases the whole card (num_gpus=1), so the dependencies run them
    one after another."""
    import chip_smoke as CS  # by reference, not as __main__
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode

    gpu = {"num_gpus": 1, "num_cpus": 0}
    fwd = rt.remote(**gpu)(CS.dag_forward_step)
    red = rt.remote(**gpu)(CS.dag_reduce_step)
    join = rt.remote(max_retries=0, **gpu)(CS.dag_join_step)
    with InputNode() as seed_in:
        f = fwd.bind(seed_in, log)
        return join.bind(f, red.bind(f, log), log, fail_flag)


def _dag_runs(log: str) -> list:
    if not os.path.exists(log):
        return []
    with open(log) as f:
        return [json.loads(line) for line in f if line.strip()]


def _spans(runs: list, t0: float) -> list:
    """[step, start, end] of each logged step run, seconds after t0."""
    return [[r["step"], r["t0"] - t0, r["t1"] - t0] for r in runs]


def _same_output(out, ref) -> bool:
    """Every tensor of a join's output bitwise equal to ``ref``'s, on the
    card, and the same launches."""
    import torch

    return all(isinstance(out.get(k), torch.Tensor)
               and out[k].device == torch.device("cuda", 0)
               and out[k].dtype == ref[k].dtype
               and torch.equal(out[k], ref[k])
               for k in ("logits", "argmax", "row_sums")) \
        and out.get("launches") == ref["launches"]


def phase_dag_workflow(seed: int):
    """.bind() graphs and durable workflows on the card (the module's
    docstring, dag_workflow). Returns B1's launches in the DAG's and the
    first workflow's forward step."""
    import pickle

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    from ray_tpu_torch.models import transformer as T

    t_phase = time.perf_counter()
    row = {"phase": "dag_workflow", "card": _nvidia_smi(),
           "config": f"llama3-1b bf16, {_TRAINER_LAYERS} layers",
           "tokens": [4, 2048]}
    # the driver's forward at the same seed and depth: what every run of
    # the graph must give back bit for bit
    cfg = _llama_bf16(n_layers=_TRAINER_LAYERS)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(seed),
                           cfg, device="cuda")
    ref = counted_forward(params, cfg, seed)
    del params
    torch.cuda.empty_cache()
    x = ref["logits"]
    ref.update(argmax=x.argmax(dim=-1), row_sums=x.float().sum(dim=-1))
    torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dag_")
    logs = {k: os.path.join(tmp, f"runs_{k}.jsonl") for k in "abc"}
    flag = os.path.join(tmp, "fail_join_once")
    got = {}
    times = {}
    try:
        rt.init(num_cpus=4, object_store_memory=_DAG_STORE_BYTES,
                log_to_driver=False)
        try:
            # (a) the graph, executed once from its input
            t0 = time.time()
            out_a = rt.get(dag_graph(logs["a"]).execute(seed), timeout=600)
            times["dag_execute_s"] = time.time() - t0
            runs_a = _dag_runs(logs["a"])
            fwd_a = [r for r in runs_a if r["step"] == "forward"]
            if fwd_a:
                times["first_step_start_s"] = fwd_a[0]["t0"] - t0
                times["first_worker_age_at_step_s"] = (
                    fwd_a[0]["t0"] - fwd_a[0]["proc_start"])
            times["dag_forward_s"] = out_a["forward_s"]
            times["dag_steps"] = _spans(runs_a, t0)
            got["a"] = {
                "logits_shape": list(out_a["logits"].shape),
                "logits_dtype": str(out_a["logits"].dtype),
                "logits_device": str(out_a["logits"].device),
                "launches": out_a["launches"],
                "bitwise_to_driver": _same_output(out_a, ref),
                "forward_runs": len(fwd_a),
                "steps": [r["step"] for r in runs_a]}

            # (b) the same graph as a durable workflow
            workflow.init(os.path.join(tmp, "wf"))
            t0 = time.time()
            out_b = workflow.run(dag_graph(logs["b"]),
                                 workflow_id="dag_workflow_b", input=seed)
            times["workflow_b_s"] = time.time() - t0
            times["workflow_b_steps"] = _spans(_dag_runs(logs["b"]), t0)
            wf_b = os.path.join(tmp, "wf", "dag_workflow_b")
            ckpts = sorted(os.listdir(os.path.join(wf_b, "steps")))
            fwd_ckpt = [c for c in ckpts
                        if c.endswith("_dag_forward_step.pkl")]
            ckpt = None
            if len(fwd_ckpt) == 1:
                with open(os.path.join(wf_b, "steps", fwd_ckpt[0]),
                          "rb") as f:
                    ckpt = pickle.load(f)
            logits_b = (ckpt or {}).get("logits")
            got["b"] = {
                "status": workflow.get_status("dag_workflow_b"),
                "launches": out_b["launches"],
                "bitwise_to_a": _same_output(out_b, out_a),
                "output_bitwise_to_a": _same_output(
                    workflow.get_output("dag_workflow_b"), out_a),
                "checkpoints": ckpts,
                "forward_checkpoint_device": (
                    str(logits_b.device) if logits_b is not None else None),
                "forward_checkpoint_bitwise": bool(
                    logits_b is not None
                    and logits_b.device == torch.device("cuda", 0)
                    and torch.equal(logits_b, out_a["logits"])),
                "forward_runs": sum(1 for r in _dag_runs(logs["b"])
                                    if r["step"] == "forward")}
            del ckpt, logits_b

            # (c) a workflow whose join fails once, then resume
            open(flag, "w").close()
            t0 = time.time()
            err = None
            try:
                workflow.run(dag_graph(logs["c"], flag),
                             workflow_id="dag_workflow_c", input=seed)
            except Exception as e:  # noqa: BLE001 — the injected failure
                err = repr(e)[:300]
            times["workflow_c_failed_run_s"] = time.time() - t0
            status_failed = workflow.get_status("dag_workflow_c")
            before = len(_dag_runs(logs["c"]))
            t0 = time.time()
            out_c = workflow.resume("dag_workflow_c")
            times["resume_s"] = time.time() - t0
            runs_c = _dag_runs(logs["c"])
            resumed = runs_c[before:]
            times["resume_steps"] = _spans(resumed, t0)
            got["c"] = {
                "error": err, "status_after_failure": status_failed,
                "status": workflow.get_status("dag_workflow_c"),
                "bitwise_to_a": _same_output(out_c, out_a),
                "forward_runs": sum(1 for r in runs_c
                                    if r["step"] == "forward"),
                "resumed_steps": [r["step"] for r in resumed],
                "resumed_b1": sum(r["b1"] for r in resumed)}
            del out_a, out_b, out_c
        finally:
            rt.shutdown()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for _ in range(100):
        left = _workers_left()
        if not left:
            break
        time.sleep(0.1)
    times["wall_s"] = time.perf_counter() - t_phase
    a, b, c = got.get("a", {}), got.get("b", {}), got.get("c", {})
    row.update(got)
    row["numbers"] = times
    row["workers_left"] = left
    checks = {
        "driver_launches": ref["launches"] == _DAG_LAUNCHES,
        "a_logits": (a.get("logits_shape") == [4, cfg.vocab_size]
                     and a.get("logits_dtype") == "torch.bfloat16"
                     and a.get("logits_device") == "cuda:0"),
        "a_bitwise_to_driver": a.get("bitwise_to_driver") is True,
        "a_launches": a.get("launches") == _DAG_LAUNCHES,
        "a_forward_ran_once": a.get("forward_runs") == 1,
        "b_successful": b.get("status") == workflow.WorkflowStatus.SUCCESSFUL,
        "b_bitwise_to_a": (b.get("bitwise_to_a") is True
                           and b.get("output_bitwise_to_a") is True),
        "b_launches": b.get("launches") == _DAG_LAUNCHES,
        "b_forward_checkpoint_on_card": (
            b.get("forward_checkpoint_bitwise") is True),
        "c_resumable": (c.get("error") is not None
                        and c.get("status_after_failure")
                        == workflow.WorkflowStatus.RESUMABLE),
        "c_forward_not_rerun": c.get("forward_runs") == 1,
        "c_resume_launches_no_b1": (c.get("resumed_steps") == ["join"]
                                    and c.get("resumed_b1") == 0),
        "c_successful": (c.get("status")
                         == workflow.WorkflowStatus.SUCCESSFUL
                         and c.get("bitwise_to_a") is True),
        "no_worker_left": not left}
    row["checks"] = checks
    row["ok"] = all(checks.values())
    _emit(row)
    if not row["ok"]:
        raise AssertionError(f"dag_workflow phase failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return a["launches"]["flash_fwd"], b["launches"]["flash_fwd"]


def phase_microbenchmark():
    """The port's core microbenchmark as its command (the module's
    docstring, microbenchmark): its JSON on a line of its own, then the
    phase's row."""
    t0 = time.perf_counter()
    row = {"phase": "microbenchmark", "card": _nvidia_smi(),
           "command": "python -m ray_tpu_torch.utils.microbenchmark --quick"}
    env = {**os.environ, "RAY_TPU_USAGE_STATS_ENABLED": "0",
           "PYTHONPATH": os.pathsep.join(
               [_ROOT] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p])}
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.utils.microbenchmark",
         "--quick"], cwd=_ROOT, capture_output=True, text=True, env=env,
        timeout=_MICROBENCH_TIMEOUT_S)
    metrics = {}
    if out.returncode == 0 and out.stdout.strip():
        metrics = json.loads(out.stdout.strip().splitlines()[-1])
        _emit(metrics)
    for _ in range(100):
        left = _workers_left()
        if not left:
            break
        time.sleep(0.1)
    row.update({"returncode": out.returncode,
                "stderr_tail": out.stderr[-2000:] if out.returncode else "",
                "missing": [m for m in _MICROBENCH_METRICS
                            if m not in metrics],
                "wall_s": time.perf_counter() - t0, "workers_left": left})
    checks = {"exit_0": out.returncode == 0,
              "every_reference_metric": not row["missing"],
              "rates_positive": all(metrics.get(m, 0) > 0
                                    for m in _MICROBENCH_METRICS),
              "no_worker_left": not left}
    row["checks"] = checks
    row["ok"] = all(checks.values())
    _emit(row)
    if not row["ok"]:
        raise AssertionError(f"microbenchmark phase failed: "
                             f"{[k for k, v in checks.items() if not v]}")


def _logits_sha256(logits) -> str:
    """SHA-256 of a bf16 tensor's bytes (copied to the host)."""
    import hashlib

    import torch

    return hashlib.sha256(logits.contiguous().view(torch.int16).cpu()
                          .numpy().tobytes()).hexdigest()


def ops_forward_task(seed: int) -> dict:
    """Phase ops_layer's num_gpus=1 task: llama3-1b in bf16 at full width
    and _TRAINER_LAYERS layers from ``seed`` on cuda:0, counted_forward at
    [4, 2048]; the logits' SHA-256 and B1's launches in this process, with
    the lease this worker sees."""
    return _forward_from_seed(seed)[0]


def _forward_from_seed(seed: int) -> tuple:
    """ops_forward_task's work -> (its dict, the params, the config)."""
    t0 = time.time()
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.models import transformer as T

    t_import = time.time()
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    t_ctx = time.time()
    cfg = _llama_bf16(n_layers=_TRAINER_LAYERS)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(seed),
                           cfg, device="cuda")
    torch.cuda.synchronize()
    t_params = time.time()
    out = counted_forward(params, cfg, seed)
    logits = out["logits"]
    return {"sha256": _logits_sha256(logits), "launches": out["launches"],
            "device": str(logits.device), "shape": list(logits.shape),
            "dtype": str(logits.dtype), "forward_s": out["s"],
            "import_s": t_import - t0, "cuda_context_s": t_ctx - t_import,
            "params_s": t_params - t_ctx,
            "gpu_ids": ray_tpu_torch.get_gpu_ids(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "proc_start": _proc_start_time(), "t0": t0,
            "t1": time.time()}, params, cfg


def ops_device_task() -> dict:
    """Phase ops_layer (e)'s num_gpus=1 task on the Spark node: what the
    worker sees of the card."""
    t0 = time.time()
    import torch

    import ray_tpu_torch

    return {"device_count": torch.cuda.device_count(),
            "device_name": torch.cuda.get_device_name(0),
            "gpu_ids": ray_tpu_torch.get_gpu_ids(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "proc_start": _proc_start_time(), "t0": t0}


_OPS_JOB = """\
import json, os, sys
sys.path.insert(0, {root!r})
import chip_smoke as CS
import ray_tpu_torch as rt
rt.init(address=os.environ["RAY_TPU_ADDRESS"], log_to_driver=False)
task = rt.remote(num_gpus=1, num_cpus=0)(CS.ops_forward_task)
out = rt.get(task.remote({seed}), timeout={timeout})
print("OPS_JOB_RESULT " + json.dumps(out), flush=True)
rt.shutdown()
"""


def _ops_left(probes=_OPS_PROBES) -> list:
    """Processes of the phase still alive (heads, agents, workers, the
    job's entrypoint), as ``pid cmdline`` lines."""
    left = []
    for probe in probes:
        out = subprocess.run(["pgrep", "-af", probe], capture_output=True,
                             text=True)
        left += [ln for ln in out.stdout.splitlines()
                 if str(os.getpid()) != ln.split()[0]]
    return left


def _ops_settle(timeout: float = 15.0, probes=_OPS_PROBES) -> list:
    t_end = time.monotonic() + timeout
    while True:
        left = _ops_left(probes)
        if not left or time.monotonic() > t_end:
            return left
        time.sleep(0.1)


def _cli(env: dict, addr_file: str, *args, timeout: float = 120):
    """``python -m ray_tpu_torch --address-file <addr_file> *args``:
    (returncode, stdout, stderr, seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "--address-file",
         addr_file, *args], cwd=_ROOT, env=env, capture_output=True,
        text=True, timeout=timeout)
    return out.returncode, out.stdout, out.stderr, \
        time.perf_counter() - t0


def _http_json(url: str, timeout: float = 30):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _ops_task_row(out: dict, sha: str) -> dict:
    return {"sha256_equal": out["sha256"] == sha,
            "launches": out["launches"], "device": out["device"],
            "shape": out["shape"], "dtype": out["dtype"],
            "gpu_ids": out["gpu_ids"],
            "cuda_visible_devices": out["cuda_visible_devices"],
            "import_s": out["import_s"],
            "cuda_context_s": out["cuda_context_s"],
            "params_s": out["params_s"], "forward_s": out["forward_s"],
            "worker_age_at_task_s": out["t0"] - out["proc_start"],
            "task_s": out["t1"] - out["t0"]}


def _ops_cli_and_jobs(seed: int, sha: str, cards: int, env: dict,
                      tmp: str, times: dict) -> dict:
    """Phase ops_layer (a)-(c): the CLI head, two jobs, the dashboard,
    doctor and stop."""
    import urllib.request

    import ray_tpu_torch as rt
    from ray_tpu_torch.dashboard import DOCTOR_ENDPOINTS, start_dashboard
    from ray_tpu_torch.jobs import JobSubmissionClient

    got = {}
    addr_file = os.path.join(tmp, "address")
    t_a = time.perf_counter()
    head_log = open(os.path.join(tmp, "head.log"), "wb")
    head = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "--address-file", addr_file,
         "start", "--head", "--num-cpus", "2"], cwd=_ROOT, env=env,
        stdout=head_log, stderr=subprocess.STDOUT, start_new_session=True)
    try:
        t_end = time.monotonic() + 120
        while not os.path.exists(addr_file):
            if head.poll() is not None or time.monotonic() > t_end:
                raise RuntimeError("the CLI head did not start: " + open(
                    os.path.join(tmp, "head.log")).read()[-2000:])
            time.sleep(0.05)
        times["cli_head_start_s"] = time.perf_counter() - t_a
        with open(addr_file) as f:
            address = json.load(f)["address"]
        rc, out, err, secs = _cli(env, addr_file, "status")
        times["cli_status_s"] = secs
        gpu = [ln.split(":", 1)[1].split("/") for ln in out.splitlines()
               if ln.strip().startswith("GPU:")]
        got["a"] = {"status_rc": rc, "status_gpu_line": [
            float(x) for x in gpu[0]] if gpu else None,
            "nvidia_smi_cards": cards,
            "status_tail": out[-600:] if rc == 0 else err[-1200:]}
        rc, out, err, secs = _cli(env, addr_file, "list", "nodes")
        times["cli_list_s"] = secs
        rows = json.loads(out) if rc == 0 else []
        got["a"]["list_rc"] = rc
        got["a"]["list_nodes_gpu"] = [
            (r["node_idx"], r["resources_total"].get("GPU")) for r in rows]
        times["a_s"] = time.perf_counter() - t_a

        # (b) two jobs through the client in a driver attached to the head
        t_b = time.perf_counter()
        script = os.path.join(tmp, "ops_layer_job.py")
        with open(script, "w") as f:
            f.write(_OPS_JOB.format(root=_ROOT, seed=seed,
                                    timeout=_OPS_TIMEOUT_S))
        rt.init(address=address, log_to_driver=False)
        try:
            client = JobSubmissionClient()
            t0 = time.perf_counter()
            jid = client.submit_job(
                entrypoint=f"{sys.executable} {script}",
                submission_id="ops_layer_forward")
            t_end = time.monotonic() + _OPS_TIMEOUT_S
            while client.get_job_status(jid) in ("PENDING", "RUNNING"):
                if time.monotonic() > t_end:
                    break
                time.sleep(0.1)
            times["job_submit_to_result_s"] = time.perf_counter() - t0
            status = client.get_job_status(jid)
            logs = client.get_job_logs(jid)
            result = [ln for ln in logs.splitlines()
                      if ln.startswith("OPS_JOB_RESULT ")]
            job = json.loads(result[-1].split(" ", 1)[1]) if result else {}
            rc, cli_logs, err, secs = _cli(env, addr_file, "job", "logs",
                                           jid)
            times["cli_job_logs_s"] = secs
            got["b"] = {"status": status,
                        "logs_tail": logs[-1500:] if not job else "",
                        "cli_logs_rc": rc,
                        "cli_logs_same_result": bool(result) and
                        result[-1] in cli_logs.splitlines()}
            if job:
                got["b"].update(_ops_task_row(job, sha))
                times["job_task_worker_age_s"] = \
                    got["b"]["worker_age_at_task_s"]
            # the second job, stopped through the CLI
            sid = client.submit_job(entrypoint="sleep 600",
                                    submission_id="ops_layer_sleep")
            pgid = None
            t_end = time.monotonic() + 30
            while pgid is None and time.monotonic() < t_end:
                ps = subprocess.run(["pgrep", "-x", "sleep"],
                                    capture_output=True, text=True)
                for pid in ps.stdout.split():
                    try:
                        with open(f"/proc/{pid}/cmdline") as f:
                            cmd = f.read().split("\0")
                        if cmd[:2] == ["sleep", "600"]:
                            pgid = os.getpgid(int(pid))
                    except (OSError, ProcessLookupError):
                        pass
                time.sleep(0.05)
            def group():
                """The live processes of the sleep job's group."""
                if pgid is None:
                    return []
                return subprocess.run(["pgrep", "-g", str(pgid)],
                                      capture_output=True,
                                      text=True).stdout.split()

            before = group()
            rc, out, err, secs = _cli(env, addr_file, "job", "stop", sid)
            times["cli_job_stop_s"] = secs
            t_end = time.monotonic() + 15
            while group() and time.monotonic() < t_end:
                time.sleep(0.05)
            got["b"]["sleep_job"] = {
                "stop_rc": rc, "stop_out": out.strip(),
                "status": client.get_job_status(sid), "pgid": pgid,
                "group_before": len(before), "group_after": group()}
            times["b_s"] = time.perf_counter() - t_b

            # (c) the dashboard in this attached driver
            t_c = time.perf_counter()
            dash = start_dashboard(port=0)
            try:
                t_end = time.monotonic() + 30
                while True:
                    _, cl = _http_json(dash.url + "/api/cluster")
                    total = cl["resources_total"].get("GPU")
                    avail = cl["resources_available"].get("GPU")
                    if avail == total or time.monotonic() > t_end:
                        break
                    time.sleep(0.2)
                _, jobs = _http_json(dash.url + "/api/jobs")
                with urllib.request.urlopen(dash.url + "/",
                                            timeout=30) as r:
                    index = r.read().decode()
                bad = []
                for ep in DOCTOR_ENDPOINTS:
                    try:
                        with urllib.request.urlopen(dash.url + ep,
                                                    timeout=60) as r:
                            if r.status != 200 or not r.read():
                                bad.append((ep, r.status))
                    except Exception as e:  # noqa: BLE001 — recorded
                        bad.append((ep, repr(e)[:200]))
            finally:
                dash.stop()
            got["c"] = {
                "gpu_total": total, "gpu_available": avail,
                "jobs": sorted((j["job_id"], j["status"]) for j in jobs),
                "ui_gpu_tile": "GPU avail / total" in index,
                "endpoints": len(DOCTOR_ENDPOINTS), "bad_endpoints": bad}
        finally:
            rt.shutdown()
        rc, out, err, secs = _cli(env, addr_file, "doctor")
        times["cli_doctor_s"] = secs
        got["c"]["doctor_rc"] = rc
        got["c"]["doctor_summary"] = [ln for ln in out.splitlines()
                                      if ln.startswith("doctor:")]
        if rc:
            got["c"]["doctor_err"] = (out + err)[-1500:]
        t0 = time.perf_counter()
        rc, out, err, secs = _cli(env, addr_file, "stop")
        try:
            head.wait(timeout=60)
        except subprocess.TimeoutExpired:
            pass
        times["cli_stop_s"] = time.perf_counter() - t0
        got["c"].update(stop_rc=rc, head_exit=head.poll())
        got["c"]["left"] = _ops_settle()
        times["c_s"] = time.perf_counter() - t_c
    finally:
        if head.poll() is None:
            os.killpg(head.pid, 9)
            head.wait(timeout=30)
        head_log.close()
    return got


def _ops_pool(seed: int, sha: str, times: dict) -> dict:
    """Phase ops_layer (d): a GPU-less in-process head whose autoscaler
    grows a fake GKE GPU pool for a num_gpus=1 task and shrinks it back."""
    import chip_smoke as CS  # by reference, not as __main__
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import (Autoscaler, AutoscalingPolicy,
                                          BatchingNodeProvider,
                                          FakeGkeGpuCloud)

    t_d = time.perf_counter()
    info = rt.init(num_cpus=1, num_gpus=0, log_to_driver=False,
                   object_store_memory=_DAG_STORE_BYTES,
                   _system_config={"idle_worker_keep_alive_s": 1.0})
    cloud = sc = None
    try:
        head = info.head
        addr = head.enable_tcp(host="127.0.0.1", advertise_ip="127.0.0.1")
        cloud = FakeGkeGpuCloud(addr, num_gpus_per_node=1,
                                num_cpus_per_node=1,
                                accelerator=_OPS_POOL_ACCELERATOR)
        sc = Autoscaler(head, BatchingNodeProvider(cloud), AutoscalingPolicy(
            max_workers=1, idle_timeout_s=1.5, update_interval_s=0.2))
        sc.start()
        t0 = time.perf_counter()
        ref = rt.remote(num_gpus=1, num_cpus=0)(CS.ops_forward_task).remote(
            seed)
        registered = None
        t_end = time.monotonic() + _OPS_TIMEOUT_S
        while not rt.wait([ref], timeout=0.05)[0]:
            if registered is None and any(
                    n["labels"].get("accelerator") == _OPS_POOL_ACCELERATOR
                    for n in rt.nodes()):
                registered = time.perf_counter() - t0
            if time.monotonic() > t_end:
                break
        out = rt.get(ref, timeout=60)
        t_res = time.perf_counter()
        times["pool_submit_to_result_s"] = t_res - t0
        times["pool_scale_up_s"] = registered
        pool = [n for n in rt.nodes()
                if n["labels"].get("accelerator") == _OPS_POOL_ACCELERATOR]
        got = {"pool_nodes": [(n["node_idx"], n["resources_total"].get(
            "GPU"), n["labels"].get("ray_tpu_autoscaler_id"))
            for n in pool]}
        got.update(_ops_task_row(out, sha))
        times["pool_task_worker_age_s"] = got["worker_age_at_task_s"]
        t_end = time.monotonic() + 60
        while cloud.list_nodes() and time.monotonic() < t_end:
            time.sleep(0.1)
        times["pool_scale_down_s"] = time.perf_counter() - t_res
        got["pool_after"] = cloud.list_nodes()
        got["scale_requests"] = [(r.desired_num_workers,
                                  list(r.workers_to_delete))
                                 for r in cloud.scale_requests]
        got["launches_terminations"] = [sc.num_launches,
                                        sc.num_terminations]
    finally:
        if sc is not None:
            sc.stop()
        if cloud is not None:
            cloud.shutdown()
        rt.shutdown()
    got["left"] = _ops_settle()
    times["d_s"] = time.perf_counter() - t_d
    return got


def _ops_spark(smi_name: str, times: dict) -> dict:
    """Phase ops_layer (e): a Spark-shim node started through the CLI's
    ``start --address`` that declares the card."""
    import chip_smoke as CS  # by reference, not as __main__
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.api import NodeAffinitySchedulingStrategy
    from ray_tpu_torch.utils import spark

    t_e = time.perf_counter()
    rt.init(num_cpus=1, num_gpus=0, log_to_driver=False,
            object_store_memory=_DAG_STORE_BYTES)
    try:
        t0 = time.perf_counter()
        spark.setup_ray_cluster(num_worker_nodes=1, num_cpus_per_node=1,
                                num_gpus_per_node=1,
                                launcher=spark.subprocess_launcher,
                                timeout_s=120)
        times["spark_setup_s"] = time.perf_counter() - t0
        try:
            nodes = [n for n in rt.state.list_nodes() if n["is_remote"]]
            got = {"nodes": [(n["node_idx"],
                              n["resources_total"].get("GPU"))
                             for n in nodes]}
            task = rt.remote(num_gpus=1, num_cpus=0)(CS.ops_device_task)
            t0 = time.perf_counter()
            out = rt.get(task.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    nodes[0]["node_idx"])).remote(), timeout=_OPS_TIMEOUT_S)
            times["spark_task_s"] = time.perf_counter() - t0
            times["spark_task_worker_age_s"] = out["t0"] - out["proc_start"]
            got.update({k: out[k] for k in (
                "device_count", "device_name", "gpu_ids",
                "cuda_visible_devices")})
            got["device_name_equal"] = out["device_name"] == smi_name
        finally:
            spark.shutdown_ray_cluster()
    finally:
        rt.shutdown()
    got["left"] = _ops_settle()
    times["e_s"] = time.perf_counter() - t_e
    return got


def phase_ops_layer(seed: int):
    """The port's ops layer on the card (the module's docstring,
    ops_layer). Returns B1's launches in the job's task and in the GPU
    pool node's task."""
    import torch

    from ray_tpu_torch.models import transformer as T

    t_phase = time.perf_counter()
    smi = _nvidia_smi()
    row = {"phase": "ops_layer", "card": smi,
           "config": f"llama3-1b bf16, {_TRAINER_LAYERS} layers",
           "tokens": [4, 2048], "budget_s": _OPS_BUDGET_S}
    cards = _smi_cards()
    # the driver's forward at the same seed and depth: what the job's and
    # the pool node's forwards must give back bit for bit
    cfg = _llama_bf16(n_layers=_TRAINER_LAYERS)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(seed),
                           cfg, device="cuda")
    ref = counted_forward(params, cfg, seed)
    del params
    torch.cuda.empty_cache()
    sha = _logits_sha256(ref["logits"])
    row["driver"] = {"launches": ref["launches"],
                     "device": str(ref["logits"].device)}
    times = {}
    env = {**os.environ, "RAY_TPU_USAGE_STATS_ENABLED": "0",
           "PYTHONPATH": os.pathsep.join(
               [_ROOT] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p])}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ops_")
    saved = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = env["PYTHONPATH"]  # spark's agents
    got = {}
    try:
        got.update(_ops_cli_and_jobs(seed, sha, cards, env, tmp, times))
        got["d"] = _ops_pool(seed, sha, times)
        got["e"] = _ops_spark(smi.split(",")[0].strip(), times)
    finally:
        if saved is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = saved
        shutil.rmtree(tmp, ignore_errors=True)
    left = _ops_settle()
    times["wall_s"] = time.perf_counter() - t_phase
    row.update(got)
    row["numbers"] = times
    row["left"] = left
    a, b, c, d, e = (got.get(k, {}) for k in "abcde")
    sleep_job = b.get("sleep_job", {})
    pool_ids = [p[2] for p in d.get("pool_nodes", [])]
    gpu_task = {"device": "cuda:0", "shape": [4, cfg.vocab_size],
                "dtype": "torch.bfloat16", "gpu_ids": [0],
                "cuda_visible_devices": "0", "launches": _OPS_LAUNCHES,
                "sha256_equal": True}
    checks = {
        "driver_launches": ref["launches"] == _OPS_LAUNCHES,
        "a_status_gpu": (a.get("status_rc") == 0 and cards == 1
                         and a.get("status_gpu_line") == [cards, cards]),
        "a_list_nodes_gpu": (a.get("list_rc") == 0
                             and a.get("list_nodes_gpu") == [(0, cards)]),
        "b_succeeded": b.get("status") == "SUCCEEDED",
        "b_forward": all(b.get(k) == v for k, v in gpu_task.items()),
        "b_cli_logs": (b.get("cli_logs_rc") == 0
                       and b.get("cli_logs_same_result") is True),
        "b_sleep_stopped": (sleep_job.get("stop_rc") == 0
                            and sleep_job.get("stop_out") == "True"
                            and sleep_job.get("status") == "STOPPED"
                            and sleep_job.get("group_before", 0) >= 1
                            and sleep_job.get("group_after") == []),
        "c_cluster_gpu": (c.get("gpu_total") == cards
                          and c.get("gpu_available") == cards),
        "c_jobs": c.get("jobs") == [("ops_layer_forward", "SUCCEEDED"),
                                    ("ops_layer_sleep", "STOPPED")],
        "c_ui": c.get("ui_gpu_tile") is True,
        "c_endpoints": (c.get("endpoints", 0) > 0
                        and c.get("bad_endpoints") == []),
        "c_doctor": c.get("doctor_rc") == 0,
        "c_stop": c.get("stop_rc") == 0 and c.get("head_exit") is not None,
        "c_no_process_left": c.get("left") == [],
        "d_pool_node": (len(pool_ids) == 1
                        and d["pool_nodes"][0][1] == 1.0),
        "d_forward": all(d.get(k) == v for k, v in gpu_task.items()),
        "d_scaled_to_zero": (d.get("pool_after") == [] and pool_ids
                             and [r for r in d.get("scale_requests", [])
                                  if r[1]] == [(0, pool_ids)]),
        "d_no_process_left": d.get("left") == [],
        "e_node_gpu": (len(e.get("nodes", [])) == 1
                       and e["nodes"][0][1] == 1.0),
        "e_sees_card": (e.get("device_count") == 1
                        and e.get("device_name_equal") is True
                        and e.get("gpu_ids") == [0]),
        "e_no_process_left": e.get("left") == [],
        "no_process_left": not left}
    row["checks"] = checks
    row["ok"] = all(checks.values())
    _emit(row)
    if not row["ok"]:
        raise AssertionError(f"ops_layer phase failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return b["launches"]["flash_fwd"], d["launches"]["flash_fwd"]


class ClientsActor:
    """Phase clients' num_gpus=1 actor, created by descriptor from C++
    (``task_client ... actor-create chip_smoke:ClientsActor``). The gateway
    replies in JSON, so its methods return plain values only."""

    def forward(self, seed: int) -> dict:
        """ops_forward_task's forward; the params stay for
        forward_from_store."""
        out, self.params, self.cfg = _forward_from_seed(seed)
        self.seed = seed
        return out

    def forward_from_store(self, oid_hex: str) -> dict:
        """The same forward on tokens a native process put into this node's
        arena (decimal text, a row a line, read with get_raw); puts the
        rows' last-position argmax as text under a fresh id (put_raw)."""
        import torch

        from ray_tpu_torch.core.context import get_context
        from ray_tpu_torch.core.ids import ObjectID

        t0 = time.time()
        store = get_context().store
        text = store.get_raw(ObjectID(bytes.fromhex(oid_hex)))
        if text is None:
            raise KeyError(f"no object {oid_hex} in this node's arena")
        tokens = torch.tensor([[int(t) for t in row.split()]
                               for row in text.decode().splitlines()],
                              dtype=torch.int32, device="cuda")
        t_read = time.time()
        out = counted_forward(self.params, self.cfg, self.seed, tokens)
        put = ObjectID(os.urandom(20))
        store.put_raw(put, " ".join(
            str(i) for i in out["logits"].argmax(-1).tolist()).encode())
        return {"sha256": _logits_sha256(out["logits"]),
                "launches": out["launches"],
                "device": str(out["logits"].device),
                "tokens": list(tokens.shape), "text_bytes": len(text),
                "read_s": t_read - t0, "forward_s": out["s"],
                "argmax_oid": put.hex(), "s": time.time() - t0}


def clients_cpu_task(a: int, b: int) -> list:
    """Phase clients (e)'s CPU task by descriptor: [a + b, this pid]."""
    return [a + b, os.getpid()]


def _gateway_call(addr: str, req: dict) -> dict:
    """One request to the head's cross-language gateway, framed as the C++
    and Java clients frame it: an 8-byte little-endian length and a pickled
    (XLANG_CALL, 1, json) tuple out; frames back until a raw one (the
    length's top bit set), whose JSON is the reply."""
    import pickle
    import socket
    import struct

    from ray_tpu_torch.core import protocol as P

    host, port = addr.removeprefix("tcp:").rsplit(":", 1)
    body = pickle.dumps((P.XLANG_CALL, 1, json.dumps(req).encode()),
                        protocol=3)
    with socket.create_connection((host, int(port)), timeout=60) as sock:
        sock.sendall(struct.pack("<Q", len(body)) + body)
        f = sock.makefile("rb")
        while True:
            (n,) = struct.unpack("<Q", f.read(8))
            data = f.read(n & ~(1 << 63))
            if n >> 63:
                return json.loads(data)


def _client(*args, timeout: float = _CLIENTS_TIMEOUT_S) -> dict:
    """One native client run: its exit code, stdout, stderr and seconds."""
    t0 = time.perf_counter()
    out = subprocess.run(list(args), capture_output=True, text=True,
                         timeout=timeout)
    return {"rc": out.returncode, "out": out.stdout.strip(),
            "err": out.stderr.strip()[-2000:],
            "s": time.perf_counter() - t0}


def _json_or_none(text: str):
    try:
        return json.loads(text)
    except ValueError:
        return None


def _clients_forward_ok(got: dict, sha: str) -> bool:
    """What every forward reply of the clients phase must hold: logits
    bitwise the driver's, B1's launches, and the card."""
    return (got.get("sha256") == sha
            and got.get("launches") == _OPS_LAUNCHES
            and got.get("device") == "cuda:0")


def _clients_forward_row(got, sha: str, cfg) -> dict:
    """What (c)'s and (f)'s forward reply must hold, and the actor's split."""
    got = got or {}
    return {"sha256_equal": got.get("sha256") == sha,
            "launches": got.get("launches"), "device": got.get("device"),
            "shape": got.get("shape"), "dtype": got.get("dtype"),
            "gpu_ids": got.get("gpu_ids"),
            "ok": (_clients_forward_ok(got, sha)
                   and got.get("shape") == [4, cfg.vocab_size]
                   and got.get("dtype") == "torch.bfloat16"
                   and got.get("gpu_ids") == [0])}


def phase_clients(seed: int):
    """The port's C++ and Java clients on the card (the module's
    docstring, clients). Returns B1's launches in the C++-created actor's
    forward and in its forward on tokens from the arena."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.native import build as NB

    t_phase = time.perf_counter()
    row = {"phase": "clients", "card": _nvidia_smi(),
           "config": f"llama3-1b bf16, {_TRAINER_LAYERS} layers",
           "tokens": [4, 2048], "budget_s": _CLIENTS_BUDGET_S}
    cards = _smi_cards()
    walls, checks = {}, {}
    # the driver's forward at the same seed and depth
    cfg = _llama_bf16(n_layers=_TRAINER_LAYERS)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(seed),
                           cfg, device="cuda")
    ref = counted_forward(params, cfg, seed)
    tokens = forward_tokens(cfg, seed).tolist()
    del params
    torch.cuda.empty_cache()
    sha = _logits_sha256(ref["logits"])
    argmax = ref["logits"].argmax(-1).tolist()
    checks["driver_launches"] = ref["launches"] == _OPS_LAUNCHES
    walls["driver_forward_s"] = time.perf_counter() - t_phase

    # (a) the binaries, from this checkout's sources; a build error fails
    t0 = time.perf_counter()
    bins = {}
    for name in ("task_client", "client_example"):
        t = time.perf_counter()
        bins[name] = NB.build_binary(name)
        walls[f"a_build_{name}_s"] = time.perf_counter() - t
    walls["a_s"] = time.perf_counter() - t0
    row["binaries"] = {n: os.path.relpath(p, _ROOT) for n, p in bins.items()}
    tc, ce = bins["task_client"], bins["client_example"]

    t0 = time.perf_counter()
    info = ray_tpu_torch.init(num_gpus=cards)
    got = {}
    try:
        # (b) the head and its gateway
        addr = info.head.enable_tcp("127.0.0.1")
        unix = f"unix:{info.head.session_dir}/head.sock"
        store = ray_tpu_torch.nodes()[0]["store_name"]
        cluster = _gateway_call(addr, {"op": "cluster"})
        got["b_cluster"] = cluster
        checks["b_cluster_gpu"] = (
            cluster.get("status") == "ok" and cards >= 1
            and cluster["result"]["resources"].get("GPU") == cards)
        walls["b_s"] = time.perf_counter() - t0

        # (c) a num_gpus=1 actor created and called from C++
        t0 = time.perf_counter()
        opts = {"name": _CLIENTS_ACTOR, "num_gpus": 1, "num_cpus": 0}
        c_create = _client(tc, addr, "actor-create",
                           "chip_smoke:ClientsActor", "[]", json.dumps(opts))
        c_call = _client(tc, addr, "actor-call", _CLIENTS_ACTOR, "forward",
                         json.dumps([seed]))
        c = _json_or_none(c_call["out"])
        walls["c_s"] = time.perf_counter() - t0
        got["c"] = {"create": c_create, "call_rc": c_call["rc"],
                    "call_err": c_call["err"], "call_s": c_call["s"],
                    **_clients_forward_row(c, sha, cfg)}
        if c:
            got["c"]["actor_split"] = {
                k: c[k] for k in ("import_s", "cuda_context_s", "params_s",
                                  "forward_s")}
            got["c"]["worker_age_at_call_s"] = c["t0"] - c["proc_start"]
        checks["c_create"] = (c_create["rc"] == 0 and _json_or_none(
            c_create["out"]) == {"actor": _CLIENTS_ACTOR})
        checks["c_forward"] = c_call["rc"] == 0 and got["c"]["ok"]

        # (d) tokens in through the arena from C++, the argmax back out
        t0 = time.perf_counter()
        text = "\n".join(" ".join(str(t) for t in r) for r in tokens)
        oid = os.urandom(20).hex()
        d_put = _client(ce, store, "put", oid, text)
        d_call = _client(tc, addr, "actor-call", _CLIENTS_ACTOR,
                         "forward_from_store", json.dumps([oid]))
        d = _json_or_none(d_call["out"]) or {}
        d_get = (_client(ce, store, "get", d["argmax_oid"])
                 if "argmax_oid" in d else {"rc": None, "out": ""})
        back = d_get["out"].split(": ", 1)[-1].split()
        walls["d_s"] = time.perf_counter() - t0
        got["d"] = {"text_bytes": len(text), "put": d_put,
                    "call_rc": d_call["rc"], "call_err": d_call["err"],
                    "call_s": d_call["s"],
                    "sha256_equal": d.get("sha256") == sha,
                    "launches": d.get("launches"),
                    "device": d.get("device"), "tokens": d.get("tokens"),
                    "read_s": d.get("read_s"),
                    "forward_s": d.get("forward_s"),
                    "get": {k: d_get.get(k) for k in ("rc", "s")},
                    "argmax": back, "driver_argmax": argmax}
        checks["d_put"] = (d_put["rc"] == 0
                           and f"({len(text)} bytes)" in d_put["out"])
        checks["d_forward"] = (d_call["rc"] == 0
                               and _clients_forward_ok(d, sha)
                               and d.get("tokens") == [4, 2048])
        checks["d_argmax"] = (d_get["rc"] == 0
                              and back == [str(i) for i in argmax])

        # (e) a CPU task over the unix socket, a missing function
        t0 = time.perf_counter()
        e_task = _client(tc, unix, "chip_smoke:clients_cpu_task", "[2, 3]")
        e_missing = _client(tc, unix, "chip_smoke:no_such_function")
        walls["e_task_s"] = time.perf_counter() - t0
        task_out = _json_or_none(e_task["out"])
        got["e"] = {"task": e_task, "missing": e_missing}
        checks["e_task"] = (e_task["rc"] == 0 and isinstance(task_out, list)
                            and task_out[0] == 5
                            and task_out[1] != os.getpid())
        checks["e_missing"] = (e_missing["rc"] == 1
                               and "error" in e_missing["err"].lower())

        # (f) the Java client, where there is a JDK; before (e)'s kill
        t0 = time.perf_counter()
        if shutil.which("javac") and shutil.which("java"):
            classes = NB.build_java()
            f_call = _client("java", "-cp", classes, "RayTpuClient", addr,
                             "actor-call", _CLIENTS_ACTOR, "forward",
                             json.dumps([seed]))
            reply = _json_or_none(f_call["out"]) or {}
            f_row = _clients_forward_row(reply.get("result"), sha, cfg)
            got["f"] = {"rc": f_call["rc"], "err": f_call["err"], **f_row}
            checks["f_java"] = f_call["rc"] == 0 and f_row["ok"]
        else:
            got["f"] = {"java": "no JDK"}
            _emit({"java": "no JDK"})
        walls["f_s"] = time.perf_counter() - t0

        # (e) the actor killed from C++; a call after it fails
        t0 = time.perf_counter()
        e_kill = _client(tc, addr, "actor-kill", _CLIENTS_ACTOR)
        e_after = _client(tc, addr, "actor-call", _CLIENTS_ACTOR, "forward",
                          json.dumps([seed]))
        walls["e_kill_s"] = time.perf_counter() - t0
        got["e"].update(kill=e_kill, after_kill=e_after)
        checks["e_kill"] = e_kill["rc"] == 0 and e_after["rc"] == 1
    finally:
        # (g)
        t0 = time.perf_counter()
        ray_tpu_torch.shutdown()
        left = _ops_settle(probes=_CLIENTS_PROBES)
        walls["g_s"] = time.perf_counter() - t0
    got["left"] = left
    checks["g_no_process_left"] = not left
    walls["wall_s"] = time.perf_counter() - t_phase
    checks["within_budget"] = walls["wall_s"] <= _CLIENTS_BUDGET_S
    row.update(got)
    row["numbers"] = walls
    row["checks"] = checks
    row["ok"] = all(checks.values())
    _emit(row)
    if not row["ok"]:
        raise AssertionError(f"clients phase failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return got["c"]["launches"]["flash_fwd"], got["d"]["launches"]["flash_fwd"]


class LlamaStage:
    """One pipeline stage of the llama3-1b train cell, the ``fn`` of a
    ``PipelineStage``: the embedding (first stage), ``n_layers`` decoder
    layers without remat, the final norm and the tied LM head in fp32
    (last stage), from the port's model pieces. The tied embedding is two
    stage params: the first stage's ``embed`` and the last stage's
    ``head``. Referenced as ``chip_smoke.LlamaStage``, so it pickles by
    reference."""

    def __init__(self, cfg, first: bool, last: bool, n_layers: int):
        self.cfg = dataclasses.replace(cfg, n_layers=n_layers, remat=False)
        self.first, self.last = first, last

    def __call__(self, p, x):
        import torch

        from ray_tpu_torch.models import transformer as T

        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = self.cfg
        if self.first:
            x = T.embed_tokens({"embed": p["embed"]}, x, cfg)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = T._layers([p["layers"]], x, cfg, positions)
        if self.last:
            x = T.lm_head({"embed": p["head"],
                           "final_norm": p["final_norm"]}, x, cfg)
        return x


def stage_loss(logits, targets):
    """Phase train's loss on a microbatch: the mean next-token cross
    entropy, logsumexp minus the gold logit (the port's loss_fn)."""
    import torch

    t = targets.to(logits.device).long()
    gold = torch.gather(logits, -1, t[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


def llama_stages(PL, params, cfg, n_stages: int) -> list:
    """The decoder's params split into ``n_stages`` PipelineStages of
    LlamaStage, each stage's leaves its own copies (the first stage the
    table, the last the head and final norm)."""
    import chip_smoke as CS  # by reference, not as __main__

    per = cfg.n_layers // n_stages
    stages = []
    for k in range(n_stages):
        p = {"layers": {n: w[k * per:(k + 1) * per].clone()
                        for n, w in params["layers"].items()}}
        if k == 0:
            p["embed"] = params["embed"].clone()
        if k == n_stages - 1:
            p["head"] = params["embed"].clone()
            p["final_norm"] = params["final_norm"].clone()
        stages.append(PL.PipelineStage(
            fn=CS.LlamaStage(cfg, k == 0, k == n_stages - 1, per),
            params=p))
    return stages


def abs_grad_sum(PL, stages, mbs, tgts) -> list:
    """sum_i |g_i| per element (fp32), g_i each microbatch's grads alone by
    single_program_reference, as [stage][leaf]: the scale of the 2 x 2 run's
    bound."""
    absum = None
    for x, t in zip(mbs, tgts):
        _, gi = PL.single_program_reference(stages, stage_loss, [x], [t])
        a = [[g.float().abs() for g in PL._tree_leaves(s)] for s in gi]
        absum = a if absum is None else [
            [u + v for u, v in zip(su, sv)] for su, sv in zip(absum, a)]
        del gi, a
    return absum


def dp_over_bound(PL, grads, ref_grads, absum, M: int):
    """(elements of the data-parallel grads further from the oracle's than
    _TPIPE_DP_BOUND * sum_i|g_i| / M, the largest error over its bound)."""
    over, worst = 0, 0.0
    for g, r, a in zip(grads, ref_grads, absum):
        for x, y, s in zip(PL._tree_leaves(g), PL._tree_leaves(r), a):
            d = (x.float() - y.float().to(x.device)).abs()
            bound = _TPIPE_DP_BOUND * s.to(x.device) / M
            over += int((d > bound).sum().item())
            worst = max(worst, (d / bound.clamp(min=1e-30)).max().item())
    return over, worst


def _phase_rows(state, prefix: str, funcs, want: int) -> dict:
    """Each ``{prefix}{func}``'s phase rows (count, mean_ms, p50/p95 of
    sched_wait, dispatch, arg_fetch, exec, ...), polled until every one
    has ``want`` completed execs (the stage workers flush their events on
    their own cadence)."""
    names = [prefix + f for f in funcs]
    t_end = time.monotonic() + 30
    while True:
        rows = state.phase_summary(names)
        if all(rows.get(n, {}).get("exec", {}).get("count", 0) >= want
               for n in names) or time.monotonic() > t_end:
            return {f: rows.get(prefix + f, {}) for f in funcs}
        time.sleep(0.5)


@contextlib.contextmanager
def _card_memory():
    """The card's most used bytes over all its processes while the block
    runs (torch.cuda.mem_get_info every 0.1 s), in a one-item list."""
    import torch

    used, stop = [0], threading.Event()

    def sample():
        while not stop.is_set():
            free, total = torch.cuda.mem_get_info()
            used[0] = max(used[0], total - free)
            stop.wait(0.1)

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        yield used
    finally:
        stop.set()
        th.join()


def _arenas(state) -> dict:
    """Each node's object-store arena, GiB: used now, the high-water mark
    and the capacity (the nodes' last heartbeats)."""
    out = {}
    for idx, n in state.memory_summary().get("nodes", {}).items():
        a = n.get("arena", {})
        out[idx] = [round(a.get(k, 0) / 2**30, 3) for k in (
            "used_bytes", "highwater_bytes", "capacity")]
    return out


def _mean_ms(row: dict, phase: str):
    return row.get(phase, {}).get("mean_ms")


def _bitwise_tree(xs, refs) -> bool:
    import torch

    return all(torch.equal(x, r) for x, r in zip(xs, refs))


def _tpipe_dp_run(PL, params, cfg, mbs, tgts, checks: dict) -> dict:
    """Phase train_pipeline's 2 stages x 2 replicas (half the cell's
    layers a stage, 1F1B, each replica two of the four microbatches) on
    the cluster's four logical nodes: the replicas' bf16 CUDA grads sum
    through ray_tpu_torch.collective (the chunked ring on the object
    plane). Adds its checks to ``checks``; returns its row."""
    import torch

    import chip_smoke as CS  # by reference, not as __main__
    import ray_tpu_torch as rt
    from ray_tpu_torch import state
    from ray_tpu_torch.core.context import get_context

    M = len(mbs)
    stages = llama_stages(PL, params, cfg, 2)
    t0 = time.perf_counter()
    dp = PL.Pipeline(stages, loss_fn=CS.stage_loss, schedule="1f1b",
                     replicas_per_stage=2, placement="auto",
                     name_prefix="dp_")
    probes = dp.probe()
    start_s = time.perf_counter() - t0
    del stages
    dp.reset()
    ctx = get_context()
    promoted0 = len(ctx._inline_promoted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = dp.run_batch(mbs, tgts)
    wall = time.perf_counter() - t0
    launches = [p["kernel_launches"] for p in dp.probe()]
    promoted = len(ctx._inline_promoted) - promoted0
    grads = dp.grads()
    others = rt.get([dp.actors[k * 2 + 1].grads.remote(True)
                     for k in range(2)], timeout=600)
    rows = _phase_rows(state, "dp_", [
        f"stage{k}r{r}.{op}" for k in range(2) for r in range(2)
        for op in ("fwd", "bwd")], M // 2)
    ar = _phase_rows(state, "dp_", [
        f"stage{k}r{r}.allreduce" for k in range(2) for r in range(2)], 1)
    allreduces = dp.grad_allreduces
    dp.shutdown()
    del dp
    # the oracle and the bound's scale once the four actors have left the
    # card (they share it with this process)
    torch.cuda.empty_cache()
    stages = llama_stages(PL, params, cfg, 2)
    ref_loss, ref = PL.single_program_reference(stages, CS.stage_loss, mbs,
                                                tgts)
    absum = abs_grad_sum(PL, stages, mbs, tgts)
    del stages
    over, worst = dp_over_bound(PL, grads, ref, absum, M)
    d = {"stages": 2, "replicas_per_stage": 2, "bound": _TPIPE_DP_BOUND,
         "stage_actors_start_s": start_s,
         "leases": [(p["node_idx"], p["gpu_ids"], p["cuda_devices"])
                    for p in probes],
         "batch_wall_s": wall, "loss": out["loss"],
         "loss_rel": abs(out["loss"] - ref_loss) / abs(ref_loss),
         "grad_rel": [_tree_rel(PL._tree_leaves(g), PL._tree_leaves(r))
                      for g, r in zip(grads, ref)],
         "elements_over_bound": over, "worst_err_over_bound": worst,
         "replicas_bitwise": all(_bitwise_tree(
             PL._tree_leaves(g), PL._tree_leaves(h))
             for g, h in zip(grads, others)),
         "launches": launches, "inline_promoted": promoted,
         "allreduce_s": {f: (_mean_ms(r, "exec") or 0) / 1e3
                         for f, r in ar.items()},
         "stage_ms": {f: {ph: _mean_ms(r, ph) for ph in (
             "exec", "sched_wait", "arg_fetch")} for f, r in rows.items()},
         "grad_allreduces": allreduces}
    del grads, others, absum, ref
    torch.cuda.empty_cache()
    checks["dp_one_replica_per_node"] = len(
        {p[0] for p in d["leases"]}) == 4
    checks["dp_leases"] = all(p[1] == [0] and p[2] == 1
                              for p in d["leases"])
    checks["dp_loss"] = d["loss_rel"] <= _TPIPE_REL_TOL
    checks["dp_grads_in_bound"] = over == 0
    checks["dp_replicas_bitwise"] = d["replicas_bitwise"]
    # 8 layers x 2 microbatches in each replica: 16 each, as 4 x 4
    checks["dp_launches"] = launches == [_TPIPE_LAUNCHES] * 4
    checks["dp_by_ref"] = promoted == 0
    checks["dp_synced_once"] = d["grad_allreduces"] == 1
    return d


def phase_train_pipeline(fa, T, TR, C, seed: int):
    """The train cell as an MPMD pipeline of stage actors (the module's
    docstring, train_pipeline). Returns the launches of one batch summed
    over the four stage actors."""
    import torch

    import chip_smoke as CS  # by reference, not as __main__
    import ray_tpu_torch as rt
    from ray_tpu_torch import state
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.config import get_config
    from ray_tpu_torch.core.context import get_context
    from ray_tpu_torch.train import pipeline as PL

    cfg = train_config(C, n_layers=_TPIPE_DEPTH)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(seed),
                           _llama_bf16(n_layers=_TPIPE_DEPTH), device="cuda")
    batch = train_batch(cfg, seed + 3)
    M = _TPIPE_MICRO
    mbs = [batch["inputs"][i:i + 1] for i in range(M)]
    tgts = [batch["targets"][i:i + 1] for i in range(M)]
    row = {"phase": "train_pipeline", "card": _nvidia_smi(),
           "config": "llama3-1b", "n_layers": _TPIPE_DEPTH,
           "stages": _TPIPE_STAGES,
           "layers_per_stage": _TPIPE_LAYERS, "microbatches": M,
           "microbatch": [1, 2048], "dtype": "bfloat16",
           "remat_in_stage": False, "rel_tol": _TPIPE_REL_TOL,
           "elastic_checkpoints": False}

    # the cell's tied gradient: the whole batch through loss_fn (remat)
    names = _leaf_names(params)
    loss_whole, grads = _grads(T, TR, params, batch, cfg)
    tied = grads[names.index("embed")].float().cpu()  # off the card
    del grads
    torch.cuda.empty_cache()

    # the oracle on the card, with the same stage functions
    stages = llama_stages(PL, params, cfg, _TPIPE_STAGES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_loss, ref_grads = PL.single_program_reference(
        stages, CS.stage_loss, mbs, tgts)
    torch.cuda.synchronize()
    row["oracle_s"] = time.perf_counter() - t0
    # a stage folds each microbatch's grads as its backward runs: GPipe's
    # run in reverse, so its oracle folds the microbatches in reverse
    _, rev_grads = PL.single_program_reference(
        stages, CS.stage_loss, mbs[::-1], tgts[::-1])
    torch.cuda.empty_cache()
    row["oracle_loss"] = ref_loss
    row["whole_batch_loss"] = loss_whole.item()
    oracles = {"1f1b": ref_grads, "gpipe": rev_grads}
    del ref_grads, rev_grads  # each leaves the card after its schedule

    # a GPU-less head and logical nodes of one GPU each: every stage
    # leases the card as GPU 0
    cluster = Cluster(head_node_args={
        "num_cpus": 4, "num_gpus": 0,
        "object_store_memory": _TPIPE_HEAD_STORE, "log_to_driver": False,
        "_system_config": {"pipeline_checkpoint_every_waves": 0}})
    ctx = get_context()
    checks = {}
    try:
        for _ in range(_TPIPE_STAGES):
            cluster.add_node(num_cpus=2, num_gpus=1,
                             object_store_memory=_TPIPE_NODE_STORE)
        t0 = time.perf_counter()
        pipe = PL.Pipeline(stages, loss_fn=CS.stage_loss, placement="auto")
        probes = pipe.probe()
        row["stage_actors_start_s"] = time.perf_counter() - t0
        row["stage_leases"] = [{k: p[k] for k in (
            "stage", "node_idx", "gpu_ids", "device", "cuda_devices")}
            for p in probes]
        checks["one_stage_per_node"] = len(
            {p["node_idx"] for p in probes}) == _TPIPE_STAGES
        checks["stage_leases"] = all(
            p["gpu_ids"] == [0] and p["cuda_devices"] == 1
            and p["device"] == "cuda" for p in probes)
        del stages
        runs = {}
        for sched in ("gpipe", "1f1b"):
            pipe.schedule, pipe.name_prefix = sched, f"{sched}_"
            oracle = oracles.pop(sched)
            ref_leaves = [PL._tree_leaves(g) for g in oracle]
            pipe.reset()  # grads and the stages' launch counters to 0
            promoted0 = len(ctx._inline_promoted)
            torch.cuda.synchronize()
            with _card_memory() as used:
                t0 = time.perf_counter()
                out = pipe.run_batch(mbs, tgts)
                wall = time.perf_counter() - t0
            launches = [p["kernel_launches"] for p in pipe.probe()]
            promoted = len(ctx._inline_promoted) - promoted0
            t0 = time.perf_counter()
            grads = pipe.grads()
            fetch_s = time.perf_counter() - t0
            leaves = [PL._tree_leaves(g) for g in grads]
            embed = (grads[0]["embed"].float()
                     + grads[-1]["head"].float())
            rows = _phase_rows(state, f"{sched}_", [
                f"stage{k}.{op}" for k in range(_TPIPE_STAGES)
                for op in ("fwd", "bwd")], M)
            run = {
                "batch_wall_s": wall, "grads_fetch_s": fetch_s,
                "card_used_gib_max": used[0] / 2**30,
                "loss": out["loss"],
                "loss_rel": abs(out["loss"] - ref_loss) / abs(ref_loss),
                "loss_bitwise": out["loss"] == ref_loss,
                "grad_rel": [_tree_rel(g, r)
                             for g, r in zip(leaves, ref_leaves)],
                "grad_bitwise": [_bitwise_tree(g, r)
                                 for g, r in zip(leaves, ref_leaves)],
                "embed_copies_rel": {
                    "table": _tree_rel([grads[0]["embed"]],
                                       [oracle[0]["embed"]]),
                    "head": _tree_rel([grads[-1]["head"]],
                                      [oracle[-1]["head"]])},
                "embed_sum_rel_to_whole_batch": _tree_rel(
                    [embed], [tied.to(embed.device)]),
                "launches": launches,
                "inline_promoted": promoted,
                "stage_ms": {f: {ph: _mean_ms(r, ph) for ph in (
                    "exec", "sched_wait", "arg_fetch")}
                    for f, r in rows.items()}}
            del grads, leaves, embed, oracle, ref_leaves
            torch.cuda.empty_cache()
            runs[sched] = run
            checks[f"{sched}_loss"] = run["loss_rel"] <= _TPIPE_REL_TOL
            checks[f"{sched}_grads"] = all(
                r <= _TPIPE_REL_TOL for r in run["grad_rel"]) and all(
                r <= _TPIPE_REL_TOL
                for r in run["embed_copies_rel"].values())
            checks[f"{sched}_launches"] = launches == [
                _TPIPE_LAUNCHES] * _TPIPE_STAGES
            # no activation or cotangent passed through the driver: each
            # hop was a ref to the producing stage's arena
            checks[f"{sched}_by_ref"] = promoted == 0
        row["runs"] = runs
        row["activation_bytes"] = 2048 * cfg.d_model * 2
        row["max_inline_object_size"] = get_config().max_inline_object_size
        checks["activation_in_arena"] = (row["activation_bytes"]
                                         > row["max_inline_object_size"])
        pipe.shutdown()
        del pipe, oracles
        torch.cuda.empty_cache()
        row["dp"] = _tpipe_dp_run(PL, params, cfg, mbs, tgts, checks)
        del params
    except Exception:
        # what failed where, before the cluster and its task table go
        _emit({"phase": "train_pipeline.failed_tasks", "tasks": [
            {"name": r["name"], "node_idx": r["node_idx"],
             "error": (r["error"] or "")[-2000:]}
            for r in state.list_tasks(
                filters=[("state", "=", "FAILED")], limit=100)],
            "arenas_used_highwater_capacity_gib": _arenas(state)})
        raise
    finally:
        cluster.shutdown()
    for _ in range(100):
        left = _workers_left()
        if not left:
            break
        time.sleep(0.1)
    row["workers_left"] = left
    checks["no_worker_left"] = not left
    torch.cuda.empty_cache()
    row["checks"] = checks
    row["ok"] = all(checks.values())
    _emit(row)
    if not row["ok"]:
        raise AssertionError(f"train_pipeline phase failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return {k: sum(c[k] for c in runs["gpipe"]["launches"])
            for k in _TPIPE_LAUNCHES}


# ---- phase rllib -----------------------------------------------------------

def rllib_learner(name: str, obs_dim: int, num_actions: int, hiddens,
                  seed: int, device):
    """One of the five learners at its algorithm's default settings."""
    from ray_tpu_torch import rllib

    kw = dict(hiddens=hiddens, seed=seed, device=device)
    if name == "ppo":
        return rllib.PPOLearner(obs_dim, num_actions, **kw)
    if name == "impala":
        return rllib.ImpalaLearner(obs_dim, num_actions, **kw)
    if name == "appo":
        return rllib.APPOLearner(obs_dim, num_actions, **kw)
    if name == "a2c":
        c = rllib.A2CConfig()
        return rllib.A2CLearner(obs_dim, num_actions, lr=c.lr,
                                vf_coeff=c.vf_coeff,
                                entropy_coeff=c.entropy_coeff,
                                grad_clip=c.grad_clip, **kw)
    c = rllib.DQNConfig()
    return rllib.DQNLearner(obs_dim, num_actions, lr=c.lr, gamma=c.gamma,
                            double_q=c.double_q, **kw)


def rllib_batch(name: str, obs_dim: int, num_actions: int, seed: int,
                rows: int = _RL_PPO_BATCH, T: int = _RL_T, N: int = _RL_N):
    """A fixed batch for ``name``'s learner, made by numpy from ``seed``:
    ``rows`` rows (PPO, A2C), [T, N] time-major (IMPALA, APPO), or DQN's
    replay batch (its config's train_batch_size, with PER weights)."""
    import numpy as np

    from ray_tpu_torch.rllib import DQNConfig, SampleBatch

    rng = np.random.default_rng(seed)
    logp = lambda shape: (np.log(1.0 / num_actions)  # noqa: E731
                          + 0.3 * rng.normal(size=shape)).astype(np.float32)
    f32 = lambda shape: rng.normal(size=shape).astype(np.float32)  # noqa
    if name in ("ppo", "a2c"):
        return SampleBatch({"obs": f32((rows, obs_dim)),
                            "actions": rng.integers(0, num_actions, rows),
                            "action_logp": logp(rows),
                            "advantages": f32(rows),
                            "value_targets": f32(rows)})
    if name in ("impala", "appo"):
        return SampleBatch({"obs": f32((T, N, obs_dim)),
                            "actions": rng.integers(0, num_actions, (T, N)),
                            "rewards": f32((T, N)),
                            "dones": rng.random((T, N)) < 0.02,
                            "action_logp": logp((T, N)),
                            "bootstrap_obs": f32((N, obs_dim))})
    B = DQNConfig().train_batch_size
    return SampleBatch({"obs": f32((B, obs_dim)),
                        "actions": rng.integers(0, num_actions, B),
                        "rewards": f32(B), "dones": rng.random(B) < 0.05,
                        "new_obs": f32((B, obs_dim)),
                        "weights": rng.uniform(0.2, 1.0, B).astype(
                            np.float32)})


def _rl_one_step(name: str, learner, batch, seed: int) -> dict:
    """One Adam step through the learner's own update()."""
    if name == "ppo":
        return learner.update(batch, num_epochs=1,
                              minibatch_size=batch.count, seed=seed)
    return learner.update(batch)


def _rl_rel(got, ref) -> float:
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref),
                                                 1e-30))


def adam_first_step_bound(grads_a, grads_b, lr: float, clip) -> dict:
    """Per element, how far two first Adam steps from the same params may
    end apart given each side's gradients: _RL_ADAM_ABS for the arithmetic,
    plus lr |f(g_a) - f(g_b)| with f(g) = g / (|g| + eps), the first step's
    direction once the bias corrections make mu_hat = g and sqrt(nu_hat) =
    |g|, each side's grads clipped by its own global norm. Where |g| is near
    eps, f turns the grads' reduction-order noise into up to 2 lr (at
    bench_rllib.py's width an element of 1.25e-8, 2e-6 of its leaf's
    largest, moved 1.25e-6 between two CPU thread counts); elsewhere the
    second term vanishes."""
    import numpy as np

    def direction(grads):
        norm = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                             for g in grads.values()))
        scale = 1.0 if clip is None or norm < clip else clip / norm
        return {k: scale * g / (np.abs(scale * g) + _ADAM_EPS)
                for k, g in grads.items()}

    fa, fb = direction(grads_a), direction(grads_b)
    return {k: _RL_ADAM_ABS + lr * np.abs(fa[k] - fb[k]) for k in fa}


def rllib_parity(name: str, obs_dim: int, num_actions: int, hiddens,
                 seed: int) -> dict:
    """``name``'s learner on the card against the same learner on the CPU:
    the same params (the CPU learner's, with the policy head scaled by 100
    so the policy is far from uniform: near it, a policy loss over
    normalized advantages cancels to ~1e-4 of its terms and its relative
    error measures the cancellation) and the same batch. Loss metrics
    within _RL_REL_TOL relative, each grad leaf within _RL_REL_TOL as
    |d|/|g|, the params after one Adam step within adam_first_step_bound
    of each other. -> a row with the largest error beside each bar and
    "ok"."""
    import numpy as np

    cpu = rllib_learner(name, obs_dim, num_actions, hiddens, seed, "cpu")
    card = rllib_learner(name, obs_dim, num_actions, hiddens, seed, "cuda")
    w = cpu.get_weights()
    w["w_pi"] = w["w_pi"] * 100.0
    cpu.set_weights(w)
    card.set_weights(w)
    batch = rllib_batch(name, obs_dim, num_actions, seed + 1)
    g_cpu, m_cpu = cpu.compute_grads(batch)
    g_card, m_card = card.compute_grads(batch)
    grad_rel = {k: _rl_rel(g_card[k], g_cpu[k]) for k in g_cpu}
    metric_rel = {k: _rl_rel(m_card[k], m_cpu[k]) for k in m_cpu}
    out_cpu = _rl_one_step(name, cpu, batch, seed)
    out_card = _rl_one_step(name, card, batch, seed)
    metric_rel.update({f"update_{k}": _rl_rel(out_card[k], out_cpu[k])
                       for k in out_cpu})
    lr = cpu.tx.learning_rate
    bound = adam_first_step_bound(g_card, g_cpu, lr, cpu.tx.grad_clip)
    new_cpu, new_card = cpu.get_weights(), card.get_weights()
    p_abs = over_bound = 0.0
    amplified, amplified_g = 0, 0.0
    for k in new_cpu:
        d = np.abs(new_card[k].astype(np.float64) - new_cpu[k])
        p_abs = max(p_abs, float(d.max()))
        over_bound = max(over_bound, float((d / bound[k]).max()))
        big = d > _RL_ADAM_ABS
        amplified += int(big.sum())
        amplified_g = max(amplified_g, float(
            np.abs(g_cpu[k][big]).max(initial=0.0)))
    row = {"learner": name, "rows": int(np.prod(batch["actions"].shape)),
           "metric_max_rel": max(metric_rel.values()),
           "metric_bar": _RL_REL_TOL, "metric_rel": metric_rel,
           "grad_max_rel": max(grad_rel.values()), "grad_bar": _RL_REL_TOL,
           "param_max_abs": p_abs, "param_abs_bar": _RL_ADAM_ABS,
           "param_max_share_of_bound": over_bound,
           "param_elements_past_abs_bar": amplified,
           "their_largest_abs_g": amplified_g, "adam_eps": _ADAM_EPS}
    row["ok"] = (row["metric_max_rel"] <= _RL_REL_TOL
                 and row["grad_max_rel"] <= _RL_REL_TOL and over_bound <= 1)
    return row


def _rl_sync_ms(fn, iters: int) -> float:
    """Host ms per call of fn(), each ending in a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def rllib_throughput(obs_dim: int, num_actions: int, seed: int) -> dict:
    """(b): each learner's ms per update on the card and the env-steps it
    consumes a second; one PPO update under the profiler; the V-trace
    loop's share of an IMPALA update."""
    import torch

    from ray_tpu_torch.rllib import vtrace

    out = {}
    for name in _RL_LEARNERS:
        lrn = rllib_learner(name, obs_dim, num_actions, _RL_HIDDENS, seed,
                            "cuda")
        batch = rllib_batch(name, obs_dim, num_actions, seed + 2)
        kw = (dict(num_epochs=_RL_PPO_EPOCHS,
                   minibatch_size=_RL_PPO_MINIBATCH, seed=seed)
              if name == "ppo" else {})
        ms = _rl_sync_ms(lambda: lrn.update(batch, **kw), 5)
        rows = int(batch["actions"].size)
        out[name] = {"rows": rows, "ms_per_update": ms,
                     "env_steps_per_s": rows / (ms / 1e3)}
        if name == "ppo":
            steps = _RL_PPO_EPOCHS * (rows // _RL_PPO_MINIBATCH)
            prof = _step_profile(lambda: lrn.update(batch, **kw))
            n = prof["device_launches"]
            prof["adam_steps"] = steps
            prof["launches_per_minibatch_step"] = (
                n / steps if isinstance(n, int) else n)
            # the profiler slows the host many fold: the share of an
            # unprofiled update's wall that the device is busy
            dev_ms = prof["device_ms"]
            prof["device_busy_share_of_update"] = (
                dev_ms / ms if isinstance(dev_ms, float) else dev_ms)
            out["ppo_profile"] = prof
        if name == "impala":
            dev = lrn._batch(batch)
            with torch.no_grad():
                from ray_tpu_torch.rllib.models import forward
                logits, values = forward(
                    lrn.params, dev["obs"].reshape(_RL_T * _RL_N, -1))
                _, boot = forward(lrn.params, dev["bootstrap_obs"])
            tlogp = torch.log_softmax(logits, -1).reshape(
                _RL_T, _RL_N, -1).gather(
                    -1, dev["actions"][..., None]).squeeze(-1)
            vals = values.reshape(_RL_T, _RL_N)
            v_ms = _rl_sync_ms(lambda: vtrace(
                dev["action_logp"], tlogp, dev["rewards"], dev["dones"],
                vals, boot, lrn.gamma), 20)
            out["vtrace"] = {"ms": v_ms, "T": _RL_T, "N": _RL_N,
                             "share_of_impala_update": v_ms / ms}
        del lrn
    torch.cuda.empty_cache()
    return out


def rllib_group_check(obs_dim: int, num_actions: int, hiddens, seed: int,
                      rows: int) -> dict:
    """(c): a LearnerGroup of 2 PPO learner actors on a cluster whose head
    has no GPU and whose two logical nodes declare one each (both lease the
    card as GPU 0). Each actor sees GPU 0 alone; its grads on its shard
    equal the driver's learner's on the same shard bit for bit (the same
    kernels on the same inputs); after the averaged update the local and
    remote weights are equal bit for bit."""
    import functools

    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.rllib import LearnerGroup, PPOLearner

    cluster = Cluster(head_node_args={"num_cpus": 2, "num_gpus": 0,
                                      "log_to_driver": False})
    row, checks = {}, {}
    group = None
    try:
        for _ in range(2):
            cluster.add_node(num_cpus=1, num_gpus=1)
        make = functools.partial(PPOLearner, obs_dim, num_actions,
                                 hiddens=hiddens, seed=seed)
        t0 = time.perf_counter()
        group = LearnerGroup(make, num_learners=2)
        row["learner_actors_start_s"] = time.perf_counter() - t0
        where = rt.get([r.where.remote() for r in group.remotes],
                       timeout=120)
        row["where"] = where
        checks["gpu0_alone"] = all(
            w["gpu_ids"] == [0] and w["cuda_visible_devices"] == "0"
            and w["device_count"] == 1 and w["device"] == "cuda"
            for w in where)
        batch = rllib_batch("ppo", obs_dim, num_actions, seed + 3, rows=rows)
        half = rows // 2
        shards = [batch.slice(0, half), batch.slice(half, rows)]
        remote = rt.get([r.compute_grads.remote(s)
                         for r, s in zip(group.remotes, shards)],
                        timeout=120)
        local = [group.local.compute_grads(s) for s in shards]
        checks["shard_grads_bitwise"] = all(
            all(np.array_equal(gr[k], gl[k]) for k in gl) and mr == ml
            for (gr, mr), (gl, ml) in zip(remote, local))
        row["shard_grads_max_abs"] = max(
            float(np.abs(gr[k] - gl[k]).max())
            for (gr, _), (gl, _) in zip(remote, local) for k in gl)
        t0 = time.perf_counter()
        group.update(batch)
        row["group_update_s"] = time.perf_counter() - t0
        w = group.get_weights()
        checks["weights_bitwise"] = all(
            all(np.array_equal(rw[k], w[k]) for k in w)
            for rw in rt.get([r.get_weights.remote()
                              for r in group.remotes], timeout=120))
    finally:
        for r in group.remotes if group is not None else ():
            rt.kill(r)
        cluster.shutdown()
    row["checks"] = checks
    row["ok"] = bool(checks) and all(checks.values())
    return row


def _rl_weights_equal(algo) -> bool:
    """Each rollout worker's weights equal the learner's bit for bit."""
    import numpy as np

    import ray_tpu_torch as rt

    w = algo.get_policy_weights()
    return all(all(np.array_equal(ww[k], w[k]) for k in w)
               for ww in rt.get([x.get_weights.remote()
                                 for x in algo.workers], timeout=120))


def rllib_end_to_end(seed: int) -> dict:
    """(d) and (e) on the runtime the caller started."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.rllib import PPO, PPOConfig

    row, checks = {}, {}
    # (d1) PPO on CartPole-v1 at tests/test_rllib.py:133-140's settings
    t0 = time.perf_counter()
    algo = PPOConfig().environment("CartPole-v1").rollouts(
        num_rollout_workers=2, num_envs_per_worker=4,
        rollout_fragment_length=64,
    ).training(
        lr=1e-3, train_batch_size=512, num_sgd_iter=8,
        sgd_minibatch_size=128, entropy_coeff=0.003, grad_clip=10.0,
    ).debugging(seed=seed).build()
    row["cartpole_build_s"] = time.perf_counter() - t0
    best, iters, timers = 0.0, 0, []
    t0 = time.perf_counter()
    try:
        for iters in range(1, _RL_CARTPOLE_ITERS + 1):
            result = algo.train()
            timers.append(result["timers"])
            best = max(best, result.get("episode_reward_mean", 0.0))
            if best >= 150.0:
                break
        row["cartpole"] = {
            "best_episode_reward_mean": best, "iterations": iters,
            "train_s": time.perf_counter() - t0,
            "learner_device": result["learner_device"],
            "mean_timers_ms": {k: sum(t[k] for t in timers) / len(timers)
                               for k in timers[0]}}
        checks["cartpole_reaches_130"] = best >= _RL_CARTPOLE_BAR
        checks["cartpole_learner_on_card"] = (result["learner_device"]
                                              == "cuda")
        checks["cartpole_weights_synced"] = _rl_weights_equal(algo)
    finally:
        algo.stop()
    # (d2) PPO on Breakout-Mini-v0 at bench_rllib.py:182-187's settings
    t0 = time.perf_counter()
    algo = PPOConfig().environment("Breakout-Mini-v0").rollouts(
        num_rollout_workers=2, num_envs_per_worker=8,
        rollout_fragment_length=64,
    ).training(model_hiddens=_RL_HIDDENS).debugging(seed=seed).build()
    row["breakout_build_s"] = time.perf_counter() - t0
    try:
        its = []
        for _ in range(_RL_BREAKOUT_ITERS):
            r = algo.train()
            its.append({"env_steps_per_sec": r["env_steps_per_sec"],
                        "env_steps": r["env_steps_this_iter"],
                        **r["timers"]})
        row["breakout"] = its
        checks["breakout_weights_synced"] = _rl_weights_equal(algo)
    finally:
        algo.stop()
    # (e) Tune: two PPO trials, each leasing the card for its learner
    base = PPOConfig().rollouts(num_rollout_workers=1,
                                num_envs_per_worker=2,
                                rollout_fragment_length=32)
    t0 = time.perf_counter()
    results = tune.Tuner(
        PPO, param_space={"__algo_config__": base,
                          "lr": tune.grid_search([1e-4, 3e-4])},
        tune_config=tune.TuneConfig(
            metric="episode_reward_mean", mode="max",
            resources_per_trial={"CPU": 1, "GPU": 1}),
        run_config=tune.RunConfig(stop={"training_iteration": 2}),
    ).fit()
    row["tune_s"] = time.perf_counter() - t0
    trials = [{"lr": r.config["lr"],
               "iterations": r.metrics.get("training_iteration"),
               "learner_device": r.metrics.get("learner_device"),
               "gpu_ids": r.metrics.get("gpu_ids"),
               "error": str(r.error) if r.error else None}
              for r in results]
    row["tune"] = trials
    checks["tune_both_trials_report_on_gpu0"] = (
        len(trials) == 2 and {t["lr"] for t in trials} == {1e-4, 3e-4}
        and all(t["iterations"] == 2 and t["learner_device"] == "cuda"
                and t["gpu_ids"] == [0] and t["error"] is None
                for t in trials))
    row["checks"] = checks
    return row


def phase_rllib(seed: int):
    """The port's RLlib on the card (the module's docstring, rllib)."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import BreakoutMini

    obs_dim, num_actions = BreakoutMini.observation_dim, \
        BreakoutMini.num_actions
    row = {"phase": "rllib", "card": _nvidia_smi(),
           "cell": {"env": "Breakout-Mini-v0", "obs_dim": obs_dim,
                    "num_actions": num_actions, "hiddens": _RL_HIDDENS,
                    "ppo_batch": _RL_PPO_BATCH,
                    "ppo_minibatch": _RL_PPO_MINIBATCH,
                    "ppo_epochs": _RL_PPO_EPOCHS, "T": _RL_T, "N": _RL_N,
                    "dtype": "float32", "tf32": False}}
    checks = {}
    t0 = time.perf_counter()
    row["parity"] = [rllib_parity(n, obs_dim, num_actions, _RL_HIDDENS,
                                  seed) for n in _RL_LEARNERS]
    row["parity_s"] = time.perf_counter() - t0
    for p in row["parity"]:
        checks[f"parity_{p['learner']}"] = p["ok"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    row["throughput"] = rllib_throughput(obs_dim, num_actions, seed)
    row["throughput_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    row["group"] = rllib_group_check(obs_dim, num_actions, _RL_HIDDENS,
                                     seed, _RL_PPO_BATCH)
    row["group_s"] = time.perf_counter() - t0
    checks.update({f"group_{k}": v
                   for k, v in row["group"]["checks"].items()})
    checks["group_ran"] = bool(row["group"]["checks"])
    t0 = time.perf_counter()
    rt.init(num_cpus=8)
    try:
        e2e = rllib_end_to_end(seed)
    finally:
        rt.shutdown()
    row["end_to_end_s"] = time.perf_counter() - t0
    checks.update(e2e.pop("checks"))
    row["end_to_end"] = e2e
    for _ in range(100):
        left = _workers_left()
        if not left:
            break
        time.sleep(0.1)
    row["workers_left"] = left
    checks["no_worker_left"] = not left
    row["checks"] = checks
    row["ok"] = all(checks.values())
    _emit(row)
    if not row["ok"]:
        raise AssertionError(f"rllib phase failed: "
                             f"{[k for k, v in checks.items() if not v]}")


def _rl2_flat(tree, prefix: str = "") -> dict:
    """{"a/b": numpy leaf} of a nested dict of tensors or arrays."""
    import numpy as np

    if not isinstance(tree, dict):
        if hasattr(tree, "detach"):
            tree = tree.detach().cpu().numpy()
        return {prefix or "leaf": np.array(tree, np.float64)}
    out = {}
    for k, v in tree.items():
        out.update(_rl2_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


def _rl2_tree_rel(got, ref) -> float:
    """The largest leaf's |d| / |g| over two trees of one structure."""
    g, r = _rl2_flat(got), _rl2_flat(ref)
    return max(_rl_rel(g[k], r[k]) for k in r)


def rllib2_learner(name: str, cell: dict, seed: int, device, tmp: str):
    """``name``'s learner at its algorithm's defaults and ``cell``'s
    widths on ``device``; the offline learners are their algorithms, built
    on a small dataset written under ``tmp``."""
    from ray_tpu_torch import rllib

    hid = cell["hiddens"]
    if name == "sac":
        c = rllib.SACConfig()
        return rllib.SACLearner(
            3, 1, actor_lr=c.lr, critic_lr=c.critic_lr, alpha_lr=c.alpha_lr,
            gamma=c.gamma, tau=c.tau, action_scale=2.0,
            initial_alpha=c.initial_alpha, target_entropy=-1.0,
            hiddens=hid, seed=seed, device=device)
    if name in ("td3", "ddpg"):
        c = rllib.TD3Config() if name == "td3" else rllib.DDPGConfig()
        return rllib.TD3Learner(
            3, 1, actor_lr=c.lr, critic_lr=c.critic_lr, gamma=c.gamma,
            tau=c.tau, action_scale=2.0, action_shift=0.0, twin_q=c.twin_q,
            target_noise=c.target_noise,
            target_noise_clip=c.target_noise_clip, hiddens=hid, seed=seed,
            device=device)
    if name == "r2d2":
        c = rllib.R2D2Config()
        return rllib.R2D2Learner(cell["obs"], cell["acts"], lr=c.lr,
                                 gamma=c.gamma, burn_in=_RL2_BURN_IN,
                                 hidden=cell["r2d2_hidden"], seed=seed,
                                 device=device)
    if name in ("bc", "cql", "marwil"):
        import os

        path = os.path.join(tmp, "dataset")
        if not os.path.isdir(path):
            rllib.save_batches(path, [rllib2_batch("bc", cell, seed + 7)])
        cfg = {"bc": rllib.BCConfig, "cql": rllib.CQLConfig,
               "marwil": rllib.MARWILConfig}[name]()
        return (cfg.environment(cell["offline_env"])
                .offline_data(input_path=path)
                .training(model_hiddens=hid).resources(device=device)
                .debugging(seed=seed).build())
    if name == "dreamer":
        from ray_tpu_torch.rllib.dreamer import DreamerLearner

        return DreamerLearner(cell["obs"], cell["acts"], deter=cell["deter"],
                              hidden=cell["dreamer_hidden"], seed=seed,
                              device=device)
    c = rllib.AlphaZeroConfig()
    return rllib.AlphaZeroLearner(18, 9, hiddens=cell["az_hiddens"],
                                  lr=c.lr, seed=seed, device=device)


def rllib2_batch(name: str, cell: dict, seed: int):
    """A fixed batch for ``name``'s learner, made by numpy from ``seed``."""
    import numpy as np

    from ray_tpu_torch.rllib import SampleBatch, make_env

    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    if name in ("sac", "td3", "ddpg"):
        B = cell["cont_batch"]
        return SampleBatch({"obs": f32(B, 3),
                            "actions": rng.uniform(-2, 2, (B, 1)).astype(
                                np.float32),
                            "rewards": f32(B), "dones": rng.random(B) < 0.05,
                            "new_obs": f32(B, 3)})
    if name == "r2d2":
        S, T = cell["seqs"], _RL2_BURN_IN + _RL2_SEQ_LEN
        return {"obs": f32(S, T, cell["obs"]),
                "actions": rng.integers(0, cell["acts"], (S, T)),
                "rewards": f32(S, T), "dones": rng.random((S, T)) < 0.02,
                "reset": rng.random((S, T)) < 0.03,
                "h0": 0.5 * f32(S, cell["r2d2_hidden"])}
    if name in ("bc", "cql", "marwil"):
        env = make_env(cell["offline_env"])
        B, D = cell["offline_batch"], env.observation_dim
        return SampleBatch({"obs": f32(B, D),
                            "actions": rng.integers(0, env.num_actions, B),
                            "rewards": f32(B), "dones": rng.random(B) < 0.05,
                            "new_obs": f32(B, D)})
    if name == "dreamer":
        B, L = cell["B"], cell["L"]
        return (f32(B, L, cell["obs"]),
                rng.integers(0, cell["acts"], (B, L)), f32(B, L),
                (rng.random((B, L)) > 0.02).astype(np.float32))
    n = cell["az_batch"]
    return (f32(n, 18), rng.dirichlet(np.ones(9), size=n).astype(np.float32),
            rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32))


def rllib2_noise(name: str, cell: dict, seed: int):
    """The draws one update of ``name`` takes, on the CPU from ``seed``:
    standard normals for SAC's two actions and TD3's target smoothing,
    Gumbel noise for Dreamer's categoricals; None for the others."""
    import torch

    from ray_tpu_torch.rllib.models import gumbel

    gen = torch.Generator().manual_seed(seed)
    if name == "sac":
        B = cell["cont_batch"]
        return [torch.randn((B, 1), generator=gen) for _ in range(2)]
    if name in ("td3", "ddpg"):
        return [torch.randn((cell["cont_batch"], 1), generator=gen)]
    if name == "dreamer":
        B, L, G, C, H = cell["B"], cell["L"], 8, 8, 15
        return [gumbel((L, B, G, C), gen), gumbel((H, B * L, cell["acts"]),
                                                  gen),
                gumbel((H, B * L, G, C), gen)]
    return None


def _rl2_state(name: str, ln) -> dict:
    """A numpy snapshot of everything one update changes."""
    from ray_tpu_torch.rllib.models import to_numpy

    if name in ("sac", "td3", "ddpg"):
        return to_numpy(ln.state)
    if name == "r2d2":
        return {"params": to_numpy(ln.params)}
    if name in ("bc", "cql", "marwil"):
        out = {"params": to_numpy(ln.params)}
        if name == "marwil":
            out["ma_adv_sq"] = to_numpy(ln.ma_adv_sq)
        return out
    if name == "dreamer":
        return to_numpy({k: ln._state[k] for k in ("wm", "ac", "target",
                                                   "ret_scale")})
    return {"params": to_numpy(ln._state[0])}


def _rl2_step(name: str, ln, batch, noise) -> tuple:
    """One update of ``ln`` on numpy ``batch`` with the CPU ``noise`` ->
    (metrics as floats, {stage: grads}, extra): extra holds Dreamer's
    posterior starts, which its second stage imagines from."""
    import torch

    from ray_tpu_torch.rllib import sac as SAC

    dev = ln.device
    nz = [x.to(dev) for x in noise] if noise is not None else None
    extra = {}
    if name == "sac":
        m, g = ln.train_step(SAC.to_batch(batch, dev), *nz)
        grads = {"critic": g["critic"], "actor": g["actor"],
                 "alpha": g["alpha"]}
    elif name in ("td3", "ddpg"):
        b = SAC.to_batch(batch, dev)
        closs, cg = ln.critic_step(b, nz[0])
        aloss, ag = ln.actor_step(b)
        m, grads = {"critic_loss": closs, "actor_loss": aloss}, {
            "critic": cg, "actor": ag}
    elif name == "r2d2":
        loss, g = ln.train_step(ln._batch(batch))
        m, grads = {"loss": loss}, {"params": g}
    elif name in ("bc", "cql", "marwil"):
        m, g = ln.train_step(ln.to_device(batch))
        grads = {"params": g}
    elif name == "dreamer":
        b = ln.to_device(*batch)
        F = torch.nn.functional
        taken = F.one_hot(b[1], ln.num_actions).to(torch.float32)
        act = torch.cat([torch.zeros_like(taken[:, :1]), taken[:, :-1]], 1)
        with torch.no_grad():
            hs, ss, _, _ = ln.observe(ln._state["wm"], b[0], act, nz[0])
        extra = {"h0": hs.reshape(-1, ln.deter),
                 "s0": ss.reshape(-1, ln.stoch)}
        m, g = ln.train_step(*b, {"post": nz[0], "act": nz[1],
                                  "img": nz[2]})
        grads = {"wm": g["wm"], "ac": g["ac"]}
    else:
        m, g = ln.train_step(*(torch.as_tensor(x, device=dev)
                               for x in batch))
        grads = {"params": g}
    return ({k: float(v) for k, v in m.items()}, grads, extra)


def _rl2_second_stage(name: str, cpu, s0: dict, s1: dict, extra: dict,
                      batch, noise) -> tuple:
    """The CPU learner's second-stage loss at the inputs the card's second
    stage saw (the card's state after its first stage, its posterior
    starts) -> (metrics, {stage: grads}); empty for one-stage learners."""
    import torch

    from ray_tpu_torch.rllib import sac as SAC
    from ray_tpu_torch.rllib.learner import value_and_grad
    from ray_tpu_torch.rllib.models import params_from_numpy as P

    if name == "sac":
        alpha = torch.exp(P(s0["log_alpha"], "cpu"))
        loss, logp, g = value_and_grad(
            SAC.actor_loss, P(s0["actor"], "cpu"), P(s1["q1"], "cpu"),
            P(s1["q2"], "cpu"), alpha, SAC.to_batch(batch, "cpu"),
            noise[1], cpu.scale, cpu.shift)
        return ({"actor_loss": float(loss),
                 "entropy": float(-torch.mean(logp))},
                {"actor": g, "alpha": -(torch.mean(logp)
                                        + cpu.target_entropy)})
    if name in ("td3", "ddpg"):
        loss, _, g = value_and_grad(
            cpu.actor_loss, P(s0["actor"], "cpu"), {"q1": P(s1["q1"], "cpu")},
            SAC.to_batch(batch, "cpu"))
        return {"actor_loss": float(loss)}, {"actor": g}
    if name == "dreamer":
        loss, aux, g = value_and_grad(
            cpu.ac_loss, P(s0["ac"], "cpu"), P(s1["wm"], "cpu"),
            P(s0["target"], "cpu"), P(s0["ret_scale"], "cpu"),
            extra["h0"].cpu(), extra["s0"].cpu(), noise[1], noise[2])
        cl, aol, ent, mret, new_scale = aux
        return ({"critic_loss": float(cl), "actor_loss": float(aol),
                 "entropy": float(ent), "imag_return_mean": float(mret),
                 "ret_scale": float(0.99 * s0["ret_scale"]
                                    + 0.01 * new_scale)}, {"ac": g})
    return {}, {}


def _rl2_moves(name: str, ln) -> list:
    """Per piece of state one update moves: (state key, the grads that
    moved it from a {stage: grads} dict, its Adam, the share of the step
    it moves: tau or 0.02 for a Polyak or EMA target)."""
    critic = lambda q: lambda g: g["critic"][q]  # noqa: E731
    stage = lambda s: lambda g: g[s]  # noqa: E731
    if name in ("sac", "td3", "ddpg"):
        moves = [("q1", critic("q1"), ln.critic_tx, 1.0),
                 ("q2", critic("q2"), ln.critic_tx, 1.0),
                 ("tq1", critic("q1"), ln.critic_tx, ln.tau),
                 ("tq2", critic("q2"), ln.critic_tx, ln.tau),
                 ("actor", stage("actor"), ln.actor_tx, 1.0)]
        if name == "sac":
            return moves + [("log_alpha", stage("alpha"), ln.alpha_tx,
                             1.0)]
        return moves + [("t_actor", stage("actor"), ln.actor_tx, ln.tau)]
    if name == "dreamer":
        return [("wm", stage("wm"), ln.wm_tx, 1.0),
                ("ac", stage("ac"), ln.ac_tx, 1.0),
                ("target", stage("ac"), ln.ac_tx, 0.02)]
    tx = ln.tx if hasattr(ln, "tx") else ln._opt
    return [("params", stage("params"), tx, 1.0)]


def rllib2_parity(name: str, cell: dict, seed: int) -> dict:
    """``name``'s learner on the card against the same learner on the CPU
    from the same carried state (params_from_numpy), on the same batch and
    the same noise. The first stage's loss metrics and grads within
    _RL_REL_TOL relative (|d|/|g| a leaf); the second stage's (SAC's and
    TD3's actor, Dreamer's actor-critic) against the CPU's loss at the
    inputs the card's second stage saw, within the same bars; the state
    after the whole step within adam_first_step_bound of each side's own
    grads (a target moving tau or 0.02 of its net's step, that share of
    the bound). -> a row with the largest error beside each bar and
    "ok"."""
    import tempfile

    import numpy as np

    from ray_tpu_torch.rllib.models import params_from_numpy

    with tempfile.TemporaryDirectory() as tmp:
        cpu = rllib2_learner(name, cell, seed, "cpu", tmp)
        card = rllib2_learner(name, cell, seed, "cuda", tmp)
    s0 = _rl2_state(name, cpu)
    # the card's learner starts from the CPU's state, carried as numpy
    if name in ("sac", "td3", "ddpg"):
        card.state = params_from_numpy(s0, "cuda")
    elif name == "r2d2":
        card.set_weights(s0["params"])
    elif name in ("bc", "cql", "marwil"):
        card.params = params_from_numpy(s0["params"], "cuda")
        if name == "cql":
            card.target_params = params_from_numpy(s0["params"], "cuda")
    elif name == "dreamer":
        card._state.update(params_from_numpy(s0, "cuda"))
    else:
        card._state = (params_from_numpy(s0["params"], "cuda"),
                       card._opt.init(params_from_numpy(s0["params"],
                                                        "cuda")))
    batch = rllib2_batch(name, cell, seed + 1)
    noise = rllib2_noise(name, cell, seed + 2)
    m_card, g_card, extra = _rl2_step(name, card, batch, noise)
    s1_card = _rl2_state(name, card)
    m_cpu, g_cpu, _ = _rl2_step(name, cpu, batch, noise)
    s1_cpu = _rl2_state(name, cpu)
    m2, g2 = _rl2_second_stage(name, cpu, s0, s1_card, extra, batch, noise)
    first = {k: v for k, v in m_cpu.items() if k not in m2}
    metric_rel = {k: _rl_rel(m_card[k], v) for k, v in first.items()}
    metric_rel.update({f"stage2_{k}": _rl_rel(
        m_card[k] if k != "ret_scale" else s1_card["ret_scale"], v)
        for k, v in m2.items()})
    grad_rel = {}
    for stage, g in g_cpu.items():
        ref = g2.get(stage, g)
        grad_rel[stage] = _rl2_tree_rel(g_card[stage], ref)
    # the state after the whole step
    p_abs = share = 0.0
    for key, grads_of, tx, frac in _rl2_moves(name, cpu):
        ga, gb = _rl2_flat(grads_of(g_card)), _rl2_flat(grads_of(g_cpu))
        bound = adam_first_step_bound(ga, gb, tx.learning_rate,
                                      tx.grad_clip)
        new_a, new_b = _rl2_flat(s1_card[key]), _rl2_flat(s1_cpu[key])
        for leaf in new_b:
            d = np.abs(new_a[leaf] - new_b[leaf])
            b = _RL_ADAM_ABS + frac * (bound[leaf] - _RL_ADAM_ABS)
            p_abs = max(p_abs, float(d.max()))
            share = max(share, float((d / b).max()))
    row = {"learner": name, "metric_max_rel": max(metric_rel.values()),
           "metric_bar": _RL_REL_TOL, "metric_rel": metric_rel,
           "grad_max_rel": max(grad_rel.values()), "grad_bar": _RL_REL_TOL,
           "grad_rel": grad_rel, "param_max_abs": p_abs,
           "param_max_share_of_bound": share}
    if name == "marwil":
        row["ma_adv_sq_rel"] = _rl_rel(s1_card["ma_adv_sq"],
                                       s1_cpu["ma_adv_sq"])
        metric_rel["ma_adv_sq"] = row["ma_adv_sq_rel"]
        row["metric_max_rel"] = max(metric_rel.values())
    if name == "dreamer":
        # the card's own step imagines on its own updated world model,
        # whose Adam-noise-band elements may differ from the CPU's: shown,
        # not barred (the stage-2 check above holds it like for like)
        row["own_step_ret_scale_rel"] = _rl_rel(s1_card["ret_scale"],
                                                s1_cpu["ret_scale"])
    row["ok"] = (row["metric_max_rel"] <= _RL_REL_TOL
                 and row["grad_max_rel"] <= _RL_REL_TOL and share <= 1)
    return row


def _rl2_update_fn(name: str, ln, batch):
    """A zero-argument update of ``ln`` through its own API (its own
    draws), ending in host floats."""
    if name in ("td3", "ddpg"):
        return lambda: ln.update(batch, do_actor=True)
    if name in ("sac", "r2d2"):
        return lambda: ln.update(batch)
    if name in ("bc", "cql", "marwil"):
        dev = ln.to_device(batch)
        return lambda: {k: float(v) for k, v in ln.train_step(dev)[0]
                        .items()}
    return lambda: ln.update(*batch)


def _rl2_rows(name: str, cell: dict) -> int:
    """Env steps one update consumes (Dreamer: B L replayed steps; R2D2:
    its sequences' steps, burn-in included)."""
    if name in ("sac", "td3", "ddpg"):
        return cell["cont_batch"]
    if name == "r2d2":
        return cell["seqs"] * (_RL2_BURN_IN + _RL2_SEQ_LEN)
    if name in ("bc", "cql", "marwil"):
        return cell["offline_batch"]
    if name == "dreamer":
        return cell["B"] * cell["L"]
    return cell["az_batch"]


def rllib2_throughput(cell: dict, seed: int) -> dict:
    """(b): each learner's ms per update on the card and the env-steps it
    consumes a second; SAC's and Dreamer's update under the profiler
    (launches, busy share); Dreamer's three loops (forward, each timed
    alone) as shares of its update; Dreamer's act per env step."""
    import tempfile

    import numpy as np
    import torch

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in _RL2_LEARNERS:
            ln = rllib2_learner(name, cell, seed, "cuda", tmp)
            batch = rllib2_batch(name, cell, seed + 3)
            fn = _rl2_update_fn(name, ln, batch)
            ms = _rl_sync_ms(fn, 3 if name == "dreamer" else 10)
            rows = _rl2_rows(name, cell)
            out[name] = {"rows": rows, "ms_per_update": ms,
                         "env_steps_per_s": rows / (ms / 1e3)}
            if name in ("sac", "dreamer"):
                prof = _step_profile(fn)
                dev_ms = prof["device_ms"]
                prof["device_busy_share_of_update"] = (
                    dev_ms / ms if isinstance(dev_ms, float) else dev_ms)
                out[f"{name}_profile"] = prof
            if name == "dreamer":
                out["dreamer_loops"] = _rl2_dreamer_loops(ln, batch, ms)
                pol = ln.init_policy_state()
                obs = np.random.default_rng(seed).normal(
                    size=cell["obs"]).astype(np.float32)

                def act():
                    nonlocal pol
                    pol, _ = ln.act(pol, obs)

                out["dreamer_act_ms_per_env_step"] = _rl_sync_ms(act, 50)
            del ln
    torch.cuda.empty_cache()
    return out


def _rl2_dreamer_loops(ln, batch, update_ms: float) -> dict:
    """The posterior unroll (L steps), the imagination (H steps) and the
    lambda-return recursion (H-1 steps) of one update, each run alone as
    a forward without grad: ms and share of the update's ms."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.rllib.dreamer import mlp

    b = ln.to_device(*batch)
    B, L = b[1].shape
    noise = ln.draw_noise(B, L)
    taken = F.one_hot(b[1], ln.num_actions).to(torch.float32)
    act = torch.cat([torch.zeros_like(taken[:, :1]), taken[:, :-1]], 1)
    st = ln._state
    out = {}
    with torch.no_grad():
        hs, ss, _, _ = ln.observe(st["wm"], b[0], act, noise["post"])
        h0, s0 = hs.reshape(-1, ln.deter), ss.reshape(-1, ln.stoch)
        feats, _, _ = ln.imagine(st["wm"], st["ac"], h0, s0, noise["act"],
                                 noise["img"])
        rew = mlp(st["wm"], "rew1", "rew2", feats)[..., 0]
        disc = ln.gamma * torch.sigmoid(
            mlp(st["wm"], "cont1", "cont2", feats)[..., 0])
        tv = mlp(st["target"], "critic1", "critic2", feats)[..., 0]
        for key, fn in (
                ("observe", lambda: ln.observe(st["wm"], b[0], act,
                                               noise["post"])),
                ("imagine", lambda: ln.imagine(st["wm"], st["ac"], h0, s0,
                                               noise["act"], noise["img"])),
                ("lambda_returns", lambda: ln.lambda_returns(rew, disc,
                                                             tv))):
            ms = _rl_sync_ms(fn, 5)
            out[key] = {"ms": ms, "share_of_update": ms / update_ms}
    out["steps"] = {"observe": L, "imagine": ln.horizon,
                    "lambda_returns": ln.horizon - 1}
    return out


def _rl2_builders(seed: int) -> dict:
    """(c)'s algorithms with actors, as zero-argument builders."""
    import chip_smoke as CS  # by reference, not as __main__
    from ray_tpu_torch import rllib

    return {
        # SAC at tests/test_rllib_sac.py:184-205
        "sac": lambda: (
            rllib.SACConfig().environment("Pendulum-v1")
            .rollouts(num_rollout_workers=1, num_envs_per_worker=8,
                      rollout_fragment_length=32)
            .training(train_batch_size=128, num_updates_per_iter=48,
                      num_steps_sampled_before_learning_starts=512,
                      lr=1e-3, critic_lr=1e-3, alpha_lr=1e-3)
            .debugging(seed=seed).build()),
        # Ape-X: 2 CPU workers, 2 replay shards
        "apex": lambda: (
            rllib.ApexDQNConfig().environment("CartPole-v1").rollouts(
                num_rollout_workers=2, num_envs_per_worker=4,
                rollout_fragment_length=32).debugging(seed=seed).build()),
        "multi_agent": lambda: rllib.MultiAgentPPO(
            CS._TwoGuess, policies=["p0", "p1"],
            policy_mapping_fn=CS._two_guess_policy, num_rollout_workers=2,
            rollout_len=64, lr=1e-2, seed=seed),
        "alphazero": lambda: (
            rllib.AlphaZeroConfig().rollouts(num_rollout_workers=2)
            .training(mcts_sims=32, games_per_worker=6)
            .debugging(seed=seed).build()),
    }


def _rl2_build(fn):
    t0 = time.perf_counter()
    return fn(), time.perf_counter() - t0


def rllib2_dreamer_task() -> tuple:
    """DreamerV3 on CartPole in a num_gpus=1 task (fp32, TF32 off, as in
    the driver) -> (row, checks)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    row, checks = {}, {}
    t0 = time.perf_counter()
    _rl2_dreamer(row, checks)
    row["dreamer"]["task_s"] = time.perf_counter() - t0
    return row, checks


def rllib2_end_to_end(seed: int) -> dict:
    """(c) on the runtime the caller started: SAC on Pendulum, DreamerV3
    on CartPole (both to the reference tests' bars), Ape-X, MultiAgentPPO,
    AlphaZero, CQL and MARWIL, every learner on the card. Each is
    host-bound in one Python thread, so DreamerV3, which has no actors,
    runs in a num_gpus=1 task (its own process: acting and learning on
    the card as in a driver) while the others run here, one after
    another; the actors of SAC, Ape-X, MultiAgentPPO and AlphaZero (9,
    one CPU lease each, the replay shards half of one) start together in
    threads: each actor's import of torch costs 10-15 s."""
    import concurrent.futures as cf

    import chip_smoke as CS  # by reference, not as __main__
    import ray_tpu_torch as rt

    row, checks, algos = {}, {}, {}
    t0 = time.perf_counter()
    dreamer = rt.remote(CS.rllib2_dreamer_task).options(
        num_cpus=0, num_gpus=1).remote()
    pool = cf.ThreadPoolExecutor(4)
    futs = {k: pool.submit(_rl2_build, fn)
            for k, fn in _rl2_builders(seed).items()}
    try:
        for k, f in futs.items():
            algos[k], row[f"{k}_build_s"] = f.result(timeout=600)
        _rl2_sac(algos["sac"], row, checks)
        _rl2_apex(algos["apex"], row, checks)
        _rl2_multi_agent(algos["multi_agent"], row, checks)
        _rl2_alphazero(algos["alphazero"], row, checks)
        _rl2_offline(seed, row, checks)
        row["others_s"] = time.perf_counter() - t0
        d_row, d_checks = rt.get(dreamer, timeout=900)
        row.update(d_row)
        checks.update(d_checks)
    finally:
        for k, f in futs.items():
            if k not in algos and f.exception(timeout=600) is None:
                algos[k] = f.result()[0]
        pool.shutdown()
        for algo in algos.values():
            algo.cleanup()  # a Trainable's stop(); MultiAgentPPO's own
    row["checks"] = checks
    return row


def _rl2_dreamer(row: dict, checks: dict):
    """DreamerV3 at tests/test_rllib_dreamer.py:99-115."""
    from ray_tpu_torch import rllib

    t0 = time.perf_counter()
    algo = (rllib.DreamerV3Config().training(updates_per_iter=16)
            .debugging(seed=1).build())
    try:
        early, iters = None, []
        for i in range(_RL2_DREAMER_ITERS):
            ti = time.perf_counter()
            m = algo.step()
            iters.append(time.perf_counter() - ti)
            if i == 4:
                early = m.get("episode_reward_mean", 0.0)
        final = m["episode_reward_mean"]
        row["dreamer"] = {"early": early, "final": final,
                          "train_s": time.perf_counter() - t0,
                          "iteration_s_first_last": [iters[0], iters[-1]],
                          "learner_device": str(algo.learner.device)}
        checks["dreamer_final_over_60"] = final > _RL2_DREAMER_BAR
        checks["dreamer_final_over_early_plus_20"] = (
            final > early + _RL2_DREAMER_GAIN)
        checks["dreamer_learner_on_card"] = (algo.learner.device.type
                                             == "cuda")
    finally:
        algo.stop()


def _rl2_sac(algo, row: dict, checks: dict):
    """SAC until its best episode_reward_mean reaches the bar, at most
    _RL2_SAC_ITERS iterations (the reference test runs on to -750: its
    verdict is the same, reached later)."""
    best, it, t0 = -1e9, 0, time.perf_counter()
    for it in range(1, _RL2_SAC_ITERS + 1):
        r = algo.train()
        best = max(best, r.get("episode_reward_mean", -1e9))
        if best >= _RL2_SAC_BAR:
            break
    row["sac"] = {"best_episode_reward_mean": best, "iterations": it,
                  "train_s": time.perf_counter() - t0,
                  "learner_device": r["learner_device"],
                  "env_steps_per_s_last": r["env_steps_per_sec"]}
    checks["sac_reaches_minus_900"] = best >= _RL2_SAC_BAR
    checks["sac_learner_on_card"] = r["learner_device"] == "cuda"
    checks["sac_weights_synced"] = _rl_weights_equal(algo)


def _rl2_apex(algo, row: dict, checks: dict):
    """Ape-X until its shards fill, then _RL2_APEX_ITERS learning
    iterations."""
    import ray_tpu_torch as rt

    fill, learned, t0 = 0, 0, time.perf_counter()
    while learned < _RL2_APEX_ITERS and fill < 50:
        r = algo.train()
        if "loss" in r:
            learned += 1
        else:
            fill += 1
    prios = rt.get([s.priority_stats.remote() for s in algo.replay_shards],
                   timeout=120)
    row["apex"] = {"fill_iterations": fill, "learning_iterations": learned,
                   "train_s": time.perf_counter() - t0,
                   "replay_size": r["replay_size"], "shards": prios,
                   "learner_device": r["learner_device"]}
    checks["apex_replay_filled"] = r["replay_size"] > 0
    checks["apex_learned"] = learned == _RL2_APEX_ITERS
    checks["apex_priorities_reach_shards"] = all(
        p["max_priority"] != 1.0 and p["total"] != p["size"] for p in prios)
    checks["apex_weights_synced"] = _rl_weights_equal(algo)
    checks["apex_learner_on_card"] = r["learner_device"] == "cuda"


def _rl2_multi_agent(ma, row: dict, checks: dict):
    """MultiAgentPPO with two policies for 2 iterations."""
    t0 = time.perf_counter()
    outs = [ma.train() for _ in range(2)]
    row["multi_agent"] = {"s": time.perf_counter() - t0,
                          "env_steps": outs[-1]["env_steps"],
                          "devices": {p: str(ln.device) for p, ln in
                                      ma.learners.items()}}
    checks["multi_agent_learners_on_card"] = all(
        ln.device.type == "cuda" for ln in ma.learners.values())
    checks["multi_agent_two_policies"] = set(ma.get_weights()) == {"p0",
                                                                   "p1"}


def _rl2_alphazero(algo, row: dict, checks: dict):
    """AlphaZero with 2 self-play workers for 2 iterations; the workers'
    weights equal the learner's bit for bit."""
    import numpy as np

    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    outs = [algo.step() for _ in range(2)]
    w = algo.learner.get_weights()
    synced = all(
        ww is not None and set(ww) == set(w)
        and all(np.array_equal(ww[k], w[k]) for k in w)
        for ww in rt.get([x.get_weights.remote() for x in algo.workers],
                         timeout=120))
    row["alphazero"] = {"s": time.perf_counter() - t0,
                        "replay_size": outs[-1]["replay_size"],
                        "total_loss": outs[-1]["total_loss"],
                        "learner_device": str(algo.learner.device)}
    checks["alphazero_learner_on_card"] = (algo.learner.device.type
                                           == "cuda")
    checks["alphazero_workers_synced"] = synced


def _rl2_offline(seed: int, row: dict, checks: dict):
    """CQL and MARWIL, 64 updates each on a logged CartPole dataset."""
    import tempfile

    from ray_tpu_torch import rllib

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rllib.collect_dataset("CartPole-v1", tmp,
                              num_steps=_RL2_DATASET_STEPS, epsilon=0.3,
                              seed=seed)
        row["dataset_s"] = time.perf_counter() - t0
        for name, cfg in (("cql", rllib.CQLConfig()),
                          ("marwil", rllib.MARWILConfig())):
            algo = (cfg.environment("CartPole-v1")
                    .offline_data(input_path=tmp).debugging(seed=seed)
                    .build())
            try:
                t0 = time.perf_counter()
                m = algo.training_step()
                row[name] = {"updates":
                             algo.algo_config.num_updates_per_iter,
                             "s": time.perf_counter() - t0,
                             "dataset_size": algo.dataset.count,
                             "metrics": m, "device": str(algo.device)}
                checks[f"{name}_on_card_finite"] = (
                    algo.device.type == "cuda" and algo.dataset.count
                    == _RL2_DATASET_STEPS and all(
                        math.isfinite(v) for v in m.values()))
            finally:
                algo.stop()


class _TwoGuess:
    """Two agents, 1-step episodes: each sees [sign, noise] and earns 1.0
    for matching its own sign (tests/test_rllib.py's multi-agent env)."""

    agent_ids = ("a0", "a1")
    observation_dim = 2
    num_actions = 2
    max_episode_steps = 1

    def __init__(self):
        import numpy as np

        self._rng = np.random.default_rng(0)

    def _obs_one(self):
        import numpy as np

        sign = 1.0 if self._rng.random() < 0.5 else -1.0
        return np.array([sign, self._rng.random()], np.float32)

    def reset(self, seed=None):
        import numpy as np

        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._cur = {a: self._obs_one() for a in self.agent_ids}
        return dict(self._cur)

    def step(self, actions):
        rewards = {}
        for a, act in actions.items():
            want = 1 if self._cur[a][0] > 0 else 0
            rewards[a] = 1.0 if act == want else 0.0
        dones = {a: True for a in actions}
        dones["__all__"] = True
        self._cur = {a: self._obs_one() for a in self.agent_ids}
        return dict(self._cur), rewards, dones, {}


def _two_guess_policy(agent: str) -> str:
    return "p0" if agent == "a0" else "p1"


def phase_rllib2(seed: int):
    """The port's RLlib, part 2, on the card (the module's docstring,
    rllib2)."""
    import torch

    import ray_tpu_torch as rt

    row = {"phase": "rllib2", "card": _nvidia_smi(),
           "cell": {**_RL2_CELL, "burn_in": _RL2_BURN_IN,
                    "seq_len": _RL2_SEQ_LEN, "dtype": "float32",
                    "tf32": False}}
    checks = {}
    t0 = time.perf_counter()
    row["parity"] = [rllib2_parity(n, _RL2_CELL, seed)
                     for n in _RL2_LEARNERS]
    row["parity_s"] = time.perf_counter() - t0
    for p in row["parity"]:
        checks[f"parity_{p['learner']}"] = p["ok"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    row["throughput"] = rllib2_throughput(_RL2_CELL, seed)
    row["throughput_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt.init(num_cpus=8)
    try:
        e2e = rllib2_end_to_end(seed)
    finally:
        rt.shutdown()
    row["end_to_end_s"] = time.perf_counter() - t0
    checks.update(e2e.pop("checks"))
    row["end_to_end"] = e2e
    for _ in range(100):
        left = _workers_left()
        if not left:
            break
        time.sleep(0.1)
    row["workers_left"] = left
    checks["no_worker_left"] = not left
    row["checks"] = checks
    row["ok"] = all(checks.values())
    _emit(row)
    if not row["ok"]:
        raise AssertionError(f"rllib2 phase failed: "
                             f"{[k for k, v in checks.items() if not v]}")


def _active_flops_per_token(cfg, seq: int) -> float:
    """Training FLOPs a token needs in the MoE model: 6 x the parameters
    it multiplies by (q/k/v/o projections, the router, its k experts'
    SwiGLU, the tied head) + the attention term of cfg.flops_per_token
    (12 L d T). Expert places left empty by the capacity, and the experts a
    token is not routed to, are not counted."""
    d, L, hd = cfg.d_model, cfg.n_layers, cfg.head_dim
    attn = d * cfg.n_heads * hd * 2 + 2 * d * cfg.kv_heads * hd
    per_layer = attn + d * cfg.moe_experts + cfg.moe_top_k * 3 * d * cfg.d_ff
    return 6.0 * (L * per_layer + cfg.vocab_size * d) + 12.0 * L * d * seq


def phase_moe_train(fa, T, TR, cfg, params, seed: int):
    """The MoE model at _MOE_TRAIN_LAYERS layers (``cfg``, bf16 params,
    remat "nothing"), batch 4 x 2048: train check (a) within
    _TRAIN_BF16_RATIO (the unbroken kernels over 2 weight seeds x 2 batches
    read loss 0.114-0.942, gradient 0.935-0.997 and wq/wk/wv leaves at most
    1.001 there, under the dense bars; B2's mutant reaches 1.89 on wq, B3's
    1.26 on wk); _TRAIN_STEPS AdamW steps on one fixed batch with
    finite, falling losses and a finite moe_aux; launches per step exactly
    _MOE_TRAIN_LAUNCHES; ms per step (steps 2-5), tokens/s, peak memory and
    MFU of the active work (_active_flops_per_token; cfg.flops_per_token
    is the reference's and counts no experts). Params change in place."""
    batch = train_batch(cfg, seed + 3)
    _zero_counts(fa)
    parity = train_parity(T, TR, cfg, params, batch)
    grad_launches = _counts(fa)
    run = _train_steps(fa, TR, cfg, params, batch, _TRAIN_STEPS, False)
    walls = run.pop("walls_ms")
    step_ms = sum(walls[1:]) / len(walls[1:])
    aux = [m["moe_aux"] for m in run.pop("metrics")]
    flops_step = _active_flops_per_token(cfg, 2048) * 4 * 2048
    launches_ok = all(c == _MOE_TRAIN_LAUNCHES
                      for c in [grad_launches, *run["launches_per_step"]])
    aux_finite = all(math.isfinite(x) for x in aux)
    del run["profile_last_step"]
    _emit({"phase": "moe_train", "config": "llama3-1b", **_MOE,
           "n_layers": cfg.n_layers, "batch": [4, 2048],
           "param_dtype": "bfloat16", "mu_dtype": "bfloat16", "remat": True,
           "lr": 3e-4, "parity": parity, "grad_launches": grad_launches,
           **run, "moe_aux": aux, "moe_aux_finite": aux_finite,
           "launches_want": _MOE_TRAIN_LAUNCHES, "first_step_ms": walls[0],
           "ms_per_step": step_ms, "tokens_per_s": 4 * 2048 / step_ms * 1e3,
           "active_flops_per_step": flops_step,
           "flops_formula": "4*2048*(6*(L*(2*d*H*hd + 2*d*KV*hd + d*E"
                            " + k*3*d*ff) + V*d) + 12*L*d*2048)",
           "mfu_active": flops_step / step_ms * 1e3
           / _PEAK_FLOPS["bfloat16"]})
    if not (parity["ok"] and run["finite"] and run["falling"] and aux_finite
            and launches_ok):
        raise AssertionError("moe_train phase failed")
    return run["launches_per_step"][0]


def phase_train_mesh(fa, T, TR, C, params, seed: int):
    """Phase train's cell on make_mesh(fsdp=1), an NCCL world of one:
      (a) one step's loss and gradient with the params as DTensors
          (interop.shard_params) against the unmeshed step's on the same
          params and batch, within _MESH_TOL (loss absolute, flattened
          gradient relative); that step launches B1 32, B2 16, B3 16 times;
      (b) _TRAIN_STEPS meshed AdamW steps from a copy of the params:
          launches per step, ms per step (steps 2-5), peak memory, beside
          phase train's, which shows the DTensor wrapper's host cost.
    ``params`` are left as they were; the process group is destroyed."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.interop import shard_params
    from ray_tpu_torch.parallel import make_mesh

    cfg = train_config(C)
    batch = train_batch(cfg, seed + 3)
    mesh = make_mesh(fsdp=1)
    try:
        loss_u, grads_u = _grads(T, TR, params, batch, cfg)
        dparams = shard_params(mesh, params, cfg)
        _zero_counts(fa)
        loss_m, grads_m = _grads(T, TR, dparams, batch, cfg, mesh)
        grad_launches = _counts(fa)
        direct = {"loss": abs(loss_m.item() - loss_u.item()),
                  "grad": _tree_rel(grads_m, grads_u)}
        del grads_u, grads_m, dparams
        torch.cuda.empty_cache()
        copy = TR.tree_map(lambda w: w.clone(), params)
        run = _train_steps(fa, TR, cfg, copy, batch, _TRAIN_STEPS, False,
                           mesh)
        del copy
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    walls = run.pop("walls_ms")
    step_ms = sum(walls[1:]) / len(walls[1:])
    del run["metrics"], run["profile_last_step"]
    launches_ok = all(c == _TRAIN_LAUNCHES
                      for c in [grad_launches, *run["launches_per_step"]])
    parity_ok = all(x <= _MESH_TOL for x in direct.values())
    _emit({"phase": "train_mesh", "config": "llama3-1b", "batch": [4, 2048],
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
           "backend": "nccl", "meshed_vs_unmeshed": direct,
           "tol": _MESH_TOL, "loss_unmeshed": loss_u.item(),
           "grad_launches": grad_launches, **run,
           "launches_want": _TRAIN_LAUNCHES, "first_step_ms": walls[0],
           "ms_per_step": step_ms,
           "tokens_per_s": 4 * 2048 / step_ms * 1e3})
    if not (parity_ok and launches_ok and run["finite"] and run["falling"]):
        raise AssertionError("train_mesh phase failed")
    return run["launches_per_step"][0]


def phase_train_dots(fa, T, TR, C, params, seed: int):
    """Phase train's cell with remat_policy "dots" (keep the outputs of
    aten.mm, recompute the rest) from the same params and batch:
      (a) one step's loss and gradients under "dots" and under "nothing"
          through the kernels must agree within _DOTS_TOL; the "dots" step
          launches B1 32, B2 16 and B3 16 times;
      (b) three AdamW steps each way from copies of the params: launches
          per step, ms per step (step 2), peak memory, and step 3's device
          time and busy share from torch.profiler, side by side.
    ``params`` are left as they were."""
    import torch

    nothing = train_config(C)
    dots = dataclasses.replace(nothing, remat_policy="dots")
    batch = train_batch(nothing, seed + 3)
    loss_n, grads_n = _grads(T, TR, params, batch, nothing)
    _zero_counts(fa)
    loss_d, grads_d = _grads(T, TR, params, batch, dots)
    grad_launches = _counts(fa)
    direct = {"loss": abs(loss_d.item() - loss_n.item()),
              "grad": _tree_rel(grads_d, grads_n)}
    del grads_n, grads_d
    torch.cuda.empty_cache()
    parity_ok = all(x <= _DOTS_TOL for x in direct.values())

    runs = {}
    for tag, cfg in (("nothing", nothing), ("dots", dots)):
        copy = TR.tree_map(lambda w: w.clone(), params)
        run = _train_steps(fa, TR, cfg, copy, batch, 3, True)
        del copy, run["metrics"]
        prof = run.pop("profile_last_step")
        run["profile_step3"] = {k: prof[k] for k in (
            "profiled_wall_ms", "device_ms", "device_busy_share")}
        torch.cuda.empty_cache()
        runs[tag] = run
    launches_ok = all(c == _TRAIN_LAUNCHES for c in
                      [grad_launches, *runs["dots"]["launches_per_step"]])
    _emit({"phase": "train_dots", "config": "llama3-1b", "batch": [4, 2048],
           "remat_policy": "dots", "dots_vs_nothing": direct,
           "tol": _DOTS_TOL, "grad_launches": grad_launches,
           "launches_want": _TRAIN_LAUNCHES, "runs": runs,
           "ms_per_step": {k: r["walls_ms"][-1] for k, r in runs.items()},
           "device_ms_step3": {k: r["profile_step3"]["device_ms"]
                               for k, r in runs.items()},
           "peak_mem_gib": {k: r["peak_mem_gib"] for k, r in runs.items()}})
    if not (parity_ok and launches_ok and
            all(r["finite"] for r in runs.values())):
        raise AssertionError("train_dots phase failed")
    return runs["dots"]["launches_per_step"][0]


def axis_check(fa, T, TR, cfg, params, vm, tokens, batch, fwd_ratio,
               train_ratio) -> dict:
    """The forward check (forward_parity) and train check (a)
    (train_parity) with the kernel side on the VirtualMesh ``vm``, and the
    launches of one forward and one train step there."""
    import torch

    _zero_counts(fa)
    with torch.no_grad():
        T.forward(params, tokens, cfg, vm)
    torch.cuda.synchronize()
    fwd_launches = _counts(fa)
    fwd = forward_parity(T, cfg, params, params, tokens, fwd_ratio,
                         _FWD_REL_TOL, vm)
    torch.cuda.empty_cache()
    _zero_counts(fa)
    train = train_parity(T, TR, cfg, params, batch, vm, train_ratio)
    train_launches = _counts(fa)  # the plain and fp32 steps launch nothing
    torch.cuda.empty_cache()
    launches_ok = (fwd_launches == _AXIS_LAUNCHES["forward"]
                   and train_launches == _AXIS_LAUNCHES["train"])
    return {"forward": fwd, "train": train, "forward_launches": fwd_launches,
            "train_launches": train_launches,
            "launches_want": _AXIS_LAUNCHES, "launches_ok": launches_ok,
            "ok": fwd["ok"] and train["ok"] and launches_ok}


def pipeline_config(C):
    """The train cell in _PP stages of 4 layers on _PP_MICRO microbatches."""
    return dataclasses.replace(train_config(C),
                               pipeline_microbatches=_PP_MICRO)


def _axis_times(T, TR, cfg, params, vm, tokens, batch) -> dict:
    """ms of a forward (CUDA events, 3 runs) and of a forward + backward
    (host clock around synchronized calls, 2 runs) on ``vm`` and unmeshed,
    in this order: meshed, unmeshed, unmeshed, meshed."""
    import torch

    def fwd(mesh):
        with torch.no_grad():
            return _time_ms(lambda: T.forward(params, tokens, cfg, mesh), 3,
                            1)

    def grad(mesh):
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _grads(T, TR, params, batch, cfg, mesh)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return min(walls)

    out = {"forward_ms": fwd(vm), "forward_unmeshed_ms": fwd(None)}
    out["grad_step_unmeshed_ms"] = grad(None)
    out["grad_step_ms"] = grad(vm)
    torch.cuda.empty_cache()
    return out


def phase_tensor(fa, T, TR, C, params, seed: int):
    """The train cell on _TP virtual tensor ranks (VirtualMesh("tensor",
    4)): each rank's heads through B1/B2/B3 at [32, 2048, 64], its d_ff
    columns and vocabulary rows, the partial sums added in rank order.
    axis_check within _TP_FWD_RATIO and _TP_TRAIN_RATIO, launches exactly
    _AXIS_LAUNCHES; times beside the unmeshed ones, and a rank's share
    (each rank does a quarter of the work; the all-reduces are not on
    this card)."""
    from ray_tpu_torch.parallel.mesh import VirtualMesh

    cfg = train_config(C)
    vm = VirtualMesh("tensor", _TP)
    tokens, batch = forward_tokens(cfg, seed), train_batch(cfg, seed + 3)
    row = axis_check(fa, T, TR, cfg, params, vm, tokens, batch,
                     _TP_FWD_RATIO, _TP_TRAIN_RATIO)
    times = _axis_times(T, TR, cfg, params, vm, tokens, batch)
    _emit({"phase": "tensor", "config": "llama3-1b", "virtual_ranks": _TP,
           "batch": [4, 2048], "remat": True, "dtype": "bfloat16",
           "b1_b2_b3_shape": [4 * cfg.n_heads // _TP, 2048, 64],
           "fwd_ratio_tol": _TP_FWD_RATIO,
           "train_ratio_tol": _TP_TRAIN_RATIO, **row, **times,
           "per_rank_forward_ms": times["forward_ms"] / _TP,
           "per_rank_grad_step_ms": times["grad_step_ms"] / _TP})
    if not row["ok"]:
        raise AssertionError("tensor phase failed")
    return row


def phase_pipeline(fa, T, TR, C, params, seed: int):
    """The train cell in _PP virtual stages (VirtualMesh("pipeline", 4)) of
    4 layers on _PP_MICRO microbatches of [1, 2048]: the GPipe schedule of
    parallel/pipeline.py in one process, the hand-off a copy, the bubble
    ticks skipped. axis_check within _PP_FWD_RATIO and _PP_TRAIN_RATIO,
    launches exactly _AXIS_LAUNCHES; times beside the unmeshed ones. A
    stage's work per microbatch is the measured time over S*M, and a real
    pipeline's step takes M + S - 1 such ticks (bubble share (S-1)/(M+S-1),
    derived, not measured across cards)."""
    from ray_tpu_torch.parallel.mesh import VirtualMesh

    cfg = pipeline_config(C)
    vm = VirtualMesh("pipeline", _PP)
    tokens, batch = forward_tokens(cfg, seed), train_batch(cfg, seed + 3)
    row = axis_check(fa, T, TR, cfg, params, vm, tokens, batch,
                     _PP_FWD_RATIO, _PP_TRAIN_RATIO)
    times = _axis_times(T, TR, cfg, params, vm, tokens, batch)
    ticks, work = _PP_MICRO + _PP - 1, _PP * _PP_MICRO
    _emit({"phase": "pipeline", "config": "llama3-1b", "virtual_stages": _PP,
           "microbatches": _PP_MICRO, "microbatch": [1, 2048],
           "bubble_ticks": "skipped", "remat": True, "dtype": "bfloat16",
           "b1_b2_b3_shape": [cfg.n_heads, 2048, 64],
           "fwd_ratio_tol": _PP_FWD_RATIO,
           "train_ratio_tol": _PP_TRAIN_RATIO, **row, **times,
           "bubble_share": (_PP - 1) / ticks,
           "per_rank_forward_ms_derived": times["forward_ms"] / work * ticks,
           "per_rank_grad_step_ms_derived":
               times["grad_step_ms"] / work * ticks})
    if not row["ok"]:
        raise AssertionError("pipeline phase failed")
    return row


def phase_moe_parallel(M, cfg, params, seed: int):
    """Layer 0 of the MoE model at [4, 2048] bf16 on 4 virtual expert ranks
    (2 experts each: each routes every token, runs its experts' kept slots,
    the partial outputs summed) and on 2 virtual sequence ranks (chunks of
    1024 tokens; capacity claimed along the whole row, rank 1 offset by
    rank 0's counts), at capacity factor 1.25 and 0.5, each against the
    unsharded moe_ffn by moe_layer's checks: expert ids and kept slots
    equal, the output within 1.05 (2u|y| + 6u A) + 1e-6 per element and
    1e-2 as a whole; at 0.5 some slots must drop. Times beside the
    unsharded layer's."""
    import torch

    from ray_tpu_torch.parallel.mesh import VirtualMesh

    lp = {k: params["layers"][k][0] for k in ("router", "w_gate", "w_up",
                                              "w_down")}
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    h = torch.randn(4, 2048, cfg.d_model, generator=g,
                    device="cuda").to(cfg.dtype)
    u, ok = _MOE_LAYER_UNIT, True
    for cf in (cfg.moe_capacity_factor, _MOE_LAYER_DROP_CF):
        c = dataclasses.replace(cfg, moe_capacity_factor=cf)
        with torch.no_grad():
            y_u, _, top_u, kept_u = M.moe_layer(h, lp, c)
            tol = 1.05 * (2 * u * y_u.float().abs()
                          + 6 * u * _moe_abs_path(M, h, lp, c)) + 1e-6
            unsharded_ms = _time_ms(lambda: M.moe_layer(h, lp, c), 5)
            for axis, n in (("expert", 4), ("sequence", 2)):
                vm = VirtualMesh(axis, n)
                y, _, top_i, kept = M.moe_layer(h, lp, c, vm)
                torch.cuda.synchronize()
                dy = y.float() - y_u.float()
                row = {"same_expert_ids": torch.equal(top_i, top_u),
                       "same_kept": torch.equal(kept, kept_u),
                       "dropped_share": 1 - kept.float().mean().item(),
                       "max_abs_err": dy.abs().max().item(),
                       "err_over_tol": (dy.abs() / tol).max().item(),
                       "rel_norm_err": (dy.norm()
                                        / y_u.float().norm()).item(),
                       "finite": bool(torch.isfinite(y.float()).all()),
                       "ms": _time_ms(lambda: M.moe_layer(h, lp, c, vm), 5),
                       "unsharded_ms": unsharded_ms}
                row["ok"] = (row["same_expert_ids"] and row["same_kept"]
                             and row["finite"] and row["err_over_tol"] <= 1
                             and row["rel_norm_err"] <= _MOE_LAYER_REL_TOL
                             and (cf == cfg.moe_capacity_factor
                                  or row["dropped_share"] > 0))
                _emit({"phase": "moe_parallel", "axis": axis,
                       "virtual_ranks": n, "shape": [4, 2048, cfg.d_model],
                       "dtype": "bfloat16", **_MOE,
                       "moe_capacity_factor": cf,
                       "tol": f"1.05*(2u|y| + 6u*sum_k p|act|@|W_down|) + "
                              f"1e-6, u={u}",
                       "rel_norm_tol": _MOE_LAYER_REL_TOL, **row})
                ok = ok and row["ok"]
        torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the expert- or sequence-split MoE layer "
                             "disagrees with the unsharded one")


def phase_engine_mesh(E, cfg, p32, seed: int):
    """The fp32 engine on make_mesh(tensor=1), an NCCL world of one, token
    for token against the unmeshed engine on the same prompts. It covers
    the meshed engine's code path on the card (its rank's weights and
    cache, the reductions and the logits' gather, all over groups of one);
    the splits over real ranks run in tests/test_torch_multicard.py. The
    process group is destroyed after."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import make_mesh

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    rng = random.Random(seed + 7)
    prompts = [[rng.randint(1, cfg.vocab_size - 1) for _ in range(n)]
               for n in (5, 17, 40, 64)]
    mesh = make_mesh(tensor=1)
    got, walls = {}, {}
    try:
        for tag, m in (("unmeshed", None), ("meshed", mesh)):
            eng = E.InferenceEngine(p32, cfg32, slots=8, max_prompt_len=64,
                                    max_new_tokens=32, greedy=True,
                                    seed=seed, mesh=m)
            t0 = time.perf_counter()
            reqs = [eng.submit(p) for p in prompts]
            for _ in range(1000):
                if all(r.done.is_set() for r in reqs):
                    break
                eng.step()
            walls[tag] = time.perf_counter() - t0
            got[tag] = [list(r.tokens) for r in reqs]
            del eng
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    match = [a == b for a, b in zip(got["meshed"], got["unmeshed"])]
    _emit({"phase": "engine_mesh", "dtype": "float32", "tf32": False,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
           "backend": "nccl", "covers": "the meshed engine's code path on a "
           "world of one; no split over ranks",
           "prompt_lens": [len(p) for p in prompts], "max_new_tokens": 32,
           "match_unmeshed": match, "wall_s": walls})
    if not all(match):
        raise AssertionError("the meshed engine's tokens differ from the "
                             "unmeshed engine's")


def _axis_launches(tensor_row, pipeline_row, name: str) -> dict:
    """A kernel's launches on the tensor and pipeline paths (a forward is
    listed only where the kernel runs there)."""
    out = {}
    for tag, row in (("tensor", tensor_row), ("pipeline", pipeline_row)):
        if row["forward_launches"][name]:
            out[f"{tag}_forward"] = row["forward_launches"][name]
        out[f"{tag}_train_step"] = row["train_launches"][name]
    return out


def run(seed: int) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    try:
        from ray_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the ray_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    from ray_tpu_torch.models import config as C
    from ray_tpu_torch.models import engine as E
    from ray_tpu_torch.models import generate as G
    from ray_tpu_torch.models import moe as M
    from ray_tpu_torch.models import training as TR
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.parallel import ring as R
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    # fp32 matmuls and convolutions in full fp32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_script = t0 = time.perf_counter()
    per_source = _build.build_all()  # one nvcc per source, all together
    libs = {n: _build.load(n)._name for n in _build.sources()}
    ptxas = {n: _build.ptxas_report(_build.build_log(n)) for n in libs}
    spilled = [k["kernel"] for ks in ptxas.values() for k in ks
               if k["spill_stores"] or k["spill_loads"]]
    _emit({"phase": "build", "seconds": time.perf_counter() - t0,
           "seconds_per_source": per_source,
           "libraries": {n: os.path.relpath(p, _ROOT)
                         for n, p in libs.items()},
           "ptxas": ptxas, "spilled": spilled, "ok": not spilled})

    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    _emit({"phase": "device", "kind": kind, "count": count,
           "nvidia_smi": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda})

    failed = ["build"] if spilled else []

    def attempt(name, fn, *args):
        # a failed phase is reported and the later phases still run, so one
        # run shows every fault; the script then exits non-zero
        t0 = time.perf_counter()
        try:
            return fn(*args)
        except Exception:
            traceback.print_exc()
            failed.append(name)
            return None
        finally:
            _emit({"phase_wall": name, "s": time.perf_counter() - t0})

    rows = attempt("kernels", phase_kernels, fa, seed)
    bwd_rows = attempt("kernels_bwd", phase_kernels_bwd, fa, seed)
    ring_launches = attempt("ring", phase_ring, fa, R, seed)
    torch.cuda.empty_cache()
    attempt("entry", phase_entry)

    cfg = C.get_config("llama3-1b", param_dtype=torch.bfloat16)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(seed),
                           cfg, device="cuda")
    # the same weights in fp32 (bf16 values are exact in fp32)
    p32 = {"embed": params["embed"].float(),
           "final_norm": params["final_norm"].float(),
           "layers": {k: w.float() for k, w in params["layers"].items()}}
    runtime_launches = attempt("runtime", phase_runtime, T, cfg, params,
                               seed)
    torch.cuda.empty_cache()
    launches = attempt("forward", phase_forward, fa, T, cfg, params, p32,
                       seed)
    attempt("engine", phase_engine_fp32, E, G, cfg, p32, seed)
    attempt("engine_mesh", phase_engine_mesh, E, cfg, p32, seed)
    del p32
    torch.cuda.empty_cache()
    serving_tps = attempt("serving", phase_serving, E, cfg, params, seed)
    torch.cuda.empty_cache()
    serve_launches = attempt("serve", phase_serve, E, T, cfg, params, seed,
                             serving_tps)
    torch.cuda.empty_cache()

    # Mixture-of-Experts: the 16-layer model (13.7 GB in bf16), then the
    # 4-layer one that trains
    moe = moe_config(C)
    moe_params = attempt("moe_init", T.init_params, torch.Generator(
        device="cuda").manual_seed(seed + 100), moe, "cuda")
    moe_launches = moe_train_launches = None
    if moe_params is not None:
        attempt("moe_layer", phase_moe_layer, M, moe, moe_params, seed)
        attempt("moe_parallel", phase_moe_parallel, M, moe, moe_params,
                seed)
        torch.cuda.empty_cache()
        moe_launches = attempt("moe_forward", phase_moe_forward, fa, T, M,
                               moe, moe_params, seed)
    del moe_params
    torch.cuda.empty_cache()
    moe4 = moe_train_config(C)
    moe_params = attempt("moe_init", T.init_params, torch.Generator(
        device="cuda").manual_seed(seed + 101), moe4, "cuda")
    if moe_params is not None:
        attempt("moe_engine", phase_moe_engine, E, G, moe4, moe_params,
                seed)
        torch.cuda.empty_cache()
        # serving at the 4-layer MoE model's depth (the 16-layer model's
        # 32 requests took 38-64 s, which the script's limit cannot spare)
        attempt("moe_serving", phase_serving, E, moe4, moe_params, seed,
                "moe_serving")
        torch.cuda.empty_cache()
        moe_train_launches = attempt("moe_train", phase_moe_train, fa, T,
                                     TR, moe4, moe_params, seed)
    del moe_params
    torch.cuda.empty_cache()

    tensor_row = attempt("tensor", phase_tensor, fa, T, TR, C, params, seed)
    torch.cuda.empty_cache()
    pipeline_row = attempt("pipeline", phase_pipeline, fa, T, TR, C, params,
                           seed)
    torch.cuda.empty_cache()
    mesh_launches = attempt("train_mesh", phase_train_mesh, fa, T, TR, C,
                            params, seed)
    torch.cuda.empty_cache()
    dots_launches = attempt("train_dots", phase_train_dots, fa, T, TR, C,
                            params, seed)
    torch.cuda.empty_cache()
    train_row = attempt("train", phase_train, fa, T, TR, C, params, seed)
    # the driver's train state goes before the trainer's worker makes its
    # own on the same card
    del params
    torch.cuda.empty_cache()
    _emit({"driver_reserved_bytes": torch.cuda.memory_reserved()})
    trainer_row = attempt("trainer", phase_trainer, fa, T, TR, C, seed)
    torch.cuda.empty_cache()
    data_launches = attempt("data", phase_data, seed, trainer_row,
                            train_row)
    torch.cuda.empty_cache()
    dag_launches = attempt("dag_workflow", phase_dag_workflow, seed)
    torch.cuda.empty_cache()
    attempt("microbenchmark", phase_microbenchmark)
    ops_launches = attempt("ops_layer", phase_ops_layer, seed)
    torch.cuda.empty_cache()
    clients_launches = attempt("clients", phase_clients, seed)
    torch.cuda.empty_cache()
    tpipe_launches = attempt("train_pipeline", phase_train_pipeline, fa, T,
                             TR, C, seed)
    torch.cuda.empty_cache()
    attempt("rllib", phase_rllib, seed)
    torch.cuda.empty_cache()
    attempt("rllib2", phase_rllib2, seed)
    _emit({"script_wall_s": time.perf_counter() - t_script})
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1

    train_launches = train_row["launches"]
    main = next(r for r in rows if r["case"] == "main")
    bwd_main = next(r for r in bwd_rows if r["case"] == "main")
    line = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:35",
        "launches": launches, "max_abs_err": main["o_max_abs_err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "tflops_per_s": main["tflops_per_s"],
        "bound_share": main["bound_ms"] / main["ms"],
        "launches_by_path": {
            "forward": launches, "train_step": train_launches["flash_fwd"],
            "runtime_actor_forward": runtime_launches,
            "serve_forward": serve_launches,
            "moe_forward": moe_launches,
            "moe_train_step": moe_train_launches["flash_fwd"],
            "train_dots_step": dots_launches["flash_fwd"],
            "ring_forward": ring_launches["ring_forward"],
            "train_mesh_step": mesh_launches["flash_fwd"],
            "trainer_step": trainer_row["launches"]["flash_fwd"],
            "data_trainer_step": data_launches["flash_fwd"],
            "dag_forward": dag_launches[0],
            "workflow_forward": dag_launches[1],
            "job_forward": ops_launches[0],
            "gke_pool_forward": ops_launches[1],
            "cpp_client_forward": clients_launches[0],
            "cpp_store_forward": clients_launches[1],
            "train_pipeline": tpipe_launches["flash_fwd"],
            **_axis_launches(tensor_row, pipeline_row, "flash_fwd")}}]
    for name, line_no, source, err in (
            ("flash_bwd_dq", 87, "flash_bwd.cu", "dq_max_abs_err"),
            ("flash_bwd_dkv", 111, "flash_bwd_dkv.cu", None)):
        k = bwd_main[name]
        line.append({
            "name": name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{source}",
            "replaces": f"ray_tpu/ops/flash_attention.py:{line_no}",
            "launches": train_launches[name],
            "max_abs_err": (bwd_main[err] if err else
                            max(bwd_main["dk_max_abs_err"],
                                bwd_main["dv_max_abs_err"])),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
            "tflops_per_s": k["tflops_per_s"],
            "bound_share": k["bound_ms"] / k["ms"],
            "launches_by_path": {
                "train_step": train_launches[name],
                "moe_train_step": moe_train_launches[name],
                "train_dots_step": dots_launches[name],
                "ring_backward": ring_launches[
                    "ring_backward" if name == "flash_bwd_dq"
                    else "ring_backward_dkv"],
                "train_mesh_step": mesh_launches[name],
                "trainer_step": trainer_row["launches"][name],
                "data_trainer_step": data_launches[name],
                "train_pipeline": tpipe_launches[name],
                **_axis_launches(tensor_row, pipeline_row, name)}})
    _emit({"kernels": line})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": count}})
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    try:
        return run(args.seed)
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
