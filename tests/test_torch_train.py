"""The port's Train library (``ray_tpu_torch.train``) on its runtime: the
cases of tests/test_train.py, with ``test_jax_trainer_real_step`` as
``test_torch_trainer_real_step``, ``as_trainable`` through the port's Tune,
and the Torch backend's own rules (GPU leases, no fallback)."""

import os
import tempfile

import pytest

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.train import (
    Checkpoint,
    DataParallelTrainer,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
)
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def runtime():
    # two fake GPUs: leases the workers see as CUDA_VISIBLE_DEVICES, with no
    # card behind them
    ray_tpu_torch.init(num_cpus=8, num_gpus=2, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


def test_single_worker_fit(runtime, tmp_path):
    def loop(config):
        for i in range(3):
            train.report({"step": i, "loss": 1.0 / (i + 1)})

    result = DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="t1", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None
    assert result.metrics["step"] == 2
    assert len(result.metrics_history) == 3


def test_multi_worker_ranks(runtime, tmp_path):
    def loop(config):
        ctx = train.get_context()
        train.report({"rank": ctx.world_rank, "world": ctx.world_size})

    result = DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="t2", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None
    assert result.metrics["world"] == 2
    assert result.metrics["rank"] == 0  # rank-0 metrics win


def test_checkpoint_roundtrip_and_topk(runtime, tmp_path):
    def loop(config):
        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            start = ckpt.to_dict()["step"] + 1
        for i in range(start, 4):
            train.report({"score": float(i)},
                         checkpoint=Checkpoint.from_dict({"step": i}))

    rc = RunConfig(name="t3", storage_path=str(tmp_path),
                   checkpoint_config=train.CheckpointConfig(
                       num_to_keep=2, checkpoint_score_attribute="score"))
    result = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=rc).fit()
    assert result.error is None
    assert result.checkpoint.to_dict()["step"] == 3
    ckpt_dir = os.path.join(str(tmp_path), "t3", "checkpoints")
    assert len(os.listdir(ckpt_dir)) == 2  # top-K retention

    # resume continues from the saved step without redoing work
    result2 = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="t3b", storage_path=str(tmp_path)),
        resume_from_checkpoint=result.checkpoint).fit()
    assert result2.metrics_history == []  # start==4, loop body skipped


def test_gang_restart_on_failure(runtime, tmp_path):
    marker = os.path.join(tempfile.mkdtemp(), "boom")

    def loop(config):
        ckpt = train.get_checkpoint()
        start = ckpt.to_dict()["step"] + 1 if ckpt else 0
        for i in range(start, 4):
            train.report({"step": i},
                         checkpoint=Checkpoint.from_dict({"step": i}))
            if i == 1 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                raise RuntimeError("worker down")

    result = DataParallelTrainer(
        loop, train_loop_config={"marker": marker},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="t4", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)),
    ).fit()
    assert result.error is None
    assert result.metrics["step"] == 3


def test_fit_traces_its_layer(runtime, tmp_path):
    """fit's own costs are spans in the timeline: each attempt's executor
    start and shutdown, and each reported checkpoint's write, in order."""
    import time

    marker = os.path.join(str(tmp_path), "boom")

    def loop(config):
        ckpt = train.get_checkpoint()
        start = ckpt.to_dict()["step"] + 1 if ckpt else 0
        for i in range(start, 3):
            train.report({"step": i},
                         checkpoint=Checkpoint.from_dict({"step": i}))
            if i == 0 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                raise RuntimeError("worker down")

    t0 = time.time()
    result = TorchTrainer(
        loop, train_loop_config={"marker": marker},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="traced", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)),
    ).fit()
    assert result.error is None
    spans = [(e["name"], e["ts"], e["dur"])
             for e in ray_tpu_torch.tracing.timeline()
             if e["cat"] == "span" and e["name"].startswith("train.")
             and e["ts"] >= t0 * 1e6]
    spans.sort(key=lambda s: s[1])
    assert [n for n, _, _ in spans] == [
        "train.executor_start", "train.checkpoint_register",
        "train.executor_shutdown",
        "train.executor_start", "train.checkpoint_register",
        "train.checkpoint_register", "train.executor_shutdown"]
    assert all(d >= 0 for _, _, d in spans)


def test_failure_exhausted_surfaces_error(runtime, tmp_path):
    def loop(config):
        raise RuntimeError("always fails")

    result = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="t5", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is not None


def test_torch_trainer_real_step(runtime, tmp_path):
    """End-to-end: a tiny torch train step inside the worker (one worker,
    no process group: a gang of one starts none)."""

    def loop(config):
        import torch
        import torch.distributed as dist

        w = torch.zeros(4, requires_grad=True)
        opt = torch.optim.SGD([w], lr=0.1)
        x = torch.ones(8, 4)
        y = torch.ones(8)
        for i in range(5):
            loss = torch.mean((x @ w - y) ** 2)
            opt.zero_grad()
            loss.backward()
            opt.step()
            train.report({"loss": float(loss),
                          "group": dist.is_initialized()})

    result = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="torch1", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None
    losses = [m["loss"] for m in result.metrics_history]
    assert losses[-1] < losses[0]
    assert not any(m["group"] for m in result.metrics_history)


def test_trainer_as_tune_trainable(runtime, tmp_path):
    from ray_tpu_torch import tune

    def loop(config):
        train.report({"final": config["lr"] * 10})

    trainer = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="tt", storage_path=str(tmp_path)))
    results = tune.Tuner(
        trainer.as_trainable(),
        param_space={"lr": tune.grid_search([0.1, 0.2])},
        tune_config=tune.TuneConfig(metric="final", mode="max"),
    ).fit()
    assert results.get_best_result().metrics["final"] == pytest.approx(2.0)


def test_uneven_worker_loops(runtime, tmp_path):
    """Regression: a worker finishing earlier than its peers must not
    deadlock the result pump (next_results used to re-poll drained
    workers)."""

    def loop(config):
        ctx = train.get_context()
        rounds = 2 if ctx.world_rank == 0 else 4
        for i in range(rounds):
            train.report({"i": i, "rank": ctx.world_rank})

    result = DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="uneven", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None
    # 2 lock-step rounds + 2 solo rounds from the longer worker
    assert len(result.metrics_history) == 4


# ------------------------------------------------------ the Torch backend


def test_scaling_config_leases_gpus():
    assert ScalingConfig().bundle() == {"CPU": 1}
    assert ScalingConfig(use_gpu=True).bundle() == {"CPU": 1, "GPU": 1}
    assert ScalingConfig(gpus_per_worker=2, cpus_per_worker=4).bundle() == \
        {"CPU": 4, "GPU": 2}
    assert RunConfig().resolved_storage_path().endswith(
        "ray_tpu_torch_results")


def test_gang_shares_one_gloo_group(runtime, tmp_path):
    """Two workers: one process group (gloo without GPUs), rank i is the
    worker's world rank, and an all-reduce sums over the gang."""

    def loop(config):
        import torch
        import torch.distributed as dist

        t = torch.tensor([float(train.get_world_rank() + 1)])
        dist.all_reduce(t)
        train.report({"backend": dist.get_backend(),
                      "rank": dist.get_rank(),
                      "world_rank": train.get_world_rank(),
                      "size": dist.get_world_size(), "sum": float(t)})

    result = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="gloo", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None
    assert result.metrics == {"backend": "gloo", "rank": 0, "world_rank": 0,
                              "size": 2, "sum": 3.0}


def test_gpu_worker_without_a_card_raises(runtime, tmp_path):
    """A GPU lease with no CUDA device behind it fails the run: no
    fallback to the CPU."""

    def loop(config):
        train.report({"ran": True})

    with pytest.raises(ray_tpu_torch.RayTaskError, match="no CUDA device"):
        TorchTrainer(
            loop, scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="nocard", storage_path=str(tmp_path)),
        ).fit()


def test_failed_process_group_fails_the_run(runtime, tmp_path, monkeypatch):
    """A gang that leases GPUs joins an NCCL group. One that cannot start
    (this CPU build of torch lacks NCCL) fails the run; it does not carry
    on over gloo. The card check is skipped here so that the fake leases
    reach the group."""
    from ray_tpu_torch.train import backend

    def loop(config):
        train.report({"ran": True})

    def no_card_check():
        pass

    monkeypatch.setattr(backend, "_setup_gpu", no_card_check)
    with pytest.raises(ray_tpu_torch.RayTaskError, match="NCCL"):
        TorchTrainer(
            loop, scaling_config=ScalingConfig(num_workers=2, use_gpu=True),
            run_config=RunConfig(name="nonccl", storage_path=str(tmp_path)),
        ).fit()
