"""The port's Data library (``ray_tpu_torch.data``) on its runtime: the
cases of tests/test_data.py, with ``test_iter_jax_batches`` as
``test_iter_torch_batches_cpu`` and ``test_dataset_feeds_trainer`` through
``TorchTrainer`` and ``iter_torch_batches(device="cpu")``."""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import data
from torch_port_util import deadline, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


@deadline(60)
def test_range_count_take(runtime):
    ds = data.range(100)
    assert ds.count() == 100
    assert ds.take(3) == [{"id": 0}, {"id": 1}, {"id": 2}]


@deadline(60)
def test_from_items_and_map(runtime):
    ds = data.from_items([{"x": i} for i in range(10)])
    out = ds.map(lambda r: {"x": r["x"] * 2}).take_all()
    assert [r["x"] for r in out] == [i * 2 for i in range(10)]


@deadline(60)
def test_map_batches_numpy(runtime):
    ds = data.range(32)
    out = ds.map_batches(lambda b: {"y": b["id"] * 10},
                         batch_size=8).take_all()
    assert sorted(r["y"] for r in out) == [i * 10 for i in range(32)]


@deadline(60)
def test_map_batches_pandas(runtime):
    ds = data.range(10)

    def f(df):
        df["z"] = df["id"] + 1
        return df

    out = ds.map_batches(f, batch_format="pandas").take_all()
    assert [r["z"] for r in out] == list(range(1, 11))


@deadline(60)
def test_filter_flat_map(runtime):
    ds = data.range(10).filter(lambda r: r["id"] % 2 == 0)
    assert ds.count() == 5
    ds2 = data.from_items([1, 2]).flat_map(lambda x: [x, x * 10])
    assert sorted(ds2.take_all()) == [1, 2, 10, 20]


@deadline(60)
def test_fusion_pipeline(runtime):
    # several chained one-to-one ops execute as one fused stage per block
    ds = (data.range(50)
          .map(lambda r: {"id": r["id"], "v": r["id"] * 2})
          .filter(lambda r: r["v"] >= 20)
          .map_batches(lambda b: {"v": b["v"] + 1}))
    vals = sorted(r["v"] for r in ds.take_all())
    assert vals == [i * 2 + 1 for i in range(10, 50)]


@deadline(60)
def test_repartition_and_num_blocks(runtime):
    ds = data.range(100, parallelism=10).repartition(4).materialize()
    assert ds.num_blocks() == 4
    assert ds.count() == 100


@deadline(60)
def test_random_shuffle_preserves_rows(runtime):
    ds = data.range(200).random_shuffle(seed=7)
    vals = [r["id"] for r in ds.take_all()]
    assert sorted(vals) == list(range(200))
    assert vals != list(range(200))  # actually shuffled


@deadline(60)
def test_sort(runtime):
    rng = np.random.default_rng(0)
    items = [{"k": int(v)} for v in rng.permutation(500)]
    ds = data.from_items(items, parallelism=8).sort("k")
    out = [r["k"] for r in ds.take_all()]
    assert out == sorted(out)
    out_desc = [r["k"] for r in
                data.from_items(items).sort("k", descending=True)
                .take_all()]
    assert out_desc == sorted(out_desc, reverse=True)


@deadline(60)
def test_groupby_aggregations(runtime):
    items = [{"g": i % 3, "v": float(i)} for i in range(30)]
    ds = data.from_items(items, parallelism=4)
    counts = {r["g"]: r["count()"] for r in ds.groupby("g").count()
              .take_all()}
    assert counts == {0: 10, 1: 10, 2: 10}
    sums = {r["g"]: r["sum(v)"] for r in ds.groupby("g").sum("v")
            .take_all()}
    assert sums[0] == sum(float(i) for i in range(0, 30, 3))
    means = {r["g"]: r["mean(v)"] for r in ds.groupby("g").mean("v")
             .take_all()}
    assert means[1] == pytest.approx(
        np.mean([float(i) for i in range(1, 30, 3)]))


@deadline(60)
def test_groupby_map_groups(runtime):
    items = [{"g": i % 2, "v": i} for i in range(10)]
    out = (data.from_items(items).groupby("g")
           .map_groups(lambda batch: {
               "g": batch["g"][:1], "total": np.asarray(
                   [batch["v"].sum()])}, batch_format="numpy")
           .take_all())
    totals = {r["g"]: r["total"] for r in out}
    assert totals == {0: 20, 1: 25}


@deadline(60)
def test_global_aggregates(runtime):
    ds = data.range(10)
    assert ds.sum("id") == 45
    assert ds.min("id") == 0
    assert ds.max("id") == 9
    assert ds.mean("id") == pytest.approx(4.5)


@deadline(60)
def test_limit_union_zip(runtime):
    assert data.range(100).limit(7).count() == 7
    u = data.range(5).union(data.range(3))
    assert u.count() == 8
    z = data.range(4).zip(
        data.range(4).map(lambda r: {"other": r["id"] * 100}))
    rows = z.take_all()
    assert rows[2]["id"] == 2 and rows[2]["other"] == 200


@deadline(60)
def test_iter_batches_rechunk(runtime):
    ds = data.range(100, parallelism=7)
    batches = list(ds.iter_batches(batch_size=32, batch_format="numpy"))
    sizes = [len(b["id"]) for b in batches]
    assert sizes == [32, 32, 32, 4]
    all_ids = np.concatenate([b["id"] for b in batches])
    assert sorted(all_ids.tolist()) == list(range(100))


@deadline(60)
def test_split_and_streaming_split(runtime):
    shards = data.range(100).split(4, equal=True)
    counts = [s.count() for s in shards]
    assert sum(counts) == 100
    assert max(counts) - min(counts) <= 1

    iters = data.range(64).streaming_split(2)
    seen = []
    for it in iters:
        for b in it.iter_batches(batch_size=16):
            seen.extend(b["id"].tolist())
    assert sorted(seen) == list(range(64))


@deadline(90)
def test_actor_pool_map_batches(runtime):
    class AddConst:
        def __init__(self, c):
            self.c = c

        def __call__(self, batch):
            return {"id": batch["id"] + self.c}

    ds = data.range(40, parallelism=4).map_batches(
        AddConst, fn_constructor_args=(5,),
        compute=data.ActorPoolStrategy(size=2))
    assert sorted(r["id"] for r in ds.take_all()) == \
        [i + 5 for i in range(40)]


@deadline(60)
def test_write_read_parquet_roundtrip(runtime, tmp_path):
    ds = data.range(50).map(lambda r: {"id": r["id"], "sq": r["id"] ** 2})
    out_dir = str(tmp_path / "pq")
    ds.write_parquet(out_dir)
    back = data.read_parquet(out_dir)
    assert back.count() == 50
    assert back.sum("sq") == sum(i ** 2 for i in range(50))


@deadline(60)
def test_write_read_csv_json(runtime, tmp_path):
    ds = data.from_items([{"a": i, "b": f"s{i}"} for i in range(10)])
    csv_dir, json_dir = str(tmp_path / "csv"), str(tmp_path / "json")
    ds.write_csv(csv_dir)
    ds.write_json(json_dir)
    assert data.read_csv(csv_dir).count() == 10
    back = data.read_json(json_dir).take_all()
    assert sorted(r["a"] for r in back) == list(np.arange(10))


@deadline(60)
def test_tensor_columns(runtime):
    arrs = np.stack([np.full((2, 3), i) for i in range(8)])
    ds = data.from_numpy(arrs)
    batch = next(ds.iter_batches(batch_size=8, batch_format="numpy"))
    assert batch["data"].shape == (8, 2, 3)
    assert (batch["data"][3] == 3).all()


@deadline(60)
def test_iter_torch_batches_cpu(runtime):
    ds = data.range(16)
    batch = next(iter(ds.iter_torch_batches(batch_size=16, device="cpu")))
    assert isinstance(batch["id"], torch.Tensor)
    assert batch["id"].device.type == "cpu"
    assert batch["id"].sum() == 120


@deadline(120)
def test_dataset_feeds_trainer(runtime, tmp_path):
    """Integration: ray_tpu_torch.data -> TorchTrainer ingest via dataset
    shards, each worker's batches as CPU tensors."""
    from ray_tpu_torch import train

    ds = data.range(64).map(lambda r: {"x": float(r["id"])})

    def loop(config):
        shard = train.get_dataset_shard("train")
        total = 0.0
        n = 0
        for b in shard.iter_torch_batches(batch_size=8, device="cpu"):
            assert b["x"].dtype == torch.float64
            total += float(b["x"].sum())
            n += len(b["x"])
        train.report({"total": total, "n": n})

    result = train.TorchTrainer(
        loop,
        scaling_config=train.ScalingConfig(num_workers=2),
        run_config=train.RunConfig(name="ingest",
                                   storage_path=str(tmp_path)),
        datasets={"train": ds},
    ).fit()
    assert result.error is None
    assert result.metrics["n"] == 32  # each worker sees half


@deadline(90)
def test_streaming_split_is_lazy(runtime, tmp_path, monkeypatch):
    """streaming_split must NOT materialize the dataset: with a stalled
    consumer, only the backpressure window's worth of map tasks run
    (ref: output_splitter backpressure, streaming_executor budgets)."""
    import time

    monkeypatch.setenv("RAY_TPU_DATA_INFLIGHT", "2")
    marker = tmp_path / "ran"

    def touch(batch):
        with open(marker, "a") as f:
            f.write("x\n")
        return batch

    ds = data.range(200, parallelism=20).map_batches(touch)
    (it,) = ds.streaming_split(1)
    gen = it.iter_batches(batch_size=10)
    first = next(gen)
    assert len(first["id"]) == 10
    time.sleep(1.0)  # let the pump run as far ahead as it can
    ran = marker.read_text().count("x")
    assert ran < 20, f"all {ran} map tasks ran despite stalled consumer"

    seen = list(first["id"]) + [v for b in gen for v in b["id"]]
    assert sorted(seen) == list(range(200))
    assert marker.read_text().count("x") == 20


@deadline(90)
def test_streaming_split_consumable_from_workers(runtime):
    """Split iterators are picklable and drainable inside worker
    processes (the Train ingest path)."""
    it1, it2 = data.range(48).streaming_split(2)

    @ray_tpu_torch.remote
    def consume(it):
        total = 0
        n = 0
        for b in it.iter_batches(batch_size=8):
            total += int(b["id"].sum())
            n += len(b["id"])
        return total, n

    (t1, n1), (t2, n2) = ray_tpu_torch.get(
        [consume.remote(it1), consume.remote(it2)], timeout=120)
    assert n1 + n2 == 48
    assert t1 + t2 == sum(range(48))
