"""The port's pipelined exchange (``ray_tpu_torch.data.executor`` on
``ray_tpu_torch.core.task_graph``): the cases of tests/test_data_shuffle.py
(the task graph, row identity against the drain-based exchange, the
eager-free footprint bound, arena-fill backpressure, the prefetch opt-out,
the streamed actor pool, limit). Its 2-node smoke is in
tests/test_torch_data_cluster.py; its bench_data.py smoke waits for the
port's benches."""

import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data, state
from ray_tpu_torch.core.task_graph import Port, TaskGraphExecutor, TaskNode
from ray_tpu_torch.data import executor as dx
from ray_tpu_torch.data.block import BlockAccessor
from torch_port_util import deadline, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ray_start():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield info
    ray_tpu_torch.shutdown()


# ================================================== task graph (pure)


class TestTaskGraph:
    def test_dep_gating_and_lane_order(self):
        g = TaskGraphExecutor()
        log = []
        g.add_value("in", "X")
        g.add(TaskNode("a", lambda x: log.append(("a", x)) or "A",
                       ["in"], lane=0))
        g.add(TaskNode("b", lambda a: log.append(("b", a)) or "B",
                       ["a"], lane=1, keep=True))
        assert g.run() == {"b": "B"}
        assert log == [("a", "X"), ("b", "A")]

    def test_lane_head_blocks_rest(self):
        g = TaskGraphExecutor()
        order = []
        g.add(TaskNode("late", lambda x: order.append("late"),
                       ["dep"], lane="L"))
        g.add(TaskNode("early", lambda: order.append("early"),
                       lane="L"))
        assert g.pump() == 0  # head of lane gated -> lane stalls
        g.add_value("dep", 1)
        g.pump()
        assert order == ["late", "early"]

    def test_port_release_is_per_column(self):
        g = TaskGraphExecutor()
        g.add(TaskNode("s", lambda: ["p0", "p1"]))
        g.pump()
        g.add(TaskNode("m0", lambda p: p, [Port("s", 0)], keep=True))
        g.pump()
        # port 0 freed at its consumer's submission; port 1 must
        # survive until ITS (later-added) consumer submits
        assert g.value("s") == [None, "p1"]
        g.add(TaskNode("m1", lambda p: p, [Port("s", 1)], keep=True))
        kept = g.run()
        assert kept == {"m0": "p0", "m1": "p1"}

    def test_whole_value_freed_at_last_consumer(self):
        g = TaskGraphExecutor()
        g.add(TaskNode("a", lambda: "A"))
        g.add(TaskNode("c1", lambda a: a + "1", ["a"], keep=True))
        g.add(TaskNode("c2", lambda a: a + "2", ["a"], keep=True))
        g.pump()
        assert g.value("a") is None  # both consumers submitted
        assert g.run() == {"c1": "A1", "c2": "A2"}

    def test_wedge_detected(self):
        g = TaskGraphExecutor()
        g.add(TaskNode("x", lambda d: d, ["never"]))
        with pytest.raises(RuntimeError, match="wedged"):
            g.run()

    def test_duplicate_key_rejected(self):
        g = TaskGraphExecutor()
        g.add(TaskNode("x", lambda: 1))
        with pytest.raises(ValueError, match="duplicate"):
            g.add(TaskNode("x", lambda: 2))
        with pytest.raises(ValueError, match="duplicate"):
            g.add_value("x", 3)


# ============================== equivalence vs the drain-based exchange


def _blocks_of(ds):
    return [BlockAccessor(ray_tpu_torch.get(r, timeout=600)).to_pylist()
            for r in ds._refs()]


def _baseline_exchange(in_blocks, kind, n_out, key, seed, descending):
    """The pre-r17 drain-based exchange, simulated in-process with the
    SAME split/merge kernels: split every input, merge partition j over
    parts (0..n_in-1, j) in input order, one task per partition. The
    pipelined exchange must be row-identical to this, block by block."""
    from ray_tpu_torch.data.block import build_block
    from ray_tpu_torch.data.executor import _merge_parts, _sample_keys, \
        _split_for_partition

    if kind == "sort":
        samples = [_sample_keys(build_block(b), key, 20)
                   for b in in_blocks]
        flat = sorted(x for s in samples for x in s)
        step = max(1, len(flat) // n_out)
        part_key = (key, flat[step::step][:n_out - 1])
    else:
        part_key = key
    parts = []
    for i, b in enumerate(in_blocks):
        s = seed if seed is None else seed + i
        parts.append(_split_for_partition(build_block(b), n_out, kind,
                                          s, part_key))
    out = []
    for j in range(n_out):
        out.append(BlockAccessor(_merge_parts(
            kind, key, seed, descending,
            *[p[j] for p in parts])).to_pylist())
    if kind == "sort" and descending:
        out.reverse()
    return out


@deadline(120)
def test_repartition_row_identical(ray_start):
    base = data.from_items([{"x": i} for i in range(97)],
                           parallelism=6).materialize()
    got = _blocks_of(base.repartition(4).materialize())
    want = _baseline_exchange(_blocks_of(base), "repartition", 4,
                              None, None, False)
    assert got == want


@deadline(120)
def test_random_shuffle_row_identical(ray_start):
    base = data.from_items([{"x": i} for i in range(200)],
                           parallelism=7).materialize()
    got = _blocks_of(base.random_shuffle(seed=11).materialize())
    want = _baseline_exchange(_blocks_of(base), "random_shuffle",
                              7, None, 11, False)
    assert got == want
    flat = [r["x"] for b in got for r in b]
    assert sorted(flat) == list(range(200)) and \
        flat != list(range(200))


@pytest.mark.parametrize("descending", [False, True])
@deadline(120)
def test_sort_row_identical(ray_start, descending):
    rng = np.random.default_rng(3)
    items = [{"k": int(v)} for v in rng.permutation(300)]
    base = data.from_items(items, parallelism=5).materialize()
    got = _blocks_of(base.sort("k", descending=descending)
                     .materialize())
    want = _baseline_exchange(_blocks_of(base), "sort",
                              5, "k", None, descending)
    assert got == want
    flat = [r["k"] for b in got for r in b]
    assert flat == sorted(flat, reverse=descending)


@deadline(120)
def test_pipelined_vs_legacy_executor_row_identical(ray_start):
    """End-to-end cross-check: the SAME dataset run through the
    pipelined exchange and through the preserved pre-r17 executor
    (``data_shuffle_pipelined=False`` — drain + row kernels) produces
    identical blocks, kind by kind."""
    from ray_tpu_torch.core.config import get_config

    cfg = get_config()
    base = data.from_items(
        [{"k": (i * 37) % 50, "v": i} for i in range(150)],
        parallelism=6).materialize()
    for build in (lambda d: d.repartition(4),
                  lambda d: d.random_shuffle(seed=13),
                  lambda d: d.sort("k"),
                  lambda d: d._with_all_to_all("groupby", key="k")):
        cfg.data_shuffle_pipelined = True
        got = _blocks_of(build(base).materialize())
        cfg.data_shuffle_pipelined = False
        try:
            want = _blocks_of(build(base).materialize())
        finally:
            cfg.data_shuffle_pipelined = True
        assert got == want


@deadline(120)
def test_groupby_row_identical_cross_process_routing(ray_start):
    # keys route via _det_hash (crc32 over pickle), so the partition a
    # group lands in is identical across worker interpreters AND in
    # this in-process baseline
    items = [{"g": i % 7, "v": i} for i in range(140)]
    base = data.from_items(items, parallelism=4).materialize()
    got = _blocks_of(
        base._with_all_to_all("groupby", key="g").materialize())
    want = _baseline_exchange(_blocks_of(base), "groupby",
                              4, "g", None, False)
    assert got == want
    # every group lives in exactly one output partition
    for g in range(7):
        holders = [j for j, b in enumerate(got)
                   if any(r["g"] == g for r in b)]
        assert len(holders) == 1, (g, holders)


# ========================================= footprint + backpressure


@deadline(120)
def test_exchange_footprint_bounded(ray_start, monkeypatch):
    """Eager free bounds intermediate store entries at
    O(n_out x (window + fanin)), not O(n_in x n_out). A/B on the SAME
    runtime: the drain-equivalent configuration (window and fan-in
    effectively infinite — no admission gating, no folds, every part
    held to its terminal merge: the pre-r17 algorithm) vs the pipelined
    defaults. The borrow-grace window is shrunk so the store sampler
    observes true liveness instead of the ~1s free-deferral tail."""
    monkeypatch.setenv("RAY_TPU_DATA_INFLIGHT", "3")
    from ray_tpu_torch.core.config import get_config
    from ray_tpu_torch.core.context import get_context

    monkeypatch.setattr(get_context().ref_counter, "_grace_s", 0.1)
    cfg = get_config()
    n_in, n_out = 32, 4
    pad = np.zeros(40_000, np.uint8)

    def fatten(b):
        time.sleep(0.1)  # pace the stream (a real read stage is IO-paced)
        return {"id": b["id"], "pad": np.stack([pad] * len(b["id"]))}

    def run_once(window, fanin):
        monkeypatch.setattr(cfg, "data_shuffle_inflight_window", window)
        monkeypatch.setattr(cfg, "data_shuffle_merge_fanin", fanin)
        peak = [0]
        stop = threading.Event()

        def sample():
            while not stop.is_set():
                try:
                    n = len(state.list_objects(limit=4000))
                except Exception:  # noqa: BLE001 — shutdown race
                    break
                peak[0] = max(peak[0], n)
                time.sleep(0.05)

        t = threading.Thread(target=sample, daemon=True)
        t.start()
        rows = data.range(n_in, parallelism=n_in).map_batches(fatten) \
            .repartition(n_out).take_all()
        stop.set()
        t.join(timeout=5)
        assert sorted(r["id"] for r in rows) == list(range(n_in))
        return peak[0]

    before = dict(dx.SHUFFLE_STATS)
    drain_peak = run_once(10**6, 10**6)
    time.sleep(1)  # let the previous run's tail free
    pipe_peak = run_once(2, 8)
    # drain holds all n_in x n_out parts + inputs at merge time
    # (measured ~130-160 entries here); the pipelined exchange's live
    # set is window/fanin-bounded and independent of n_in (~60)
    assert drain_peak >= n_in, drain_peak  # sampler saw the A leg
    assert pipe_peak <= max(0.7 * drain_peak, 40), \
        f"pipelined peak {pipe_peak} not below drain peak {drain_peak}"
    d = {k: dx.SHUFFLE_STATS[k] - before.get(k, 0)
         for k in dx.SHUFFLE_STATS}
    assert d["splits"] == 2 * n_in
    assert d["parts_freed_eagerly"] >= 2 * n_in * n_out
    assert d["exchanges"] == 2


@deadline(120)
def test_max_store_fill_reads_real_gauges(ray_start):
    """_max_store_fill must read the reporter gauges off the STATE-API
    node rows (the `ray_tpu_torch.nodes()` NODE_INFO reply carries no
    telemetry — reading it there silently disables backpressure)."""
    ref = ray_tpu_torch.put(np.zeros(48 << 20, np.uint8))  # ~9% of the arena
    deadline = time.monotonic() + 10  # reporter publishes every ~2s
    fill = 0.0
    while time.monotonic() < deadline:
        dx._fill_cache["ts"] = 0.0  # bypass the 0.2s cache
        fill = dx._max_store_fill()
        if fill > 0.05:
            break
        time.sleep(0.3)
    assert 0.05 < fill < 1.0, fill
    del ref


@deadline(120)
def test_backpressure_pauses_on_store_fill(ray_start, monkeypatch):
    """While the (mocked) node store-fill gauge reads above the
    high-water fraction, split admission pauses; admission resumes when
    it drops and the exchange still produces correct output."""
    fills = iter([0.99, 0.99, 0.99, 0.0])
    monkeypatch.setattr(dx, "_max_store_fill",
                        lambda: next(fills, 0.0))
    before = dx.SHUFFLE_STATS["backpressure_pauses"]
    out = data.range(40, parallelism=4).random_shuffle(seed=3) \
        .take_all()
    assert sorted(r["id"] for r in out) == list(range(40))
    assert dx.SHUFFLE_STATS["backpressure_pauses"] > before


@deadline(120)
def test_shuffle_summary_surfaces(ray_start):
    data.range(20, parallelism=2).repartition(2).take_all()
    s = state.data_shuffle_summary()
    assert s["driver"]["exchanges"] >= 1
    assert s["driver"]["splits"] >= 2


# ================================= prefetch opt-out (hint A/B control)


@deadline(120)
def test_prefetch_args_optout_filters_hint_ids(ray_start):
    from ray_tpu_torch.core.context import get_context
    from ray_tpu_torch.core.task_spec import ARG_REF

    ctx = get_context()

    class _Spec:
        def __init__(self, ids, prefetch_args=True):
            self.args = [(ARG_REF, i, "own") for i in ids]
            self.prefetch_args = prefetch_args

    class _Holder:
        hinted = None

    sent = []

    class _Recorder:
        def is_attached(self):
            return True

        def send(self, *frame):
            sent.append(frame)

    real_head = ctx.head
    ctx.head = _Recorder()
    try:
        from ray_tpu_torch.core.config import get_config

        cfg = get_config()
        coalesce = cfg.prefetch_hint_coalesce
        cfg.prefetch_hint_coalesce = False
        try:
            ctx._send_prefetch_hint(
                _Holder(), [_Spec([b"a"], prefetch_args=False),
                            _Spec([b"b"])], "lease-1")
        finally:
            cfg.prefetch_hint_coalesce = coalesce
    finally:
        ctx.head = real_head
    assert len(sent) == 1
    assert sent[0][2] == [b"b"], sent  # opted-out spec's id filtered

    # all specs opted out -> no frame at all
    sent.clear()
    ctx2_head = ctx.head
    ctx.head = _Recorder()
    try:
        ctx._send_prefetch_hint(
            _Holder(), [_Spec([b"c"], prefetch_args=False)], "lease-2")
    finally:
        ctx.head = ctx2_head
    assert not sent


@deadline(120)
def test_shuffle_hint_knob_reaches_merge_specs(ray_start):
    """data_shuffle_prefetch_hints=False submits merges/folds with
    prefetch_args=False (observed via the RemoteFunction option)."""
    f = ray_tpu_torch.remote(lambda x: x)
    assert f._prefetch_args is True
    g = f.options(prefetch_args=False)
    assert g._prefetch_args is False
    # options() without the key preserves the opt-out
    assert g.options(name="z")._prefetch_args is False


# ======================================= streamed actor pool / limit


@deadline(120)
def test_actor_pool_streams_and_retires(ray_start):
    class AddOne:
        def __call__(self, batch):
            return {"id": batch["id"] + 1}

    ds = data.range(24, parallelism=6).map_batches(
        AddOne, compute=data.ActorPoolStrategy(size=2))
    out = sorted(r["id"] for r in ds.take_all())
    assert out == [i + 1 for i in range(24)]
    # pool actors retire once their last block completed (background
    # waiters) — poll the state API until both are DEAD
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        rows = state.list_actors(limit=100)
        pool = [r for r in rows if r["class_name"] == "_PoolWorker"]
        if pool and all(r["state"] == "DEAD" for r in pool):
            break
        time.sleep(0.2)
    else:
        pytest.fail(f"pool actors not retired: {pool}")


@deadline(120)
def test_limit_prefix_batched(ray_start):
    # exact prefix semantics survive the batched-count rewrite
    rows = data.range(100, parallelism=10).limit(25).take_all()
    assert [r["id"] for r in rows] == list(range(25))
    assert data.range(30, parallelism=3).limit(30).count() == 30
    assert data.range(10, parallelism=2).limit(0).count() == 0
