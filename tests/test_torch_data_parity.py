"""The port's Data held against the reference's (``ray_tpu.data``) on the
same numpy-made blocks: the exchange's routing and merge functions
(repartition, seeded shuffle, sort with ties both ways, groupby) give the
same rows in the same partitions; the TFRecord codec writes the same bytes;
the aggregates agree. The reference's blocks are Arrow tables, the port's
numpy columns; both are built from the same arrays. End to end, a seeded
shuffle and a sort through the port's runtime equal the reference's
functions applied in process to the same blocks."""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu.data import block as ref_block
from ray_tpu.data import executor as ref_exec
from ray_tpu.data import grouped as ref_grouped
from ray_tpu.data import tfrecord as ref_tfrecord
from ray_tpu_torch import data
from ray_tpu_torch.data import block as port_block
from ray_tpu_torch.data import executor as port_exec
from ray_tpu_torch.data import grouped as port_grouped
from ray_tpu_torch.data import tfrecord as port_tfrecord
from torch_port_util import deadline, one_torch_thread  # noqa: F401

_SIZES = (37, 5, 53, 8, 61)


def _arrays(seed: int, sizes=_SIZES):
    """Per block: int keys with many ties, floats, strings and an int32
    tensor column [n, 3]."""
    rng = np.random.default_rng(seed)
    out, start = [], 0
    for n in sizes:
        out.append({
            "id": np.arange(start, start + n, dtype=np.int64),
            "k": rng.integers(0, 9, n).astype(np.int64),
            "v": rng.standard_normal(n),
            "s": np.asarray([f"s{int(x)}" for x in rng.integers(0, 5, n)]),
            "t": rng.integers(-50, 50, (n, 3)).astype(np.int32)})
        start += n
    return out


def _rows(pkg_block, block):
    """Rows with tensor cells as nested lists: the two packages' rows
    compare equal exactly when they hold the same values."""
    return [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in r.items()}
            for r in pkg_block.BlockAccessor(block).iter_rows()]


def _exchange(pkg_block, pkg_exec, blocks, kind, n_out, key, seed,
              descending):
    """The drain-based exchange in process with one package's kernels:
    sort samples its bounds, every input splits (seed + i), partition j
    merges its parts in input order; each partition's rows."""
    if kind == "sort":
        samples = [pkg_exec._sample_keys(b, key, 20) for b in blocks]
        flat = sorted(x for s in samples for x in s)
        step = max(1, len(flat) // n_out)
        part_key = (key, flat[step::step][:n_out - 1])
    else:
        part_key = key
    parts = [pkg_exec._split_for_partition(
        b, n_out, kind, seed if seed is None else seed + i, part_key)
        for i, b in enumerate(blocks)]
    out = [_rows(pkg_block, pkg_exec._merge_parts(
        kind, key, seed, descending, *[p[j] for p in parts]))
        for j in range(n_out)]
    if kind == "sort" and descending:
        out.reverse()
    return out


def _both(arrays):
    return ([ref_block.from_numpy(a) for a in arrays],
            [port_block.from_numpy(a) for a in arrays])


_CASES = [("repartition", 4, None, None, False),
          ("random_shuffle", 5, None, 11, False),
          ("random_shuffle", 3, None, 0, False),
          ("sort", 4, "k", None, False),
          ("sort", 4, "k", None, True),
          ("sort", 3, "s", None, True),
          ("groupby", 4, "k", None, False),
          ("groupby", 3, "s", None, False)]


@pytest.mark.parametrize("kind,n_out,key,seed,descending", _CASES)
def test_exchange_row_identical_to_reference(kind, n_out, key, seed,
                                             descending):
    ref_blocks, port_blocks = _both(_arrays(1))
    # the port's blocks take the columnar route, as the reference's
    for rb, pb in zip(ref_blocks, port_blocks):
        ra, pa_ = ref_block.BlockAccessor(rb), port_block.BlockAccessor(pb)
        if kind != "sort":
            assert port_exec._routing(pa_, n_out, kind, seed, key) == \
                ref_exec._routing(ra, n_out, kind, seed, key)
        assert pa_.key_column("k") == ra.key_column("k")
        assert pa_.key_column("t") is None and ra.key_column("t") is None
    want = _exchange(ref_block, ref_exec, ref_blocks, kind, n_out, key,
                     seed, descending)
    got = _exchange(port_block, port_exec, port_blocks, kind, n_out, key,
                    seed, descending)
    assert got == want
    flat = [r["id"] for part in got for r in part]
    assert sorted(flat) == list(range(sum(_SIZES)))
    if kind == "sort":
        keys = [r[key] for part in got for r in part]
        assert keys == sorted(keys, reverse=descending)
        ties = [r["id"] for part in got for r in part if r[key] == keys[0]]
        assert ties == sorted(ties)  # stable: ties keep input order


def test_sort_routing_identical_to_reference():
    ref_blocks, port_blocks = _both(_arrays(2))
    bounds = [2, 2, 5, 7]  # repeated bounds: ties at a boundary
    for rb, pb in zip(ref_blocks, port_blocks):
        assert port_exec._routing(port_block.BlockAccessor(pb), 5, "sort",
                                  None, ("k", bounds)) == \
            ref_exec._routing(ref_block.BlockAccessor(rb), 5, "sort", None,
                              ("k", bounds))


def test_tensor_key_takes_the_row_path_identically():
    """A callable key (here over the tensor column) has no columnar
    routing in either package; the row path routes the same rows to the
    same partitions."""
    ref_blocks, port_blocks = _both(_arrays(3, (12, 9)))
    key = (lambda r: int(r["t"][0]))  # a callable key
    for rb, pb in zip(ref_blocks, port_blocks):
        want = ref_exec._split_for_partition(rb, 3, "groupby", None, key)
        got = port_exec._split_for_partition(pb, 3, "groupby", None, key)
        assert [_rows(port_block, g) for g in got] == \
            [_rows(ref_block, w) for w in want]


def test_tfrecord_bytes_identical_to_reference(tmp_path):
    rng = np.random.default_rng(4)
    examples = [{"label": int(rng.integers(-2**40, 2**40)),
                 "weights": [float(x) for x in rng.standard_normal(5)],
                 "name": f"sample-{i}",
                 "raw": bytes(rng.integers(0, 256, 17, dtype=np.uint8)),
                 "ids": [int(x) for x in rng.integers(-9, 10**6, 4)]}
                for i in range(6)]
    payloads = [port_tfrecord.encode_example(e) for e in examples]
    assert payloads == [ref_tfrecord.encode_example(e) for e in examples]
    blob = bytes(rng.integers(0, 256, 4096, dtype=np.uint8))
    assert port_tfrecord.crc32c(blob) == ref_tfrecord.crc32c(blob)
    port_tfrecord.write_records(str(tmp_path / "p.tfrecords"), payloads)
    ref_tfrecord.write_records(str(tmp_path / "r.tfrecords"), payloads)
    assert (tmp_path / "p.tfrecords").read_bytes() == \
        (tmp_path / "r.tfrecords").read_bytes()
    back = port_tfrecord.read_records(str(tmp_path / "r.tfrecords"))
    assert [port_tfrecord.decode_example(p) for p in back] == \
        [ref_tfrecord.decode_example(p) for p in back]


def test_aggregates_equal_to_reference():
    arrays = _arrays(5, (40, 31, 29))
    ref_blocks, port_blocks = _both(arrays)

    def aggs(g):
        return [g._col_agg(None, "count"), g._col_agg("v", "sum"),
                g._col_agg("v", "min"), g._col_agg("v", "max"),
                g._col_agg("v", "mean"), g._col_agg("v", "std"),
                g._col_agg("id", "sum")]

    for key in ("k", "s"):
        want = [_rows(ref_block, ref_grouped._aggregate_partition(
            b, key, aggs(ref_grouped))) for b in ref_blocks]
        got = [_rows(port_block, port_grouped._aggregate_partition(
            b, key, aggs(port_grouped))) for b in port_blocks]
        assert got == want


@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


@deadline(120)
def test_runtime_shuffle_and_sort_equal_reference_functions(runtime):
    """End to end through the port's runtime (the pipelined exchange, its
    fold tree and merges in worker processes): each output block equals
    the reference's split and merge functions applied to the same input
    blocks; the global aggregates equal the reference's fold of per-block
    partials over the same rows."""
    arrays = _arrays(6, (40, 25, 33, 12, 50, 19, 44, 27, 36))
    ref_blocks, _ = _both(arrays)
    ds = data.from_numpy(arrays)
    n = len(arrays)
    for build, case in (
            (lambda d: d.random_shuffle(seed=123),
             ("random_shuffle", n, None, 123, False)),
            (lambda d: d.sort("k", descending=True),
             ("sort", n, "k", None, True)),
            (lambda d: d.repartition(4), ("repartition", 4, None, None,
                                         False))):
        got = [_rows(port_block, ray_tpu_torch.get(r, timeout=120))
               for r in build(ds).materialize()._refs()]
        want = _exchange(ref_block, ref_exec, ref_blocks, *case)
        assert got == want, case[0]
    # the reference's global aggregates (Dataset._column_reduce): a
    # partial over each block's rows, folded on the driver
    parts = [[r["v"] for r in ref_block.BlockAccessor(b).iter_rows()]
             for b in ref_blocks]
    flat = [x for p in parts for x in p]
    assert ds.sum("v") == sum(sum(p) for p in parts)
    assert ds.min("v") == min(min(p) for p in parts)
    assert ds.max("v") == max(max(p) for p in parts)
    assert ds.mean("v") == sum(sum(p) for p in parts) / len(flat)
    assert ds.std("v") == float(np.std(flat, ddof=1))
