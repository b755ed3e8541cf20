"""Every traffic mix is made again exactly from its seed and keeps to its
cell's ranges; different seeds reorder the same work."""

import numpy as np
import pytest

from benchmark import traffic

SEEDS = (0, 2 ** 31 + 11, 5_000_000_003)
REQUEST_MIXES = sorted(p.stem for p in (traffic.HERE / "traffic").glob("*.json")
                       if traffic.load(p.stem)["kind"] != "packed")


@pytest.mark.parametrize("seed", SEEDS)
def test_train_rows_reproducible_and_packed(seed):
    mix = traffic.load("packed-train")
    a = traffic.train_rows(mix, 32768, seed, 24)
    b = traffic.train_rows(mix, 32768, seed, 24)
    assert np.array_equal(a, b)
    assert a.shape == (24, mix["row_tokens"]) and a.dtype == np.int32
    body = a[a != mix["separator_id"]]
    assert body.min() >= mix["first_token_id"] and body.max() < 32768
    assert (a == mix["separator_id"]).any()
    assert not np.array_equal(a, traffic.train_rows(mix, 32768, seed + 1, 24))


def test_doc_lengths_in_range():
    spec = traffic.load("packed-train")["doc_tokens"]
    q = traffic.quantiles(spec, 4096)
    assert q.min() >= 64 and q.max() <= 16384
    assert abs(np.median(q) - spec["median"]) <= 2


@pytest.mark.parametrize("name", REQUEST_MIXES)
@pytest.mark.parametrize("seed", SEEDS)
def test_requests_reproducible_and_in_range(name, seed):
    mix = traffic.load(name)
    lengths = traffic.request_lengths(mix, seed, 300)
    assert lengths == traffic.request_lengths(mix, seed, 300)
    p = traffic.prompts(mix, 32000, seed, lengths[:20])
    q = traffic.prompts(mix, 32000, seed, lengths[:20])
    assert all(np.array_equal(x, y) for x, y in zip(p, q))
    assert [len(x) for x in p] == [n for n, _ in lengths[:20]]
    pt, ot = mix["prompt_tokens"], mix["output_tokens"]
    assert all(pt["min"] <= n <= pt["max"] and ot["min"] <= m <= ot["max"]
               for n, m in lengths)
    assert all(x.min() >= mix["first_token_id"] and x.max() < 32000
               for x in p)


@pytest.mark.parametrize("name", REQUEST_MIXES)
def test_seeds_reorder_the_same_pool(name):
    mix = traffic.load(name)
    n = mix["pool"]
    a = traffic.request_lengths(mix, 1, n)
    b = traffic.request_lengths(mix, 2, n)
    assert a != b
    assert sorted(x for x, _ in a) == sorted(x for x, _ in b)
    assert sorted(y for _, y in a) == sorted(y for _, y in b)


def test_chat_medians():
    mix = traffic.load("chat")
    p = traffic.quantiles(mix["prompt_tokens"], mix["pool"])
    o = traffic.quantiles(mix["output_tokens"], mix["pool"])
    assert 900 <= np.median(p) <= 1100 and 120 <= np.median(o) <= 136


@pytest.mark.parametrize("seed", SEEDS)
def test_arrivals(seed):
    due = traffic.arrivals(8.0, seed, -8.0, 30.0)
    assert np.array_equal(due, traffic.arrivals(8.0, seed, -8.0, 30.0))
    assert due.min() >= -8.0 and due.max() < 30.0
    assert np.all(np.diff(due) > 0)
    assert 0.8 * 8 * 38 <= len(due) <= 1.2 * 8 * 38
