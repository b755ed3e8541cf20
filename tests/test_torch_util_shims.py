"""The ray.util shims of the port: the ActorPool, Queue, multiprocessing
Pool and joblib cases of tests/test_util_shims.py on ray_tpu_torch."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.utils import ActorPool, Empty, Full, Queue
from ray_tpu_torch.utils.multiprocessing import Pool
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def rt():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class _Doubler:
    def double(self, v):
        return 2 * v

    def slow_double(self, v):
        time.sleep(0.05 * (v % 3))
        return 2 * v


def test_actor_pool_map_ordered(rt):
    pool = ActorPool([_Doubler.remote() for _ in range(2)])
    out = list(pool.map(lambda a, v: a.double.remote(v), range(8)))
    assert out == [2 * v for v in range(8)]


def test_actor_pool_map_unordered(rt):
    pool = ActorPool([_Doubler.remote() for _ in range(2)])
    out = list(pool.map_unordered(
        lambda a, v: a.slow_double.remote(v), range(6)))
    assert sorted(out) == [2 * v for v in range(6)]


def test_actor_pool_submit_get(rt):
    pool = ActorPool([_Doubler.remote()])
    pool.submit(lambda a, v: a.double.remote(v), 10)
    pool.submit(lambda a, v: a.double.remote(v), 20)  # queues (1 actor)
    assert pool.has_next()
    assert pool.get_next(timeout=60) == 20
    assert pool.get_next(timeout=60) == 40
    assert not pool.has_next()
    with pytest.raises(StopIteration):
        pool.get_next()


def test_actor_pool_push_pop(rt):
    a1, a2 = _Doubler.remote(), _Doubler.remote()
    pool = ActorPool([a1])
    assert pool.pop_idle() is a1
    assert pool.pop_idle() is None
    pool.push(a1)
    pool.push(a2)
    assert pool.has_free()


def test_actor_pool_error_does_not_strand_pool(rt):
    """A failed task's ref must leave the bookkeeping with its error;
    the next unordered get returns the OTHER task's result, not the
    already-consumed exception."""
    @ray_tpu_torch.remote
    class W:
        def work(self, v):
            if v == 0:
                raise ValueError("boom")
            return v

    pool = ActorPool([W.remote()])
    pool.submit(lambda a, v: a.work.remote(v), 0)
    pool.submit(lambda a, v: a.work.remote(v), 5)  # queued (1 actor)
    with pytest.raises(Exception):
        pool.get_next(timeout=60)
    assert pool.get_next_unordered(timeout=60) == 5
    assert not pool.has_next()


def test_queue_basic(rt):
    q = Queue(maxsize=2)
    q.put(1)
    q.put(2)
    assert q.qsize() == 2
    assert q.full()
    with pytest.raises(Full):
        q.put(3, block=False)
    assert q.get() == 1
    assert q.get() == 2
    assert q.empty()
    with pytest.raises(Empty):
        q.get(block=False)
    with pytest.raises(Empty):
        q.get(timeout=0.2)
    q.shutdown()


def test_queue_cross_task(rt):
    q = Queue()

    @ray_tpu_torch.remote
    def producer(q, n):
        for i in range(n):
            q.put(i)
        return n

    ray_tpu_torch.get(producer.remote(q, 5), timeout=60)
    got = [q.get(timeout=10) for _ in range(5)]
    assert got == [0, 1, 2, 3, 4]
    q.shutdown()


def _sq(x):
    return x * x


def _add(a, b):
    return a + b


def test_mp_pool_map_and_apply(rt):
    with Pool(processes=2) as p:
        assert p.map(_sq, range(10)) == [x * x for x in range(10)]
        assert p.apply(_add, (3, 4)) == 7
        r = p.apply_async(_add, (1, 2))
        assert r.get(timeout=60) == 3 and r.successful()
        assert p.starmap(_add, [(1, 2), (3, 4)]) == [3, 7]
        assert sorted(p.imap_unordered(_sq, range(6))) == \
            [x * x for x in range(6)]
        assert list(p.imap(_sq, range(6))) == [x * x for x in range(6)]


def test_mp_pool_close_semantics(rt):
    p = Pool(processes=1)
    p.close()
    with pytest.raises(ValueError):
        p.map(_sq, [1])
    p.join()
    p.terminate()


def test_joblib_backend(rt):
    joblib = pytest.importorskip("joblib")
    from ray_tpu_torch.utils import register_ray

    register_ray()
    with joblib.parallel_backend("ray"):
        out = joblib.Parallel(n_jobs=2)(
            joblib.delayed(_sq)(i) for i in range(8))
    assert out == [x * x for x in range(8)]
