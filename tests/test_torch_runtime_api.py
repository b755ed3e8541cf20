"""The port's runtime core through its public API (real worker processes):
the cases of tests/test_core_api.py against ``ray_tpu_torch``, and one
scenario run through ``ray_tpu`` and through ``ray_tpu_torch`` in turn,
whose results must be equal."""

import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.core.config import runtime_tmp_dir


@pytest.fixture(scope="module")
def rt():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def echo(x):
    return x


@ray_tpu_torch.remote
def add(a, b):
    return a + b


class TestTasks:
    def test_basic(self, rt):
        assert ray_tpu_torch.get(add.remote(1, 2), timeout=60) == 3

    def test_kwargs(self, rt):
        assert ray_tpu_torch.get(add.remote(1, b=5), timeout=60) == 6

    def test_many_parallel(self, rt):
        refs = [echo.remote(i) for i in range(100)]
        assert ray_tpu_torch.get(refs, timeout=60) == list(range(100))

    def test_large_result_via_shm(self, rt):
        @ray_tpu_torch.remote
        def big():
            return np.ones(1_000_000, dtype=np.float32)

        out = ray_tpu_torch.get(big.remote(), timeout=60)
        assert out.shape == (1_000_000,) and out[0] == 1.0

    def test_large_arg_by_ref(self, rt):
        arr = np.arange(500_000, dtype=np.float64)
        ref = ray_tpu_torch.put(arr)
        total = ray_tpu_torch.get(
            ray_tpu_torch.remote(lambda x: float(np.sum(x))).remote(ref),
            timeout=60)
        assert total == float(arr.sum())

    def test_multiple_returns(self, rt):
        @ray_tpu_torch.remote(num_returns=2)
        def two():
            return 1, 2

        a, b = two.remote()
        assert ray_tpu_torch.get(a, timeout=60) == 1
        assert ray_tpu_torch.get(b, timeout=60) == 2

    def test_error_propagation(self, rt):
        @ray_tpu_torch.remote(max_retries=0)
        def boom():
            raise ValueError("expected-failure")

        with pytest.raises(ray_tpu_torch.RayTaskError) as ei:
            ray_tpu_torch.get(boom.remote(), timeout=60)
        assert "expected-failure" in str(ei.value)

    def test_nested_submission(self, rt):
        @ray_tpu_torch.remote
        def outer(n):
            return sum(ray_tpu_torch.get([echo.remote(i) for i in range(n)],
                                         timeout=60))

        assert ray_tpu_torch.get(outer.remote(5), timeout=120) == 10

    def test_ref_in_datastructure(self, rt):
        ref = ray_tpu_torch.put(41)

        @ray_tpu_torch.remote
        def unwrap(d):
            return ray_tpu_torch.get(d["ref"], timeout=60) + 1

        assert ray_tpu_torch.get(unwrap.remote({"ref": ref}),
                                 timeout=60) == 42

    def test_wait(self, rt):
        @ray_tpu_torch.remote
        def slow(t):
            time.sleep(t)
            return t

        fast, stuck = slow.remote(0.01), slow.remote(10)
        ready, rest = ray_tpu_torch.wait([fast, stuck], num_returns=1,
                                         timeout=30)
        assert ready == [fast] and rest == [stuck]
        ray_tpu_torch.cancel(stuck, force=True)

    def test_get_timeout(self, rt):
        @ray_tpu_torch.remote
        def hang():
            time.sleep(30)

        ref = hang.remote()
        with pytest.raises(ray_tpu_torch.GetTimeoutError):
            ray_tpu_torch.get(ref, timeout=0.2)
        ray_tpu_torch.cancel(ref, force=True)

    def test_options_override(self, rt):
        f = echo.options(name="renamed")
        assert ray_tpu_torch.get(f.remote("v"), timeout=60) == "v"

    def test_direct_call_rejected(self, rt):
        with pytest.raises(TypeError):
            echo(1)


class TestActors:
    def test_counter(self, rt):
        @ray_tpu_torch.remote
        class Counter:
            def __init__(self):
                self.v = 0

            def inc(self):
                self.v += 1
                return self.v

        c = Counter.remote()
        assert ray_tpu_torch.get([c.inc.remote() for _ in range(5)],
                                 timeout=60) == [1, 2, 3, 4, 5]

    def test_ordering(self, rt):
        @ray_tpu_torch.remote
        class Log:
            def __init__(self):
                self.items = []

            def append(self, x):
                self.items.append(x)

            def get(self):
                return self.items

        log = Log.remote()
        for i in range(20):
            log.append.remote(i)
        assert ray_tpu_torch.get(log.get.remote(),
                                 timeout=60) == list(range(20))

    def test_actor_error(self, rt):
        @ray_tpu_torch.remote
        class Bad:
            def fail(self):
                raise RuntimeError("actor-method-error")

            def ok(self):
                return "fine"

        b = Bad.remote()
        with pytest.raises(ray_tpu_torch.RayTaskError):
            ray_tpu_torch.get(b.fail.remote(), timeout=60)
        # actor survives method errors
        assert ray_tpu_torch.get(b.ok.remote(), timeout=60) == "fine"

    def test_constructor_error(self, rt):
        @ray_tpu_torch.remote
        class Broken:
            def __init__(self):
                raise ValueError("ctor-fail")

            def m(self):
                return 1

        h = Broken.remote()
        with pytest.raises((ray_tpu_torch.ActorDiedError,
                            ray_tpu_torch.RayTaskError)):
            ray_tpu_torch.get(h.m.remote(), timeout=60)

    def test_named_actor(self, rt):
        @ray_tpu_torch.remote
        class Registry:
            def ping(self):
                return "pong"

        Registry.options(name="reg1").remote()
        time.sleep(0.5)
        h = ray_tpu_torch.get_actor("reg1")
        assert ray_tpu_torch.get(h.ping.remote(), timeout=60) == "pong"

    def test_handle_passing(self, rt):
        @ray_tpu_torch.remote
        class Store:
            def __init__(self):
                self.v = None

            def set(self, v):
                self.v = v

            def get(self):
                return self.v

        @ray_tpu_torch.remote
        def writer(handle, v):
            ray_tpu_torch.get(handle.set.remote(v), timeout=60)
            return True

        s = Store.remote()
        assert ray_tpu_torch.get(writer.remote(s, 123), timeout=120)
        assert ray_tpu_torch.get(s.get.remote(), timeout=60) == 123

    def test_async_actor(self, rt):
        @ray_tpu_torch.remote
        class AsyncActor:
            async def work(self, x):
                import asyncio

                await asyncio.sleep(0.01)
                return x * 2

        a = AsyncActor.remote()
        assert ray_tpu_torch.get(a.work.remote(21), timeout=60) == 42

    def test_kill(self, rt):
        @ray_tpu_torch.remote
        class Victim:
            def ping(self):
                return "pong"

        v = Victim.remote()
        assert ray_tpu_torch.get(v.ping.remote(), timeout=60) == "pong"
        ray_tpu_torch.kill(v)
        with pytest.raises((ray_tpu_torch.ActorDiedError,
                            ray_tpu_torch.ActorUnavailableError)):
            ray_tpu_torch.get(v.ping.remote(), timeout=60)


class TestObjects:
    def test_put_get_roundtrip_types(self, rt):
        for val in [1, "s", {"a": [1, 2]}, None, (1, 2),
                    np.arange(10)]:
            out = ray_tpu_torch.get(ray_tpu_torch.put(val), timeout=60)
            if isinstance(val, np.ndarray):
                assert np.array_equal(out, val)
            else:
                assert out == val

    def test_double_get_same_value(self, rt):
        ref = ray_tpu_torch.put([1, 2, 3])
        assert ray_tpu_torch.get(ref, timeout=60) == \
            ray_tpu_torch.get(ref, timeout=60)

    def test_put_of_ref_rejected(self, rt):
        with pytest.raises(TypeError):
            ray_tpu_torch.put(ray_tpu_torch.put(1))

    def test_cluster_resources(self, rt):
        res = ray_tpu_torch.cluster_resources()
        assert res["CPU"] == 4.0
        assert "GPU" not in res and "TPU" not in res


class TestTaskChaining:
    """Submitter-side dependency resolution (regression: tasks whose args
    were pending upstream outputs hung forever — the inline result was never
    promoted to shm for the downstream worker)."""

    def test_pending_output_as_arg(self, rt):
        @ray_tpu_torch.remote
        def inc(x):
            return x + 1

        refs = [inc.remote(i) for i in range(8)]
        chained = [inc.remote(r) for r in refs]
        assert ray_tpu_torch.get(chained, timeout=60) == list(range(2, 10))

    def test_deep_chain(self, rt):
        @ray_tpu_torch.remote
        def inc(x):
            return x + 1

        r = inc.remote(0)
        for _ in range(10):
            r = inc.remote(r)
        assert ray_tpu_torch.get(r, timeout=60) == 11

    def test_error_propagates_to_dependents(self, rt):
        @ray_tpu_torch.remote(max_retries=0)
        def boom():
            raise ValueError("chained-err")

        @ray_tpu_torch.remote
        def inc(x):
            return x + 1

        with pytest.raises(ray_tpu_torch.RayTaskError) as ei:
            ray_tpu_torch.get(inc.remote(boom.remote()), timeout=60)
        assert "chained-err" in str(ei.value)

    def test_actor_method_with_pending_arg(self, rt):
        @ray_tpu_torch.remote
        def slow(x):
            time.sleep(0.5)
            return x

        @ray_tpu_torch.remote
        class Doubler:
            def use(self, v):
                return v * 2

        d = Doubler.remote()
        assert ray_tpu_torch.get(d.use.remote(slow.remote(21)),
                                 timeout=60) == 42


def test_bind_names_the_missing_dag_port(rt):
    """dag/ is ported: bind() builds the reference's node types, and
    they execute on the port's runtime."""
    from ray_tpu_torch.dag import ClassNode, FunctionNode

    node = echo.bind(1)
    assert isinstance(node, FunctionNode)
    assert ray_tpu_torch.get(node.execute(), timeout=60) == 1

    @ray_tpu_torch.remote
    class Node:
        def get(self, x):
            return x

    cls_node = Node.bind()
    assert isinstance(cls_node, ClassNode)
    assert ray_tpu_torch.get(cls_node.get.bind(node).execute(),
                             timeout=60) == 1


def test_session_lives_under_the_temp_directory(rt):
    """The session directory, its sockets and its logs lie under this
    process's temp directory (TMPDIR), where two checkouts' runs on one
    host never meet."""
    session = rt.ctx.session_dir
    assert Path(session).parent == Path(tempfile.gettempdir(),
                                        "ray_tpu_torch")
    assert Path(session, "head.sock").is_socket()
    assert Path(session, "logs").is_dir()


def test_a_temp_directory_too_long_for_sockets_falls_back(monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", "/t" + "x" * 80)
    assert runtime_tmp_dir() == "/tmp/ray_tpu_torch"
    monkeypatch.setattr(tempfile, "tempdir", "/short")
    assert runtime_tmp_dir() == "/short/ray_tpu_torch"


# ------------------------------------------------ the differential scenario
#
# Plain module-level definitions, wrapped by each package's ``remote``: the
# same code runs on both runtimes.


def _square(x):
    return x * x


def _divmod(a, b):
    return a // b, a % b


def _fail(msg):
    raise ValueError(msg)


def _nested_sum(pkg_name, refs):
    import importlib

    pkg = importlib.import_module(pkg_name)
    return float(sum(np.sum(pkg.get(r, timeout=60)) for r in refs["arrays"]))


class _Account:
    def __init__(self, balance):
        self.balance = balance

    def deposit(self, amount):
        self.balance += amount
        return self.balance

    def withdraw(self, amount):
        if amount > self.balance:
            raise RuntimeError(f"insufficient funds: {self.balance} < "
                               f"{amount}")
        self.balance -= amount
        return self.balance


def _error_of(pkg, ref):
    with pytest.raises(pkg.RayTaskError) as ei:
        pkg.get(ref, timeout=60)
    return type(ei.value).__name__, type(ei.value.cause).__name__, \
        str(ei.value.cause)


def _scenario(pkg):
    """Task results, actor state, exception types and messages, and put/get
    of numpy values, as plain data."""
    rng = np.random.default_rng(0)
    out = {}
    square = pkg.remote(_square)
    out["squares"] = pkg.get([square.remote(i) for i in range(6)],
                             timeout=60)
    out["divmod"] = pkg.get(list(pkg.remote(num_returns=2)(_divmod)
                                 .remote(17, 5)), timeout=60)
    out["chain"] = pkg.get(square.remote(square.remote(3)), timeout=60)
    acct = pkg.remote(_Account).remote(100)
    out["deposits"] = pkg.get([acct.deposit.remote(i) for i in range(1, 5)],
                              timeout=60)
    out["actor_error"] = _error_of(pkg, acct.withdraw.remote(1_000))
    out["after_error"] = pkg.get(acct.withdraw.remote(10), timeout=60)
    out["task_error"] = _error_of(
        pkg, pkg.remote(max_retries=0)(_fail).remote("bad input 7"))
    values = [rng.normal(size=(64, 32)).astype(np.float32),
              rng.integers(0, 1 << 30, size=300_000, dtype=np.int64),
              np.arange(24, dtype=np.float64).reshape(2, 3, 4)[:, ::2]]
    got = pkg.get([pkg.put(v) for v in values], timeout=60)
    out["put_get"] = [(g.dtype.str, g.shape, g.tobytes()) for g in got]
    refs = {"arrays": [pkg.put(v) for v in values[:2]]}
    out["nested"] = pkg.get(pkg.remote(_nested_sum).remote(pkg.__name__,
                                                            refs),
                            timeout=60)
    pkg.kill(acct)
    return out


def test_same_scenario_through_reference_and_port(rt):
    ray_tpu_torch_out = _scenario(ray_tpu_torch)
    ray_tpu.init(num_cpus=4, num_tpus=0)
    try:
        ray_tpu_out = _scenario(ray_tpu)
    finally:
        ray_tpu.shutdown()
    assert ray_tpu_torch_out == ray_tpu_out
    assert ray_tpu_out["actor_error"] == (
        "RayTaskError", "RuntimeError", "insufficient funds: 110 < 1000")
    assert ray_tpu_out["task_error"] == ("RayTaskError", "ValueError",
                                         "bad input 7")
