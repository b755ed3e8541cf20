"""An aborted prefetch in the port's object plane, then a demand pull of
the same object from the same source: the mirror of
tests/test_locality.py::test_prefetch_abort_cleans_unsealed_entry, and
the same abort-then-pull loop repeated while another thread loads the
CPU. The aborted serve keeps streaming on the shared connection after
the abort; none of its late frames may land in the demand pull's
entry."""

import threading
import time

import numpy as np
import pytest

from ray_tpu_torch.core import protocol as P
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store import ShmObjectStore
from ray_tpu_torch.core.object_transfer import ObjectPuller, TransferServer
from torch_port_util import deadline

ARENA = 64 * 1024 * 1024
SIZE = 4 * 1024 * 1024  # four 1 MiB chunks


@pytest.fixture
def xfer():
    io = P.IOLoop("test-xfer-io")
    io.start()
    stores, servers = [], []

    def make_source():
        s = ShmObjectStore(f"rtpu_tl_{ObjectID.from_random().hex()[:8]}",
                           ARENA, create=True)

        def read(oid, _s=s):
            got = _s.get(oid)
            if got is None:
                return None
            d, m = got
            return d, bytes(m), (lambda: _s.release(oid))

        srv = TransferServer(io, read, advertise_ip="127.0.0.1")
        stores.append(s)
        servers.append(srv)
        return s, srv

    dst = ShmObjectStore(f"rtpu_tl_{ObjectID.from_random().hex()[:8]}",
                         ARENA, create=True)
    stores.append(dst)
    puller = ObjectPuller(io, dst)
    yield make_source, dst, puller
    puller.close()
    for srv in servers:
        srv.close()
    for s in stores:
        s.close()
    io.stop()


def _payload(nbytes, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes()


def _seed(store, oid, payload):
    buf = store.create(oid, len(payload))
    buf[:] = payload
    store.seal(oid)


def _fetch_bytes(store, oid):
    d, m = store.get(oid)
    out = bytes(d)
    del d, m
    store.release(oid)
    return out


def _abort_then_pull(puller, dst, srv, oid, payload, throttle_s):
    """Start a throttled prefetch, abort it once its first chunk landed,
    then demand-pull the object unthrottled over the same connection.
    Returns the bytes the demand pull sealed."""
    srv.throttle_s = throttle_s
    done = {}

    def prefetch():
        done["ok"] = puller.pull(oid, [srv.addr], timeout=60,
                                 size_hint=len(payload), prefetch=True)

    seen = puller.bytes_by_source.get(srv.addr, 0)
    t = threading.Thread(target=prefetch)
    t.start()
    until = time.monotonic() + 30
    while puller.bytes_by_source.get(srv.addr, 0) == seen and \
            time.monotonic() < until:
        time.sleep(0.001)
    assert puller.abort(oid) is True
    t.join(30)
    assert done.get("ok") is False
    assert not dst.contains(oid)
    # a demand pull (non-prefetch) is NOT abortable
    srv.throttle_s = 0.0
    assert puller.pull(oid, [srv.addr], timeout=60, size_hint=len(payload))
    return _fetch_bytes(dst, oid)


def _first_bad_byte(got, want):
    a, b = np.frombuffer(got, np.uint8), np.frombuffer(want, np.uint8)
    bad = np.flatnonzero(a != b)
    return int(bad[0]) if bad.size else None


@deadline(60)
def test_prefetch_abort_cleans_unsealed_entry(xfer):
    """PULL_ABORT mid-prefetch: the leader wakes, the created-but-
    unsealed arena entry is deleted, and a later demand pull starts
    clean and seals the object's own bytes."""
    make_source, dst, puller = xfer
    s1, srv1 = make_source()
    oid, payload = ObjectID.from_random(), _payload(SIZE, seed=12)
    _seed(s1, oid, payload)
    got = _abort_then_pull(puller, dst, srv1, oid, payload, 0.3)
    assert _first_bad_byte(got, payload) is None


@deadline(60)
def test_prefetch_abort_then_pull_loop_under_cpu_load(xfer):
    """The same abort-then-pull, 50 times over one connection while a
    second thread keeps the CPU busy: every demand pull seals exactly
    the source's bytes (the aborted serve's late chunks and its DONE
    must not complete the new entry)."""
    make_source, dst, puller = xfer
    s1, srv1 = make_source()
    stop = threading.Event()

    def burn():
        x = np.ones(1 << 16)
        while not stop.is_set():
            x = np.sqrt(x + 1.0)

    hog = threading.Thread(target=burn, daemon=True)
    hog.start()
    bad = []
    try:
        for i in range(50):
            oid, payload = ObjectID.from_random(), _payload(SIZE, seed=i)
            _seed(s1, oid, payload)
            got = _abort_then_pull(puller, dst, srv1, oid, payload, 0.01)
            first = _first_bad_byte(got, payload)
            if first is not None:
                bad.append((i, first))
            dst.delete(oid)
            s1.delete(oid)
    finally:
        stop.set()
        hog.join(10)
    assert bad == [], f"(round, first wrong byte): {bad}"
