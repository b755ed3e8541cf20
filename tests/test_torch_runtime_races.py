"""Two orderings of ray_tpu_torch's runtime that a busy cluster tests.

- A task's plasma return reaches its owner in the task's reply, on the
  executing worker's connection to the owner, while the head learns of the
  object from the worker's OBJECT_SEALED, on the worker's connection to the
  head. The owner then pulls the return through the head at once. The
  worker's seal report is a call that the head answers after recording the
  seal, so the head knows the object before the reply leaves, however late
  it handles the report.
- A connection's sender holds its write lock while it drains the queue. The
  garbage collector may run a finalizer in that thread mid-drain (an
  ObjectRef's __del__ sending its free on the same connection): that send
  queues its frame, which the drain sends, instead of waiting for the lock
  its own thread holds.
- While one thread imports torch, ``sys.modules["torch"]`` holds a module
  without its attributes yet. Another thread that serializes a value then
  asks for a tensor only of an object whose type comes from torch, instead
  of reading ``torch.Tensor`` off that module.
"""

import socket
import sys
import threading
import types

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.core import protocol as P
from ray_tpu_torch.core.api import NodeAffinitySchedulingStrategy
from ray_tpu_torch.core.head import Head
from torch_port_util import deadline, ray_start_cluster  # noqa: F401


class _Ones:
    def make(self, n: int):
        return np.ones(n, dtype=np.float32)


@deadline(90)
def test_owner_pulls_a_return_whose_seal_the_head_handles_late(
        ray_start_cluster, monkeypatch):
    real = Head._HANDLERS[P.OBJECT_SEALED]

    def late(self, conn, rid, *args):
        # the head reads the report and records it 0.5 s later, off its
        # io loop (a busy head)
        threading.Timer(0.5, real, (self, conn, rid) + args).start()

    monkeypatch.setitem(Head._HANDLERS, P.OBJECT_SEALED, late)
    node = ray_start_cluster.add_node(num_cpus=1)
    # an actor's return: a lost one is not rebuilt by running it again
    ones = ray_tpu_torch.remote(_Ones).options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node, soft=False)).remote()
    n = 1 << 20  # 4 MiB: a plasma return on the other node
    for _ in range(3):
        got = ray_tpu_torch.get(ones.make.remote(n), timeout=60)
        assert float(got.sum()) == n


@deadline(30)
def test_a_send_made_mid_drain_by_the_draining_thread_is_sent():
    a, b = socket.socketpair()
    conn, peer = P.Connection(a, "a"), P.Connection(b, "b")
    real = conn._send_all_vectored
    nested = []

    def vectored(bufs, *args, **kwargs):
        if not nested:  # a finalizer that sends, run by this drain
            nested.append(True)
            conn.send(P.OBJECT_FREE, [b"nested"])
        return real(bufs, *args, **kwargs)

    conn._send_all_vectored = vectored
    try:
        conn.send(P.OBJECT_FREE, [b"outer"])
        got = []
        while len(got) < 2:
            got += peer.feed(b.recv(1 << 16))
        assert [m[2] for m in got] == [[b"outer"], [b"nested"]]
        assert conn._wlock_owner is None and not conn._wq
    finally:
        a.close()
        b.close()


def test_serializing_while_another_thread_imports_torch(monkeypatch):
    """A driver's first iter_torch_batches imports torch while
    streaming_split's pump thread pickles block refs onto its queues: the
    pickler must not fail on the half-imported module."""
    from ray_tpu_torch.core import serialization as S

    monkeypatch.setitem(sys.modules, "torch", types.ModuleType("torch"))
    value = {"block": {"x": np.arange(10)}, "refs": [[1], [2]]}
    out = S.deserialize(S.serialize(value).frames)
    assert out["refs"] == [[1], [2]]
    assert np.array_equal(out["block"]["x"], np.arange(10))
