"""Binary identifiers for jobs, tasks, actors, objects, nodes, placement groups.

Design follows the reference's ID scheme (src/ray/common/id.h): fixed-width
binary IDs where child IDs embed parentage (an ObjectID embeds the TaskID that
created it plus a return/put index; a TaskID embeds the ActorID/JobID context).
Unlike the reference we keep them as immutable Python values backed by
``bytes`` — the hot paths that need native speed deal in the object store's
integer handles, not these IDs.
"""

from __future__ import annotations

import os
import threading


class _RandPool:
    """Buffered kernel entropy: one urandom syscall per ~600 IDs.

    Per-call ``os.urandom`` measured ~0.4 ms on the deployment kernel —
    the single largest cost of ``f.remote()`` ID minting (one TaskID +
    one ObjectID per task). Fork safety is preserved by re-keying the
    pool in forked children (workers are fork+exec so they never share
    it, but the multiprocessing shim can fork)."""

    def __init__(self):
        self._buf = b""
        self._off = 0
        self._lock = threading.Lock()

    def take(self, n: int) -> bytes:
        if n > 4096:  # larger than the pool refill: draw directly
            return os.urandom(n)
        with self._lock:
            off = self._off
            if off + n > len(self._buf):
                self._buf = os.urandom(8192)
                off = 0
            self._off = off + n
            return self._buf[off:off + n]


_pool = _RandPool()
os.register_at_fork(after_in_child=_pool.__init__)


def _random_bytes(n: int) -> bytes:
    return _pool.take(n)


class BaseID:
    SIZE = 16
    __slots__ = ("_binary", "_hash")

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}"
            )
        self._binary = binary
        self._hash = hash(binary)

    @classmethod
    def from_random(cls):
        return cls(_random_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._binary == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._binary

    def hex(self) -> str:
        return self._binary.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._binary == self._binary

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._binary,))


class JobID(BaseID):
    SIZE = 4

    @classmethod
    def from_int(cls, i: int) -> "JobID":
        return cls(i.to_bytes(4, "little"))

    def to_int(self) -> int:
        return int.from_bytes(self._binary, "little")


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    """12 bytes: 8 random + 4 job id."""

    SIZE = 12

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(_random_bytes(8) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._binary[8:])


class TaskID(BaseID):
    """16 bytes: 4 unique + 12 actor-or-job context."""

    SIZE = 16

    @classmethod
    def for_normal_task(cls, job_id: JobID) -> "TaskID":
        return cls(_random_bytes(12) + job_id.binary())

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(_random_bytes(4) + actor_id.binary())

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        return cls(b"\xff" * 12 + job_id.binary())


class ObjectID(BaseID):
    """20 bytes: 16-byte parent TaskID + 4-byte index.

    Index semantics match the reference: put objects and return objects draw
    from the same index space (puts are negative in the reference; we use the
    high bit instead).
    """

    SIZE = 20
    PUT_BIT = 0x8000_0000

    @classmethod
    def for_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + (index | cls.PUT_BIT).to_bytes(4, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._binary[:16])

    def index(self) -> int:
        return int.from_bytes(self._binary[16:], "little") & ~self.PUT_BIT

    def is_put(self) -> bool:
        return bool(int.from_bytes(self._binary[16:], "little") & self.PUT_BIT)


class PlacementGroupID(BaseID):
    SIZE = 12

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(_random_bytes(8) + job_id.binary())
