"""Head control-plane persistence: a write-ahead log for GCS-lite tables.

The reference keeps its GCS tables (KV, named/detached actors, placement
groups, job table) in an external Redis so a restarted GCS recovers the
control plane (`/root/reference/src/ray/gcs/store_client/redis_store_client.h`,
`gcs_server.cc` RaySyncer bootstrap). A TPU-pod head has no Redis; instead
the head appends every durable mutation to a length-prefixed pickle WAL in
the session directory and replays it on construction. Compaction rewrites
the log as one snapshot record when it grows past a threshold.

Durable records (everything else — leases, object directory, transient
worker state — is rebuilt by the live cluster re-registering):

- ``("kv_put", ns, key, value)`` / ``("kv_del", ns, key)``
- ``("actor", spec_bytes)``        named (detached) actor created
- ``("actor_gone", actor_id_bin)`` named actor permanently dead/killed
- ``("pg", spec_bytes)``           placement group created
- ``("pg_gone", pg_id_bin)``       placement group removed
- ``("dedupe", client_id, rid)``   a client request that produced one of
                                   the durable mutations above was
                                   applied — a restarted head re-acks a
                                   retried copy instead of applying it
                                   twice (GCS-FT request dedupe)
- ``("snapshot", state_dict)``     compaction record (always first after
                                   a compaction; replay starts from it)
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

_LEN = struct.Struct("<Q")

WAL_NAME = "head_state.wal"


class HeadStore:
    """Append-only durable log for the head's control-plane tables."""

    def __init__(self, session_dir: str,
                 compact_threshold_bytes: int = 8 * 1024 * 1024):
        self.path = os.path.join(session_dir, WAL_NAME)
        self._lock = threading.Lock()
        self._compact_threshold = compact_threshold_bytes
        # Exclusive advisory lock: two live heads appending to one WAL
        # from separate handles would interleave length-prefix/payload
        # writes and corrupt the log. Held for the head's lifetime.
        self._lockfile = open(self.path + ".lock", "a+")
        try:
            import fcntl

            fcntl.flock(self._lockfile, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._lockfile.close()
            raise RuntimeError(
                f"another head already owns session dir "
                f"{session_dir!r} (WAL lock held)")
        self._records: List[tuple] = []
        if os.path.exists(self.path):
            self._records = _read_all(self.path)
        self._f = open(self.path, "ab")

    # ------------------------------------------------------------- write

    def append(self, record: tuple):
        blob = pickle.dumps(record, protocol=5)
        with self._lock:
            self._f.write(_LEN.pack(len(blob)))
            self._f.write(blob)
            self._f.flush()
            if self._f.tell() > self._compact_threshold:
                self._compact_locked()

    def _compact_locked(self):
        state = replay(_read_all(self.path))
        tmp = self.path + ".tmp"
        blob = pickle.dumps(("snapshot", state), protocol=5)
        with open(tmp, "wb") as f:
            f.write(_LEN.pack(len(blob)))
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._f.close()
        self._f = open(self.path, "ab")

    def close(self):
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass
            try:
                self._lockfile.close()  # releases the flock
            except OSError:
                pass

    # ------------------------------------------------------------- read

    def restore(self) -> Optional[Dict[str, Any]]:
        """State replayed from the records found on disk at open time
        (i.e. a previous head's writes), or None for a fresh session."""
        if not self._records:
            return None
        return replay(self._records)


def _read_all(path: str) -> List[tuple]:
    records: List[tuple] = []
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return records
    off = 0
    n = len(data)
    while off + 8 <= n:
        (ln,) = _LEN.unpack_from(data, off)
        off += 8
        if off + ln > n:  # torn tail write from a crashed head — drop it
            break
        try:
            records.append(pickle.loads(data[off:off + ln]))
        except Exception:  # noqa: BLE001 — corrupt record ends the log
            break
        off += ln
    return records


def replay(records: List[tuple]) -> Dict[str, Any]:
    """Fold the WAL into the durable-state dict.

    Returns ``{"kv": {ns: {key: value}}, "actors": {actor_id_bin:
    spec_bytes}, "pgs": {pg_id_bin: spec_bytes}, "dedupe":
    [(client_id, rid), ...]}``.
    """
    kv: Dict[Any, Dict[Any, Any]] = {}
    actors: Dict[bytes, bytes] = {}
    pgs: Dict[bytes, bytes] = {}
    dedupe: Dict[Tuple[str, int], None] = {}  # insertion-ordered set
    for rec in records:
        kind = rec[0]
        if kind == "snapshot":
            state = rec[1]
            kv = {ns: dict(t) for ns, t in state.get("kv", {}).items()}
            actors = dict(state.get("actors", {}))
            pgs = dict(state.get("pgs", {}))
            dedupe = dict.fromkeys(
                tuple(k) for k in state.get("dedupe", ()))
        elif kind == "dedupe":
            dedupe[(rec[1], rec[2])] = None
        elif kind == "kv_put":
            _, ns, key, value = rec
            kv.setdefault(ns, {})[key] = value
        elif kind == "kv_del":
            _, ns, key = rec
            kv.get(ns, {}).pop(key, None)
        elif kind == "actor":
            spec_bytes = rec[1]
            actors[_actor_key(spec_bytes)] = spec_bytes
        elif kind == "actor_gone":
            actors.pop(rec[1], None)
        elif kind == "pg":
            spec_bytes = rec[1]
            pgs[_pg_key(spec_bytes)] = spec_bytes
        elif kind == "pg_gone":
            pgs.pop(rec[1], None)
    # bound what a snapshot / restore carries: only recent request ids
    # matter (a client retries within head_reconnect_timeout_s)
    keys = list(dedupe)[-4096:]
    return {"kv": kv, "actors": actors, "pgs": pgs, "dedupe": keys}


def _actor_key(spec_bytes: bytes) -> bytes:
    from .serialization import loads

    return loads(spec_bytes).actor_id.binary()


def _pg_key(spec_bytes: bytes) -> bytes:
    from .serialization import loads

    return loads(spec_bytes).pg_id.binary()
