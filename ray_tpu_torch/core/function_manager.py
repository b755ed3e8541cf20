"""Function/class export and caching.

Analog of python/ray/_private/function_manager.py in the reference: remote
functions and actor classes are cloudpickled once, exported to the head KV
under a content-hash key, and lazily fetched + cached by executing workers.
"""

from __future__ import annotations

import hashlib
import threading
import weakref
from typing import Any, Callable, Dict


class FunctionManager:
    NS = "fn"

    def __init__(self, kv_put: Callable, kv_get: Callable):
        self._kv_put = kv_put
        self._kv_get = kv_get
        self._exported: set = set()
        self._cache: Dict[str, Any] = {}
        # fn object -> exported id; export() is on the per-task submit hot
        # path, so the cloudpickle+hash must run once per function object,
        # not once per task. Weak keys: dropping the last user reference to
        # a remote function must not pin it here.
        self._id_by_obj: "weakref.WeakKeyDictionary[Any, str]" = \
            weakref.WeakKeyDictionary()
        self._lock = threading.Lock()

    def export(self, obj: Any) -> str:
        """Serialize a function/class, export to KV, return its id.

        Memoized by object identity: a remote function's code and captured
        globals are snapshotted at FIRST submission, and later mutations of
        captured globals are not re-exported (matches the reference —
        python/ray/remote_function.py pickles once per function object, so
        mutating a module global between calls was never propagated there
        either). Redefine the function to pick up new state."""
        try:
            fn_id = self._id_by_obj.get(obj)
        except TypeError:  # unhashable/unweakrefable callable
            fn_id = None
        if fn_id is not None:
            return fn_id
        from .serialization import dumps

        data = dumps(obj)
        fn_id = hashlib.blake2b(data, digest_size=16).hexdigest()
        with self._lock:
            done = fn_id in self._exported
        if not done:
            self._kv_put(self.NS, fn_id, data, True)
            with self._lock:
                self._exported.add(fn_id)
                self._cache[fn_id] = obj
        try:
            self._id_by_obj[obj] = fn_id
        except TypeError:
            pass
        return fn_id

    def fetch(self, fn_id: str) -> Any:
        with self._lock:
            if fn_id in self._cache:
                return self._cache[fn_id]
        data = self._kv_get(self.NS, fn_id)
        if data is None:
            raise KeyError(f"function {fn_id} not found in KV")
        from .serialization import loads

        obj = loads(data)
        with self._lock:
            self._cache[fn_id] = obj
        return obj
