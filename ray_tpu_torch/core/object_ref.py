"""ObjectRef — the distributed future handle.

Analog of the reference's ``ObjectRef`` (python/ray/_raylet.pyx ObjectRef +
C++ reference_count.h ownership). Each ref knows its ObjectID and its owner
(the worker that created it via ``put`` or task submission). Destruction
decrements the process-local reference count; when the owner observes zero
local refs, zero pending task args, and zero borrowers, the object is freed
from the store (distributed GC).
"""

from __future__ import annotations

from typing import Optional

from .ids import ObjectID


class ObjectRef:
    __slots__ = ("id", "owner", "_registered", "__weakref__")

    def __init__(self, object_id: ObjectID, owner: Optional[str] = None,
                 _register: bool = True):
        self.id = object_id
        self.owner = owner  # owker id hex string of owning worker, or None=local
        self._registered = False
        if _register:
            from .context import get_context_if_exists

            ctx = get_context_if_exists()
            if ctx is not None:
                ctx.ref_counter.add_local_ref(self)
                self._registered = True
                # Borrower registration with the owner (no-op if we own it).
                ctx.notify_deserialized_ref(self)

    @staticmethod
    def _deserialize(binary: bytes, owner: Optional[str]) -> "ObjectRef":
        return ObjectRef(ObjectID(binary), owner)

    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id.binary()

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        from .context import get_context

        return get_context().as_future(self)

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"

    def __del__(self):
        if not self._registered:
            return
        try:
            from .context import get_context_if_exists

            ctx = get_context_if_exists()
            if ctx is not None:
                ctx.ref_counter.remove_local_ref(self)
        except BaseException:
            # Interpreter teardown may have cleared module globals.
            pass

    def __reduce__(self):
        # Plain pickle of a ref (outside the serialization module's borrower
        # tracking) still round-trips, but borrower registration only happens
        # through serialization.serialize().
        return (ObjectRef._deserialize, (self.id.binary(), self.owner))
