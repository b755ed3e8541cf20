"""``isinstance(x, DTensor)`` without importing ``torch.distributed.tensor``.

That module pulls in ``torch.fx.experimental.symbolic_shapes`` and sympy,
which an unmeshed forward, train step or engine step never uses. No tensor
can be a DTensor before the module is imported, so until then the answer is
False; the first call that builds a mesh's placements imports it.
"""

from __future__ import annotations

import sys


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor``."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)
