"""DAG node types and the bottom-up executor.

Ref parity: python/ray/dag/dag_node.py:23 (DAGNode: _bound_args,
_apply_recursive, execute), function_node.py (FunctionNode ->
fn.remote), class_node.py (ClassNode -> Class.remote, ClassMethodNode ->
handle.method.remote), input_node.py (InputNode placeholder bound at
execute time). Execution submits every node as a normal task/actor call
with upstream ObjectRefs as arguments, so the cluster scheduler
parallelizes independent branches for free.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple


class DAGNode:
    """A lazily-bound node; subclasses define how to submit themselves."""

    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = tuple(args)
        self._bound_kwargs = dict(kwargs)

    # -------------------------------------------------------- traversal

    def _resolve_args(self, cache, input_value):
        args = [a.
                _to_ref(cache, input_value) if isinstance(a, DAGNode) else a
                for a in self._bound_args]
        kwargs = {k: (v._to_ref(cache, input_value)
                      if isinstance(v, DAGNode) else v)
                  for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _to_ref(self, cache: dict, input_value):
        """Submit this node (memoized — diamond deps execute once)."""
        if id(self) not in cache:
            cache[id(self)] = self._submit(cache, input_value)
        return cache[id(self)]

    def _submit(self, cache, input_value):
        raise NotImplementedError

    # -------------------------------------------------------- execution

    def execute(self, *input_values) -> Any:
        """Walk the graph, submit everything, return the root's ObjectRef
        (or actor handle for a ClassNode root)."""
        input_value = input_values[0] if input_values else None
        return self._to_ref({}, input_value)


class InputNode(DAGNode):
    """Placeholder bound to ``dag.execute(value)``'s argument
    (python/ray/dag/input_node.py). Usable as a context manager for
    parity with the reference's ``with InputNode() as inp:`` style."""

    def __init__(self):
        super().__init__((), {})

    def _to_ref(self, cache, input_value):
        return input_value

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class FunctionNode(DAGNode):
    """``remote_fn.bind(*args)`` — executes as ``remote_fn.remote(...)``."""

    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _submit(self, cache, input_value):
        args, kwargs = self._resolve_args(cache, input_value)
        return self._remote_fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """``ActorClass.bind(*ctor_args)`` — instantiated once per execute;
    method nodes hang off it."""

    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls

    def _submit(self, cache, input_value):
        args, kwargs = self._resolve_args(cache, input_value)
        return self._actor_cls.remote(*args, **kwargs)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodStub(self, name)


class _MethodStub:
    def __init__(self, class_node: ClassNode, method: str):
        self._class_node = class_node
        self._method = method

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method, args, kwargs)


class ClassMethodNode(DAGNode):
    """``class_node.method.bind(*args)`` — calls the method on the shared
    actor instance created by its ClassNode."""

    def __init__(self, class_node: ClassNode, method: str, args, kwargs):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method = method

    def _submit(self, cache, input_value):
        handle = self._class_node._to_ref(cache, input_value)
        args, kwargs = self._resolve_args(cache, input_value)
        return getattr(handle, self._method).remote(*args, **kwargs)
