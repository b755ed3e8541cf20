"""Dask-on-ray_tpu_torch: execute Dask task graphs on cluster tasks.

Ref parity: ray.util.dask (python/ray/util/dask/scheduler.py
ray_dask_get): a Dask *scheduler* — the `get` callable every Dask
collection accepts — that submits each graph task as a cluster task,
resolving inter-task references through object refs so independent
subgraphs run in parallel.

Redesign notes: the reference walks dask.core; a Dask graph is plain
data (dict key -> task tuple (callable, *args)), so the executor here
speaks that protocol directly and works even without dask installed
(raw graphs). When dask IS importable, ``enable_dask_on_ray()``
registers the scheduler globally, after which ``dask.compute`` /
``.compute()`` on any collection runs on the cluster.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List

import ray_tpu_torch

__all__ = ["ray_dask_get", "enable_dask_on_ray", "disable_dask_on_ray"]


def _is_task(x) -> bool:
    return isinstance(x, tuple) and len(x) > 0 and callable(x[0])


def _keys_in(x, graph) -> List[Hashable]:
    """Graph keys referenced by a task argument (dask's nested-key walk:
    keys can hide in lists/tuples of args)."""
    found = []
    if isinstance(x, (list, tuple)) and not _is_task(x):
        for item in x:
            found.extend(_keys_in(item, graph))
    elif _is_task(x):
        for item in x[1:]:
            found.extend(_keys_in(item, graph))
    else:
        try:
            if x in graph:
                found.append(x)
        except TypeError:
            pass  # unhashable literal
    return found


def _execute_task(task, resolved: Dict[Hashable, Any]):
    """Run one task tuple with every graph reference substituted."""

    def sub(x):
        if _is_task(x):
            fn = x[0]
            return fn(*[sub(a) for a in x[1:]])
        if isinstance(x, list):
            return [sub(i) for i in x]
        if isinstance(x, tuple):
            return tuple(sub(i) for i in x)
        try:
            if x in resolved:
                return resolved[x]
        except TypeError:
            pass
        return x

    return sub(task)


def ray_dask_get(dsk: Dict[Hashable, Any], keys, **_kw):
    """Dask scheduler: execute graph ``dsk`` for ``keys`` on cluster
    tasks (ref: ray.util.dask.ray_dask_get). Each task becomes one
    remote call whose args are the object refs of its dependencies, so
    the cluster scheduler extracts the graph's parallelism;
    ray_tpu_torch.get materializes only the requested keys."""
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()

    @ray_tpu_torch.remote
    def run_task(task, dep_keys, *dep_vals):
        return _execute_task(task, dict(zip(dep_keys, dep_vals)))

    refs: Dict[Hashable, Any] = {}

    def submit(key):
        if key in refs:
            return refs[key]
        task = dsk[key]
        if not _is_task(task) and not _keys_in(task, dsk):
            # literal (dask stores leaf data directly in the graph)
            refs[key] = ray_tpu_torch.put(task)
            return refs[key]
        deps = []
        seen = set()
        for d in _keys_in(task, dsk):
            if d not in seen and d != key:
                seen.add(d)
                deps.append(d)
        dep_refs = [submit(d) for d in deps]
        refs[key] = run_task.remote(task, list(deps), *dep_refs)
        return refs[key]

    def walk(ks):
        if isinstance(ks, (list, tuple)):
            return type(ks)(walk(k) for k in ks)
        return ray_tpu_torch.get(submit(ks), timeout=600)

    return walk(keys)


_saved = []


def enable_dask_on_ray():
    """Make ray_dask_get the global Dask scheduler (requires dask)."""
    import dask

    _saved.append(dask.config.get("scheduler", None))
    dask.config.set(scheduler=ray_dask_get)
    return ray_dask_get


def disable_dask_on_ray():
    import dask

    prev = _saved.pop() if _saved else None
    dask.config.set(scheduler=prev)
