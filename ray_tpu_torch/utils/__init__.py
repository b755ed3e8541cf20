"""ray_tpu_torch.utils — the ``ray.util`` surface of the port.

So far the distributed ``Queue`` (util/queue.py), which
``Dataset.streaming_split`` deals block refs through. The actor pool,
multiprocessing pool, joblib, dask and spark shims and the
microbenchmark of ``ray_tpu.utils`` are not ported yet.
"""

from ray_tpu_torch.utils.queue import Empty, Full, Queue

__all__ = ["Queue", "Empty", "Full"]
