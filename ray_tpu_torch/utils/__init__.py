"""ray_tpu_torch.utils — the ``ray.util`` surface of the port.

Ref parity for the `ray.util` ecosystem surface: ActorPool
(util/actor_pool.py), Queue (util/queue.py), multiprocessing Pool
(util/multiprocessing/pool.py), joblib backend (util/joblib/), with the
Dask scheduler (``utils.dask``) and the core microbenchmark
(``python -m ray_tpu_torch.utils.microbenchmark``) beside them. Of
``ray_tpu.utils`` only the spark shim is not ported yet: its workers run
the command line's ``start``, which comes with the CLI.
"""

from ray_tpu_torch.utils.actor_pool import ActorPool
from ray_tpu_torch.utils.joblib_backend import register_ray
from ray_tpu_torch.utils.queue import Empty, Full, Queue

__all__ = ["ActorPool", "Queue", "Empty", "Full", "register_ray"]
