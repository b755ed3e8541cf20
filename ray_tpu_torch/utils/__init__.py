"""ray_tpu_torch.utils — the ``ray.util`` surface of the port.

Ref parity for the `ray.util` ecosystem surface: ActorPool
(util/actor_pool.py), Queue (util/queue.py), multiprocessing Pool
(util/multiprocessing/pool.py), joblib backend (util/joblib/), with the
Dask scheduler (``utils.dask``), the core microbenchmark
(``python -m ray_tpu_torch.utils.microbenchmark``) and the Spark shim
(``utils.spark``, whose workers run the CLI's ``start --address``)
beside them.
"""

from ray_tpu_torch.utils.actor_pool import ActorPool
from ray_tpu_torch.utils.joblib_backend import register_ray
from ray_tpu_torch.utils.queue import Empty, Full, Queue

__all__ = ["ActorPool", "Queue", "Empty", "Full", "register_ray"]
