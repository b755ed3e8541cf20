"""joblib backend: scikit-learn style `Parallel` jobs on the cluster.

Ref parity: ray.util.joblib (python/ray/util/joblib/__init__.py
register_ray + ray_backend.py RayBackend): after ``register_ray()``,
``joblib.parallel_backend("ray")`` routes joblib batches to cluster
actors via the multiprocessing Pool shim. Gated on joblib being
importable (it ships with scikit-learn; not a hard dependency here).
"""

from __future__ import annotations


def register_ray():
    """Register the 'ray' joblib backend (call once, then
    ``with joblib.parallel_backend('ray'): ...``)."""
    try:
        from joblib._parallel_backends import MultiprocessingBackend
        from joblib.parallel import register_parallel_backend
    except ImportError as e:  # pragma: no cover - joblib not installed
        raise ImportError(
            "joblib is required for register_ray(); it ships with "
            "scikit-learn") from e

    import ray_tpu_torch
    from ray_tpu_torch.utils.multiprocessing import Pool

    class RayBackend(MultiprocessingBackend):
        """joblib batches run on cluster actors through the Pool shim
        (which implements the multiprocessing.Pool apply_async surface
        joblib drives)."""

        supports_timeout = True

        def effective_n_jobs(self, n_jobs):
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init()
            if n_jobs is None or n_jobs == -1:
                return max(1, int(
                    ray_tpu_torch.cluster_resources().get("CPU", 1)))
            return max(1, int(n_jobs))

        def configure(self, n_jobs=1, parallel=None, prefer=None,
                      require=None, **kwargs):
            n_jobs = self.effective_n_jobs(n_jobs)
            self.parallel = parallel
            self._pool = Pool(processes=n_jobs)
            return n_jobs

        def terminate(self):
            if getattr(self, "_pool", None) is not None:
                self._pool.terminate()
                self._pool = None

    register_parallel_backend("ray", RayBackend)
