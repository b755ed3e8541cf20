"""Import target for the port's declarative-config serve test
(tests/test_torch_serve_depth.py; the JAX package's is
tests/serve_config_target.py)."""

from ray_tpu_torch import serve


@serve.deployment
class Echo:
    def __call__(self, x):
        return f"echo:{x}"


app = Echo.bind()
