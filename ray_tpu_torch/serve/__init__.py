"""ray_tpu_torch.serve — model serving on the ray_tpu_torch runtime.

The port of ``ray_tpu/serve`` (the reference's Serve library, SURVEY.md
§2.4; python/ray/serve/): a controller actor reconciles declarative app
state into replica actors; handles route requests client-side with
power-of-two-choices + max_concurrent_queries backpressure;
``@serve.batch`` coalesces concurrent requests into one batched forward
pass; an HTTP proxy actor provides ingress. Deployments may request GPUs
via ``ray_actor_options={"num_gpus": N}``. Importing this package loads no
torch: the controller and proxy actors never touch a model.

Public API mirrors ``ray.serve``:

    @serve.deployment
    class Model:
        def __call__(self, x): ...

    handle = serve.run(Model.bind(), name="app")
    handle.remote(x).result()
"""

from .api import (
    delete,
    get_app_handle,
    get_deployment_handle,
    proxy_ports,
    run,
    shutdown,
    start,
    status,
)
from .batching import batch
from .config import AutoscalingConfig, DeploymentConfig, HTTPOptions
from .deployment import Application, Deployment, deployment
from .grpc_proxy import start_grpc, stop_grpc
from .handle import (DeploymentHandle, DeploymentResponse,
                     DeploymentResponseGenerator)
from .multiplex import get_multiplexed_model_id, multiplexed
from .schema import deploy_config

__all__ = [
    "deployment", "Deployment", "Application", "run", "delete", "status",
    "shutdown", "start", "start_grpc", "stop_grpc",
    "proxy_ports", "batch", "get_app_handle", "get_deployment_handle",
    "DeploymentHandle", "DeploymentResponse", "DeploymentResponseGenerator",
    "multiplexed", "get_multiplexed_model_id", "deploy_config",
    "AutoscalingConfig",
    "DeploymentConfig", "HTTPOptions",
]

from ray_tpu_torch.usage_stats import record_library_usage as _rlu
_rlu("serve")
del _rlu
