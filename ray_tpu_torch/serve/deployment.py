"""Deployment definition + ``@serve.deployment`` decorator.

Ref analog: python/ray/serve/api.py:243 (decorator), serve/deployment.py
(Deployment class), and the ``.bind()`` application-graph API
(serve/deployment_graph.py) — composition is kept, the DAG IR is not:
a bound deployment's init args may themselves be Applications, which the
controller deploys transitively and replicas receive as DeploymentHandles.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from .config import AutoscalingConfig, DeploymentConfig


@dataclasses.dataclass
class Deployment:
    """An undeployed deployment definition (callable + config)."""

    func_or_class: Any
    name: str
    config: DeploymentConfig

    def options(self, **kwargs) -> "Deployment":
        cfg = dataclasses.replace(self.config)
        name = kwargs.pop("name", self.name)
        for key, val in kwargs.items():
            if key == "autoscaling_config" and isinstance(val, dict):
                val = AutoscalingConfig(**val)
            if not hasattr(cfg, key):
                raise TypeError(f"unknown deployment option {key!r}")
            setattr(cfg, key, val)
        return Deployment(self.func_or_class, name, cfg)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __call__(self, *a, **k):
        raise TypeError(
            f"Deployment '{self.name}' cannot be called directly; deploy it "
            f"with serve.run(<dep>.bind(...)) and call the returned handle.")


@dataclasses.dataclass
class Application:
    """A deployment bound to its constructor args (possibly other Apps)."""

    deployment: Deployment
    init_args: Tuple = ()
    init_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.deployment.name


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: Optional[int] = None,
               max_concurrent_queries: Optional[int] = None,
               user_config: Any = None,
               autoscaling_config=None,
               ray_actor_options: Optional[dict] = None,
               health_check_period_s: Optional[float] = None,
               health_check_timeout_s: Optional[float] = None,
               graceful_shutdown_timeout_s: Optional[float] = None,
               version: Optional[str] = None) -> Any:
    """``@serve.deployment`` — wrap a class or function as a Deployment."""

    def decorate(obj) -> Deployment:
        cfg = DeploymentConfig()
        if num_replicas is not None:
            if num_replicas <= 0:
                raise ValueError("num_replicas must be positive")
            cfg.num_replicas = num_replicas
        if max_concurrent_queries is not None:
            cfg.max_concurrent_queries = max_concurrent_queries
        if user_config is not None:
            cfg.user_config = user_config
        if autoscaling_config is not None:
            cfg.autoscaling_config = (
                autoscaling_config if isinstance(
                    autoscaling_config, AutoscalingConfig)
                else AutoscalingConfig(**autoscaling_config))
        if ray_actor_options is not None:
            cfg.ray_actor_options = dict(ray_actor_options)
        if health_check_period_s is not None:
            cfg.health_check_period_s = health_check_period_s
        if health_check_timeout_s is not None:
            cfg.health_check_timeout_s = health_check_timeout_s
        if graceful_shutdown_timeout_s is not None:
            cfg.graceful_shutdown_timeout_s = graceful_shutdown_timeout_s
        cfg.version = version
        return Deployment(obj, name or getattr(obj, "__name__", "deployment"),
                          cfg)

    if _func_or_class is not None:
        return decorate(_func_or_class)
    return decorate
