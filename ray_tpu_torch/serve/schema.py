"""Declarative Serve config: deploy applications from a YAML/dict spec.

Ref parity: ray.serve schema + REST config (python/ray/serve/schema.py:559
ServeDeploySchema / ServeApplicationSchema; `serve deploy config.yaml`).
Shape (a subset of the reference's, same field names)::

    applications:
      - name: app1
        import_path: my_module:app      # a Deployment or bound graph
        route_prefix: /app1
        args: {...}                     # optional, passed to a builder fn
        deployments:                    # per-deployment overrides
          - name: Model
            num_replicas: 2
            max_concurrent_queries: 8
            user_config: {...}
            autoscaling_config: {...}

``deploy_config`` imports each target, applies overrides via
Deployment.options, and serve.run()s it.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional

_DEPLOYMENT_OVERRIDES = ("num_replicas", "max_concurrent_queries",
                         "user_config", "autoscaling_config",
                         "ray_actor_options", "health_check_period_s",
                         "health_check_timeout_s")


def load_config_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        text = f.read()
    try:
        import yaml

        return yaml.safe_load(text)
    except ImportError:
        import json

        return json.loads(text)


def _import_target(import_path: str):
    """'pkg.module:attr' -> the attribute (ref: import_attr)."""
    if ":" not in import_path:
        raise ValueError(
            f"import_path {import_path!r} must look like 'module:attr'")
    module_name, attr = import_path.split(":", 1)
    module = importlib.import_module(module_name)
    target = module
    for part in attr.split("."):
        target = getattr(target, part)
    return target


def _apply_overrides(app_target, overrides: List[Dict[str, Any]]):
    """Rebuild the deployment (or bound-graph root) with per-deployment
    option overrides from the config."""
    from .deployment import Application, Deployment

    by_name = {o["name"]: o for o in overrides or []}

    def rebuild(node):
        if isinstance(node, Application):
            d = node.deployment
            o = by_name.get(d.name)
            new_args = tuple(rebuild(a) if isinstance(a, Application) else a
                             for a in node.init_args)
            new_kwargs = {k: (rebuild(v) if isinstance(v, Application)
                              else v)
                          for k, v in node.init_kwargs.items()}
            if o:
                opts = {k: v for k, v in o.items()
                        if k in _DEPLOYMENT_OVERRIDES}
                d = d.options(**opts)
            return d.bind(*new_args, **new_kwargs)
        if isinstance(node, Deployment):
            o = by_name.get(node.name)
            if o:
                opts = {k: v for k, v in o.items()
                        if k in _DEPLOYMENT_OVERRIDES}
                node = node.options(**opts)
            return node
        return node

    return rebuild(app_target)


def deploy_config(config: Dict[str, Any] | str) -> List[str]:
    """Deploy every application in the config; returns their names.
    (ref: `serve deploy` against the REST schema)."""
    from . import api as serve_api

    if isinstance(config, str):
        config = load_config_file(config)
    apps = config.get("applications")
    if not apps:
        raise ValueError("config has no 'applications' list")
    deployed = []
    for app in apps:
        name = app.get("name") or "default"
        target = _import_target(app["import_path"])
        if callable(target) and not hasattr(target, "bind") and \
                not hasattr(target, "deployment"):
            # builder function taking the config args dict
            target = target(app.get("args") or {})
        target = _apply_overrides(target, app.get("deployments"))
        serve_api.run(target, name=name,
                      route_prefix=app.get("route_prefix", f"/{name}"))
        deployed.append(name)
    return deployed


def status_schema() -> Dict[str, Any]:
    """Cluster serve status in the REST schema's shape
    (ref: serve/schema.py ServeStatusSchema)."""
    from . import api as serve_api

    return {"applications": serve_api.status()}
