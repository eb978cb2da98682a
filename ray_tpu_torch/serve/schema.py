"""Declarative serve config: deploy applications from a YAML/dict spec
(ref analog: python/ray/serve/schema.py ServeDeploySchema + the REST/CLI
`serve deploy` path).

Config shape:

    applications:
      - name: app1
        import_path: my_module:app        # Application OR builder fn
        args: {size: 3}                   # builder kwargs (optional)
        deployments:                      # per-deployment overrides
          - name: Model
            num_replicas: 2
            max_ongoing_requests: 8
"""

from __future__ import annotations

import importlib
from typing import Any

from ray_tpu_torch.serve.deployment import Application


def _load_import_path(import_path: str):
    module_name, _, attr = import_path.partition(":")
    if not attr:
        raise ValueError(
            f"import_path {import_path!r} must be 'module:attribute'")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def build_app(app_config: dict) -> Application:
    """Materialize one application entry: import, call the builder if
    needed, apply per-deployment overrides."""
    target = _load_import_path(app_config["import_path"])
    args = app_config.get("args") or {}
    if isinstance(target, Application):
        app = target
    else:
        app = target(**args)
        if not isinstance(app, Application):
            raise TypeError(
                f"{app_config['import_path']} returned {type(app)}, "
                "expected a bound Application")
    overrides = {d["name"]: d for d in app_config.get("deployments", [])}
    if overrides:
        _apply_overrides(app, overrides)
    return app


def _apply_overrides(app: Application, overrides: dict[str, dict]):
    for node in app.walk():
        ov = overrides.get(node.deployment.name)
        if not ov:
            continue
        opts = {k: v for k, v in ov.items() if k != "name"}
        node.deployment = node.deployment.options(**opts)


def deploy_config(config: Any, *, _blocking: bool = True) -> dict:
    """Deploy every application in a config dict / YAML string / YAML file
    path. Returns {app_name: ingress handle}."""
    import os

    from ray_tpu_torch import serve

    if isinstance(config, str):
        import yaml

        if os.path.exists(config):
            with open(config) as f:
                config = yaml.safe_load(f)
        else:
            config = yaml.safe_load(config)
    if not isinstance(config, dict) or "applications" not in config:
        raise ValueError("config must contain an 'applications' list")
    handles = {}
    for app_config in config["applications"]:
        name = app_config.get("name", "default")
        app = build_app(app_config)
        handles[name] = serve.run(app, name=name, _blocking=_blocking)
    return handles
