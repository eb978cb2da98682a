"""Cluster launcher: `up / down / attach / exec` over a cluster config
(ref analogs: the reference's `ray up/down/attach/exec` CLI + autoscaler
cluster YAML).

Config, as JSON (or YAML, read with PyYAML when it is installed):

    {"cluster_name": "demo",
     "provider": {"type": "local"},          # local | fake | gcp
     "head": {"resources": {"CPU": 4}, "dashboard_port": 0},
     "node_types": [
       {"name": "h100-1", "resources_per_host": {"CPU": 2, "GPU": 1},
        "hosts": 1, "max_slices": 4,
        "min_slices": 0}],                   # pre-launched at `up`
     "autoscaler": {"idle_timeout_s": 120}}

`up` starts the head with the autoscaler wired to the configured provider
(which keeps the min_slices floors), and records state under
~/.ray_tpu_torch/clusters/<name>.json; `down` terminates slices and stops
the head's whole session; `exec`/`attach` run commands/shells against the
recorded address.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

STATE_DIR = os.path.expanduser("~/.ray_tpu_torch/clusters")


def _state_path(name: str) -> str:
    return os.path.join(STATE_DIR, f"{name}.json")


def load_config(path: str) -> dict:
    with open(path) as f:
        if path.endswith(".json"):
            cfg = json.load(f)
        else:
            import yaml

            cfg = yaml.safe_load(f)
    cfg.setdefault("cluster_name", "default")
    cfg.setdefault("provider", {"type": "local"})
    cfg.setdefault("head", {})
    cfg.setdefault("node_types", [])
    return cfg


def _save_state(cfg: dict, state: dict):
    os.makedirs(STATE_DIR, exist_ok=True)
    with open(_state_path(cfg["cluster_name"]), "w") as f:
        json.dump(state, f, indent=1)


def load_state(name: str) -> dict:
    with open(_state_path(name)) as f:
        return json.load(f)


def up(config_path: str) -> dict:
    cfg = load_config(config_path)
    name = cfg["cluster_name"]
    if os.path.exists(_state_path(name)):
        raise SystemExit(f"cluster {name!r} already up "
                         f"(state: {_state_path(name)}); "
                         f"`down {name}` first")
    head_cfg = cfg["head"]
    # the configured provider goes to the head's autoscaler, with the
    # cluster's name, which scopes a cloud provider's listing to it
    autoscaler_cfg = {
        "provider": {"cluster_name": name, **cfg["provider"]},
        "node_types": list(cfg["node_types"]),
        **(cfg.get("autoscaler") or {}),
    }
    from ray_tpu_torch._internal.spawn import child_env, fast_python_argv

    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = [
        "--resources", json.dumps(head_cfg.get("resources", {"CPU": 4.0})),
        "--dashboard-port", str(head_cfg.get("dashboard_port", 0)),
    ]
    if cfg["node_types"]:
        args += ["--autoscaler-config", json.dumps(autoscaler_cfg)]
    # head stderr -> cluster log, NOT an inherited pipe: a caller
    # capturing this CLI's output would otherwise block until the head
    # daemon exits (same discipline as `start`)
    os.makedirs(STATE_DIR, exist_ok=True)
    log = open(os.path.join(STATE_DIR, f"{name}.log"), "ab")
    proc = subprocess.Popen(
        fast_python_argv("ray_tpu_torch.core.head_main") + args,
        stdout=subprocess.PIPE, stderr=log, env=child_env(pkg_root),
        text=True, start_new_session=True)
    log.close()
    line = proc.stdout.readline()
    if not line:
        raise SystemExit("head process failed to start")
    info = json.loads(line)
    address = f"127.0.0.1:{info['gcs_port']}"
    state = {"cluster_name": name, "address": address,
             "head_pid": proc.pid, "config_path": os.path.abspath(
                 config_path),
             "dashboard_port": info.get("dashboard_port"),
             "provider": cfg["provider"], "started_at": time.time()}
    _save_state(cfg, state)
    # min_slices floors are maintained by the head's autoscaler (the
    # slices are its children, so `down`'s session kill reaps them)
    print(json.dumps({"cluster": name, "address": address,
                      "dashboard_port": info.get("dashboard_port")}))
    return state


def session_pids(sid: int) -> list[int]:
    """Live (non-zombie) processes of session `sid`: the head, which
    `up` starts in a session of its own, and everything it spawned."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # fields after the parenthesised command: state ppid pgrp session
        fields = stat.rsplit(")", 1)[1].split()
        if fields[0] != "Z" and int(fields[3]) == sid:
            out.append(int(entry))
    return out


def down(name: str, timeout_s: float = 30.0):
    from ray_tpu_torch.autoscaler.node_provider import make_provider

    try:
        state = load_state(name)
    except OSError:
        raise SystemExit(f"no cluster state for {name!r}")
    # terminate autoscaled slices via a provider handle (a cloud
    # provider lists them; the local provider's slices are the head's
    # children and go with its session), then the head's session
    try:
        provider = make_provider(
            {"cluster_name": name, **state["provider"]}, state["address"])
        for sid in list(provider.non_terminated_slices()):
            provider.terminate_slice(sid)
    except Exception as e:
        print(f"down {name}: terminating slices failed: {e!r}",
              file=sys.stderr)
    head = state["head_pid"]
    try:
        os.killpg(head, signal.SIGTERM)
    except OSError:
        pass
    deadline = time.monotonic() + timeout_s
    while session_pids(head) and time.monotonic() < deadline:
        time.sleep(0.1)
    for pid in session_pids(head):
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    os.remove(_state_path(name))
    print(json.dumps({"cluster": name, "down": True}))


def exec_cmd(name: str, command: list[str]) -> int:
    state = load_state(name)
    env = dict(os.environ)
    env["RAYT_ADDRESS"] = state["address"]
    return subprocess.call(command, env=env)


def attach(name: str) -> int:
    state = load_state(name)
    env = dict(os.environ)
    env["RAYT_ADDRESS"] = state["address"]
    shell = os.environ.get("SHELL", "/bin/bash")
    print(f"# attached to {name} at {state['address']} "
          f"(RAYT_ADDRESS exported)", file=sys.stderr)
    return subprocess.call([shell], env=env)


def list_clusters() -> list[dict]:
    out = []
    try:
        names = os.listdir(STATE_DIR)
    except OSError:
        return out
    for fn in sorted(names):
        if fn.endswith(".json"):
            try:
                out.append(load_state(fn[:-5]))
            except Exception:
                pass
    return out
