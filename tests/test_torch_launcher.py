"""The port's cluster launcher (``python -m ray_tpu_torch up / down / exec /
attach``).

- The reference's ``tests/test_launcher.py`` runs re-pointed at the port
  through ``torch_repoint``: ``up`` from its YAML, a driver ``exec``'d
  against the cluster lands a GPU task on the pre-launched slice, ``down``.
- Two faults of the reference's launcher are repaired, each with a test
  that fails on the reference: ``up`` leaves the configured provider out of
  the head's autoscaler config, so the head always autoscales with the
  local provider; and ``down`` builds its provider through a factory of
  its own that passes the local provider an argument it does not take, a
  TypeError its bare ``except`` swallows, so no slice is ever terminated.
- A JSON config is read with PyYAML absent (the machine with the card has
  none), and the launcher's state and the workflow root lie apart from
  the reference's.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from torch_repoint import run_repointed
from ray_tpu_torch.autoscaler import node_provider
from ray_tpu_torch.scripts import launcher

CONFIG = {"cluster_name": "lnch-unit",
          "provider": {"type": "gcp", "project_id": "p", "zone": "z"},
          "head": {"resources": {"CPU": 4}},
          "node_types": [{"name": "h100-1", "resources_per_host":
                          {"CPU": 2, "GPU": 1}, "max_slices": 1}],
          "autoscaler": {"idle_timeout_s": 10}}


def test_reference_launcher_file_passes_on_the_port(tmp_path):
    run_repointed("test_launcher", 1, tmp_path, timeout=170)


def _head_autoscaler_config(module, cfg_path, monkeypatch) -> dict:
    """The --autoscaler-config that `module.up` passes the head, caught
    at the head's spawn."""
    seen = {}

    class _Spawned(Exception):
        pass

    def popen(argv, **kw):
        seen["argv"] = argv
        raise _Spawned

    monkeypatch.setattr(module, "STATE_DIR", str(cfg_path.parent / "state"))
    monkeypatch.setattr(module.subprocess, "Popen", popen)
    with pytest.raises(_Spawned):
        module.up(str(cfg_path))
    argv = seen["argv"]
    return json.loads(argv[argv.index("--autoscaler-config") + 1])


def test_up_passes_the_configured_provider_to_the_head(tmp_path,
                                                       monkeypatch):
    """The reference's `up` drops the provider (`launcher.py:76-89`), so
    its head calls make_provider(None, ...) and scales with the local
    provider whatever the config says; the port's head gets it."""
    from ray_tpu.scripts import launcher as jlauncher

    cfg_path = tmp_path / "cluster.json"
    cfg_path.write_text(json.dumps(CONFIG))
    jcfg = _head_autoscaler_config(jlauncher, cfg_path, monkeypatch)
    assert "provider" not in jcfg
    cfg = _head_autoscaler_config(launcher, cfg_path, monkeypatch)
    assert cfg["provider"] == {"cluster_name": "lnch-unit",
                               **CONFIG["provider"]}
    assert cfg["node_types"] == CONFIG["node_types"]
    assert cfg["idle_timeout_s"] == 10
    # head_main builds its provider from that dict
    from ray_tpu_torch.autoscaler.gcp import GcpGpuNodeProvider

    provider = node_provider.make_provider(cfg["provider"], "127.0.0.1:1")
    assert isinstance(provider, GcpGpuNodeProvider)
    assert provider.cluster_name == "lnch-unit"


class _Recording:
    def __init__(self):
        self.terminated = []

    def non_terminated_slices(self):
        return {"h100-1-a": {}, "h100-1-b": {}}

    def terminate_slice(self, sid):
        self.terminated.append(sid)


def test_down_terminates_the_providers_slices_and_the_session(
        tmp_path, monkeypatch):
    """`down` builds its provider through the autoscaler's one factory and
    terminates every slice it lists, then stops the head's whole session
    and waits for it. The reference's own factory builds
    FakeTpuSliceProvider(addr, log_dir=...), which takes no log_dir: a
    TypeError its `down` swallows, so it terminates nothing."""
    from ray_tpu.scripts import launcher as jlauncher

    with pytest.raises(TypeError, match="log_dir"):
        jlauncher.make_provider({"type": "local"}, "127.0.0.1:1")
    assert not hasattr(launcher, "make_provider")

    recording, asked = _Recording(), []
    monkeypatch.setattr(node_provider, "make_provider",
                        lambda cfg, addr: asked.append((cfg, addr))
                        or recording)
    monkeypatch.setattr(launcher, "STATE_DIR", str(tmp_path))
    # a stand-in head: a session of its own with a child in it
    head = subprocess.Popen(
        [sys.executable, "-c", "import subprocess, sys, time; "
         "subprocess.Popen([sys.executable, '-c', "
         "'import time; time.sleep(60)']); time.sleep(60)"],
        start_new_session=True)
    deadline = time.monotonic() + 30
    while len(launcher.session_pids(head.pid)) < 2:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    with open(tmp_path / "u.json", "w") as f:
        json.dump({"cluster_name": "u", "address": "127.0.0.1:9",
                   "head_pid": head.pid, "provider": {"type": "local"}}, f)
    try:
        launcher.down("u")
    finally:
        if head.poll() is None:
            os.killpg(head.pid, signal.SIGKILL)
        head.wait(timeout=30)
    assert asked == [({"cluster_name": "u", "type": "local"},
                      "127.0.0.1:9")]
    assert recording.terminated == ["h100-1-a", "h100-1-b"]
    assert launcher.session_pids(head.pid) == []
    assert not (tmp_path / "u.json").exists()


def test_json_config_needs_no_yaml(tmp_path, monkeypatch):
    """A .json config is read with json: PyYAML's absence (the machine
    with the card has none) only stops a YAML config, and YAML reads the
    same file to the same dict."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps(CONFIG))
    cfg = launcher.load_config(str(path))
    assert cfg == {**CONFIG}
    monkeypatch.delitem(sys.modules, "yaml")
    import yaml

    assert yaml.safe_load(path.read_text()) == CONFIG
    monkeypatch.setitem(sys.modules, "yaml", None)
    (tmp_path / "cluster.yaml").write_text("cluster_name: c\n")
    with pytest.raises(ImportError):
        launcher.load_config(str(tmp_path / "cluster.yaml"))


def test_state_and_workflow_root_lie_apart_from_the_reference():
    """The launcher's state dir and the workflow root are the port's own:
    a cluster of the same name in both packages (the re-pointed
    test_launcher and the reference's, both `lnch-test`, under xdist)
    never reads the other's state, and two checkouts' workflows never
    share a root under /tmp."""
    import tempfile

    from ray_tpu.scripts import launcher as jlauncher
    from ray_tpu.workflow import api as jworkflow
    from ray_tpu_torch.workflow import api as workflow

    assert launcher.STATE_DIR == os.path.expanduser(
        "~/.ray_tpu_torch/clusters")
    assert launcher.STATE_DIR != jlauncher.STATE_DIR
    if "RAYT_WORKFLOW_ROOT" not in os.environ:
        assert workflow.DEFAULT_ROOT == os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch", "workflows")
        assert workflow.DEFAULT_ROOT != jworkflow.DEFAULT_ROOT
