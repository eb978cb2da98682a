"""ray_tpu_torch.rl against ray_tpu.rl on the same numpy inputs.

Weights cross by ``models.convert.params_from_numpy`` (HWIO convs to OIHW,
the conv stride as an int); batches are numpy made from a seed; where the
reference draws normal noise from a key, the same draw is handed to the
port (``sample_squashed(noise=...)``, ``SAC.update(noise=...)``). Forward
passes, ``sample_squashed`` and ``vtrace`` agree to 1e-5; one PPO update
(4 epochs), one IMPALA and one APPO update (MLP and CNN), one DQN update
(double-Q on and off) and one SAC update leave params that agree to 1e-4
relative. Also here: the device-rebuild rule of device objects and edges,
target networks that do not alias the online ones, and the torch twins of
the reference RL tests whose bodies run jax.
"""

import math
import os
import time
from unittest import mock

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl import module as jrlm
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.rl import module as rlm

F32 = dict(rtol=1e-5, atol=1e-5)


def _jnp_tree(tree):
    """The reference's params as numpy (its _ConvMeta nodes stay)."""
    return jax.tree.map(np.asarray, tree)


def _to_port(jtree):
    return params_from_numpy(_jnp_tree(jtree), device="cpu")


def _leaves(tree, prefix=""):
    """(path, array) leaves of a numpy/tensor tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{prefix}/{i}")]
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree.detach().cpu().numpy())]
    if isinstance(tree, np.ndarray) or hasattr(tree, "shape"):
        return [(prefix, np.asarray(tree))]
    return []        # a conv stride


def assert_params_close(port, ref, rel=1e-4):
    """Every leaf of `port` (the port's tree, converted back to the
    reference's layout) within `rel` relative L2 of `ref`'s, and
    elementwise within rel of it plus rel of the leaf's scale."""
    got = dict(_leaves(params_to_numpy(port)))
    want = dict(_leaves(_jnp_tree(ref)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        scale = float(np.linalg.norm(w)) or 1.0
        assert float(np.linalg.norm(g - w)) <= rel * scale, (
            k, float(np.linalg.norm(g - w)) / scale)
        np.testing.assert_allclose(
            g, w, rtol=rel, atol=rel * float(np.abs(w).max() or 1.0),
            err_msg=k)


# ------------------------------------------------------------- forward
_FORWARD = {
    "mlp": lambda: (jrlm.MLPModuleConfig(4, 2), (4,)),
    "cnn_catch": lambda: (jrlm.CNNModuleConfig((10, 10, 1), 3), (10, 10, 1)),
    # stride 2, kernel 4 on 11 pixels: SAME pads 1 low and 2 high
    "cnn_asymmetric": lambda: (jrlm.CNNModuleConfig((11, 11, 3), 4),
                               (11, 11, 3)),
}


@pytest.mark.parametrize("name", sorted(_FORWARD))
def test_forward_matches_reference(name):
    cfg, obs_shape = _FORWARD[name]()
    jp = jrlm.init_params(cfg, jax.random.PRNGKey(3))
    obs = np.random.default_rng(0).normal(size=(5,) + obs_shape).astype(
        np.float32)
    want_logits, want_value = jrlm.forward(jp, jnp.asarray(obs))
    logits, value = rlm.forward(_to_port(jp), torch.as_tensor(obs))
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), **F32)
    np.testing.assert_allclose(value.detach().numpy(),
                               np.asarray(want_value), **F32)


def test_cnn_same_padding_is_asymmetric_at_stride_two():
    """The [11, 11, 3] case pads unevenly (1 low, 2 high); Catch's
    [10, 10, 1] evenly. A symmetric pad would move the parity case."""
    x = torch.zeros(1, 3, 11, 11)
    assert rlm._same_pad(x, 4, 2).shape[-2:] == (14, 14)
    marked = torch.zeros(1, 1, 11, 11)
    marked[..., 0, 0] = 1.0
    assert float(rlm._same_pad(marked, 4, 2)[0, 0, 1, 1]) == 1.0
    assert rlm._same_pad(torch.zeros(1, 1, 10, 10), 4, 2).shape[-2:] == (
        12, 12)


def test_params_round_trip_through_the_reference_layout():
    cfg = jrlm.CNNModuleConfig((10, 10, 1), 3)
    jp = jrlm.init_params(cfg, jax.random.PRNGKey(0))
    port = _to_port(jp)
    assert port["conv"][0]["w"].shape == (16, 1, 4, 4)       # OIHW
    assert port["conv"][0]["meta"] == 2
    back = params_to_numpy(port)
    for (k, a), (k2, b) in zip(_leaves(back), _leaves(_jnp_tree(jp))):
        assert k == k2
        np.testing.assert_array_equal(a, b)
    assert back["conv"][1]["meta"] == 1


def test_init_scales_match_reference():
    """Same init scales per leaf (std within sampling error), the biases
    zero: a learning gate depends on them."""
    for cfg in (jrlm.MLPModuleConfig(4, 2),
                jrlm.CNNModuleConfig((10, 10, 1), 3)):
        jp = dict(_leaves(_jnp_tree(jrlm.init_params(
            cfg, jax.random.PRNGKey(0)))))
        tp = dict(_leaves(params_to_numpy(rlm.init_params(
            _port_cfg(cfg), 0, "cpu"))))
        assert jp.keys() == tp.keys()
        for k in jp:
            assert jp[k].shape == tp[k].shape, k
            if k.endswith("/b"):
                assert not tp[k].any()
            else:
                assert abs(tp[k].std() / jp[k].std() - 1) < 0.35, k


def _port_cfg(cfg):
    cls = {"MLPModuleConfig": rlm.MLPModuleConfig,
           "CNNModuleConfig": rlm.CNNModuleConfig}[type(cfg).__name__]
    return cls(**cfg.__dict__)


def test_continuous_forward_and_sample_squashed_match_reference():
    cfg = jrlm.ContinuousModuleConfig(observation_size=3, action_size=2,
                                      action_high=2.0)
    jp = jrlm.init_continuous_params(cfg, jax.random.PRNGKey(1))
    tp = _to_port(jp)
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(16, 3)).astype(np.float32)
    act = rng.uniform(-2, 2, (16, 2)).astype(np.float32)
    mean, log_std = jrlm.actor_forward(jp["actor"], jnp.asarray(obs))
    tmean, tlog_std = rlm.actor_forward(tp["actor"], torch.as_tensor(obs))
    np.testing.assert_allclose(tmean.detach().numpy(), mean, **F32)
    np.testing.assert_allclose(tlog_std.detach().numpy(), log_std, **F32)
    for q in ("q1", "q2"):
        np.testing.assert_allclose(
            rlm.q_forward(tp[q], torch.as_tensor(obs),
                          torch.as_tensor(act)).detach().numpy(),
            jrlm.q_forward(jp[q], jnp.asarray(obs), jnp.asarray(act)),
            **F32)
    key = jax.random.PRNGKey(7)
    a, logp = jrlm.sample_squashed(mean, log_std, key, 2.0)
    noise = np.asarray(jax.random.normal(key, mean.shape))
    ta, tlogp = rlm.sample_squashed(tmean, tlog_std, None, 2.0, noise=noise)
    np.testing.assert_allclose(ta.detach().numpy(), a, **F32)
    np.testing.assert_allclose(tlogp.detach().numpy(), logp, **F32)


# -------------------------------------------------------------- vtrace, GAE
def _vtrace_inputs(T=7, B=3, seed=0):
    rng = np.random.default_rng(seed)
    dones = rng.random((T, B)) < 0.2
    trunc = np.where(dones & (rng.random((T, B)) < 0.5),
                     rng.normal(size=(T, B)), 0.0).astype(np.float32)
    return dict(
        behavior_logp=np.log(rng.uniform(0.2, 0.9, (T, B))).astype(
            np.float32),
        target_logp=np.log(rng.uniform(0.2, 0.9, (T, B))).astype(np.float32),
        rewards=rng.normal(size=(T, B)).astype(np.float32),
        values=rng.normal(size=(T, B)).astype(np.float32),
        bootstrap_value=rng.normal(size=(B,)).astype(np.float32),
        dones=dones, trunc_values=trunc)


@pytest.mark.parametrize("clips", [(1.0, 1.0), (0.8, 1.2)])
def test_vtrace_matches_reference_with_dones_and_truncations(clips):
    from ray_tpu.rl.vtrace import vtrace as jvtrace
    from ray_tpu_torch.rl.vtrace import vtrace

    x = _vtrace_inputs()
    kw = dict(gamma=0.97, rho_clip=clips[0], c_clip=clips[1])
    want = jvtrace(**{k: jnp.asarray(v) for k, v in x.items()}, **kw)
    got = vtrace(**{k: torch.as_tensor(v) for k, v in x.items()}, **kw)
    for g, w in zip(got, want):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


def test_gae_and_ppo_batch_match_reference():
    from ray_tpu.rl.learner import build_ppo_batch as jbuild
    from ray_tpu.rl.learner import compute_gae as jgae
    from ray_tpu_torch.rl.learner import build_ppo_batch, compute_gae

    x = _vtrace_inputs(seed=2)
    args = (x["rewards"], x["values"], x["dones"], x["bootstrap_value"],
            0.99, 0.95, x["trunc_values"])
    for g, w in zip(compute_gae(*args), jgae(*args)):
        np.testing.assert_array_equal(g, w)
    samples = [_ppo_sample(np.random.default_rng(s)) for s in (0, 1)]
    got, want = build_ppo_batch(samples, 0.99, 0.95), jbuild(samples, 0.99,
                                                               0.95)
    assert got[1:] == want[1:]
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k])


def _ppo_sample(rng, T=16, N=4):
    return {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
            "logp": np.log(rng.uniform(0.3, 0.7, (T, N))).astype(np.float32),
            "values": rng.normal(size=(T, N)).astype(np.float32),
            "rewards": np.ones((T, N), np.float32),
            "dones": rng.random((T, N)) < 0.1,
            "trunc_values": np.zeros((T, N), np.float32),
            "last_value": rng.normal(size=(N,)).astype(np.float32),
            "episode_returns": [float(rng.integers(5, 50))]}


# -------------------------------------------------------------- updates
def test_ppo_update_matches_jax_learner():
    """One TorchLearner.update (4 epochs x 2 minibatches, grad clip
    active) against JaxLearner.update from the same weights and batch."""
    from ray_tpu.rl.learner import JaxLearner
    from ray_tpu.rl.learner import PPOLearnerConfig as JCfg
    from ray_tpu_torch.rl.learner import (PPOLearnerConfig, TorchLearner,
                                          build_ppo_batch)

    kw = dict(lr=3e-3, num_epochs=4, minibatch_size=128, max_grad_norm=0.5)
    ref = JaxLearner(cloudpickle.dumps(jrlm.MLPModuleConfig(4, 2)),
                     cloudpickle.dumps(JCfg(**kw)), seed=0)
    port = TorchLearner(cloudpickle.dumps(rlm.MLPModuleConfig(4, 2)),
                        cloudpickle.dumps(PPOLearnerConfig(**kw)), seed=0,
                        device="cpu")
    port.set_weights(_to_port(ref.params))
    batch, _, _ = build_ppo_batch(
        [_ppo_sample(np.random.default_rng(s), T=64) for s in (3, 4)],
        0.99, 0.95)
    want = ref.update(dict(batch))
    got = port.update(dict(batch))
    assert got.keys() == want.keys()
    for k in want:
        assert math.isclose(got[k], want[k], rel_tol=1e-4, abs_tol=1e-6), k
    assert_params_close(port.params, ref.params)


def _impala_batch(obs_shape, T=8, B=6, seed=0):
    rng = np.random.default_rng(seed)
    dones = rng.random((T, B)) < 0.15
    return {
        "obs": rng.random((T, B) + obs_shape).astype(np.float32),
        "last_obs": rng.random((B,) + obs_shape).astype(np.float32),
        "actions": rng.integers(0, 2, (T, B)).astype(np.int32),
        "logp": np.log(rng.uniform(0.3, 0.7, (T, B))).astype(np.float32),
        "rewards": rng.normal(size=(T, B)).astype(np.float32),
        "dones": dones,
        "trunc_values": np.where(dones & (rng.random((T, B)) < 0.5),
                                 rng.normal(size=(T, B)), 0.0).astype(
                                     np.float32),
    }


@pytest.mark.parametrize("appo", [False, True], ids=["vtrace", "appo"])
@pytest.mark.parametrize("arch", ["mlp", "cnn"])
def test_impala_update_matches_reference(arch, appo):
    from ray_tpu.rl.impala import IMPALAConfig as JCfg
    from ray_tpu.rl.impala import IMPALALearner as JLearner
    from ray_tpu_torch.rl.impala import IMPALAConfig, IMPALALearner

    if arch == "mlp":
        obs_shape = (4,)
        jmod, tmod = jrlm.MLPModuleConfig(4, 2), rlm.MLPModuleConfig(4, 2)
    else:
        obs_shape = (10, 10, 1)
        jmod = jrlm.CNNModuleConfig(obs_shape, 2)
        tmod = rlm.CNNModuleConfig(obs_shape, 2)
    kw = dict(use_appo_loss=appo, lr=1e-3, max_grad_norm=1.0,
              entropy_coeff=0.01, vf_coeff=0.5)
    ref = JLearner(cloudpickle.dumps(jmod), cloudpickle.dumps(JCfg(**kw)))
    port = IMPALALearner(cloudpickle.dumps(tmod), cloudpickle.dumps(
        IMPALAConfig(num_gpus_per_learner=0, **kw)))
    port.set_weights(_to_port(ref.params))
    for seed in (0, 1):              # two updates: Adam's second moment
        batch = _impala_batch(obs_shape, seed=seed)
        want = ref.update(dict(batch))
        got = port.update(dict(batch))
        for k in want:
            assert math.isclose(got[k], want[k], rel_tol=1e-4,
                                abs_tol=1e-6), (k, got[k], want[k])
    assert_params_close(port.params, ref.params)


class _NoCluster:
    """Stands in for the runtime module and the actor manager, so an
    algorithm's constructor builds its learner without a cluster."""

    def __init__(self, *a, **k):
        pass

    def __getattr__(self, name):
        return _NoCluster()

    def __call__(self, *a, **k):
        return _NoCluster()


def _offline(monkeypatch, *modules):
    for m in modules:
        monkeypatch.setattr(m, "rt", _NoCluster())
        monkeypatch.setattr(m, "FaultTolerantActorManager", _NoCluster)


def _replay_batch(rng, obs=4, B=64, continuous=0):
    if continuous:
        actions = rng.uniform(-1, 1, (B, continuous)).astype(np.float32)
    else:
        actions = rng.integers(0, 2, B).astype(np.int32)
    return {"obs": rng.normal(size=(B, obs)).astype(np.float32),
            "actions": actions,
            "rewards": rng.normal(size=B).astype(np.float32),
            "next_obs": rng.normal(size=(B, obs)).astype(np.float32),
            "dones": rng.random(B) < 0.2}


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_update_matches_reference(monkeypatch, double_q):
    from ray_tpu.rl import dqn as jdqn
    from ray_tpu_torch.rl import dqn

    _offline(monkeypatch, jdqn, dqn)
    kw = dict(double_q=double_q, lr=1e-3, hidden=(32, 32))
    ref = jdqn.DQNConfig(**kw).build()
    port = dqn.DQNConfig(num_gpus_per_learner=0, **kw).build()
    ref.target_params = jrlm.init_params(ref.module_cfg,
                                         jax.random.PRNGKey(5))
    from ray_tpu_torch.rl.learner import load_into

    load_into(port.params, _to_port(ref.params))
    port.learner.target_params = _to_port(ref.target_params)
    rng = np.random.default_rng(0)
    for _ in range(2):
        batch = _replay_batch(rng)
        ref.params, ref._opt_state, want = ref._update(
            ref.params, ref.target_params, ref._opt_state,
            {k: jnp.asarray(v) for k, v in batch.items()})
        got = port.learner.update(port.learner.to_device(batch))
        assert math.isclose(float(got), float(want), rel_tol=1e-4)
    assert_params_close(port.params, ref.params)


def test_sac_update_matches_reference_with_injected_noise(monkeypatch):
    from ray_tpu.rl import sac as jsac
    from ray_tpu_torch.rl import sac

    _offline(monkeypatch, jsac, sac)
    kw = dict(env="Pendulum-v1", hidden=(32, 32), actor_lr=3e-3,
              critic_lr=3e-3, alpha_lr=3e-3, initial_alpha=0.2, tau=0.05)
    ref = jsac.SACConfig(**kw).build()
    port = sac.SACConfig(num_gpus_per_learner=0, **kw).build()
    from ray_tpu_torch.rl.learner import load_into

    load_into(port.params, _to_port(ref.params))
    load_into(port.learner.target_q, _to_port(ref.target_q))
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(11)
    for _ in range(2):
        batch = _replay_batch(rng, obs=3, continuous=1)
        key, k = jax.random.split(key)
        kc, ka = jax.random.split(k)
        B, A = batch["actions"].shape
        noise = (np.asarray(jax.random.normal(kc, (B, A))),
                 np.asarray(jax.random.normal(ka, (B, A))))
        (ref.params, ref.target_q, ref.log_alpha, ref._opt_state,
         want) = ref._update(ref.params, ref.target_q, ref.log_alpha,
                             ref._opt_state,
                             {k2: jnp.asarray(v) for k2, v in batch.items()},
                             k)
        got = port.learner.update(port.learner.to_device(batch),
                                  noise=noise)
        for name in want:
            assert math.isclose(float(got[name]), float(want[name]),
                                rel_tol=1e-4, abs_tol=1e-6), name
    assert_params_close(port.params, ref.params)
    assert_params_close(port.learner.target_q, ref.target_q)
    assert math.isclose(float(port.learner.log_alpha), float(ref.log_alpha),
                        rel_tol=1e-4)


# -------------------------------------------------------- aliasing trap
def test_target_networks_are_copies_not_aliases():
    """JAX's tree.map(lambda x: x, params) target copies share immutable
    arrays; in torch they are clones, or the in-place optimizer step would
    move the target network too."""
    from ray_tpu_torch.rl import dqn, sac

    learner = dqn.DQNLearner(rlm.MLPModuleConfig(4, 2, hidden=(16,)),
                             dqn.DQNConfig(), "cpu")
    before = rlm.clone_tree(learner.target_params)
    ptrs = {t.data_ptr() for t in rlm.tensor_leaves(learner.params)}
    assert not ptrs & {t.data_ptr()
                       for t in rlm.tensor_leaves(learner.target_params)}
    learner.update(learner.to_device(_replay_batch(
        np.random.default_rng(0))))
    for t, b in zip(rlm.tensor_leaves(learner.target_params),
                    rlm.tensor_leaves(before)):
        assert torch.equal(t, b)
    assert not all(torch.equal(p, b) for p, b in zip(
        rlm.tensor_leaves(learner.params), rlm.tensor_leaves(before)))

    s = sac.SACLearner(rlm.ContinuousModuleConfig(3, 1, hidden=(16,)),
                       sac.SACConfig(tau=0.0), "cpu")
    before = rlm.clone_tree(s.target_q)
    s.update(s.to_device(_replay_batch(np.random.default_rng(1), obs=3,
                                       continuous=1)))
    for t, b in zip(rlm.tensor_leaves(s.target_q),
                    rlm.tensor_leaves(before)):
        assert torch.equal(t, b)          # tau 0: the targets stay put
    assert not torch.equal(s.params["q1"][0]["w"], before["q1"][0]["w"])


# ------------------------------------------------- the device-rebuild rule
def test_gpu_lease_reads_the_resource_demand():
    from ray_tpu_torch.core.device_objects import gpu_lease

    assert gpu_lease({"CPU": 1.0}) == 0.0
    assert gpu_lease({"CPU": 1.0, "GPU": 0.5}) == 0.5
    assert gpu_lease({"GPU_pg_" + "ab" * 8 + "_0": 1.0}) == 1.0
    assert gpu_lease(None) == 0.0


class _Worker:
    def __init__(self, gpus):
        self.leased_gpus = gpus


def test_rebuild_picks_the_cpu_in_an_unleased_process():
    """With CUDA visible (is_available patched True) but neither a GPU
    lease nor an initialised context, a tensor that arrives as host bytes
    is rebuilt on the CPU and `.to("cuda")` is never called; a GPU lease
    or an initialised context picks the card."""
    from ray_tpu_torch.core import device_objects as dobj

    real_to = torch.Tensor.to
    calls = []

    def to(self, *a, **k):
        calls.append((a, k))
        if "cuda" in str(a) + str(k):
            raise AssertionError("moved to cuda")
        return real_to(self, *a, **k)

    t = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    with mock.patch("torch.cuda.is_available", return_value=True), \
            mock.patch("torch.cuda.is_initialized", return_value=False), \
            mock.patch.object(torch.Tensor, "to", to):
        assert dobj.rebuild_device() == "cpu"
        back = dobj.deserialize_array(dobj.serialize_array(t))
        assert back.device.type == "cpu" and torch.equal(back, t)
        with mock.patch("ray_tpu_torch.core.object_ref._core_worker",
                        _Worker(0.0)):
            assert dobj.rebuild_device() == "cpu"
        with mock.patch("ray_tpu_torch.core.object_ref._core_worker",
                        _Worker(0.5)):
            assert dobj.rebuild_device() == "cuda"
    assert not any("cuda" in str(c) for c in calls)
    with mock.patch("torch.cuda.is_initialized", return_value=True):
        assert dobj.rebuild_device() == "cuda"
    # a lease with no card to back it stays on the CPU
    with mock.patch("torch.cuda.is_available", return_value=False), \
            mock.patch("ray_tpu_torch.core.object_ref._core_worker",
                       _Worker(1.0)):
        assert dobj.rebuild_device() == "cpu"


@pytest.fixture
def port_cluster():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 2})
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


def _lease_probe():
    from unittest import mock as _mock

    from ray_tpu_torch.core import device_objects as dobj
    from ray_tpu_torch.core.object_ref import get_core_worker

    with _mock.patch("torch.cuda.is_available", return_value=True):
        return get_core_worker().leased_gpus, dobj.rebuild_device()


def test_workers_read_their_own_gpu_lease(port_cluster):
    """An actor reads its lease for its lifetime (the constructor
    included), a task while it runs; with CUDA made visible, only the
    GPU-leased ones pick the card."""
    rt = port_cluster

    class Probe:
        def __init__(self):
            self.at_init = _lease_probe()

        def probe(self):
            return self.at_init, _lease_probe()

    gpu = rt.remote(num_cpus=0, num_gpus=1)(Probe).remote()
    cpu = rt.remote(num_cpus=1)(Probe).remote()
    assert rt.get(gpu.probe.remote(), timeout=60) == ((1.0, "cuda"),
                                                      (1.0, "cuda"))
    assert rt.get(cpu.probe.remote(), timeout=60) == ((0.0, "cpu"),
                                                      (0.0, "cpu"))
    task = rt.remote(num_cpus=1, num_gpus=0.5)(_lease_probe)
    assert rt.get(task.remote(), timeout=60) == (0.5, "cuda")
    plain = rt.remote(num_cpus=1)(_lease_probe)
    assert rt.get(plain.remote(), timeout=60) == (0.0, "cpu")
    rt.kill(gpu)
    rt.kill(cpu)


# ---------------------------------------- twins of the reference's tests
def test_vtrace_on_policy_reduces_to_returns_torch():
    """Twin of test_rl.py::test_vtrace_on_policy_reduces_to_returns."""
    from ray_tpu_torch.rl.vtrace import vtrace

    T, B = 4, 1
    logp = torch.log(torch.full((T, B), 0.5))
    vs, pg_adv = vtrace(logp, logp, torch.ones(T, B), torch.zeros(T, B),
                        torch.zeros(B), torch.zeros(T, B),
                        torch.zeros(T, B), gamma=1.0)
    np.testing.assert_allclose(vs[:, 0].numpy(), [4, 3, 2, 1], atol=1e-5)
    np.testing.assert_allclose(pg_adv[:, 0].numpy(), [4, 3, 2, 1],
                               atol=1e-5)


def test_vtrace_done_cuts_bootstrap_torch():
    """Twin of test_rl.py::test_vtrace_done_cuts_bootstrap."""
    from ray_tpu_torch.rl.vtrace import vtrace

    T, B = 3, 1
    logp = torch.zeros(T, B)
    dones = torch.tensor([[0.0], [1.0], [0.0]])
    vs, _ = vtrace(logp, logp, torch.ones(T, B), torch.zeros(T, B),
                   torch.full((B,), 100.0), dones, torch.zeros(T, B),
                   gamma=1.0)
    np.testing.assert_allclose(vs[:, 0].numpy(), [2.0, 1.0, 101.0],
                               atol=1e-5)


def test_cnn_module_forward_and_grad_torch():
    """Twin of test_rl.py::test_cnn_module_forward_and_grad: the stride
    rides as a plain int that gradients and the optimizer never see."""
    from ray_tpu_torch.rl.learner import ClippedAdam, trainable

    cfg = rlm.CNNModuleConfig(obs_shape=(10, 10, 1), num_actions=3)
    params = rlm.init_params(cfg, 0, device="cpu")
    obs = torch.zeros(5, 10, 10, 1)
    logits, value = rlm.forward(params, obs)
    assert logits.shape == (5, 3) and value.shape == (5,)
    leaves = trainable(params)
    opt = ClippedAdam(leaves, 1e-3)
    lg, v = rlm.forward(params, obs)
    opt.step(torch.autograd.grad((lg ** 2).mean() + (v ** 2).mean(),
                                 leaves))
    assert params["conv"][0]["meta"] == 2
    assert len(leaves) == 10          # 2 conv w/b, dense, pi, vf
    a, logp, v = rlm.sample_actions(params, np.zeros((3, 10, 10, 1),
                                                     np.float32),
                                    torch.Generator().manual_seed(1))
    assert a.shape == (3,) and a.dtype == np.int32 and logp.shape == (3,)


def test_sample_squashed_logp_matches_density_torch():
    """Twin of test_sac.py::test_sample_squashed_logp_matches_density."""
    rng = np.random.RandomState(0)
    mean = torch.as_tensor(rng.randn(16, 3).astype(np.float32))
    log_std = torch.as_tensor(rng.uniform(-2, 0.5, (16, 3)).astype(
        np.float32))
    h = 2.0
    a, logp = rlm.sample_squashed(mean, log_std,
                                  torch.Generator().manual_seed(0), h)
    a, logp = a.numpy(), logp.numpy()
    assert (np.abs(a) <= h + 1e-6).all()
    u = np.arctanh(np.clip(a / h, -1 + 1e-7, 1 - 1e-7))
    std = np.exp(log_std.numpy())
    log_n = (-0.5 * (((u - mean.numpy()) / std) ** 2)
             - log_std.numpy() - 0.5 * math.log(2 * math.pi))
    jac = np.log(1 - np.tanh(u) ** 2 + 1e-12) + math.log(h)
    np.testing.assert_allclose(logp, (log_n - jac).sum(axis=-1),
                               rtol=1e-3, atol=1e-3)


def test_policy_mapping_groups_agents_torch():
    """Twin of test_rl_multi_agent.py::test_policy_mapping_groups_agents:
    4 agents -> 2 policies; each policy's runner batch carries both its
    agents' streams."""
    from ray_tpu_torch.rl.multi_agent import MultiAgentEnvRunner

    cfgs = {"even": rlm.MLPModuleConfig(observation_size=4, num_actions=2,
                                        hidden=(16,)),
            "odd": rlm.MLPModuleConfig(observation_size=4, num_actions=2,
                                       hidden=(16,))}
    threads = torch.get_num_threads()
    try:
        runner = MultiAgentEnvRunner(
            "MultiAgentCartPole", 4, 0, cloudpickle.dumps(cfgs),
            cloudpickle.dumps(
                lambda aid: "even" if int(aid[-1]) % 2 == 0 else "odd"),
            cloudpickle.dumps({"num_agents": 4}))
        assert torch.get_num_threads() == 1
    finally:
        torch.set_num_threads(threads)
    assert runner.policy_agents == {"even": ["agent_0", "agent_2"],
                                    "odd": ["agent_1", "agent_3"]}
    runner.set_weights({p: rlm.to_host(rlm.init_params(c, 0, "cpu"))
                        for p, c in cfgs.items()})
    out = runner.sample(8)["policies"]
    assert out["even"]["obs"].shape == (8, 8, 4)
    assert out["odd"]["rewards"].shape == (8, 8)
    assert out["even"]["last_value"].shape == (8,)


def _fake_cw():
    class _FakeCW:
        gcs = object()

        def _spawn_from_thread(self, coro):
            coro.close()

    return _FakeCW()


def test_rl_learner_emits_step_waterfall_torch(monkeypatch):
    """Twin of test_train_observability.py::
    test_rl_learner_emits_step_waterfall, reading the learner's
    StepRecorder records directly: the run record rides the recorder's
    own buffer ahead of the steps, so a flush of the steps carries it."""
    from ray_tpu_torch.rl.impala import IMPALAConfig, IMPALALearner
    from ray_tpu_torch.train import telemetry

    fake = _fake_cw()
    monkeypatch.setattr(telemetry._TrainPublisher, "_core_worker",
                        staticmethod(lambda: fake))
    learner = IMPALALearner(
        cloudpickle.dumps(rlm.MLPModuleConfig(4, 2, hidden=(16,))),
        cloudpickle.dumps(IMPALAConfig(num_gpus_per_learner=0)))
    rec = learner._recorder
    assert rec is not None and rec.experiment == "rl:impala"
    T, B = 8, 4
    rng = np.random.default_rng(0)
    for _ in range(3):
        out = learner.update({
            "obs": rng.normal(size=(T, B, 4)).astype(np.float32),
            "last_obs": rng.normal(size=(B, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, B)).astype(np.int32),
            "logp": np.full((T, B), -0.6931, np.float32),
            "rewards": np.ones((T, B), np.float32),
            "dones": np.zeros((T, B), np.float32),
            "trunc_values": np.zeros((T, B), np.float32)})
        assert np.isfinite(out["loss"])
        time.sleep(0.01)
    rec.end_phase()
    with rec._pub._lock:
        recs = list(rec._pub._buf)
    assert recs[0]["kind"] == "run"
    assert recs[0]["run_id"] == learner._run_id
    steps = [r for r in recs if r["kind"] == "step"]
    assert [s["step"] for s in steps] == [1, 2, 3]
    assert all(s["run_id"] == learner._run_id for s in steps)
    assert all(s["stages"]["step_s"] > 0 for s in steps)
    assert any(s["stages"]["data_wait_s"] > 0
               for s in steps if s["step"] > 1)
    compiles = [r for r in recs if r["kind"] == "compile"]
    assert [c["fn"] for c in compiles] == ["impala_update"]
    assert compiles[0]["event"] == "compile"


def test_learner_devices_above_one_names_item_6(port_cluster):
    """learner_devices=2 on the CPU: the algorithm builds its learner over
    two gloo ranks in one placement group, and trains through them."""
    from ray_tpu_torch.rl.impala import IMPALAConfig

    algo = IMPALAConfig(
        learner_devices=2, num_gpus_per_learner=0, num_env_runners=1,
        num_envs_per_runner=4, rollout_fragment_length=32,
        train_batch_size=128, min_updates_per_iteration=2, seed=3).build()
    try:
        assert len(algo._learner_ranks) == 1
        assert algo._learner_pg is not None
        result = algo.train()
        assert result["num_learner_updates"] >= 1
        assert math.isfinite(result["learner/loss"])
        where = port_cluster.get(algo._learner.placement.remote(),
                                 timeout=60)
        assert where["device"] == "cpu" and where["num_updates"] >= 1
    finally:
        algo.stop()


def test_impala_learns_cartpole_torch(port_cluster):
    """Twin of test_rl.py::test_impala_learns_cartpole, whose pack-coverage
    tail runs jax: the same learning gate, compiled-DAG and throughput
    floors, then the device framing's coverage of the port's weights."""
    from ray_tpu_torch.dag.channel_exec import ChannelCompiledDAG
    from ray_tpu_torch.dag.device_channel import pack_device_tree
    from ray_tpu_torch.rl import IMPALAConfig

    rt = port_cluster
    algo = IMPALAConfig(
        env="CartPole-v1", num_env_runners=2, num_envs_per_runner=8,
        rollout_fragment_length=64, train_batch_size=512, vf_coeff=0.25,
        lr=1e-3, entropy_coeff=0.01, seed=1,
        num_gpus_per_learner=0).build()
    best = 0.0
    try:
        assert isinstance(algo._dag.dag, ChannelCompiledDAG)
        assert algo._dag.channel_kinds["shm"] > 0
        assert algo._dag.channel_kinds["device"] > 0, \
            algo._dag.channel_kinds
        algo.train()
        s0 = algo._total_steps
        t0 = time.perf_counter()
        updates = 0
        for _ in range(40):
            result = algo.train()
            updates += result["num_learner_updates"]
            best = max(best, result["episode_return_mean"])
            if best >= 100.0:
                break
        dt = time.perf_counter() - t0
        assert best >= 100.0, f"IMPALA failed to learn: best={best}"
        steps_per_s = (algo._total_steps - s0) / dt
        assert steps_per_s >= 250.0, steps_per_s
        assert updates / dt >= 0.25, updates / dt
        dev_inputs = algo._dag.dag._device_input_channels
        assert dev_inputs, "weight-broadcast edges are not device-kind"
        assert sum(ch.device_arrays for ch in dev_inputs) > 0
        w = rt.get(algo._learner.get_weights.remote(), timeout=60)
        tensors = rlm.to_device(w, "cpu")
        packed, n = pack_device_tree(tensors)
        assert n == len(rlm.tensor_leaves(tensors))    # full coverage
        # the batches arrived over the device edge as tensors (on the
        # CPU here, where the learner is leased no GPU)
        where = rt.get(algo._learner.placement.remote(), timeout=60)
        assert set(where["batch_arrivals"]) == {"cpu"}, where
        # the runners read the weights as CPU tensors and never touched
        # CUDA
        assert algo._runners.foreach(
            lambda a: a.cuda_initialized.remote()) == [False, False]
    finally:
        algo.stop()
