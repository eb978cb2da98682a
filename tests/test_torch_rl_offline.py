"""The port's offline RL against the JAX package's.

One BC update and one CQL update (two each) from the reference's weights,
converted, on the same numpy minibatch: the losses and every param leaf
agree to 1e-4 (`assert_params_close`). The learners' device follows
``num_gpus_per_learner`` (the card above 0, raising without one); CQL's
target network is a copy; the dataset IO round-trips through the data
plane's npz reader with the reference's shard names.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.rl import module as jrlm
from test_torch_rl import _to_port, assert_params_close


class _Columns:
    """A stand-in dataset over in-memory columns (the update parity needs
    no cluster): one batch of everything, as CQL materializes it."""

    def __init__(self, cols: dict):
        self.cols = cols

    def iter_batches(self, batch_size, drop_last=False):
        yield dict(self.cols)


def _transitions(rng, n=2048):
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "rewards": np.ones(n, np.float32),
            "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
            "dones": rng.random(n) < 0.05}


@pytest.fixture
def no_dataset(monkeypatch):
    from ray_tpu.rl import offline as joffline
    from ray_tpu_torch.rl import offline

    cols = _transitions(np.random.default_rng(1))
    for m in (joffline, offline):
        monkeypatch.setattr(m, "read_offline_dataset",
                            lambda path: _Columns(cols))


def _batch(rng, keys, B=256):
    t = _transitions(rng, B)
    return {k: t[k] for k in keys}


def test_bc_update_matches_reference(no_dataset):
    from ray_tpu.rl import offline as joffline
    from ray_tpu_torch.rl import offline
    from ray_tpu_torch.rl.learner import load_into

    kw = dict(hidden=(32, 32), lr=3e-3, seed=0)
    ref = joffline.BCConfig(**kw).build()
    port = offline.BCConfig(num_gpus_per_learner=0, **kw).build()
    load_into(port.params, _to_port(ref.params))
    rng = np.random.default_rng(0)
    for _ in range(2):
        batch = _batch(rng, ("obs", "actions"))
        ref.params, ref._opt_state, want = ref._update(
            ref.params, ref._opt_state,
            {k: jnp.asarray(v) for k, v in batch.items()})
        got = port.learner.update(port.learner.to_device(batch))
        assert math.isclose(float(got), float(want), rel_tol=1e-4)
    assert_params_close(port.params, ref.params)


def test_cql_update_matches_reference(no_dataset):
    import jax

    from ray_tpu.rl import offline as joffline
    from ray_tpu_torch.rl import offline
    from ray_tpu_torch.rl.learner import load_into

    kw = dict(hidden=(32, 32), lr=1e-3, cql_alpha=0.5, seed=0)
    ref = joffline.CQLConfig(**kw).build()
    port = offline.CQLConfig(num_gpus_per_learner=0, **kw).build()
    ref.target_params = jrlm.init_params(ref.module_cfg,
                                         jax.random.PRNGKey(5))
    load_into(port.params, _to_port(ref.params))
    port.learner.target_params = _to_port(ref.target_params)
    rng = np.random.default_rng(0)
    for _ in range(2):
        batch = _batch(rng, ("obs", "actions", "rewards", "next_obs",
                             "dones"))
        ref.params, ref._opt_state, want = ref._update(
            ref.params, ref.target_params, ref._opt_state,
            {k: jnp.asarray(v) for k, v in batch.items()})
        got = port.learner.update(port.learner.to_device(batch))
        assert math.isclose(float(got), float(want), rel_tol=1e-4)
    assert_params_close(port.params, ref.params)
    assert_params_close(port.learner.target_params, ref.target_params)


def test_cql_train_draws_the_reference_minibatches(no_dataset):
    """CQL.train indexes its device-resident columns with the reference's
    numpy draws: one iteration of a few updates from the same weights
    lands on the same weights."""
    from ray_tpu.rl import offline as joffline
    from ray_tpu_torch.rl import offline
    from ray_tpu_torch.rl.learner import load_into

    kw = dict(hidden=(32, 32), lr=1e-3, updates_per_iteration=4,
              target_update_freq=2, batch_size=64, seed=2)
    ref = joffline.CQLConfig(**kw).build()
    port = offline.CQLConfig(num_gpus_per_learner=0, **kw).build()
    load_into(port.params, _to_port(ref.params))
    port.learner.sync_target()
    want, got = ref.train(), port.train()
    assert got["num_updates"] == want["num_updates"] == 4
    assert math.isclose(got["loss"], want["loss"], rel_tol=1e-4)
    assert_params_close(port.params, ref.params)
    assert_params_close(port.learner.target_params, ref.target_params)


def test_learner_device_follows_num_gpus(no_dataset, monkeypatch):
    import torch

    from ray_tpu_torch.rl import offline

    algo = offline.BCConfig(num_gpus_per_learner=0).build()
    assert algo.learner.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in (offline.BCConfig(), offline.CQLConfig()):
        assert cfg.num_gpus_per_learner == 1
        with pytest.raises(RuntimeError, match="CUDA device"):
            cfg.build()


def test_cql_target_network_is_a_copy(no_dataset):
    from ray_tpu_torch.rl import offline
    from ray_tpu_torch.rl.module import tensor_leaves

    algo = offline.CQLConfig(num_gpus_per_learner=0,
                             updates_per_iteration=3,
                             target_update_freq=100).build()
    before = [t.clone() for t in tensor_leaves(algo.learner.target_params)]
    ptrs = {t.data_ptr() for t in tensor_leaves(algo.params)}
    assert not ptrs & {t.data_ptr()
                       for t in tensor_leaves(algo.learner.target_params)}
    algo.train()
    for a, b in zip(before, tensor_leaves(algo.learner.target_params)):
        assert a.equal(b)   # no sync yet: the target did not move


def test_offline_dataset_round_trip_matches_reference(tmp_path):
    """write_offline_dataset writes the reference's shard files, and the
    port's npz reader reads both packages' shards as the same columns."""
    from ray_tpu.rl import offline as joffline
    import ray_tpu_torch as rt
    from ray_tpu_torch.rl import offline

    def expert(obs):
        return (obs[:, 2] + 0.5 * obs[:, 3] > 0).astype(np.int32)

    trans = offline.collect_transitions("CartPole-v1", expert, 512, 8, 0)
    want = joffline.collect_transitions("CartPole-v1", expert, 512, 8, 0)
    for k in want:
        assert np.array_equal(trans[k], want[k]), k
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    assert offline.write_offline_dataset(trans, ours, 200) == 512
    assert joffline.write_offline_dataset(want, theirs, 200) == 512
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    rt.init(num_cpus=2)
    try:
        cols = [next(offline.read_offline_dataset(p).iter_batches(
            batch_size=1 << 20)) for p in (ours, theirs)]
    finally:
        rt.shutdown()
    for k in want:
        assert np.array_equal(cols[0][k], cols[1][k]), k
        assert np.array_equal(cols[0][k], want[k]), k
