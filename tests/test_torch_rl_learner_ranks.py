"""IMPALA's learner over several ranks (``learner_devices=2``) on gloo CPU
ranks (``num_gpus_per_learner=0``): rank 0 is the IMPALALearner actor, rank
1 an IMPALALearnerRank actor in the same placement group. One update holds
against the reference's IMPALALearner with ``learner_devices=2`` (its batch
sharded over a 2-device mesh of the 8 virtual CPU devices) to 1e-4, the RL
tolerance, and against the port's one-rank update on the whole batch; a
batch whose env axis does not divide over the ranks goes whole to each."""

from __future__ import annotations

import math

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu.rl import module as jrlm
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.rl import module as rlm
from test_torch_rl import _impala_batch, _to_port, assert_params_close

CALL_TIMEOUT_S = 90


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    try:
        yield rt
    finally:
        rt.shutdown()


@pytest.mark.parametrize("appo", [False, True], ids=["vtrace", "appo"])
def test_two_rank_learner_update_matches_reference(cluster, appo):
    from ray_tpu.rl.impala import IMPALAConfig as JCfg
    from ray_tpu.rl.impala import IMPALALearner as JLearner
    from ray_tpu_torch.rl.impala import (IMPALAConfig, IMPALALearner,
                                         _start_learner)

    kw = dict(use_appo_loss=appo, lr=1e-3, max_grad_norm=1.0,
              entropy_coeff=0.01, vf_coeff=0.5)
    jmod, tmod = jrlm.MLPModuleConfig(4, 2), rlm.MLPModuleConfig(4, 2)
    ref = JLearner(cloudpickle.dumps(jmod),
                   cloudpickle.dumps(JCfg(learner_devices=2, **kw)))
    assert ref._mesh is not None and ref._mesh.shape["data"] == 2
    one = IMPALALearner(cloudpickle.dumps(tmod), cloudpickle.dumps(
        IMPALAConfig(num_gpus_per_learner=0, **kw)))
    cfg = IMPALAConfig(num_gpus_per_learner=0, learner_devices=2,
                       call_timeout_s=CALL_TIMEOUT_S, **kw)
    learner, others, pg = _start_learner(cfg, cloudpickle.dumps(tmod),
                                         cloudpickle.dumps(cfg))
    try:
        start = _to_port(ref.params)
        one.set_weights(start)
        assert rt.get(learner.set_weights.remote(start),
                      timeout=CALL_TIMEOUT_S)
        # B=6 splits 3 + 3 over the two ranks; B=5 does not divide, so
        # every key goes whole to both
        for seed, B in ((0, 6), (1, 5)):
            batch = _impala_batch((4,), B=B, seed=seed)
            want = ref.update(dict(batch))
            whole = one.update(dict(batch))
            got = rt.get(learner.update.remote(dict(batch)),
                         timeout=CALL_TIMEOUT_S)
            for k in want:
                assert math.isclose(got[k], want[k], rel_tol=1e-4,
                                    abs_tol=1e-6), (k, got[k], want[k])
                assert math.isclose(got[k], whole[k], rel_tol=1e-4,
                                    abs_tol=1e-6), (k, got[k], whole[k])
        w0 = rt.get(learner.get_weights.remote(), timeout=CALL_TIMEOUT_S)
        w1 = rt.get(others[0].get_weights.remote(), timeout=CALL_TIMEOUT_S)
        port = params_from_numpy(w0, device="cpu")
        assert_params_close(port, ref.params)
        assert_params_close(port, params_to_numpy(one.params))
        # the ranks step on the same mean gradient: equal params
        for a, b in zip(rlm.tensor_leaves(port), rlm.tensor_leaves(
                params_from_numpy(w1, device="cpu"))):
            assert a.numpy().tobytes() == b.numpy().tobytes()
    finally:
        for a in [learner] + others:
            rt.kill(a)
        rt.remove_placement_group(pg)


def test_learner_ranks_the_cluster_cannot_place_raise(cluster):
    """Two GPU ranks on a cluster without a GPU: the reference drops its
    mesh on fewer devices; the port raises before it starts any rank."""
    from ray_tpu_torch.rl.impala import IMPALAConfig, _start_learner

    cfg = IMPALAConfig(learner_devices=2, num_gpus_per_learner=1)
    with pytest.raises(RuntimeError, match="learner_devices=2 needs 2"):
        _start_learner(cfg, cloudpickle.dumps(rlm.MLPModuleConfig(4, 2)),
                       cloudpickle.dumps(cfg))
