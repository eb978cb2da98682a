"""The port's Tune against the JAX package, and its GPU leases.

``BasicVariantGenerator`` and ``TPESearcher`` propose the same configs as
the JAX package's from the same seed (TPE fed the same results). On a
cluster with one GPU, a trial given ``ScalingConfig()`` leases the port's
default of one GPU, so the capacity count is 1 (the reference reads
``resources_per_worker`` as given and would start more trials than the
card can place); trials leased ``{"GPU": 0.5}`` count 2 and run two at
once on the one card.
"""

import os
import time

import pytest


def _space(tune):
    return {"lr": tune.loguniform(1e-5, 1e-1),
            "layers": tune.choice([1, 2, 4, 8]),
            "dropout": tune.uniform(0.0, 0.5),
            "nested": {"width": tune.randint(16, 256),
                       "act": tune.choice(["relu", "gelu", "silu"])}}


def test_variant_generator_proposes_the_reference_configs():
    from ray_tpu import tune as jtune
    from ray_tpu.tune.search import BasicVariantGenerator as JGen
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.search import BasicVariantGenerator

    def space(t):
        return {**_space(t), "seed": t.grid_search([0, 1, 2]),
                "opt": {"grid_search": ["adam", "sgd"]}}

    for seed in (0, 7):
        want = JGen(space(jtune), num_samples=3, seed=seed).variants()
        got = BasicVariantGenerator(space(tune), num_samples=3,
                                    seed=seed).variants()
        assert len(got) == 3 * 3 * 2
        assert got == want


def _objective(config) -> float:
    return ((config["lr"] - 1e-3) ** 2 * 1e4 + config["layers"] * 0.1
            + abs(config["dropout"] - 0.2)
            + abs(config["nested"]["width"] - 128) / 128)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_tpe_searcher_proposes_the_reference_configs(mode):
    from ray_tpu import tune as jtune
    from ray_tpu_torch import tune

    ref = jtune.TPESearcher(_space(jtune), metric="loss", mode=mode,
                            n_startup_trials=5, seed=3)
    port = tune.TPESearcher(_space(tune), metric="loss", mode=mode,
                            n_startup_trials=5, seed=3)
    for i in range(16):
        want = ref.suggest(f"t{i}")
        got = port.suggest(f"t{i}")
        assert got == want, i
        ref.on_trial_complete(f"t{i}", {"loss": _objective(want)})
        port.on_trial_complete(f"t{i}", {"loss": _objective(got)})


@pytest.fixture
def gpu_cluster():
    """A cluster advertising one GPU (the trials below never touch it)."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=4, resources={"GPU": 1})
    try:
        yield rt
    finally:
        rt.shutdown()


def test_capacity_counts_the_default_gpu_lease(gpu_cluster):
    from ray_tpu_torch import tune
    from ray_tpu_torch.train.config import ScalingConfig

    def capacity(**kw):
        return tune.Tuner(lambda config: None, **kw)._capacity_trials()

    assert capacity(scaling_config=ScalingConfig()) == 1
    assert capacity(scaling_config=ScalingConfig(
        resources_per_worker={"CPU": 1, "GPU": 0.5})) == 2
    assert capacity(scaling_config=ScalingConfig(use_gpu=False)) == 4
    assert capacity(resources_per_trial={"CPU": 1, "GPU": 0.5}) == 2
    assert capacity(resources_per_trial={"CPU": 1}) == 4
    assert capacity() == 1      # the default: one GPU a trial


def _sharing_trial(config):
    """Reports when it ran and what the cluster had free meanwhile."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import train

    start = time.time()
    deadline = time.monotonic() + 20
    free = rt.available_resources().get("GPU", 0.0)
    while free != 0.0 and time.monotonic() < deadline:
        time.sleep(0.1)     # the view follows the other trial's lease
        free = rt.available_resources().get("GPU", 0.0)
    time.sleep(1.0)
    train.report({"score": config["x"], "start": start, "end": time.time(),
                  "gpu_free": free, "pid": os.getpid(),
                  "use_gpu": train.get_context().use_gpu})


@pytest.mark.parametrize("how", ["scaling_config", "resources_per_trial"])
def test_half_gpu_trials_share_the_card(gpu_cluster, tmp_path, how):
    from ray_tpu_torch import tune
    from ray_tpu_torch.train.config import RunConfig, ScalingConfig

    res = {"CPU": 1, "GPU": 0.5}
    kw = ({"scaling_config": ScalingConfig(resources_per_worker=res)}
          if how == "scaling_config" else {"resources_per_trial": res})
    grid = tune.Tuner(
        _sharing_trial, param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name=how, storage_path=str(tmp_path)),
        **kw).fit()
    runs = [t.last_result for t in grid._trials]
    assert sorted(r["score"] for r in runs) == [1, 2]
    assert all(r["gpu_free"] == 0.0 and r["use_gpu"] for r in runs)
    a, b = runs
    assert a["pid"] != b["pid"]
    assert a["start"] < b["end"] and b["start"] < a["end"]  # at once
    deadline = time.monotonic() + 30
    while (gpu_cluster.available_resources().get("GPU") != 1.0
           and time.monotonic() < deadline):
        time.sleep(0.1)
    assert gpu_cluster.available_resources().get("GPU") == 1.0


def _report_x(config):
    from ray_tpu_torch import train

    train.report({"score": config["x"]})


def test_a_failed_start_does_not_end_the_run(tmp_path, monkeypatch):
    """A trial whose workers fail to set up is an error, and the trials
    still pending start after it: with one trial at a time, the first
    start failing leaves the other two to run."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.train.config import RunConfig
    from ray_tpu_torch.tune.controller import TuneController

    real_run, calls = TuneController._run, []

    def run_failing_once(self, trial, setup_refs):
        calls.append(trial.trial_id)
        if len(calls) == 1:
            raise TimeoutError("the workers of this trial never set up")
        return real_run(self, trial, setup_refs)

    monkeypatch.setattr(TuneController, "_run", run_failing_once)
    rt.init(num_cpus=2)
    try:
        grid = tune.Tuner(
            _report_x, param_space={"x": tune.grid_search([1, 2, 3])},
            tune_config=tune.TuneConfig(metric="score", mode="max",
                                        max_concurrent_trials=1),
            run_config=RunConfig(name="fail", storage_path=str(tmp_path)),
            resources_per_trial={"CPU": 1}).fit()
    finally:
        rt.shutdown()
    status = sorted(t.status.value for t in grid._trials)
    assert status == ["ERROR", "TERMINATED", "TERMINATED"]
    assert sorted(t.config["x"] for t in grid._trials) == [1, 2, 3]
    assert grid.get_best_result().metrics["score"] == 3
