"""The port's twins of the JAX package's RL benches
(``ray_tpu_torch/tools/rl_*_bench.py``) at their smallest size with the
learner on the CPU: each prints one JSON line carrying the keys of the
reference bench's result (read from the reference's source). Apart from
``test_torch_tools.py`` so that the two files run on different workers."""

import pytest

from test_torch_tools import reference_keys, run_twin

CASES = {
    # twin -> (its smallest arguments, the reference's tool)
    "rl_ppo_bench": (("1", "1"), "tools/rl_ppo_bench.py"),
    "rl_scale_bench": (("2", "1"), "tools/rl_scale_bench.py"),
    "rl_image_bench": (("2", "0.05"), "tools/rl_image_bench.py"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rl_bench_twin_prints_the_reference_keys(name):
    args, tool = CASES[name]
    out = run_twin(name, *args, timeout=150)
    assert reference_keys(tool, "_bench_body", "out") <= set(out)
    assert out["learner_device"] == "cpu"
    assert out["num_env_runners"] == int(args[0])
    assert out["samples_per_s"] > 0
