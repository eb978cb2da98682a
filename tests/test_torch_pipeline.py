"""GPipe in the port (ray_tpu_torch.parallel.pipeline) on gloo CPU ranks, one
process a stage, against the reference's pipeline_apply on the 8 virtual CPU
devices and against running the stages in sequence: tests/test_pipeline.py's
forward and gradient parity (1e-5; gradients atol 1e-5 / rtol 1e-4) and leg
4 of ``dryrun_multichip`` (llama blocks as stages, with gradients, 2e-4 as
the reference's llama-blocks test). Last, the twin of
test_pp_microbatch_loop_on_compiled_dag: torch stage actors on the port's
channel-compiled DAG."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import ray_tpu_torch as rt
from ray_tpu.models import llama as jllama
from ray_tpu.ops.rope import rope_frequencies
from ray_tpu.parallel.pipeline import pipeline_apply, stack_stage_params
from torch_mesh_ranks import run_ranks


def _mlp_stage(params, x):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def _stage_params(seed, n_stages, d=8, h=16):
    rng = np.random.default_rng(seed)
    stages = [{"w1": (0.3 * rng.standard_normal((d, h))).astype(np.float32),
               "b1": (0.1 * rng.standard_normal(h)).astype(np.float32),
               "w2": (0.3 * rng.standard_normal((h, d))).astype(np.float32),
               "b2": (0.1 * rng.standard_normal(d)).astype(np.float32)}
              for _ in range(n_stages)]
    return jax.tree.map(np.asarray, stack_stage_params(
        [jax.tree.map(jnp.asarray, s) for s in stages]))


def _sequential(stage_fn, params, x, n_stages):
    for s in range(n_stages):
        x = stage_fn(jax.tree.map(lambda leaf: leaf[s], params), x)
    return x


CASES = {"s2_m4": (2, 4), "s4_m4": (4, 4), "s4_m8": (4, 8)}


@pytest.fixture(scope="module")
def mlp_runs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 8)).astype(np.float32)
    tgt = rng.standard_normal((8, 8)).astype(np.float32)
    runs = {}
    for world in (2, 4):
        names = [n for n, (s, _) in CASES.items() if s == world]
        jobs = [("pipeline", {"kind": "mlp", "x": x, "tgt": tgt,
                              "stage_params": _stage_params(0, world),
                              "n_micro": CASES[n][1]}) for n in names]
        outs = run_ranks("many", world, jobs)
        for i, n in enumerate(names):
            runs[n] = [o[i] for o in outs]
    return x, tgt, runs


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_forward_parity(cpu_mesh_devices, mlp_runs, case):
    x, _, runs = mlp_runs
    n_stages, n_micro = CASES[case]
    params = jax.tree.map(jnp.asarray, _stage_params(0, n_stages))
    ref = _sequential(_mlp_stage, params, jnp.asarray(x), n_stages)
    mesh = Mesh(np.array(cpu_mesh_devices[:n_stages]), ("stage",))
    gspmd = jax.jit(lambda p, xx: pipeline_apply(
        _mlp_stage, p, xx, mesh, n_micro=n_micro))(params, jnp.asarray(x))
    for out in runs[case]:               # every stage returns the output
        np.testing.assert_allclose(out["out"], ref, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(out["out"], gspmd, atol=1e-5, rtol=1e-5)


def test_pipeline_grad_parity(mlp_runs):
    """Each stage's gradients (the reverse pipeline autograd builds from
    the ppermute and psum transposes) equal the sequential stages'."""
    x, tgt, runs = mlp_runs
    params = jax.tree.map(jnp.asarray, _stage_params(0, 4))

    def loss(p):
        out = _sequential(_mlp_stage, p, jnp.asarray(x), 4)
        return ((out - tgt) ** 2).mean()

    want = jax.grad(loss)(params)
    for stage, out in enumerate(runs["s4_m4"]):
        for key in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(out["grads"][key],
                                       np.asarray(want[key][stage]),
                                       atol=1e-5, rtol=1e-4,
                                       err_msg=f"stage {stage} {key}")


@pytest.fixture(scope="module")
def llama_run():
    cfg = jllama.config_for("debug", dtype=jnp.float32, remat=False,
                            attn_impl="xla")
    params = jax.tree.map(np.asarray,
                          jllama.init_params(cfg, jax.random.PRNGKey(3)))
    n_stages = 2
    per_stage = cfg.n_layers // n_stages
    stage_params = {k: v.reshape((n_stages, per_stage) + v.shape[1:])
                    for k, v in params["layers"].items()}
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal((4, 32, cfg.dim)).astype(np.float32)
    tgt = rng.standard_normal((4, 32, cfg.dim)).astype(np.float32)
    outs = run_ranks("pipeline", n_stages, {
        "kind": "llama", "cfg": {"dtype": "float32", "remat": False,
                                 "attn_impl": "xla"},
        "stage_params": stage_params, "x": x0, "tgt": tgt, "n_micro": 2,
        "remat": True})
    return cfg, params, x0, tgt, outs


def test_leg4_llama_blocks_as_stages(llama_run):
    """2 llama blocks over 2 stages (remat on each stage) against the
    reference's blocks run in sequence: output and every stage's block
    gradients."""
    cfg, params, x0, tgt, outs = llama_run
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                cfg.rope_theta)

    def run(layers):
        x = jnp.asarray(x0)
        for i in range(cfg.n_layers):
            layer = jax.tree.map(lambda leaf: leaf[i], layers)
            x, _ = jllama._block(cfg, x, layer, cos, sin, None)
        return x

    layers = jax.tree.map(jnp.asarray, params["layers"])
    want_out = run(layers)
    want = jax.grad(lambda p: ((run(p) - tgt) ** 2).mean())(layers)
    for stage, out in enumerate(outs):
        np.testing.assert_allclose(out["out"], want_out, atol=2e-4,
                                   rtol=2e-4)
        for name, g in out["grads"].items():
            np.testing.assert_allclose(g[0], np.asarray(want[name][stage]),
                                       atol=2e-4, rtol=2e-4,
                                       err_msg=f"stage {stage} {name}")


# ------------------------------------------- GPipe microbatches on the DAG
@pytest.fixture
def local_cluster():
    rt.init(num_cpus=4)
    try:
        yield rt
    finally:
        rt.shutdown()


class StageActor:
    """One pipeline stage: its own weight and a torch block."""

    def __init__(self, seed, dim):
        import torch

        gen = torch.Generator().manual_seed(seed)
        self.w = torch.randn((dim, dim), generator=gen) / dim

    def apply(self, x):
        import torch

        return torch.tanh(torch.as_tensor(x) @ self.w).numpy()

    def weights(self):
        return self.w.numpy()


def test_pp_microbatch_loop_on_compiled_dag_torch(local_cluster):
    """Twin of test_pipeline.py::test_pp_microbatch_loop_on_compiled_dag:
    each stage is an actor holding its own torch block; microbatches
    stream through the channel-compiled DAG, stage 2 of microbatch i
    overlapping stage 1 of microbatch i + 1; each output equals the
    stages applied in sequence."""
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.dag.channel_exec import ChannelCompiledDAG

    actor = rt.remote(StageActor)
    dim = 32
    s1, s2 = actor.remote(0, dim), actor.remote(1, dim)
    # read the weights before compiling: once the DAG loops start, the
    # actors' ordered queues belong to the DAG
    w1 = rt.get(s1.weights.remote())
    w2 = rt.get(s2.weights.remote())
    with InputNode() as inp:
        out = s2.apply.bind(s1.apply.bind(inp))
    dag = out.experimental_compile(channels=True)
    assert isinstance(dag, ChannelCompiledDAG)
    try:
        rng = np.random.RandomState(0)
        micro = [rng.randn(4, dim).astype("float32") for _ in range(6)]
        refs = [dag.execute(m) for m in micro]       # all in flight
        outs = [r.get(timeout=120) for r in refs]
        for m, o in zip(micro, outs):
            expect = np.tanh(np.tanh(m @ w1) @ w2)
            np.testing.assert_allclose(o, expect, rtol=1e-5, atol=1e-5)
    finally:
        dag.teardown()
