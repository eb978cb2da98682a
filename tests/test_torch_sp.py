"""Sequence parallelism in the port (ray_tpu_torch.ops.ring_attention and
the llama step under a seq axis) against the reference's ring and Ulysses
attention in shard_map on the 8 virtual CPU devices, forward and gradients.

The ring schedule runs here on the flash kernels' plain versions (CPU
tensors), in one process over n in-process shards (LocalTransport, what the
card's check uses) and over a gloo group of one process a shard
(GroupTransport). Tolerances are the reference's tests/test_sp.py: forward
2e-5, gradients atol 1e-5 / rtol 1e-4. The seq-sharded llama step (data 2 x
seq 2, rope at global positions) holds the unsharded reference's losses to
1e-5 relative, and the same step with each shard's positions restarting at
0 (the reference's default inside a shard) does not.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ray_tpu.models import llama as jllama
from ray_tpu.ops.attention import xla_attention
from ray_tpu.ops.ring_attention import ring_attention, ulysses_attention
from ray_tpu.parallel.mesh import MeshConfig
from ray_tpu.parallel.spmd import build_train_step, shard_batch
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import ring_attention as tra
from torch_mesh_ranks import run_ranks

FWD_TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _qkv(b, s, h, hk, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d),
                          (b, s, h, d))]


def _jax_sharded(attn_fn, devices, n, causal):
    mesh = Mesh(np.array(devices[:n]), ("seq",))
    fn = functools.partial(attn_fn, axis_name="seq", causal=causal)
    return mesh, shard_map(
        fn, mesh=mesh, in_specs=(P(None, "seq"),) * 3,
        out_specs=P(None, "seq"), check_rep=False)


def _jax_reference(attn_fn, devices, n, causal, q, k, v, g):
    """The reference's sharded op: output and the gradients of
    sum(out * g)."""
    mesh, sharded = _jax_sharded(attn_fn, devices, n, causal)
    put = lambda x: jax.device_put(  # noqa: E731
        jnp.asarray(x), NamedSharding(mesh, P(None, "seq")))
    out = jax.jit(sharded)(put(q), put(k), put(v))
    grads = jax.jit(jax.grad(
        lambda q, k, v: (sharded(q, k, v) * g).sum(), argnums=(0, 1, 2)))(
            put(q), put(k), put(v))
    return np.asarray(out), [np.asarray(x) for x in grads]


def _local_ring(n, causal, q, k, v, g):
    shards = [[t.clone().requires_grad_() for t in torch.from_numpy(x)
               .chunk(n, 1)] for x in (q, k, v)]
    outs = tra.ring_attention_local(*shards, causal=causal)
    out = torch.cat(outs, 1)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                [t for s in shards for t in s])
    cat = [torch.cat(grads[i * n:(i + 1) * n], 1).numpy() for i in range(3)]
    return out.detach().numpy(), cat


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_ring_local_fwd_parity(cpu_mesh_devices, causal, n_shards):
    q, k, v, g = _qkv(2, 64, 4, 4, 16)
    want, _ = _jax_reference(ring_attention, cpu_mesh_devices, n_shards,
                             causal, q, k, v, g)
    got, _ = _local_ring(n_shards, causal, q, k, v, g)
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)
    dense = np.asarray(xla_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=causal))
    np.testing.assert_allclose(got, dense, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_local_grad_parity_gqa(cpu_mesh_devices, causal):
    q, k, v, g = _qkv(1, 64, 4, 2, 16, seed=2)
    want_out, want = _jax_reference(ring_attention, cpu_mesh_devices, 4,
                                    causal, q, k, v, g)
    got_out, got = _local_ring(4, causal, q, k, v, g)
    np.testing.assert_allclose(got_out, want_out, atol=FWD_TOL, rtol=FWD_TOL)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"d{name}")


def test_ring_causal_skips_later_shards():
    """Causal ring over 4 shards makes 10 block steps (the diagonal causal,
    earlier shards dense, later shards skipped), each a dq and a dkv step
    in the backward."""
    calls = {"fwd": [], "dq": 0, "dkv": 0}
    plain = tra.PLAIN_OPS

    def fwd(q, k, v, causal, scale):
        calls["fwd"].append(causal)
        return plain.fwd(q, k, v, causal, scale)

    def dq(*args):
        calls["dq"] += 1
        return plain.dq(*args)

    def dkv(*args):
        calls["dkv"] += 1
        return plain.dkv(*args)

    q, k, v, _ = _qkv(1, 64, 2, 2, 16, seed=5)
    shards = [[t.clone().requires_grad_() for t in torch.from_numpy(x)
               .chunk(4, 1)] for x in (q, k, v)]
    outs = tra.ring_attention_local(*shards, causal=True,
                                    ops=tra.BlockOps(fwd, dq, dkv))
    torch.cat(outs, 1).sum().backward()
    assert len(calls["fwd"]) == 10 and sum(calls["fwd"]) == 4
    assert calls["dq"] == calls["dkv"] == 10


@pytest.fixture(scope="module")
def group_runs():
    q, k, v, g = _qkv(1, 64, 4, 2, 16, seed=3)
    base = {"q": q, "k": k, "v": v, "g": g}
    ring = run_ranks("ring_group", 4, {**base, "impl": "ring",
                                       "causal": True})
    uly = run_ranks("ring_group", 2, {**base, "impl": "ulysses",
                                      "causal": True})
    return base, {"ring": ring, "ulysses": uly}


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_over_a_gloo_seq_group(cpu_mesh_devices, group_runs, impl):
    base, runs = group_runs
    fn = ring_attention if impl == "ring" else ulysses_attention
    n = len(runs[impl])
    want_out, want = _jax_reference(fn, cpu_mesh_devices, n, True,
                                    base["q"], base["k"], base["v"],
                                    base["g"])
    out = np.concatenate([r["out"] for r in runs[impl]], 1)
    np.testing.assert_allclose(out, want_out, atol=FWD_TOL, rtol=FWD_TOL)
    for key, w in zip(("dq", "dk", "dv"), want):
        got = np.concatenate([r[key] for r in runs[impl]], 1)
        np.testing.assert_allclose(got, w, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"{impl} {key}")


# ------------------------------------------------- the seq-sharded step
CFG = {"dtype": "float32", "remat": True}


def _params():
    cfg = jllama.config_for("debug", dtype=jnp.float32, attn_impl="xla")
    return jax.tree.map(np.asarray,
                        jllama.init_params(cfg, jax.random.PRNGKey(0)))


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(3):
        tokens = rng.integers(0, 256, (4, 32)).astype(np.int32)
        out.append({"tokens": tokens, "targets": np.roll(tokens, -1, 1)})
    return out


@pytest.fixture(scope="module")
def seq_runs():
    params, batches = _params(), _batches()
    runs = {"ring": {"attn_impl": "auto"}, "ulysses": {"attn_impl": "ulysses"},
            "local_positions": {"attn_impl": "ring",
                                "patch": "local_positions"}}
    jobs = []
    for spec in runs.values():
        spec = dict(spec)
        cfg = {**CFG, "attn_impl": spec.pop("attn_impl")}
        jobs.append(("train_llama", {"cfg": cfg, "params": params,
                                     "batches": batches,
                                     "mesh": {"data": 2, "seq": 2}, **spec}))
    outs = run_ranks("many", 4, jobs, timeout=120)
    return dict(zip(runs, outs[0]))


@pytest.fixture(scope="module")
def unsharded_losses(cpu_mesh_devices):
    cfg = jllama.config_for("debug", dtype=jnp.float32, remat=True,
                            attn_impl="xla")
    mesh = MeshConfig(data=1).build(cpu_mesh_devices[:1])
    step, state = build_train_step(
        lambda p, b: jllama.loss_fn(p, b, cfg), optax.adamw(1e-3),
        jax.tree.map(jnp.asarray, _params()),
        jllama.param_logical_axes(cfg), mesh)
    losses = []
    for batch in _batches():
        state, aux = step(state, shard_batch(
            jax.tree.map(jnp.asarray, batch), mesh))
        losses.append(float(aux["loss"]))
    return losses


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_seq_sharded_llama_step_matches_unsharded(seq_runs,
                                                  unsharded_losses, impl):
    np.testing.assert_allclose(seq_runs[impl]["losses"], unsharded_losses,
                               rtol=1e-5)


def test_seq_sharded_step_needs_global_rope_positions(seq_runs,
                                                      unsharded_losses):
    """Each shard's positions restarting at 0 (as the reference's rope
    takes positions=None inside a shard) gives another model: its first
    loss is off by far more than the tolerance."""
    got = seq_runs["local_positions"]["losses"]
    assert abs(got[0] - unsharded_losses[0]) > 1e-3 * unsharded_losses[0]


def test_flash_or_dense_under_a_seq_axis_raises():
    """Under a seq axis larger than 1 only ring, Ulysses or auto (ring)
    attend across shards; "flash" and "xla" would attend within one."""
    q = torch.zeros(1, 16, 4, 16)
    dist = tllama._Dist(None, {}, None, None, object(), 0, 2)
    for impl in ("flash", "xla"):
        cfg = tllama.config_for("debug", attn_impl=impl)
        with pytest.raises(ValueError, match="within one sequence shard"):
            tllama._attention(cfg, q, q, q, dist)
