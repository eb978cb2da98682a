"""A configuration file's sizes, and the seeded weights that both the
program and the reference get.

A configuration file holds the model's published ``config.json`` keys (a
Llama-layout decoder: pre-norm, RoPE, grouped-query attention, SwiGLU), as
they are run. ``llama_kwargs`` maps them onto the port's ``LlamaConfig``
fields; the reference reads the same dict through ``Dims``.

Weights are drawn on the device, one ``torch.Generator`` per leaf seeded
from (seed, leaf index), so one leaf can be drawn again alone: the train
cell redraws each initial leaf to measure how far the step moved it. Layers
are stacked on a leading ``[n_layers]`` axis and weights are ``[in, out]``,
the port's layout.
"""

from __future__ import annotations

import dataclasses
import math

# leaves in a fixed order; the index seeds each leaf's generator
LEAF_ORDER = ("embed", "wq", "wk", "wv", "wo", "attn_norm", "mlp_norm",
              "w_gate", "w_up", "w_down", "final_norm", "lm_head")
NORM_SPREAD = 0.1


@dataclasses.dataclass(frozen=True)
class Dims:
    vocab: int
    dim: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int
    max_seq: int
    rope_theta: float
    norm_eps: float
    tied: bool

    @property
    def q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    def matmul_params(self) -> int:
        """Parameters of the block stack's matmuls (no head, no norms)."""
        d = self.dim
        per = (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
               + 3 * d * self.ffn)
        return self.layers * per


def dims(conf: dict) -> Dims:
    heads = conf["num_attention_heads"]
    head_dim = conf.get("head_dim") or conf["hidden_size"] // heads
    if head_dim * heads != conf["hidden_size"]:
        raise ValueError("the port computes head_dim as hidden / heads; "
                         f"{head_dim} x {heads} != {conf['hidden_size']}")
    if conf.get("sliding_window"):
        raise ValueError("a sliding window is not in the port's model")
    return Dims(vocab=conf["vocab_size"], dim=conf["hidden_size"],
                layers=conf["num_hidden_layers"], heads=heads,
                kv_heads=conf["num_key_value_heads"], head_dim=head_dim,
                ffn=conf["intermediate_size"],
                max_seq=conf["max_position_embeddings"],
                rope_theta=float(conf["rope_theta"]),
                norm_eps=float(conf["rms_norm_eps"]),
                tied=bool(conf["tie_word_embeddings"]))


def llama_kwargs(conf: dict) -> dict:
    """The port's ``LlamaConfig`` fields of this configuration."""
    d = dims(conf)
    return dict(vocab_size=d.vocab, dim=d.dim, n_layers=d.layers,
                n_heads=d.heads, n_kv_heads=d.kv_heads, hidden_dim=d.ffn,
                max_seq_len=d.max_seq, rope_theta=d.rope_theta,
                norm_eps=d.norm_eps, tie_embeddings=d.tied)


def leaf_shapes(d: Dims) -> dict:
    """{leaf: (shape, fan_in or None for a norm)} in ``LEAF_ORDER``."""
    L = d.layers
    shapes = {
        "embed": ((d.vocab, d.dim), d.dim),
        "wq": ((L, d.dim, d.q_dim), d.dim),
        "wk": ((L, d.dim, d.kv_dim), d.dim),
        "wv": ((L, d.dim, d.kv_dim), d.dim),
        "wo": ((L, d.q_dim, d.dim), d.q_dim),
        "attn_norm": ((L, d.dim), None),
        "mlp_norm": ((L, d.dim), None),
        "w_gate": ((L, d.dim, d.ffn), d.dim),
        "w_up": ((L, d.dim, d.ffn), d.dim),
        "w_down": ((L, d.ffn, d.dim), d.ffn),
        "final_norm": ((d.dim,), None),
    }
    if not d.tied:
        shapes["lm_head"] = ((d.dim, d.vocab), d.dim)
    return shapes


def draw_leaf(d: Dims, name: str, seed: int, dtype, device):
    """One leaf from its own generator: N(0, 1/fan_in), or 1 + N(0, 0.01)
    for a norm, drawn in f32 and cast once."""
    import torch

    shape, fan_in = leaf_shapes(d)[name]
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + LEAF_ORDER.index(name))
                    % (1 << 63))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    if fan_in is None:
        w.mul_(NORM_SPREAD).add_(1.0)
    else:
        w.mul_(1.0 / math.sqrt(fan_in))
    return w.to(dtype)


def make_params(d: Dims, seed: int, dtype, device) -> dict:
    """The port's parameter tree, drawn from ``seed``."""
    layer_keys = ("wq", "wk", "wv", "wo", "attn_norm", "mlp_norm",
                  "w_gate", "w_up", "w_down")
    params = {"layers": {}}
    for name in leaf_shapes(d):
        leaf = draw_leaf(d, name, seed, dtype, device)
        if name in layer_keys:
            params["layers"][name] = leaf
        else:
            params[name] = leaf
    return params


def leaves(params: dict) -> dict:
    """{leaf name: tensor}, flat."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out.update(params["layers"])
    return out
