"""Operations and bytes of the work the cells run, from shapes alone, and the
table of the chip's peaks.

Model FLOPs count each multiply-add as two operations and leave out what
the program recomputes (remat): they are what the work needs, so a share
of the peak stays honest whatever the program chooses to recompute.
"""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.model import Dims

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name: str) -> dict:
    """{"flops": bf16 dense FLOP/s, "bytes": HBM bytes/s, "part": ...} of
    the first part in the table whose name is in ``device_name``."""
    table = json.loads(PEAKS_FILE.read_text())["parts"]
    for row in table:
        if row["match"] in device_name:
            return row
    raise ValueError(f"no peak for {device_name!r} in {PEAKS_FILE.name}")


def attn_pairs_causal(s: int) -> int:
    """(query, key) pairs a causal sequence of s positions scores."""
    return s * (s + 1) // 2


def train_flops_per_token(d: Dims, seq: int) -> float:
    """Forward and backward model FLOPs a trained token costs: 6 per
    matmul parameter (the block stack and the LM head, which the tied
    embedding also is), and attention's QK^T and PV over the causal half:
    4 * hd * heads a (query, key) pair forward, twice that backward."""
    dense = 6 * (d.matmul_params() + d.dim * d.vocab)
    attn = 12 * d.heads * d.head_dim * attn_pairs_causal(seq) / seq
    return dense + d.layers * attn


def decode_token_flops(d: Dims, context: float) -> float:
    """Forward FLOPs of one position that attends over ``context`` keys
    and goes through the LM head (a served token)."""
    return (2 * (d.matmul_params() + d.dim * d.vocab)
            + d.layers * 4 * d.heads * d.head_dim * context)


def prompt_flops(d: Dims, n: int) -> float:
    """Forward FLOPs of a prompt of n real tokens, attention causal, the LM
    head once (the last position's)."""
    return (2 * d.matmul_params() * n + 2 * d.dim * d.vocab
            + d.layers * 4 * d.heads * d.head_dim * attn_pairs_causal(n))


def kv_bytes_per_position(d: Dims, elem: int = 2) -> int:
    """K and V of one position over all layers."""
    return 2 * d.layers * d.kv_dim * elem


def weight_bytes(d: Dims, elem: int = 2) -> int:
    """The matmul weights a decode step reads (the embedding rows it
    gathers are negligible and left out)."""
    return (d.matmul_params() + d.dim * d.vocab) * elem


def decode_step_bound_s(d: Dims, rows: float, depth_sum: float,
                        peak_flops: float, peak_bytes: float) -> dict:
    """Least time of one decode step over ``rows`` live rows whose cache
    depths sum to ``depth_sum``: the weights read once, each live row's K
    and V to its depth read once, the new K and V written."""
    flops = (rows * 2 * (d.matmul_params() + d.dim * d.vocab)
             + d.layers * 4 * d.heads * d.head_dim * depth_sum)
    nbytes = (weight_bytes(d) + kv_bytes_per_position(d) * depth_sum
              + kv_bytes_per_position(d) * rows)
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
    return {"flops": flops, "bytes": nbytes, "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def flash_bound(kernel: str, b: int, s: int, h: int, hk: int, hd: int,
                elem: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of one causal launch of a flash kernel: the
    operations of its matmuls over the causal pairs, each input read once
    and each output written once (lse and delta are one f32 a query row)."""
    pairs = b * h * attn_pairs_causal(s)
    rows = b * h * s * 4
    q_bytes = b * s * h * hd * elem
    kv_bytes = b * s * hk * hd * elem
    if kernel == "flash_fwd":
        return 4 * hd * pairs, 2 * q_bytes + 2 * kv_bytes + rows
    if kernel == "flash_bwd_dq":
        return 6 * hd * pairs, 3 * q_bytes + 2 * kv_bytes + 2 * rows
    if kernel == "flash_bwd_dkv":
        return 8 * hd * pairs, 2 * q_bytes + 4 * kv_bytes + 2 * rows
    raise ValueError(f"unknown flash kernel {kernel!r}")
