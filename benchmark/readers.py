"""Arithmetic the metric readers (``metrics/<name>.py``) share: window
selections of the requests' stamps, percentiles, and the FLOP and byte
counts over what a window served. Every function takes the run's context
and returns a number or None where the run holds nothing to read.
"""

from __future__ import annotations

import math

from benchmark import flops


def percentile(values: list, p: float):
    """Nearest-rank percentile (None for no values); inf counts as a value
    above every other, as a request that never answered does."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(p / 100 * len(v)) - 1)]


def on_card(ctx: dict) -> bool:
    return ctx.get("device_name", "cpu") != "cpu"


def in_window(ctx: dict, t: float) -> bool:
    return ctx["t_open"] <= t <= ctx["t_close"]


def due_in_window(ctx: dict) -> list:
    return [r for r in ctx["records"]
            if ctx["t_open"] <= r["due"] < ctx["t_close"]]


def ttft_ms(ctx: dict) -> list:
    """Time to first token of every request due in the window, from when
    it was due (ms); one that failed or never answered is infinitely late."""
    return [(r["t"][0] - r["due"]) * 1e3 if r["t"] and not r["error"]
            else float("inf") for r in due_in_window(ctx)]


def window_tokens(ctx: dict) -> list:
    """(record, index) of every token the consumer received in the window."""
    return [(r, i) for r in ctx["records"] for i, t in enumerate(r["t"])
            if in_window(ctx, t)]


def whole_rounds(ctx: dict) -> tuple[int, float]:
    """(tokens, seconds) of the window trimmed to whole engine rounds: the
    tokens received after the last delivery at or before the open, up to
    the last delivery at or before the close, over the time between those
    two deliveries. A round delivers every row's token at once, so a fixed
    window would count a round more or less by chance (one round of 32 is
    0.7% of a 51-s window)."""
    ts = sorted(t for r in ctx["records"] for t in r["t"])
    before = [t for t in ts if t <= ctx["t_open"]]
    t_a = before[-1] if before else ctx["t_open"]
    inside = [t for t in ts if t_a < t <= ctx["t_close"]]
    if not inside:
        return 0, 0.0
    return len(inside), inside[-1] - t_a


def gaps_ms(ctx: dict) -> list:
    """Every inter-token gap of every request with both ends in the
    window, in ms."""
    out = []
    for r in ctx["records"]:
        t = r["t"]
        out += [(b - a) * 1e3 for a, b in zip(t, t[1:])
                if in_window(ctx, a) and in_window(ctx, b)]
    return out


def stat_delta(ctx: dict, key: str) -> int:
    return ctx["stats_close"][key] - ctx["stats_open"][key]


def decode_round_ms(ctx: dict):
    if ctx["kind"] != "serve":
        return None
    steps = stat_delta(ctx, "batches")
    return ctx["window_s"] * 1e3 / steps if steps else None


def decode_work(ctx: dict) -> tuple[int, int]:
    """(decode tokens, sum of their contexts) in the window: token i >= 1
    of a request came from a decode step over prompt + i real keys."""
    rows = depth = 0
    for r, i in window_tokens(ctx):
        if i >= 1:
            rows += 1
            depth += len(r["prompt"]) + i
    return rows, depth


def decode_roofline_pct(ctx: dict):
    """The least time of the window's mean decode step over its measured
    round, in %."""
    if ctx["kind"] != "serve" or not on_card(ctx):
        return None
    steps = stat_delta(ctx, "batches")
    rows, depth = decode_work(ctx)
    if not steps or not rows:
        return None
    pk = flops.peaks(ctx["device_name"])
    bound = flops.decode_step_bound_s(ctx["dims"], rows / steps,
                                      depth / steps, pk["flops"], pk["bytes"])
    return 100 * bound["bound_s"] / (ctx["window_s"] / steps)


def serve_mfu_pct(ctx: dict):
    """Model FLOPs of the window's served tokens and of the prompts whose
    prefill finished in it, over the window, against the bf16 peak."""
    if ctx["kind"] != "serve" or not on_card(ctx):
        return None
    d = ctx["dims"]
    total = 0.0
    for r, i in window_tokens(ctx):
        if i == 0:
            total += flops.prompt_flops(d, len(r["prompt"]))
        else:
            total += flops.decode_token_flops(d, len(r["prompt"]) + i)
    pk = flops.peaks(ctx["device_name"])
    return 100 * total / ctx["window_s"] / pk["flops"]


def train_mfu_pct(ctx: dict):
    if ctx["kind"] != "train" or not on_card(ctx):
        return None
    pk = flops.peaks(ctx["device_name"])
    per_token = flops.train_flops_per_token(ctx["dims"], ctx["mix"]["seq"])
    return 100 * per_token * ctx["tokens"] / ctx["window_s"] / pk["flops"]


FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def flash_roofline_pct(ctx: dict):
    """The traced flash launches' bound (each launch's, from the cell's
    shapes) over their device time, in %."""
    tr = ctx.get("trace")
    if ctx["kind"] != "train" or tr is None:
        return None
    d, mix = ctx["dims"], ctx["mix"]
    pk = flops.peaks(ctx["device_name"])
    bound = spent = 0.0
    for name, row in tr["kernels"].items():
        kernel = next((k for k in FLASH_KERNELS if k + "_" in name), None)
        if kernel is None:
            continue
        f, b = flops.flash_bound(kernel, mix["batch"], mix["seq"], d.heads,
                                 d.kv_heads, d.head_dim)
        bound += row["n"] * max(f / pk["flops"], b / pk["bytes"])
        spent += row["s"]
    return 100 * bound / spent if spent else None


def idle_pct(ctx: dict):
    tr = ctx.get("trace")
    if tr is None or not tr["window_s"]:
        return None
    return 100 * (1 - tr["busy_s"] / tr["window_s"])
