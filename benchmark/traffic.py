"""The one generator of every traffic mix: it reads a mix's data file
(``traffic/<name>.json``) and the seed, and gives the requests or batches.

Serving mixes draw lengths from clipped log-normals and arrivals from a
Poisson process, but by strata: n requests take the n quantiles at
(i + 0.5) / n of each distribution, and the seed only permutes them. So
every seed sends the same multiset of prompt lengths, answer lengths and
gaps between arrivals, in another order, with other token ids: seeds
change which request meets which, not how much work a run holds. The
gaps are an exponential's quantiles, not independent draws, so an open
loop's arrivals have a Poisson process's mean and spread of gaps but are
not one.

Training mixes give [batch, seq + 1] token rows; step i's rows come from
their own generator seeded from (seed, i), on the device.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np


@dataclasses.dataclass
class Request:
    index: int
    prompt: list
    answer: int                  # tokens to generate
    due: float = 0.0             # seconds after the traffic's start


def quantiles(spec: dict, n: int) -> np.ndarray:
    """n stratified draws of a length distribution, clipped, as ints."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    norm = statistics.NormalDist()
    z = np.array([norm.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def exp_gaps(rate: float, n: int) -> np.ndarray:
    """n stratified gaps of a Poisson process of ``rate`` per second."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate


def serve_requests(mix: dict, seed: int, n: int, vocab: int) -> list:
    """n requests: stratified lengths permuted by the seed, uniform token
    ids, and for an open loop the due times of its arrivals."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 0x5E12E])
    prompts = rng.permutation(quantiles(mix["prompt"], n))
    answers = rng.permutation(quantiles(mix["answer"], n))
    due = np.zeros(n)
    if mix["loop"] == "open":
        due = np.cumsum(rng.permutation(exp_gaps(mix["rate_per_s"], n)))
    out = []
    for i in range(n):
        toks = rng.integers(0, vocab, size=int(prompts[i])).tolist()
        out.append(Request(i, toks, int(answers[i]), float(due[i])))
    return out


def open_loop_count(mix: dict, seconds: float) -> int:
    """Requests an open loop sends over its lead-in and the window."""
    return int(math.ceil(mix["rate_per_s"] * (mix["lead_in_s"] + seconds)))


def train_rows(mix: dict, seed: int, step: int, vocab: int, device):
    """(tokens, targets) [batch, seq] of step ``step``: seeded random ids,
    the targets the same row shifted by one."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 7919 + 17 * int(step) + 1) % (1 << 63))
    rows = torch.randint(0, vocab, (mix["batch"], mix["seq"] + 1),
                         generator=gen, device=device)
    return rows[:, :-1].contiguous(), rows[:, 1:].contiguous()
