"""The one traffic generator: every mix is a data file under
``portbench/traffic/`` that this module reads.

A mix fixes the prompt and output length distributions, the share of
greedy requests, the sampling settings of the rest, and the load: an
open loop at a fixed rate (each request due at its time whatever the
engine does, so a stall counts against the requests behind it) or a
closed loop of a fixed number of clients (each sends its next request
when its last one ends).

Every seed serves the same work in another order. Requests come in
blocks of ``block``: a block's prompt lengths are the distribution's
quantiles at (j + 0.5) / block, its output lengths likewise, its
greedy share exact, and its gaps between arrivals the exponential
distribution's quantiles at the same points, scaled to a mean of
exactly 1 / rate. The seed shuffles each of these within its block and
draws the token ids and the sampling seeds. A block that spans the
whole run, lead-in and window (an open mix's ``block`` is set so), gives
Poisson arrivals with their count fixed: the gaps are shuffled over the
run, so bursts come and go as they would, and every seed still offers
the same number of requests of the same sizes. Request i and its due
time are a pure function of (mix, seed, i): a block is drawn from its
own generator when first asked for.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass

import numpy as np

_NORMAL = statistics.NormalDist()


@dataclass(frozen=True)
class Request:
    index: int
    prompt: np.ndarray          # int32 token ids
    max_tokens: int
    greedy: bool
    sample_seed: int


def _quantile(dist: dict, u: float) -> float:
    """The length distribution's u-quantile, before clipping."""
    kind = dist["dist"]
    if kind == "lognormal":
        return dist["median"] * math.exp(dist["sigma"] * _NORMAL.inv_cdf(u))
    if kind == "loguniform":
        lo, hi = math.log(dist["min"]), math.log(dist["max"])
        return math.exp(lo + u * (hi - lo))
    if kind == "uniform":
        return dist["min"] + u * (dist["max"] - dist["min"])
    raise ValueError(f"unknown length distribution {kind!r}")


def block_lengths(dist: dict, block: int) -> np.ndarray:
    """The block's lengths: quantiles at (j + 0.5) / block, rounded and
    clipped to [min, max]."""
    u = (np.arange(block) + 0.5) / block
    return np.array([min(max(round(_quantile(dist, x)), dist["min"]), dist["max"])
                     for x in u], dtype=np.int64)


def block_gaps(rate: float, block: int) -> np.ndarray:
    """Exponential gaps at the block's quantile points, mean exactly 1 / rate."""
    u = (np.arange(block) + 0.5) / block
    gaps = -np.log1p(-u)
    return gaps / gaps.mean() / rate


class Traffic:
    """Requests and due times of one mix under one seed."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix = mix
        self.vocab = vocab
        self.seed = seed % (1 << 64)
        self.block = int(mix.get("block", 32))
        self.max_seq = int(mix["engine"]["max_seq"])
        self._prompts = block_lengths(mix["prompt"], self.block)
        self._outputs = block_lengths(mix["output"], self.block)
        self._gaps = block_gaps(mix["rate_per_s"], self.block) if self.open_loop else None
        self._blocks: dict[int, list] = {}
        self._due: list[float] = [0.0]

    @property
    def open_loop(self) -> bool:
        return self.mix["loop"] == "open"

    def _draw_block(self, b: int) -> list:
        rng = np.random.default_rng([self.seed, b])
        prompts = rng.permutation(self._prompts)
        outputs = rng.permutation(self._outputs)
        n_greedy = round(self.block * self.mix["greedy_share"])
        greedy = rng.permutation(np.arange(self.block) < n_greedy)
        gaps = rng.permutation(self._gaps) if self._gaps is not None else None
        out = []
        for j in range(self.block):
            n = int(prompts[j])
            budget = self.max_seq - 2 - n
            toks = rng.integers(0, self.vocab, n, dtype=np.int32)
            out.append((Request(b * self.block + j, toks, int(min(outputs[j], budget)),
                                bool(greedy[j]), int(rng.integers(0, 2**31 - 1))),
                        None if gaps is None else float(gaps[j])))
        return out

    def _entry(self, i: int):
        b = i // self.block
        if b not in self._blocks:
            self._blocks[b] = self._draw_block(b)
        return self._blocks[b][i % self.block]

    def request(self, i: int) -> Request:
        return self._entry(i)[0]

    def due(self, i: int) -> float:
        """Seconds from the load's start at which request i is due (open loop)."""
        while len(self._due) <= i:
            n = len(self._due)
            self._due.append(self._due[-1] + self._entry(n - 1)[1])
        return self._due[i]
