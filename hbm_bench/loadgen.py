"""Closed-loop traffic from a mix file and a seed.

A mix file (``hbm_bench/traffic/<name>.json``) fixes the load: the number
of clients (one serving slot each), the ring length, the prefill chunk,
the page size, and the distributions of prompt and output lengths.  Each
length is log-normal, given by its median and the standard deviation of
its logarithm, and clipped to ``[min, max]`` (an output also to what the
ring leaves after its prompt); the file names the public trace or study
each comes from and lists what it assumes.

Each client sends its next request when its previous one completes.  The
first ``clients`` requests are each client's first, cut to ``(c + 0.5) /
clients`` of the medians: a closed loop in steady state finds its
clients at evenly spread points of their requests, so the harness serves
these during set-up and opens the window on a loop whose completions are
already spread, the same for every seed.

The requests after them come in blocks of ``strata``.  A block holds one
length from each of ``strata`` equal bands of the distribution's
probability (the band's middle quantile), tail included, in an order
drawn from the run's seed (prompt and output each their own order): every
seed serves the same set of sizes in another sequence, so a window's
work does not swing with the seed and no one schedule can be tuned to.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
from pathlib import Path

import numpy as np

from hbm_bench.weights import sub_seed

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


@dataclasses.dataclass(frozen=True)
class Lengths:
    """A log-normal length: ``median * exp(sigma * z)``, clipped."""

    median: float
    sigma: float
    min: int
    max: int

    def at(self, u: float, most: int = None) -> int:
        z = statistics.NormalDist().inv_cdf(min(max(u, 1e-9), 1 - 1e-9))
        hi = self.max if most is None else min(self.max, most)
        return int(min(max(round(self.median * math.exp(self.sigma * z)),
                           self.min), hi))


@dataclasses.dataclass(frozen=True)
class Mix:
    name: str
    clients: int
    max_len: int
    prefill_chunk: int
    page_slots: int
    prompt_len: Lengths
    output_len: Lengths
    strata: int
    trace_steps: int
    trace_kind: str
    sample_tokens: int
    sample_max: int


def load_mix(name: str, directory: Path = TRAFFIC_DIR) -> Mix:
    raw = json.loads((directory / f"{name}.json").read_text())
    mix = Mix(name=name, clients=int(raw["clients"]),
              max_len=int(raw["max_len"]),
              prefill_chunk=int(raw["prefill_chunk"]),
              page_slots=int(raw["page_slots"]),
              prompt_len=Lengths(**raw["prompt_len"]),
              output_len=Lengths(**raw["output_len"]),
              strata=int(raw["strata"]),
              trace_steps=int(raw["trace_steps"]),
              trace_kind=str(raw["trace_kind"]),
              sample_tokens=int(raw["sample_tokens"]),
              sample_max=int(raw["sample_max"]))
    if mix.prompt_len.max + mix.output_len.min > mix.max_len:
        raise ValueError(f"mix {name}: the longest prompt leaves no room "
                         f"for an answer in its {mix.max_len}-position ring")
    return mix


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    index: int
    prompt: np.ndarray       # int32 token ids
    output_len: int


class Traffic:
    """The run's request sequence: ``next()`` hands out the next one."""

    def __init__(self, mix: Mix, seed: int, vocab: int):
        self.mix, self.seed, self.vocab, self.count = mix, int(seed), \
            int(vocab), 0
        self._block = (None, None)

    def _bands(self, b: int):
        if self._block[0] != b:
            k = self.mix.strata
            rng = np.random.RandomState(sub_seed(self.seed, "lengths", b)
                                        % (1 << 32))
            self._block = (b, ((rng.permutation(k) + 0.5) / k,
                               (rng.permutation(k) + 0.5) / k))
        return self._block[1]

    def lengths(self, i: int):
        """(prompt, output) length of request ``i``."""
        mix = self.mix
        if i < mix.clients:
            share = (i + 0.5) / mix.clients
            plen = max(1, round(share * mix.prompt_len.median))
            return plen, max(2, min(round(share * mix.output_len.median),
                                    mix.max_len - plen))
        i -= mix.clients
        up, uo = self._bands(i // mix.strata)
        plen = mix.prompt_len.at(float(up[i % mix.strata]))
        return plen, mix.output_len.at(float(uo[i % mix.strata]),
                                       most=mix.max_len - plen)

    def next(self) -> RequestSpec:
        i = self.count
        self.count += 1
        plen, olen = self.lengths(i)
        rng = np.random.RandomState(sub_seed(self.seed, "tokens", i)
                                    % (1 << 32))
        return RequestSpec(index=i, prompt=rng.randint(
            0, self.vocab, plen).astype(np.int32), output_len=olen)
