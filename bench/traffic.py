"""The one traffic generator: it reads a mix file (``traffic/<mix>.json``)
and hands out requests.

``_lognormal_lengths`` and ``poisson_arrivals`` are frozen copies of
``src/repro_torch/serving/traces.py``.  The work's shape is the mix's own,
drawn from its ``sizes.seed``: the (prompt, output) sizes in the order they
are asked for, the first wave's output shares and the arrival times.  The
run seed draws the token ids.  So every seed meets the same work, and two
runs differ by their tokens and by the system's timing.

Users are independent and arrive as a Poisson process at the mix's ``rate``
requests a second (an open loop).  Set-up starts the system in its steady
state: a ``first_wave`` of requests submitted at once, each asking for a
uniform share of its output length, as the requests in flight at a moment
of the steady state are part-way through theirs (Little's law: the count is
the rate times a request's time in the system, read on the card).

A request that would run past the model's context (``max_position_embeddings``)
has its prompt and then its output cut to fit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Mapping

import numpy as np


def poisson_arrivals(n: int, rate: float, rng: np.random.Generator) -> np.ndarray:
    """n arrival timestamps of a Poisson process with `rate` req/s."""
    if rate <= 0:
        return np.zeros(n)
    gaps = rng.exponential(1.0 / rate, size=n)
    return np.cumsum(gaps)


def _lognormal_lengths(rng, n, median, sigma, lo, hi):
    vals = rng.lognormal(mean=np.log(median), sigma=sigma, size=n)
    return np.clip(vals, lo, hi).astype(int)


@dataclass
class Ask:
    """One request: its token ids, its output length and, in an open loop,
    when it is due (seconds from the start of the traffic)."""

    prompt: List[int]
    max_new_tokens: int
    due: float = 0.0


def size_set(mix: Mapping, context: int) -> np.ndarray:
    """[count, 2] (prompt, output) lengths, the same for every run seed."""
    sz = mix["sizes"]
    rng = np.random.default_rng(sz["seed"])
    p, o = mix["prompt"], mix["output"]
    prompts = _lognormal_lengths(rng, sz["count"], p["median"], p["sigma"], p["lo"], p["hi"])
    outs = _lognormal_lengths(rng, sz["count"], o["median"], o["sigma"], o["lo"], o["hi"])
    prompts = np.minimum(prompts, context - o["lo"])
    outs = np.minimum(outs, context - prompts)
    return np.stack([prompts, outs], axis=1)


class Traffic:
    """The requests of one run, in the order the run asks for them."""

    def __init__(self, mix: Mapping, hf: Mapping, seed: int):
        self.mix = mix
        self.vocab = hf["vocab_size"]
        self.seed = seed
        self.sizes = size_set(mix, hf["max_position_embeddings"])
        self.shape_seed = mix["sizes"]["seed"]
        self.order = np.random.default_rng([self.shape_seed, 0]).permutation(len(self.sizes))

    def _ask(self, k: int, due: float = 0.0, share: float = 1.0) -> Ask:
        plen, olen = (int(x) for x in self.sizes[self.order[k % len(self.order)]])
        rng = np.random.default_rng([self.seed & (2**64 - 1), 1, k])
        prompt = rng.integers(1, self.vocab, size=plen).tolist()
        return Ask(prompt, max(1, int(math.ceil(olen * share))), due)

    def first_wave(self) -> List[Ask]:
        """The requests in flight as the steady state starts, each at a
        uniform share of its output."""
        n = int(self.mix["first_wave"])
        rng = np.random.default_rng([self.shape_seed, 2])
        return [self._ask(k, share=float(s)) for k, s in enumerate(rng.uniform(0.0, 1.0, n))]

    def arrivals(self) -> Iterator[Ask]:
        """The requests after the first wave, in order of their due times
        (seconds after the first wave is filled)."""
        rng = np.random.default_rng([self.shape_seed, 3])
        t, k = 0.0, int(self.mix["first_wave"])
        while True:
            t += float(poisson_arrivals(1, self.mix["rate"], rng)[0])
            yield self._ask(k, due=t)
            k += 1
