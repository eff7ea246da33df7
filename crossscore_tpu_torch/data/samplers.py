"""Neighbour (reference view) samplers; the port's own copy of
``crossscore_tpu/data/samplers.py``.

Behavioural parity with reference ``utils/neighbour/sampler.py:14-58``:
``random`` strategy picks K references without replacement; if fewer than K
exist, the list is padded with ``"empty_image"`` placeholders and permuted;
``deterministic`` mode takes the first K (used for eval reproducibility).

Randomness is explicit: every call takes a ``numpy.random.Generator`` —
no hidden global state (the loader derives per-(epoch, index) generators so
any sample is reproducible in isolation).
"""

from __future__ import annotations

import numpy as np

EMPTY_IMAGE = "empty_image"


class SamplerRandom:
    def __init__(self, n_sample: int, deterministic: bool = False):
        self.n_sample = n_sample
        self.deterministic = deterministic

    def __call__(self, ref_list: list[str], rng: np.random.Generator) -> list[str]:
        num_ref = len(ref_list)
        if self.n_sample > num_ref:
            padded = list(ref_list) + [EMPTY_IMAGE] * (self.n_sample - num_ref)
            if self.deterministic:
                return padded
            return [padded[i] for i in rng.permutation(len(padded))]
        if self.deterministic:
            return list(ref_list[: self.n_sample])
        idx = rng.choice(num_ref, size=self.n_sample, replace=False)
        return [ref_list[i] for i in idx]


def make_sampler(strategy: str, n_sample: int, deterministic: bool) -> SamplerRandom:
    if strategy == "random":
        return SamplerRandom(n_sample, deterministic)
    raise NotImplementedError(f"sampler strategy {strategy!r}")
