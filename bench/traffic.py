"""The one traffic generator: waves of prompts from a cell's traffic file.

A traffic file (``workloads/<cell>.json``) holds parameters only:

    {"batch": 8, "new_tokens": 16,
     "prompt": {"median": 2048, "sigma": 0.5, "min": 1024, "max": 4096,
                "multiple": 128}}

Load is a closed loop of ``batch`` clients: each wave is one
``ServingEngine.generate`` call of ``batch`` prompts, and the next wave
starts when it returns.  Prompt lengths follow a lognormal law given by
its median and its sigma in log space, clipped to [min, max] and rounded
up to a multiple of ``multiple`` (PERF.md §7: the port's prefill runs
far slower at a padded length with few divisors).

The lengths of wave ``i`` are drawn from ``numpy.random.default_rng(
[LENGTH_DRAW, i])``, the same for every seed, so that every seed does the
same work (PERF.md §6: lengths drawn per seed spread a run's rate past
any bound); the seed draws the order of the prompts in each wave and their
token ids, uniform over the vocabulary, from ``default_rng([seed, i])``.
A wave depends on nothing but the seed and its index.  The warm-up wave
(index -1, drawn from ``[seed, 2**32]``) holds ``batch`` prompts of the
longest length, the largest shape the window can meet.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

WARM_INDEX = 2**32
LENGTH_DRAW = 0


@dataclass(frozen=True)
class Traffic:
    batch: int
    new_tokens: int
    median: float
    sigma: float
    min_len: int
    max_len: int
    multiple: int

    @classmethod
    def load(cls, path: Path) -> "Traffic":
        d = json.loads(Path(path).read_text())
        p = d["prompt"]
        t = cls(int(d["batch"]), int(d["new_tokens"]), float(p["median"]), float(p["sigma"]), int(p["min"]),
                int(p["max"]), int(p["multiple"]))
        if not (1 <= t.min_len <= t.max_len and t.batch >= 1 and t.new_tokens >= 1 and t.multiple >= 1):
            raise ValueError(f"{path}: needs 1 <= min <= max, batch, new_tokens and multiple >= 1")
        if t.min_len % t.multiple or t.max_len % t.multiple:
            raise ValueError(f"{path}: min and max must be multiples of {t.multiple}")
        return t

    def lengths(self, index: int) -> np.ndarray:
        """The ``batch`` prompt lengths of wave ``index``, in draw order."""
        z = np.random.default_rng([LENGTH_DRAW, index]).standard_normal(self.batch)
        n = np.clip(self.median * np.exp(self.sigma * z), self.min_len, self.max_len)
        return (np.ceil(n / self.multiple) * self.multiple).astype(np.int64)

    def padded_lengths(self) -> range:
        """Every length a wave can pad to."""
        return range(self.min_len, self.max_len + 1, self.multiple)

    def wave(self, seed: int, index: int, vocab: int) -> list[np.ndarray]:
        """Wave ``index`` (-1: the warm-up wave): ``batch`` int32 prompts."""
        rng = np.random.default_rng([seed, WARM_INDEX if index < 0 else index])
        lengths = np.full(self.batch, self.max_len) if index < 0 else rng.permutation(self.lengths(index))
        return [rng.integers(0, vocab, size=int(n), dtype=np.int64).astype(np.int32) for n in lengths]
