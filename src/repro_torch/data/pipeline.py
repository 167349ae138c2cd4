"""Deterministic, shardable synthetic token pipeline.

Batches are a pure function of (seed, step): resume after a crash or an
elastic re-mesh reproduces the exact token stream with no reader state
beyond the step counter (which lives in the checkpoint).  Data layout is
host-sharded the same way the mesh shards the batch dim, so each process
only materializes its slice — the pattern real loaders (grain/tfds
index-shuffled) follow at cluster scale.

The synthetic distribution is a Zipf-ish mixture with Markov structure so
the LM loss actually decreases during the example runs (pure-uniform
tokens give a flat loss = log V).

Port of ``repro.data.pipeline``, copied as it is (plain numpy): every
batch, host slice and state equals the reference's for the same (seed,
step).  The trainer moves a batch to the device (``shard_batch`` of
``repro_torch.launch.train``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_frontend_tokens: int = 0
    d_model: int = 0  # for frontend embeddings


class SyntheticTokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # fixed Markov mixing row per (vocab bucket): cheap structure
        rng = np.random.default_rng(cfg.seed)
        self._shift = int(rng.integers(1, max(cfg.vocab - 1, 2)))

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Global batch for `step` (deterministic)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab
        # Zipf-flavored marginals + deterministic next-token structure
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        base = np.minimum(base - 1, v - 1)
        noise = rng.random((b, s))
        inputs = base.copy()
        # 70% of positions follow x_{t+1} = (x_t + shift) % v: learnable
        follow = noise < 0.7
        for t in range(1, s):
            inputs[:, t] = np.where(
                follow[:, t], (inputs[:, t - 1] + self._shift) % v, inputs[:, t]
            )
        targets = np.roll(inputs, -1, axis=1)
        targets[:, -1] = -1  # no target for the last position
        batch = {
            "inputs": inputs.astype(np.int32),
            "targets": targets.astype(np.int32),
        }
        if cfg.n_frontend_tokens:
            batch["frontend"] = rng.standard_normal(
                (b, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32
            )
        return batch

    def host_slice(self, step: int, host_index: int, host_count: int):
        """The batch rows this host is responsible for feeding."""
        batch = self.batch_at(step)
        b = self.cfg.global_batch
        assert b % host_count == 0
        lo = host_index * (b // host_count)
        hi = lo + b // host_count
        return {k: v[lo:hi] for k, v in batch.items()}

    def state(self, step: int) -> dict:
        return {"seed": self.cfg.seed, "step": step}
