"""Fault-tolerant trainer loop.

  * **checkpoint/restart** — atomic step checkpoints (params + optimizer +
    data-pipeline state); on startup the trainer resumes from the newest
    *valid* checkpoint (hash-verified; torn writes skipped).
  * **step retry** — a failed step (a device error surfaces as an
    exception from the step) triggers restore-from-last-good and continue,
    up to ``max_failures``; the induced-fault test exercises this path.
  * **straggler mitigation** — steps slower than ``straggler_zscore``
    sigmas of the last 50 step times trigger a callback (at cluster scale:
    report the slow host for eviction / re-mesh; here: logged + counted).

Port of ``repro.train.trainer``.  A step's time waits for the device
(``torch.cuda.synchronize`` where the reference calls
``jax.block_until_ready``).
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.train.step import TrainState


def default_checkpoint_dir() -> str:
    """``repro_torch_ckpt`` in the temporary directory."""
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = field(default_factory=default_checkpoint_dir)
    log_every: int = 10
    max_failures: int = 3
    straggler_zscore: float = 3.0
    straggler_warmup: int = 5


def _wait(t: torch.Tensor) -> None:
    """Block until the device has computed ``t``."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclass
class Trainer:
    cfg: TrainerConfig
    train_step: Callable  # (state, batch) -> (state, metrics)
    pipeline: SyntheticTokenPipeline
    shard_batch: Callable  # host batch -> device batch
    on_straggler: Callable[[int, float], None] | None = None
    history: list[dict] = field(default_factory=list)
    straggler_events: list[int] = field(default_factory=list)

    def run(self, state: TrainState) -> TrainState:
        c = self.cfg
        start = 0
        restored, step0, extra = restore_checkpoint(c.checkpoint_dir, state)
        if restored is not None:
            state = TrainState(*restored)
            start = int(extra.get("data_step", step0)) if extra else step0
            print(f"[trainer] resumed from step {start}")

        failures = 0
        times: list[float] = []
        step = start
        while step < c.total_steps:
            batch = self.shard_batch(self.pipeline.batch_at(step))
            t0 = time.perf_counter()
            try:
                state, metrics = self.train_step(state, batch)
                _wait(metrics["loss"])  # for timing fidelity
            except Exception as e:  # device fault path
                failures += 1
                if failures > c.max_failures:
                    raise
                print(f"[trainer] step {step} failed ({e!r}); restoring")
                restored, ckpt_step, extra = restore_checkpoint(
                    c.checkpoint_dir, state
                )
                if restored is not None:
                    state = TrainState(*restored)
                    step = int(extra.get("data_step", ckpt_step))
                continue
            dt = time.perf_counter() - t0

            # straggler detection (z-score over the recent window)
            if len(times) >= c.straggler_warmup:
                mu = float(np.mean(times))
                sd = float(np.std(times)) + 1e-9
                if (dt - mu) / sd > c.straggler_zscore:
                    self.straggler_events.append(step)
                    if self.on_straggler:
                        self.on_straggler(step, dt)
            times.append(dt)
            if len(times) > 50:
                times.pop(0)

            if step % c.log_every == 0:
                rec = {
                    "step": step,
                    "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "sec": dt,
                }
                self.history.append(rec)
                print(
                    f"[trainer] step {step:5d} loss={rec['loss']:.4f} "
                    f"gnorm={rec['grad_norm']:.3f} {dt*1e3:.0f}ms"
                )

            step += 1
            if step % c.checkpoint_every == 0 or step == c.total_steps:
                save_checkpoint(
                    c.checkpoint_dir,
                    step,
                    tuple(state),
                    extra={"data_step": step, **self.pipeline.state(step)},
                )
        return state
