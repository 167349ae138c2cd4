"""Batched LM serving engine: waves of prefill + greedy (or sampled)
decode over a request list.

The engine keeps a fixed decode batch: prompts are served in waves of
``batch``, each wave left-padded with token 0 to its longest prompt (no
padding mask, as in the reference), prefilled into a KV cache and
decoded for ``max_new_tokens`` steps.  KV caches use the model config's
dtype.  Where ``lm.graphs_fit`` takes the model on a card, the engine
keeps one cache for all waves, and its decode steps replay the CUDA
graphs captured in the first.

Port of ``repro.serve.engine`` (``ServeConfig``, ``Request``,
``ServingEngine``).  The reference jits ``prefill`` and ``decode_step``;
here they run eagerly under ``torch.inference_mode`` on the device of
the parameters, writing the cache in place.  Temperature sampling draws
from a ``torch.Generator`` on that device seeded with the step index, in
place of ``jax.random.key(step)``: the same seeding rule, another
generator, so sampled tokens differ from the reference's (greedy tokens
do not).  As in the reference, the engine installs no kernel policy:
wrap ``generate`` in ``repro_torch.kernels.policy.scheduled_kernels`` to
route its GEMMs through the scheduled kernel.  Under
``repro_torch.tracing.recording`` a wave records its spans (``engine.*``
around the padding, the cache, each readback and each next token; the
model's own inside) and counters (prompt tokens, padded positions,
decode steps).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.deprecation import warn_deprecated
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


@dataclass
class ServeConfig:
    batch: int = 8
    max_len: int = 512
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 => greedy


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S]
    output: list[int] = field(default_factory=list)
    done: bool = False


class ServingEngine:
    """DEPRECATED: the wave-based LM serving loop.

    Superseded by ``repro_torch.serve.ContinuousBatchingEngine``, which
    serves the compiled decode path (KV-cache IR + block-based pool) and
    never restarts the batch between waves.  This class stays for the raw
    ``models/lm`` stack only.
    """

    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig):
        warn_deprecated(
            "repro_torch.serve.ServingEngine",
            "repro_torch.serve.ContinuousBatchingEngine (the compiled decode path)",
        )
        self.cfg = cfg
        self.params = params
        self.scfg = serve_cfg
        self.device = params["embed"]["table"].device
        self._cache = None  # the one cache of a model whose decode step replays CUDA graphs

    def _wave_cache(self, bsz: int):
        """A fresh cache for each wave; for a model on a card that
        ``lm.graphs_fit``, the engine's one cache, kept with its captured
        decode step (``lm.decode_step``) for every wave.  A prefill
        rewrites the positions it reads and the MLA decode masks the
        rest, so an earlier wave's rows are never read."""
        if self.device.type != "cuda" or not lm.graphs_fit(self.cfg):
            return lm.init_cache(self.cfg, bsz, self.scfg.max_len, device=self.device)
        if self._cache is None:
            self._cache = lm.init_cache(self.cfg, bsz, self.scfg.max_len, device=self.device, graphs=True)
        self._cache["len"] = 0
        return self._cache

    def _next_tokens(self, logits: torch.Tensor, step: int) -> torch.Tensor:
        """[B, 1] int32: argmax, or a sample at ``temperature``."""
        if self.scfg.temperature > 0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(step)
            probs = torch.softmax(logits[:, -1] / self.scfg.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen).to(torch.int32)
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)

    def generate(self, prompts: list[np.ndarray]) -> list[Request]:
        """Serve a list of prompts with a fixed-size decode batch."""
        s = self.scfg
        reqs = [Request(i, p) for i, p in enumerate(prompts)]
        done: list[Request] = []
        queue = list(reqs)

        with torch.inference_mode():
            while queue:
                wave = queue[: s.batch]
                queue = queue[s.batch :]
                # pad wave to the static batch
                bsz = s.batch
                plen = max(len(r.prompt) for r in wave)
                sent = sum(len(r.prompt) for r in wave) if tracing.active() is not None else 0
                tracing.count("engine.prompt_tokens", sent)
                tracing.count("engine.padded_positions", bsz * plen)
                with tracing.span("engine.wave", batch=bsz, padded_len=plen, prompt_tokens=sent):
                    with tracing.span("engine.pad"):
                        toks = np.zeros((bsz, plen), np.int32)
                        for i, r in enumerate(wave):
                            toks[i, plen - len(r.prompt) :] = r.prompt  # left-pad
                        toks = torch.from_numpy(toks).to(self.device)
                    with tracing.span("engine.cache_init"):
                        cache = self._wave_cache(bsz)
                    logits, cache = lm.prefill(self.params, self.cfg, toks, cache)
                    with tracing.span("engine.next_token"):
                        cur = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
                    for step in range(s.max_new_tokens):
                        with tracing.span("engine.readback"):
                            tokens = cur[:, 0].tolist()
                        for i, r in enumerate(wave):
                            if not r.done:
                                r.output.append(tokens[i])
                        tracing.count("engine.decode_steps")
                        logits, cache = lm.decode_step(self.params, self.cfg, cache, cur)
                        with tracing.span("engine.next_token"):
                            cur = self._next_tokens(logits, step)
                for r in wave:
                    r.done = True
                    done.append(r)
        return done
