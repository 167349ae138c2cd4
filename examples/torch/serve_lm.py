"""Batched serving example: the wave-based LM engine over a request pool
(prefill + greedy decode with per-arch KV caches; MusicGen backbone by
default, at its reduced smoke width, without its audio frontend).

    PYTHONPATH=src python examples/torch/serve_lm.py --requests 12 --batch 4 [--device cuda|cpu]

The engine runs eagerly on the device of its parameters and installs no
kernel policy, as the reference's does: wrap ``engine.generate`` in
``repro_torch.kernels.policy.scheduled_kernels(backend)`` to route its
GEMMs through the scheduled CUDA kernel.
"""

import argparse
import time
import warnings

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.deprecation import ReproDeprecationWarning
from repro_torch.models import lm
from repro_torch.serve import ServeConfig, ServingEngine


def config(arch: str = "musicgen_medium"):
    return get_smoke_config(arch).with_(frontend=None, n_frontend_tokens=0)


def prompts(cfg, requests: int, prompt_len: int) -> list[np.ndarray]:
    rng = np.random.default_rng(0)
    return [
        rng.integers(0, cfg.vocab, size=(prompt_len,)).astype(np.int32)
        for _ in range(requests)
    ]


def run(device: str = "cuda", arch: str = "musicgen_medium", requests: int = 12,
        batch: int = 4, prompt_len: int = 24, new_tokens: int = 16, params=None) -> dict:
    """Serve ``requests`` prompts, then the first wave again.  ``params``
    defaults to ``lm.init_lm(0, cfg, device=device)``.  Returns ``{"cfg",
    "done", "again", "seconds"}``."""
    cfg = config(arch)
    params = lm.init_lm(0, cfg, device=device) if params is None else params
    engine = ServingEngine(
        cfg,
        params,
        ServeConfig(
            batch=batch,
            max_len=prompt_len + new_tokens + 1,
            max_new_tokens=new_tokens,
        ),
    )
    pool = prompts(cfg, requests, prompt_len)
    t0 = time.perf_counter()
    done = engine.generate(pool)
    dt = time.perf_counter() - t0
    # determinism: same engine, same prompts -> same outputs
    again = engine.generate(pool[:batch])
    assert again[0].output == done[0].output
    return {"cfg": cfg, "done": done, "again": again, "seconds": dt}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="musicgen_medium")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)

    # the wave-based engine is deprecated in favour of the compiled decode
    # path; this example serves the raw LM stack on purpose
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ReproDeprecationWarning)
        r = run(args.device, args.arch, args.requests, args.batch, args.prompt_len, args.new_tokens)
    done, dt = r["done"], r["seconds"]
    n_tok = sum(len(q.output) for q in done)
    print(f"{r['cfg'].name}: served {len(done)} requests / {n_tok} tokens "
          f"in {dt:.2f}s ({n_tok/dt:.1f} tok/s on {torch.device(args.device).type})")
    print("sample:", done[0].output)
    print("deterministic decode: OK")


if __name__ == "__main__":
    main()
