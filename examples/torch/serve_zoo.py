"""Serving a zoo model through the port's planned graph executor.

Compiles a model-zoo network once through the ``repro_torch.compile()``
front door (the zoo name is traced with ``torch.export``), then drives
repeated inference with ``run_many`` — the compiled ``ExecutionPlan``
(flat step list, slot-indexed buffer arena, constants copied to the device
once) is built at compile time and reused across every call.  The per-node
interpreter (``use_plan=False``) is run on the same traffic for
comparison; both paths are bit-exact.

    PYTHONPATH=src python examples/torch/serve_zoo.py [model] [accelerator:mode] [--device cuda|cpu]
"""

import argparse
import time

import numpy as np
import torch

import repro_torch
from repro_torch.core.zoo import get_model, model_names


def _clock(device: str) -> float:
    # on the card every call only enqueues work: wait for it before reading
    # the clock
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def run(model_name: str = "mlp_tiny", target: str = "gemmini:optimized",
        device: str = "cuda", requests: int = 256) -> dict:
    """Serve ``requests`` feeds planned and interpreted.  Returns
    ``{"module", "planned", "interpreted", "t_planned", "t_interpreted"}``
    (outputs per request, and seconds for the whole traffic)."""
    model = get_model(model_name)
    module = repro_torch.compile(
        model_name, repro_torch.Target.parse(target, cache=False, device=device)
    )
    traffic = [model.feeds(seed=s) for s in range(requests)]
    planned = module.run_many(traffic)
    interpreted = module.run_many(traffic, use_plan=False)
    assert all(
        np.array_equal(p[0], i[0]) for p, i in zip(planned, interpreted)
    ), "planned executor must be bit-exact with the interpreter"

    t0 = _clock(device)
    module.run_many(traffic)
    t_planned = _clock(device) - t0
    t0 = _clock(device)
    module.run_many(traffic, use_plan=False)
    t_interpreted = _clock(device) - t0
    return {"module": module, "model": model, "planned": planned,
            "interpreted": interpreted, "t_planned": t_planned,
            "t_interpreted": t_interpreted}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", nargs="?", default="mlp_tiny", help=", ".join(model_names()))
    ap.add_argument("target", nargs="?", default="gemmini:optimized")
    ap.add_argument("--device", default="cuda", help="cuda (the card, default) or cpu")
    ap.add_argument("--requests", type=int, default=256)
    args = ap.parse_args(argv)

    r = run(args.model, args.target, args.device, args.requests)
    module, n = r["module"], args.requests
    plan = module.plan
    print(f"model={r['model'].name} ({r['model'].description}) device={args.device}")
    print(
        f"plan: {len(plan.steps)} steps, {len(plan.const_slots)} materialized "
        f"consts, {plan.n_slots} arena slots"
    )
    print(
        f"{n} requests: planned {r['t_planned'] / n * 1e6:8.1f} us/call, "
        f"interpreter {r['t_interpreted'] / n * 1e6:8.1f} us/call "
        f"({r['t_interpreted'] / r['t_planned']:.2f}x)"
    )
    print(f"modeled cycles: {module.modeled_cycles()}")


if __name__ == "__main__":
    main()
