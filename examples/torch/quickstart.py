"""Quickstart: the paper's flow through the port's one front door.

1. Write a model as a plain PyTorch function (weights in a params dict,
   quantization in the recognized ``repro_torch.frontend.nn`` idioms).
2. Declare a ``Target`` (accelerator + mode + device) — no compiler
   internals.
3. ``repro_torch.compile(fn, target, example_inputs, params)`` exports the
   function with ``torch.export``, imports it into core IR, and compiles
   it; every offloaded GEMM runs on the scheduled CUDA kernel on the card
   (its plain PyTorch version on ``--device cpu``).
4. Execute (bit-exact vs the graph reference) + read modeled cycles.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cuda|cpu]
"""

import argparse
import warnings

import numpy as np
import torch

import repro_torch
from repro_torch.core import ir
from repro_torch.frontend import nn, trace_model

SPECS = ("gemmini:optimized", "gemmini:baseline", "gemmini:naive")


def qdense(x, params):
    """One quantized dense layer, written in plain torch: float weights are
    transposed + quantized inside the function, so the compiler folds the
    preparation at compile time (the naive BYOC mode pays at run time)."""
    w_q = nn.quantize(torch.transpose(params["w"], 0, 1), 0.03125)
    d = nn.dense(x, w_q) + params["b"]
    return torch.clamp(nn.requantize(d, 0.125), -128, 127)


def make_params():
    rng = np.random.default_rng(0)
    return {
        "w": (rng.normal(size=(128, 256)) * 0.02).astype(np.float32),
        "b": rng.integers(-100, 100, size=(128,)).astype(np.int32),
    }


def make_input():
    return np.random.default_rng(1).integers(-128, 128, (8, 256)).astype(np.int8)


def run(device: str = "cuda") -> dict:
    """Compile ``qdense`` on gemmini in the three modes on ``device``.

    Returns ``{"reference", "outputs", "cycles", "ops", "modules"}``: the
    imported graph's interpreted output, and per mode its output, modeled
    cycles, post-pass op sequence and compiled module."""
    params = make_params()
    x = make_input()
    # the examples run with deprecations as hard errors: the quickstart
    # must never drift back onto the legacy two-step API
    with warnings.catch_warnings():
        warnings.simplefilter("error", repro_torch.ReproDeprecationWarning)
        # reference semantics from the imported graph, independent of any target
        graph = trace_model(qdense, {"x": x}, params)
        result = {"reference": ir.execute_graph(graph, {"x": x})[0],
                  "outputs": {}, "cycles": {}, "ops": {}, "modules": {}}
        for spec in SPECS:
            target = repro_torch.Target.parse(spec, device=device)
            mod = repro_torch.compile(qdense, target, example_inputs={"x": x}, params=params)
            result["outputs"][spec] = mod.run({"x": x})[0]
            result["cycles"][spec] = mod.modeled_cycles()
            result["ops"][spec] = [n.op for n in mod.graph.toposort()]
            result["modules"][spec] = mod
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)

    result = run(args.device)
    ref = result["reference"]
    for spec in SPECS:
        cycles = result["cycles"][spec]
        print(
            f"{spec:20s} exact={np.array_equal(result['outputs'][spec], ref)} "
            f"cycles={cycles['total']:>12,.0f} (host={cycles['host']:,.0f}) "
            f"device={args.device}"
        )

    # what the staged pass pipeline actually did (the abstraction claim,
    # visible: every rewrite is a named, counted, timed unit)
    mod = result["modules"]["gemmini:optimized"]
    print()
    print(mod.pass_report.summary())
    print(f"inputs: {mod.input_signature()}")

    # inspect the schedule the extended-CoSA scheduler picked
    for name, sched in mod.schedules().items():
        print(f"\nschedule for {name}:")
        for lvl in sched["levels"]:
            print("  ", lvl)


if __name__ == "__main__":
    main()
