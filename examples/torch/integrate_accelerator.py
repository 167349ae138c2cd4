"""Integrate a BRAND-NEW accelerator in ~60 lines — the paper's core claim,
on the port.

We define "EdgeMM", a fictional 32x32 weight-stationary edge accelerator
with a 512 KiB unified SRAM, entirely through the public description API
(no compiler internals), register it with the accelerator registry, and
compile straight through ``repro_torch.compile(graph, Target("edgemm",
...))`` — the front door validates the description, generates the full
compiler backend, and attaches the persistent schedule cache.  The same
quantized model then compiles and runs on it in all three pipeline modes,
on both routes: the scheduled CUDA kernel (the default) and the emulated
route (``use_pallas=False``), which calls EdgeMM's ``mma`` intrinsic once
per PE tile, on torch tensors on the module's device.

    PYTHONPATH=src python examples/torch/integrate_accelerator.py [--device cuda|cpu]

(The in-tree ``edge_npu`` description in
``src/repro_torch/core/descriptions/edge_npu.py`` is the maintained version
of this pattern; ``docs/torch/integration_guide.md`` walks through it step
by step.)
"""

import argparse
import tempfile

import numpy as np
import torch

import repro_torch
from repro_torch.core import ir
from repro_torch.core.arch_spec import (
    WEIGHT_STATIONARY,
    ArchSpec,
    HardwareConstraints,
    MemLevel,
)

MODES = ("optimized", "baseline", "naive")

# --------------------- architectural description (YAML-able) ---------------
DIM = 32
edge_arch = ArchSpec(
    name="edgemm",
    levels=(
        MemLevel("pe", size_bytes=0, holds=()),
        MemLevel("sram", size_bytes=512 * 1024, bytes_per_cycle=8.0),
        MemLevel("dram", size_bytes=0, bytes_per_cycle=8.0),
    ),
    constraints=HardwareConstraints(
        pe_dim=DIM,
        alignments={"N": DIM, "C": DIM, "K": DIM},
    ),
    dataflows=(WEIGHT_STATIONARY,),
    macs_per_cycle=DIM * DIM,
    host_preproc_cycles_per_byte=16.0,
    instr_overhead_cycles=64.0,
)


# --------------------- functional description ------------------------------
# exist_ok: importing this file twice in one process keeps the first
# registration instead of raising on the duplicate name
@repro_torch.register_accelerator("edgemm", exist_ok=True)
def make_edgemm() -> repro_torch.AcceleratorDescription:
    desc = repro_torch.AcceleratorDescription(name="edgemm", arch=edge_arch)

    @desc.register_preprocessing("dense", operand="W", constant=True)
    def transpose_weights(w):
        return np.ascontiguousarray(np.transpose(w))

    @desc.register_core_compute("edgemm_qgemm", op="dense", quantized=True)
    def qdense(x_q, w_q, bias, scale):
        acc = x_q.astype(np.int32) @ w_q.astype(np.int32) + bias
        return np.clip(np.round(acc * scale), -128, 127).astype(np.int8)

    @desc.register_hw_intrinsic(
        "edgemm.mma",
        kind="compute",
        tag="edgemm_qgemm",
        tile_limits={"N": DIM, "C": DIM, "K": DIM},
        dataflow="WS",
    )
    def mma(a_tile, b_tile, acc_tile):
        # torch tensors on the module's device; the product accumulates in
        # int64 (a broadcast multiply summed over K: CUDA has no integer
        # matmul)
        prod = a_tile.to(torch.int64).unsqueeze(-1) * b_tile.to(torch.int64).unsqueeze(0)
        return acc_tile + prod.sum(dim=-2)

    @desc.register_hw_intrinsic("edgemm.load", kind="memory", operand="In")
    def load(dram, sram, rows, cols):
        return ("load", rows, cols)

    @desc.register_hw_intrinsic("edgemm.load_w", kind="memory", operand="W")
    def load_w(dram, sram, rows, cols):
        return ("load_w", rows, cols)

    @desc.register_hw_intrinsic("edgemm.store", kind="memory", operand="Out")
    def store(sram, dram, rows, cols):
        return ("store", rows, cols)

    return desc


# --------------------- that's it: one call to integrate --------------------
def build_graph(rng):
    x = ir.input_((16, 512), "int8", name="x")
    w = ir.quantize(
        ir.transpose(ir.const(rng.normal(size=(256, 512)).astype(np.float32) * 0.02)),
        scale=0.02,
    )
    b = ir.const(rng.integers(-50, 50, (256,)).astype(np.int32))
    return ir.Graph(
        [ir.clip(ir.requantize(ir.bias_add(ir.dense(x, w), b), scale=0.1))],
        name="edge_dense",
    )


def make_input():
    return np.random.default_rng(0).integers(-128, 128, (16, 512)).astype(np.int8)


def run(device: str = "cuda", use_pallas: bool = True, accelerator="edgemm") -> dict:
    """Compile EdgeMM's dense layer in the three modes on one route.

    ``accelerator`` is the registered name or a description object (a
    test passes one whose intrinsics it counts).  Returns ``{"reference",
    "outputs", "cycles", "modules", "schedules", "warm"}``: the graph
    interpreter's output, each mode's output, modeled cycles and module,
    the optimized module's schedules, and the warm recompile's scheduler
    sweeps and cache hits."""
    x_val = make_input()
    result = {
        "reference": ir.execute_graph(build_graph(np.random.default_rng(0)), {"x": x_val})[0],
        "outputs": {}, "cycles": {}, "modules": {},
    }
    with tempfile.TemporaryDirectory() as cache_dir:
        # compile through the front door: the new name is a Target like any
        # in-tree accelerator — no compiler-internal edits anywhere.
        for mode in MODES:
            mod = repro_torch.compile(
                build_graph(np.random.default_rng(0)),
                repro_torch.Target(accelerator, mode=mode, cache_dir=cache_dir,
                                   use_pallas=use_pallas, device=device),
            )
            result["modules"][mode] = mod
            result["outputs"][mode] = mod.run({"x": x_val})[0]
            result["cycles"][mode] = mod.modeled_cycles()["total"]
        result["schedules"] = result["modules"]["optimized"].schedules()

        # recompile in a FRESH backend: everything comes from the persistent
        # schedule cache — zero extended-CoSA DSE sweeps.
        warm = repro_torch.compile(
            build_graph(np.random.default_rng(0)),
            repro_torch.Target(accelerator, cache_dir=cache_dir, use_pallas=use_pallas,
                               device=device),
            options=repro_torch.CompileOptions(fresh_backend=True),
        )
        result["warm"] = (warm.backend.scheduler.n_solver_calls,
                          warm.backend.schedule_cache.stats.hits)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)

    for use_pallas in (True, False):
        route = "kernel" if use_pallas else "emulated"
        result = run(args.device, use_pallas=use_pallas)
        for mode in MODES:
            print(
                f"[{mode:12s}] route={route:8s} device={args.device} match vs reference: "
                f"{np.array_equal(result['outputs'][mode], result['reference'])}  "
                f"modeled cycles: {result['cycles'][mode]:>12,.0f}"
            )
        for name, sched in result["schedules"].items():
            print(
                f"CoSA schedule for {name}: dataflow={sched['dataflow']}, "
                f"dbuf={sched['double_buffer']}, shares={sched['memory_shares']}"
            )
        sweeps, hits = result["warm"]
        print(f"warm recompile: scheduler sweeps={sweeps}, cache hits={hits}")


if __name__ == "__main__":
    main()
