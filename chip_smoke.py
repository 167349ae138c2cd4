#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, each of which fails the script (exit code other than 0) when it
fails; nothing is caught and passed over:

  1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
  2. build: ``nvcc`` compiles ``kernels/csrc/gemm.cu`` for sm_90a from the
     checkout (``repro_torch.kernels.build``), timed; the ``-Xptxas=-v``
     report must show no spills;
  3. kernels: each instantiation of the scheduled GEMM kernel at the main
     path's shapes (``toycar_mlp`` at batch 16, its 8 layers with the block
     configs the compiled schedules give, each layer's cluster geometry
     printed), plus OS, ragged, every-epilogue, M = 1, K = 8 / 100 / 4096,
     multi-round (tall or wide blocks), unaligned-row and unaligned-base
     cases, the int32 wrap through a split K and through one CTA's mma
     accumulator, and two float launches with a split K compared bit for
     bit, each against its plain PyTorch version on the card (integers
     bit-exact; float32 within rtol=1e-4, atol=1e-3, since the two sum in
     different orders; bf16 within one bf16 ulp).
     Times are device times per launch from CUDA events around a
     CUDA-graph replay of back-to-back launches, summed over the 8 layers of
     one forward, beside the launch floor (8 launches of an empty kernel
     from the same source, timed the same way); the bound is
     max(bytes / 3.35 TB/s, operations / peak) for the same work with the
     published H100 SXM peaks;
  4. main path: ``repro_torch.compile("toycar_mlp")`` on gemmini in every
     mode, on ``cuda``; 64 requests through ``run_many`` on the batch-16
     module (4 dispatches) and 8 single requests at batch 1, twice (the
     second pass timed).  Outputs must be bit-equal to the port's own
     ``device="cpu"`` run of the same feeds (which the CPU tests hold to
     the reference), ``modeled_cycles()`` equal on both devices, and the
     kernel launch counter must rise by exactly 8 per ``run``;
  5. path kernel cases: every (shape, block config) that the paths of
     phases 6 and 7 launch — qcnn's im2col GEMMs, transformer_block's
     projections and per-instance attention GEMMs, edge_npu's 8-wide
     weight-stationary schedules of all four models, toycar at bucket 64 —
     plus toycar's raw int32 GEMMs at bucket 64 (naive), each against its
     plain version (bit-exact), timed as in phase 3, with
     ``torch._int_mm`` beside the raw int32 GEMMs where it applies
     (m > 16, k and n multiples of 8);
  6. new paths: qcnn and transformer_block on gemmini and all four models
     on edge_npu, every mode, per-sample (batch None) and at bucket 16,
     on ``cuda``: outputs bit-equal to the port's CPU run, modeled cycles
     equal, and the launches of each instantiation per run exactly what
     the plan implies (accelerator steps x batched-matmul instances);
  7. serving: ``repro_torch.launch.serve.serve_zoo`` for toycar_mlp on
     gemmini:optimized at ``--batch 64`` (buckets 1, 4, 16, 64) and for
     transformer_block at ``--batch 16``, a few hundred requests each
     through the micro-batching queue on ``cuda``; every response
     bit-equal to a per-request CPU run, and the launches equal to what
     the dispatched chunks imply.

The launch counts are set to 0 just before each of phases 4, 6 and 7 and
read just after; the ``launches`` of the kernels line are their sum.  It
prints a ``{"kernels": [...]}`` line (the toycar@16 sums of phase 3, and
every case of phase 5 under ``cases``), a summary of the paths, and as
its last line ``{"ok": true, "device": {...}}``.  ``--report PATH``
also writes everything measured to PATH as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch").is_dir():
    sys.exit("chip_smoke.py: src/repro_torch not found; run it from a checkout of the repo")
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import zoo  # noqa: E402
from repro_torch.core.batching import pick_bucket, plan_chunks  # noqa: E402
from repro_torch.core.strategy import gemm_instances  # noqa: E402
from repro_torch.kernels import build, gemm  # noqa: E402
from repro_torch.kernels.gemm import GemmKernelConfig, gemm_plain, scheduled_gemm  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

#: published H100 SXM rates (dense, no sparsity), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bfloat16": 989e12, "float32": 67e12}
MODES = ("optimized", "baseline", "naive")
SOURCE = "src/repro_torch/kernels/csrc/gemm.cu"
REPLACES = {
    "qgemm_requant": "src/repro/kernels/qgemm.py:19",
    "gemm_int32": "src/repro/kernels/gemm.py:97",
    "gemm_float": "src/repro/kernels/gemm.py:97",
}
F32_TOL = dict(rtol=1e-4, atol=1e-3)
GRAPH_LAUNCHES = 200
LATENCY_SAMPLES = 100
#: (model, accelerator) of phase 6, each in every mode, per-sample and at
#: bucket MAIN_BUCKET
NEW_PATHS = (
    ("qcnn", "gemmini"),
    ("transformer_block", "gemmini"),
    ("qcnn", "edge_npu"),
    ("toycar_mlp", "edge_npu"),
    ("mlp_tiny", "edge_npu"),
    ("transformer_block", "edge_npu"),
)
MAIN_BUCKET = 16
PATH_FEEDS = 3  # seeds per module: each run alone, then all through run_many
PATH_LATENCY_SAMPLES = 20
#: phase 7: (model, target, --batch, --requests)
SERVES = (
    ("toycar_mlp", "gemmini:optimized", 64, 512),
    ("transformer_block", "gemmini:optimized", 16, 256),
)
SERVE_DEADLINE_MS = 2.0


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return out


def device_ms(fn) -> float:
    """Device time per call of ``fn``: CUDA events around one replay of a
    CUDA graph holding ``GRAPH_LAUNCHES`` back-to-back calls (so host
    overhead between launches is not in the number)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / GRAPH_LAUNCHES


def eager_ms(fn, iters: int = 200) -> float:
    """Wall time per call issued from Python, device work included."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(m: int, k: int, n: int, in_dtype: str, out_bytes: int, bias_bytes: int):
    """(ms, bound_by): the least time for the same work on the card."""
    in_bytes = {"int8": 1, "bfloat16": 2, "float32": 4}[in_dtype]
    nbytes = (m * k + k * n) * in_bytes + bias_bytes + m * n * out_bytes
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = 2.0 * m * k * n / PEAK_OPS_PER_S[in_dtype] * 1e3
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations")


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    mag = x.abs().clamp_min(2.0**-6)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.double() - want.double()).abs().max().item() if got.numel() else 0.0


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    check(got.shape == want.shape and got.dtype == want.dtype, f"{name}: shape/dtype")
    err = max_err(got, want)
    if not got.dtype.is_floating_point:
        check(torch.equal(got, want), f"{name}: kernel != plain (max |err| {err})")
    elif got.dtype == torch.bfloat16:
        ok = ((got.float() - want.float()).abs() <= bf16_ulp(want.float())).all().item()
        check(ok, f"{name}: bf16 kernel beyond one ulp of plain (max |err| {err})")
    else:
        check(torch.allclose(got, want, **F32_TOL), f"{name}: f32 kernel vs plain, max |err| {err}")
    return err


def toycar_configs() -> dict[str, list[tuple[tuple[int, int, int], GemmKernelConfig]]]:
    """The block configs of toycar_mlp@16's 8 GEMMs, from the compiled
    schedules: optimized mode's fused qGEMMs and naive mode's raw int32
    GEMMs (compiled for the CPU: only the configs are read here)."""
    out = {}
    for mode in ("optimized", "naive"):
        module = repro_torch.compile(
            zoo.get_model("toycar_mlp").build(batch=16),
            repro_torch.Target("gemmini", mode=mode, device="cpu"),
        )
        rows = []
        for node, op in module.ops.items():
            x, w = node.inputs[0], node.inputs[1]
            rows.append(((int(np.prod(x.shape[:-1])), x.shape[-1], w.shape[-1]), op.executor.kernel_config))
        out[mode] = rows
    return out


def geometry_line(m: int, k: int, n: int, cfg: GemmKernelConfig, x, w) -> str:
    """The launch's cluster geometry and staging path, as the wrapper picks them."""
    geo = gemm.launch_geometry(m, k, n, cfg)
    vec_x, vec_w = gemm.copy_paths(x, w, cfg)
    return (f"clusters {geo.grid[0]}x{geo.grid[1]} of {geo.cluster} CTAs "
            f"(col_split {geo.col_split} x k_split {geo.k_split}, col_tile {geo.col_tile}, "
            f"k slices {geo.k_slices()}) copies x {'16B' if vec_x else 'element'} "
            f"w {'16B' if vec_w else 'element'}")


def kernel_phase(dev: torch.device) -> dict[str, dict]:
    rng = np.random.default_rng(0)

    def ints(shape, lo=-128, hi=128, dtype=np.int8):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype)).to(dev)

    def floats(shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev).to(dtype)

    configs = toycar_configs()
    results = {}
    specs = {
        "qgemm_requant": configs["optimized"],
        "gemm_int32": configs["naive"],
        # float instantiation at the same shapes and blocks: f32 in/out, bias
        "gemm_float": [
            (shape, GemmKernelConfig(cfg.block_m, cfg.block_k, cfg.block_n, cfg.dataflow, has_bias=True))
            for shape, cfg in configs["optimized"]
        ],
    }
    floors = {}
    for cluster in (1, 8):
        noops = lambda: [gemm.launch_noop(dev, cluster) for _ in range(8)]  # noqa: E731
        floors[cluster] = device_ms(noops)
        print(f"launch floor: 8 empty launches of a {cluster}-CTA cluster {floors[cluster]:.6f} ms")
    floor_ms = floors[1]
    for name, rows in specs.items():
        tot = {"ms": 0.0, "eager_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
        err, bound_kind, library_missing, layer_ms = 0.0, {"bytes": 0.0, "operations": 0.0}, [], []
        for (m, k, n), cfg in rows:
            if name == "gemm_float":
                x, w, b = floats((m, k)), floats((k, n)), floats((n,))
                in_dtype, out_bytes = "float32", 4
            else:
                x, w = ints((m, k)), ints((k, n))
                b = ints((n,), -2000, 2000, np.int32) if cfg.has_bias else None
                in_dtype, out_bytes = "int8", (1 if name == "qgemm_requant" else 4)
            run = lambda: scheduled_gemm(x, w, cfg, b)  # noqa: E731
            plain = lambda: gemm_plain(x, w, cfg, b)  # noqa: E731
            e = compare(f"{name} {m}x{k}x{n} {cfg.block_m}/{cfg.block_k}/{cfg.block_n}", run(), plain())
            err = max(err, e)
            ms, p_ms, h_ms = device_ms(run), device_ms(plain), eager_ms(run)
            b_ms, by = bound(m, k, n, in_dtype, out_bytes, 0 if b is None else 4 * n)
            bound_kind[by] += b_ms
            lib = None
            if name == "gemm_float":
                lib = device_ms(lambda: torch.addmm(b, x, w))
            elif name == "gemm_int32" and b is None:
                if m > 16 and k % 8 == 0 and n % 8 == 0:
                    lib = device_ms(lambda: torch._int_mm(x, w))
                else:
                    library_missing.append(f"{m}x{k}x{n}")
            print(
                f"kernel {name} {m}x{k}x{n} blocks {cfg.block_m}/{cfg.block_k}/{cfg.block_n} "
                f"{cfg.dataflow}: ms {ms:.6f} eager_ms {h_ms:.6f} plain_ms {p_ms:.6f} "
                f"bound_ms {b_ms:.8f} ({by}) library_ms {lib} max_abs_err {e}; "
                f"{geometry_line(m, k, n, cfg, x, w)}"
            )
            layer_ms.append(ms)
            tot["ms"] += ms
            tot["eager_ms"] += h_ms
            tot["plain_ms"] += p_ms
            tot["bound_ms"] += b_ms
            tot["library_ms"] = None if (lib is None or tot["library_ms"] is None) else tot["library_ms"] + lib
        if library_missing:
            print(
                f"kernel {name}: no library time: torch._int_mm needs m > 16 and k, n "
                f"multiples of 8 (shapes {', '.join(library_missing)})"
            )
        results[name] = {
            **tot,
            "layer_ms": layer_ms,
            "launch_floor_ms": floor_ms,
            "cluster8_floor_ms": floors[8],
            "max_abs_err": err,
            "bound_by": max(bound_kind, key=bound_kind.get),
        }
    extra_cases(ints, floats)
    edge_cases(dev, ints, floats)
    return results


def extra_cases(ints, floats) -> None:
    """OS raster, ragged edges and every epilogue of each instantiation."""
    m, k, n = 37, 100, 75  # ragged against every block below; rows unaligned
    blocks = dict(block_m=16, block_k=32, block_n=64)
    x, w = ints((m, k)), ints((k, n))
    b = ints((n,), -3000, 3000, np.int32)
    xf, wf, bf = floats((m, k)), floats((k, n)), floats((n,))
    cases = []
    for df in ("OS", "WS"):
        for lo, hi in ((-128, 127), (0, 127), (-32, 31)):
            cfg = GemmKernelConfig(**blocks, dataflow=df, acc_dtype="int32", out_dtype="int8",
                                   requant_scale=1 / 64, clip_lo=lo, clip_hi=hi, has_bias=True)
            cases.append((f"qgemm_requant {df} clip({lo},{hi})", x, w, cfg, b))
        for out, act in (("int32", None), ("int32", "relu"), ("float32", None)):
            cfg = GemmKernelConfig(**blocks, dataflow=df, acc_dtype="int32", out_dtype=out, activation=act)
            cases.append((f"gemm_int32 {df} out {out} act {act}", x, w, cfg, None))
        for dt in (torch.float32, torch.bfloat16):
            for out in ("float32", "bfloat16"):
                for act in (None, "relu", "gelu"):
                    cfg = GemmKernelConfig(**blocks, dataflow=df, out_dtype=out, activation=act, has_bias=True)
                    cases.append((f"gemm_float {df} in {dt} out {out} act {act}",
                                  xf.to(dt), wf.to(dt), cfg, bf))
    for label, xx, ww, cfg, bb in cases:
        e = compare(label, scheduled_gemm(xx, ww, cfg, bb), gemm_plain(xx, ww, cfg, bb))
        print(f"case {label} {m}x{k}x{n}: max_abs_err {e}; {geometry_line(m, k, n, cfg, xx, ww)}")
    torch.cuda.synchronize()
    print(f"cases: {len(cases)} OS/WS x ragged x epilogue cases equal their plain versions")


def edge_cases(dev: torch.device, ints, floats) -> None:
    """Shapes the cluster design must survive, each against the plain
    version: the int32 wrap through the split-K reduction and through one
    CTA's mma accumulator, M = 1, K ragged against the stage depth, a K
    longer than the shared-memory ring, CTAs that walk several row or
    column rounds, unaligned rows and bases, and bit-identical float
    launches with a split K."""
    q = dict(acc_dtype="int32", out_dtype="int8", requant_scale=1 / 256, clip_lo=-128, clip_hi=127,
             has_bias=True)
    i32 = dict(acc_dtype="int32", out_dtype="int32")
    fl = dict(has_bias=True)

    def misaligned(t: torch.Tensor) -> torch.Tensor:
        """The same values, contiguous, with the base one element off 16 bytes."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    cases = []  # (label, x, w, cfg, bias)
    # 2**17 + 64 products of (-128)(-128) = 2**31 + 2**20: past int32
    kk = 2**17 + 64
    xo = torch.full((16, kk), -128, dtype=torch.int8, device=dev)
    for nn, bn in ((8, 8), (1024, 1024)):
        wo = torch.full((kk, nn), -128, dtype=torch.int8, device=dev)
        cfg = GemmKernelConfig(16, 128, bn, "WS", **i32)
        geo = gemm.launch_geometry(16, kk, nn, cfg)
        where = "split-K reduction" if geo.k_split > 1 else "one CTA's mma accumulator"
        cases.append((f"int32 wrap through the {where}", xo, wo, cfg, None))
    for m, k, n in ((1, 640, 128), (16, 8, 128), (16, 100, 128), (16, 4096, 128)):
        x, w = ints((m, k)), ints((k, n))
        b = ints((n,), -3000, 3000, np.int32)
        xf, wf, bf = floats((m, k)), floats((k, n)), floats((n,))
        blocks = (16, 128, 128)
        cases += [
            (f"qgemm_requant {m}x{k}x{n}", x, w, GemmKernelConfig(*blocks, "WS", **q), b),
            (f"gemm_int32 {m}x{k}x{n}", x, w, GemmKernelConfig(*blocks, "OS", **i32), None),
            (f"gemm_float f32 {m}x{k}x{n}", xf, wf, GemmKernelConfig(*blocks, "WS", **fl), bf),
            (f"gemm_float bf16 {m}x{k}x{n}", xf.bfloat16(), wf.bfloat16(),
             GemmKernelConfig(*blocks, "WS", out_dtype="bfloat16", **fl), bf),
        ]
    # CTAs that walk several rounds: 16-row sub-tiles of a taller block with
    # a split K, more column tiles than a cluster holds (some CTAs idle in
    # the last round), and both at once
    for (m, k, n), blocks in (((50, 300, 100), (40, 64, 128)), ((20, 96, 1100), (32, 32, 1100)),
                              ((45, 200, 300), (32, 64, 300))):
        x, w = ints((m, k)), ints((k, n))
        b = ints((n,), -3000, 3000, np.int32)
        xf, wf, bf = floats((m, k)), floats((k, n)), floats((n,))
        cases += [
            (f"qgemm_requant rounds {blocks}", x, w, GemmKernelConfig(*blocks, "WS", **q), b),
            (f"gemm_int32 rounds {blocks}", x, w, GemmKernelConfig(*blocks, "OS", **i32), None),
            (f"gemm_float f32 rounds {blocks}", xf, wf, GemmKernelConfig(*blocks, "OS", **fl), bf),
            (f"gemm_float bf16 rounds {blocks}", xf.bfloat16(), wf.bfloat16(),
             GemmKernelConfig(*blocks, "WS", out_dtype="bfloat16", **fl), bf),
        ]
    m, k, n = 16, 640, 128  # aligned shape, unaligned bases
    x, w, b = ints((m, k)), ints((k, n)), ints((n,), -3000, 3000, np.int32)
    xf, wf, bf = floats((m, k)), floats((k, n)), floats((n,))
    cases += [
        ("qgemm_requant unaligned bases", misaligned(x), misaligned(w),
         GemmKernelConfig(16, 128, 128, "WS", **q), b),
        ("gemm_float f32 unaligned bases", misaligned(xf), misaligned(wf),
         GemmKernelConfig(16, 128, 128, "WS", **fl), bf),
        ("gemm_float bf16 unaligned bases", misaligned(xf.bfloat16()), misaligned(wf.bfloat16()),
         GemmKernelConfig(16, 128, 128, "WS", out_dtype="bfloat16", **fl), bf),
    ]
    for label, xx, ww, cfg, bb in cases:
        got, want = scheduled_gemm(xx, ww, cfg, bb), gemm_plain(xx, ww, cfg, bb)
        e = compare(label, got, want)
        mm, kk_, nn = xx.shape[0], xx.shape[1], ww.shape[1]
        print(f"case {label} {mm}x{kk_}x{nn}: max_abs_err {e}; {geometry_line(mm, kk_, nn, cfg, xx, ww)}")
        if label.startswith("int32 wrap"):
            wrapped = (2**31 + 2**20) - 2**32
            check(bool((want == wrapped).all()), f"{label}: the plain version did not wrap")
    for m, k, n in ((16, 640, 128), (16, 4096, 128)):
        xf, wf, bf = floats((m, k)), floats((k, n)), floats((n,))
        for dt in (torch.float32, torch.bfloat16):
            cfg = GemmKernelConfig(16, 128, 128, "WS", out_dtype="float32", has_bias=True)
            first = scheduled_gemm(xf.to(dt), wf.to(dt), cfg, bf)
            second = scheduled_gemm(xf.to(dt), wf.to(dt), cfg, bf)
            k_split = gemm.launch_geometry(m, k, n, cfg).k_split
            check(k_split > 1 and torch.equal(first, second),
                  f"gemm_float {dt} {m}x{k}x{n}: two launches differ (k_split {k_split})")
            print(f"case gemm_float {dt} {m}x{k}x{n} k_split {k_split}: two launches bit-identical")
    torch.cuda.synchronize()
    print(f"edge cases: {len(cases)} equal their plain versions; 4 float launch pairs bit-identical")


def sample_latencies(module, feeds_list) -> list[float]:
    """Wall time of ``LATENCY_SAMPLES`` single ``run`` calls (numpy in,
    numpy out, so each ends with its device work done)."""
    out = []
    for i in range(LATENCY_SAMPLES):
        feeds = feeds_list[i % len(feeds_list)]
        t0 = time.perf_counter()
        module.run(feeds)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main_path(dev: torch.device, card_line: str) -> dict:
    """Serve toycar_mlp through the port's front door in every mode."""
    model = zoo.get_model("toycar_mlp")
    batched = [model.feeds(seed, batch=16) for seed in range(4)]  # 64 requests
    singles = [model.feeds(100 + seed) for seed in range(8)]
    compiled = {}
    for mode in MODES:
        for b in (16, 1):
            for where in ("cuda", "cpu"):
                compiled[mode, b, where] = repro_torch.compile(
                    model.build(batch=b),
                    repro_torch.Target("gemmini", mode=mode, device=str(dev) if where == "cuda" else "cpu"),
                )
    summary = {}
    gemm.reset_launches()  # the main path's run starts here
    for mode in MODES:
        variant = "gemm_int32" if mode == "naive" else "qgemm_requant"
        m16, m1 = compiled[mode, 16, "cuda"], compiled[mode, 1, "cuda"]
        c16, c1 = compiled[mode, 16, "cpu"], compiled[mode, 1, "cpu"]
        check(m16.modeled_cycles() == c16.modeled_cycles(), f"{mode}: modeled cycles differ")
        want16, want1 = c16.run_many(batched), [c1.run(f) for f in singles]
        timings = {}
        for rep in ("check", "timed"):
            before = gemm.LAUNCHES[variant]
            t0 = time.perf_counter()
            got16 = m16.run_many(batched)
            t1 = time.perf_counter()
            got1 = [m1.run(f) for f in singles]
            t2 = time.perf_counter()
            runs = len(batched) + len(singles)
            check(gemm.LAUNCHES[variant] - before == 8 * runs,
                  f"{mode}: {gemm.LAUNCHES[variant] - before} launches for {runs} runs")
            for got, want in zip(got16 + got1, want16 + want1):
                check(len(got) == 1 and got[0].shape == want[0].shape and got[0].dtype == np.int8,
                      f"{mode}: output shape/dtype")
                check(np.array_equal(got[0], want[0]), f"{mode}: cuda output != cpu output")
            timings[rep] = ((t1 - t0) * 1e3, (t2 - t1) * 1e3)
        batch_ms, single_ms = timings["timed"]
        lat16 = sample_latencies(m16, batched)
        lat1 = sample_latencies(m1, singles)
        check(gemm.LAUNCHES[variant] - before == 8 * (runs + 2 * LATENCY_SAMPLES),
              f"{mode}: launches during the latency samples")
        summary[mode] = {
            "variant": variant,
            "modeled_cycles": m16.modeled_cycles()["total"],
            "dispatch_ms_batch16": batch_ms / len(batched),
            "per_request_ms_batch16": batch_ms / (16 * len(batched)),
            "per_request_ms_batch1": single_ms / len(singles),
            "run_ms_batch16_p50": float(np.percentile(lat16, 50)),
            "run_ms_batch16_p90": float(np.percentile(lat16, 90)),
            "run_ms_batch1_p50": float(np.percentile(lat1, 50)),
            "run_ms_batch1_p90": float(np.percentile(lat1, 90)),
            "latency_samples": LATENCY_SAMPLES,
        }
        print(
            f"main path {mode}: 64 requests in 4 dispatches of 16: "
            f"{batch_ms / len(batched):.4f} ms/dispatch, {batch_ms / 64:.5f} ms/request; "
            f"8 single requests: {single_ms / len(singles):.4f} ms/request; "
            f"bit-equal to cpu; modeled cycles {m16.modeled_cycles()['total']:.0f} [{card_line}]"
        )
        print(
            f"main path {mode}: run latency over {LATENCY_SAMPLES} runs each: batch 16 "
            f"p50 {np.percentile(lat16, 50):.4f} ms p90 {np.percentile(lat16, 90):.4f} ms; "
            f"batch 1 p50 {np.percentile(lat1, 50):.4f} ms p90 {np.percentile(lat1, 90):.4f} ms"
        )
    return summary


# -- phases 5-7: the new paths ----------------------------------------------


def step_gemms(node) -> tuple[tuple[int, int, int], int]:
    """((m, k, n), instances) of one accelerator step: the GEMM each launch
    computes and how many launches one run makes (a batched matmul replays
    the per-sample GEMM once per instance; a conv is its im2col GEMM)."""
    x, w = node.inputs[0], node.inputs[1]
    transpose_b = bool(node.attrs.get("transpose_b"))
    if node.op.endswith("conv2d"):
        kh, kw, ci, co = w.shape
        pool = node.attrs.get("pool")
        pre = tuple(pool["conv_shape"]) if pool else tuple(node.shape)
        return (int(np.prod(pre[:-1])), kh * kw * ci, co), 1
    if len(w.shape) == 3:
        return (x.shape[1], x.shape[2], w.shape[1] if transpose_b else w.shape[2]), gemm_instances(node)
    return (int(np.prod(x.shape[:-1])), x.shape[-1], w.shape[0] if transpose_b else w.shape[1]), 1


def plan_launches(module) -> dict[str, int]:
    """Launches of each instantiation that one ``run`` of ``module`` makes."""
    out = {name: 0 for name in gemm.LAUNCHES}
    for node, op in module.ops.items():
        out[gemm.variant(op.executor.kernel_config)] += step_gemms(node)[1]
    return out


def case_key(node, op) -> tuple:
    cfg = op.executor.kernel_config
    return (gemm.variant(cfg), step_gemms(node)[0], cfg)


def path_label(name: str, acc: str, mode: str, batch) -> str:
    return f"{name}@{acc}:{mode} b{batch or 1}"


def compile_new_paths(dev: torch.device) -> dict[tuple, dict]:
    """Every module of phase 6, on the card and on the CPU, keyed by
    (model, accelerator, mode, batch)."""
    out = {}
    for name, acc in NEW_PATHS:
        model = zoo.get_model(name)
        for mode in MODES:
            for batch in (None, MAIN_BUCKET):
                out[name, acc, mode, batch] = {
                    where: repro_torch.compile(
                        model.build(batch=batch),
                        repro_torch.Target(acc, mode=mode, device=str(dev) if where == "cuda" else "cpu"),
                    )
                    for where in ("cuda", "cpu")
                }
    return out


def serve_modules() -> dict[str, list]:
    """The bucket and per-sample modules phase 7 serves, compiled for the
    CPU (only their configs are read), keyed by a label per module."""
    out = {}
    for name, target, batch, _ in SERVES:
        acc, mode = target.split(":")
        t = repro_torch.Target(acc, mode=mode, device="cpu", batch_size=batch)
        module = repro_torch.compile(name, t)
        out[f"serve {name}@{target} sample"] = module.sample_module
        for b in module.bucket_sizes():
            out[f"serve {name}@{target} b{b}"] = module.bucket_module(b)
    return out


def path_case_phase(dev: torch.device, modules: dict[str, object]) -> dict[tuple, dict]:
    """Phase 5: each distinct (instantiation, shape, config) of the new
    paths' modules, against its plain version and timed."""
    rng = np.random.default_rng(1)

    def ints(shape, lo=-128, hi=128, dtype=np.int8):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype)).to(dev)

    where: dict[tuple, list[str]] = {}
    attention: set[tuple] = set()
    for label, module in modules.items():
        for node, op in module.ops.items():
            key = case_key(node, op)
            where.setdefault(key, []).append(label)
            if node.attrs.get("transpose_b") and len(node.inputs[1].shape) == 3:
                attention.add(key)
    results = {}
    for key in sorted(where, key=lambda k: (k[0], k[1], k[2].block_m, k[2].block_k, k[2].block_n)):
        name, (m, k, n), cfg = key
        x = ints((m, k))
        # the transposed attention operand reaches the kernel as a
        # contiguous copy (kernels/ops.py): make it the same way here
        w = ints((n, k)).T.contiguous() if key in attention else ints((k, n))
        b = ints((n,), -2000, 2000, np.int32) if cfg.has_bias else None
        run = lambda: scheduled_gemm(x, w, cfg, b)  # noqa: E731
        plain = lambda: gemm_plain(x, w, cfg, b)  # noqa: E731
        label = f"{name} {m}x{k}x{n} {cfg.block_m}/{cfg.block_k}/{cfg.block_n} {cfg.dataflow}"
        err = compare(label, run(), plain())
        ms, p_ms = device_ms(run), device_ms(plain)
        b_ms, by = bound(m, k, n, "int8", 1 if name == "qgemm_requant" else 4, 0 if b is None else 4 * n)
        lib, lib_note = None, None
        if name == "gemm_int32" and b is None:
            if m > 16 and k % 8 == 0 and n % 8 == 0:
                check(torch.equal(torch._int_mm(x, w), run()), f"{label}: torch._int_mm != kernel")
                lib = device_ms(lambda: torch._int_mm(x, w))
            else:
                lib_note = "torch._int_mm needs m > 16 and k, n multiples of 8"
        results[key] = {
            "variant": name, "m": m, "k": k, "n": n,
            "blocks": f"{cfg.block_m}/{cfg.block_k}/{cfg.block_n}", "dataflow": cfg.dataflow,
            "ms": ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": lib,
            "max_abs_err": err, "attention": key in attention, "paths": len(where[key]),
        }
        geo = gemm.launch_geometry(m, k, n, cfg)
        print(
            f"path case {label}{' attention' if key in attention else ''}: ms {ms:.6f} "
            f"plain_ms {p_ms:.6f} bound_ms {b_ms:.8f} ({by}) library_ms "
            f"{lib if lib_note is None else 'none (' + lib_note + ')'} err {err}; clusters "
            f"{geo.grid[0]}x{geo.grid[1]}x{geo.cluster}; {len(where[key])} modules, e.g. {where[key][0]}"
        )
    torch.cuda.synchronize()
    print(f"path cases: {len(results)} (instantiation, shape, config) cases equal their plain versions")
    return results


def kernel_ms_per_run(module, cases: dict[tuple, dict]) -> float:
    """Device time of one run's launches, from the phase-5 case times."""
    return sum(cases[case_key(node, op)]["ms"] * step_gemms(node)[1] for node, op in module.ops.items())


def new_paths_phase(compiled: dict, cases: dict, card_line: str) -> dict:
    """Phase 6: every new path on the card, held to the CPU run."""
    summary = {}
    for (name, acc, mode, batch), mods in compiled.items():
        got_m, want_m = mods["cuda"], mods["cpu"]
        label = path_label(name, acc, mode, batch)
        check(got_m.modeled_cycles() == want_m.modeled_cycles(), f"{label}: modeled cycles differ")
        per_run = plan_launches(got_m)
        model = zoo.get_model(name)
        feeds = [model.feeds(seed, batch=batch) for seed in range(PATH_FEEDS)]
        want = [want_m.run(f) for f in feeds]
        before = dict(gemm.LAUNCHES)
        got = [got_m.run(f) for f in feeds] + got_m.run_many(feeds)
        runs = 2 * len(feeds)
        for v, count in per_run.items():
            check(gemm.LAUNCHES[v] - before[v] == count * runs,
                  f"{label}: {gemm.LAUNCHES[v] - before[v]} {v} launches for {runs} runs, "
                  f"the plan implies {count} per run")
        for g, w in zip(got, want + want):
            check(len(g) == len(w) == 1 and g[0].shape == w[0].shape and g[0].dtype == w[0].dtype,
                  f"{label}: output shape/dtype")
            if not np.array_equal(g[0], w[0]):
                diff = int((g[0] != w[0]).sum())
                check(False, f"{label}: cuda output != cpu output ({diff} of {g[0].size} codes differ)")
        lat = []
        for i in range(PATH_LATENCY_SAMPLES):
            t0 = time.perf_counter()
            got_m.run(feeds[i % len(feeds)])
            lat.append((time.perf_counter() - t0) * 1e3)
        summary[label] = {
            "launches_per_run": {v: c for v, c in per_run.items() if c},
            "modeled_cycles": got_m.modeled_cycles()["total"],
            "run_ms_p50": float(np.percentile(lat, 50)),
            "kernel_ms_per_run": kernel_ms_per_run(got_m, cases),
        }
        print(
            f"new path {label}: bit-equal to cpu over {runs} runs; launches per run "
            f"{summary[label]['launches_per_run']}; run p50 {summary[label]['run_ms_p50']:.4f} ms "
            f"(kernels {summary[label]['kernel_ms_per_run']:.4f} ms device); modeled cycles "
            f"{summary[label]['modeled_cycles']:.0f}"
        )
    print(f"new paths: {len(summary)} modules served on cuda bit-equal to cpu [{card_line}]")
    return summary


def serve_phase(dev: torch.device, cases: dict, card_line: str, windows: dict) -> dict:
    """Phase 7: ``serve_zoo`` on the card, every response held to a
    per-request CPU run; each call is its own launch-count window."""
    summary = {}
    for name, target, batch, requests in SERVES:
        args = argparse.Namespace(zoo=name, target=target, batch=batch, requests=requests,
                                  deadline_ms=SERVE_DEADLINE_MS, device=str(dev))
        gemm.reset_launches()  # this serve call's window starts here
        result = serve.serve_zoo(args)
        window = dict(gemm.LAUNCHES)  # read just after it
        windows[f"serve {name}@{target} --batch {batch}"] = window
        module = result.module
        # what the dispatched chunks imply: the warmup runs every bucket
        # once, then each dispatch splits into plan_chunks of the buckets
        buckets = module.bucket_sizes()
        expected = {v: 0 for v in gemm.LAUNCHES}

        def add_chunks(n: int) -> None:
            for size in plan_chunks(buckets, n):
                mod = (module.sample_module if size == 1
                       else module.bucket_module(pick_bucket(buckets, size)))
                for v, c in plan_launches(mod).items():
                    expected[v] += c

        for b in buckets:
            add_chunks(b)
        check(len(result.stats.batch_sizes) == result.stats.batches, f"serve {name}: dispatch record")
        for size in result.stats.batch_sizes:
            add_chunks(size)
        check(window == expected, f"serve {name}: launches {window}, the dispatches imply {expected}")
        acc, mode = target.split(":")
        cpu = repro_torch.compile(zoo.get_model(name).build(), repro_torch.Target(acc, mode=mode, device="cpu"))
        check(len(result.outputs) == requests, f"serve {name}: {len(result.outputs)} responses")
        for i, (feeds, got) in enumerate(zip(result.traffic, result.outputs)):
            want = cpu.run(feeds)
            check(len(got) == 1 and got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0]),
                  f"serve {name}: response {i} != per-request cpu result")
        # where a dispatch's time goes: the same number of requests through
        # run_many without the queue, and the largest bucket's plan alone
        model = zoo.get_model(name)
        chunk = result.traffic[:batch]
        top = module.bucket_module(buckets[-1])
        packed = model.feeds(0, batch=buckets[-1])
        run_many_ms, plan_ms = [], []
        for _ in range(PATH_LATENCY_SAMPLES):
            t0 = time.perf_counter()
            module.run_many(chunk)
            t1 = time.perf_counter()
            top.run(packed)
            run_many_ms.append((t1 - t0) * 1e3)
            plan_ms.append((time.perf_counter() - t1) * 1e3)
        lat_ms = np.asarray(result.latencies_s) * 1e3
        sizes = list(result.stats.batch_sizes)
        summary[name] = {
            "target": target, "batch": batch, "buckets": list(buckets), "requests": requests,
            "boot_ms": result.boot_s * 1e3, "wall_s": result.wall_s,
            "req_per_s": requests / result.wall_s,
            "latency_ms_p50": float(np.percentile(lat_ms, 50)),
            "latency_ms_p99": float(np.percentile(lat_ms, 99)),
            "dispatches": result.stats.batches, "mean_batch": result.stats.mean_batch(),
            "batch_sizes": sorted(set(sizes)), "launches": {v: c for v, c in window.items() if c},
            "kernel_ms_per_bucket_run": {
                str(b): kernel_ms_per_run(module.bucket_module(b), cases) for b in buckets
            },
            "dispatch_ms": result.wall_s * 1e3 / result.stats.batches,
            f"run_many_{batch}_ms_p50": float(np.percentile(run_many_ms, 50)),
            f"bucket_{buckets[-1]}_plan_ms_p50": float(np.percentile(plan_ms, 50)),
        }
        print(
            f"serve {name} on {target} --batch {batch}: {requests} responses bit-equal to per-request "
            f"cpu runs; {summary[name]['req_per_s']:.1f} req/s, p50 {summary[name]['latency_ms_p50']:.4f} ms, "
            f"p99 {summary[name]['latency_ms_p99']:.4f} ms, {result.stats.batches} dispatches "
            f"(sizes {summary[name]['batch_sizes']}); launches {summary[name]['launches']}; kernel device "
            f"ms per bucket run {summary[name]['kernel_ms_per_bucket_run']} [{card_line}]"
        )
        print(
            f"serve {name}: per dispatch {summary[name]['dispatch_ms']:.4f} ms through the queue; "
            f"the same {batch} requests through run_many alone p50 {np.percentile(run_many_ms, 50):.4f} ms; "
            f"the bucket-{buckets[-1]} plan alone p50 {np.percentile(plan_ms, 50):.4f} ms, its kernels "
            f"{summary[name]['kernel_ms_per_bucket_run'][str(buckets[-1])]:.4f} ms device"
        )
    return summary


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="drive the port on one NVIDIA card")
    ap.add_argument("--report", help="also write everything measured to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False: this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card_line = card()
    print(card_line)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    path, log = build.build("gemm")
    build_s = time.perf_counter() - t0
    print(f"build: {path.name} in {build_s:.2f} s")
    usage = sorted({line.split(":", 1)[1].strip() for line in log.splitlines() if "Used" in line})
    print(f"build: ptxas per kernel: {usage}")
    spills = [line for line in log.splitlines() if "spill" in line]
    if log:  # empty when an earlier run of this checkout built the library
        check(bool(spills) and all("0 bytes spill stores, 0 bytes spill loads" in line for line in spills),
              f"build: ptxas reports spills: {[line for line in spills if ' 0 bytes spill' not in line]}")
        print(f"build: no spills in {len(spills)} kernels")
    else:
        print("build: library built by an earlier run; no ptxas report to check")

    kernels = kernel_phase(dev)
    compiled = compile_new_paths(dev)
    case_modules = {path_label(*key): mods["cpu"] for key, mods in compiled.items()}
    case_modules.update(serve_modules())
    # row 2 (raw int32) at toycar's largest serving bucket, where
    # torch._int_mm applies; no path of phases 6-7 serves naive at 64
    case_modules["toycar_mlp@gemmini:naive b64"] = repro_torch.compile(
        zoo.get_model("toycar_mlp").build(batch=64),
        repro_torch.Target("gemmini", mode="naive", device="cpu"),
    )
    cases = path_case_phase(dev, case_modules)

    windows = {}
    summary = main_path(dev, card_line)  # sets the counts to 0 first
    windows["toycar_mlp@gemmini"] = dict(gemm.LAUNCHES)  # read just after the main path's run
    for mode, s in summary.items():
        # the device time of one batch-16 forward's 8 kernels (kernel phase)
        # against the wall time of one batch-16 run
        s["kernel_ms_per_run_batch16"] = kernels[s["variant"]]["ms"]
        s["kernel_share_of_run_batch16"] = kernels[s["variant"]]["ms"] / s["run_ms_batch16_p50"]
    gemm.reset_launches()  # the new paths' run starts here
    paths = new_paths_phase(compiled, cases, card_line)
    windows["new paths"] = dict(gemm.LAUNCHES)  # read just after it
    served = serve_phase(dev, cases, card_line, windows)
    for window, counts in windows.items():
        print(f"launch window {window}: {counts}")
    for window in ("toycar_mlp@gemmini", "new paths"):
        for name in ("qgemm_requant", "gemm_int32"):
            check(windows[window][name] > 0, f"kernel {name} never launched in the {window} window")
    launches = {name: sum(w[name] for w in windows.values()) for name in gemm.LAUNCHES}

    line = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max([r["max_abs_err"]] + [c["max_abs_err"] for c in cases.values()
                                                    if c["variant"] == name]),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "eager_ms": r["eager_ms"],
            "launch_floor_ms": r["launch_floor_ms"],
            "cluster8_floor_ms": r["cluster8_floor_ms"],
            "layer_ms": r["layer_ms"],
            "shapes": "toycar_mlp batch 16, 8 layers, summed; each path case under cases",
            "cases": [
                {"shape": f"{c['m']}x{c['k']}x{c['n']}", "blocks": f"{c['blocks']} {c['dataflow']}",
                 **{k: c[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")},
                 **({"attention": True} if c["attention"] else {})}
                for c in cases.values() if c["variant"] == name
            ],
        }
        for name, r in kernels.items()
    ]}
    report = {"card": card_line, "build_s": build_s, "main_path": summary, "paths": paths,
              "serve": served, "launch_windows": windows}
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps({**report, **line}, indent=1))
    # the per-path summary is long and printed above, path by path
    print(json.dumps({k: v for k, v in report.items() if k != "paths"}))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
