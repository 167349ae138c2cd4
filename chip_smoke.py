#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, each of which fails the script (exit code other than 0) when it
fails; nothing is caught and passed over:

  1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
  2. build: ``nvcc`` compiles ``kernels/csrc/gemm.cu`` for sm_90a from the
     checkout (``repro_torch.kernels.build``), timed;
  3. kernels: each instantiation of the scheduled GEMM kernel at the main
     path's shapes (``toycar_mlp`` at batch 16, its 8 layers with the block
     configs the compiled schedules give), plus OS, ragged and
     every-epilogue cases, against its plain PyTorch version on the card
     (integers bit-exact; float32 within rtol=1e-4, atol=1e-3, since the
     two sum in different orders; bf16 within one bf16 ulp).  Times are
     device times per launch from CUDA events around a CUDA-graph replay
     of back-to-back launches, summed over the 8 layers of one forward;
     the bound is max(bytes / 3.35 TB/s, operations / peak) for the same
     work with the published H100 SXM peaks;
  4. main path: ``repro_torch.compile("toycar_mlp")`` on gemmini in every
     mode, on ``cuda``; 64 requests through ``run_many`` on the batch-16
     module (4 dispatches) and 8 single requests at batch 1, twice (the
     second pass timed).  Outputs must be bit-equal to the port's own
     ``device="cpu"`` run of the same feeds (which the CPU tests hold to
     the reference), ``modeled_cycles()`` equal on both devices, and the
     kernel launch counter must rise by exactly 8 per ``run``.

It prints a ``{"kernels": [...]}`` line and a main-path summary, and as
its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
from repro_torch.kernels import build, gemm  # noqa: E402
from repro_torch.kernels.gemm import GemmKernelConfig, gemm_plain, scheduled_gemm  # noqa: E402

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
    for name, rows in specs.items():
        tot = {"ms": 0.0, "eager_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
        err, bound_kind, library_missing = 0.0, {"bytes": 0.0, "operations": 0.0}, []
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
                f"bound_ms {b_ms:.8f} ({by}) library_ms {lib} max_abs_err {e}"
            )
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
            "max_abs_err": err,
            "bound_by": max(bound_kind, key=bound_kind.get),
        }
    extra_cases(ints, floats)
    return results


def extra_cases(ints, floats) -> None:
    """OS raster, ragged edges and every epilogue of each instantiation."""
    m, k, n = 37, 100, 75  # ragged against every block below
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
        print(f"case {label} {m}x{k}x{n}: max_abs_err {e}")
    torch.cuda.synchronize()
    print(f"cases: {len(cases)} OS/WS x ragged x epilogue cases equal their plain versions")


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


def main() -> int:
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
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f} s")
    usage = sorted({line.split(":", 1)[1].strip() for line in log.splitlines() if "Used" in line})
    print(f"build: ptxas per kernel: {usage}")

    kernels = kernel_phase(dev)
    summary = main_path(dev, card_line)
    launches = dict(gemm.LAUNCHES)  # read just after the main path's run
    for mode, s in summary.items():
        # the device time of one batch-16 forward's 8 kernels (kernel phase)
        # against the wall time of one batch-16 run
        s["kernel_ms_per_run_batch16"] = kernels[s["variant"]]["ms"]
        s["kernel_share_of_run_batch16"] = kernels[s["variant"]]["ms"] / s["run_ms_batch16_p50"]
    for name in ("qgemm_requant", "gemm_int32"):
        check(launches[name] > 0, f"kernel {name} of the main path never launched")

    line = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "eager_ms": r["eager_ms"],
            "shapes": "toycar_mlp batch 16, 8 layers, summed",
        }
        for name, r in kernels.items()
    ]}
    print(json.dumps({"main_path": summary, "card": card_line}))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
