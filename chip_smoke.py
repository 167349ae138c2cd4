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
     weight-stationary schedules of all four models, toycar at bucket 64,
     and every shard plan of phase 15 (the narrower columns of a cols
     split, the rows of a rows split, head-split attention) —
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

  8. measured DSE: ``repro_torch.compile(..., CompileOptions(
     measure_top_k=8))`` on ``cuda`` with a fresh schedule cache, for
     toycar_mlp, qcnn and transformer_block at bucket 16 on gemmini and
     edge_npu (optimized): per node each candidate's modeled cycles, block
     config, raster order, ``time_executor`` time (the device time of one
     executor call, queued behind a device-side wait) and its kernel's
     device time alone, and the winner.  The launch count must rise by (warmup +
     repeats) x candidates x GEMM instances for every node measured (the
     kernel was timed, not its plain version), outputs must be bit-equal
     to the CPU run, and a recompile after ``clear_backend_cache()`` on the
     same cache must do 0 sweeps and 0 measurements;
  9. artifacts: the batched toycar module (``--batch 64``) compiled cold,
     saved, and after ``clear_backend_cache()`` loaded on ``cuda`` with 0
     sweeps, 0 measurements, 0 pass-manager runs and 0 rewrite fires;
     launches per run equal the compiled module's, responses bit-equal to
     per-request CPU runs; then ``serve_zoo`` boots from it through
     ``--artifact``; load time beside the cold compile time, and the
     served req/s, latency p50 / p99 and dispatch count;
 10. pipelined: ``run_many(pipelined=True)`` for every phase-6 module in
     optimized and naive, bit-equal to the sequential ``run_many`` with
     the same launch count, p50 of both; and a conv that a description
     leaves on the host is refused on ``cuda`` at compile time (the port
     runs no plain GEMM on the card);
 11. decode: ``attn_decode`` on gemmini and edge_npu in every mode, as the
     unbatched decode step (``LD`` caches), the batched step at B = 8
     (``BLD``) and the prefill of 32 rows, on ``cuda``: all three outputs
     bit-equal to the CPU run, modeled cycles equal, exactly 6 / 20 / 6
     launches per call (4 projections + 2 attention GEMMs, the batched
     attention replayed per slot), run p50 beside its kernels' device
     time; then ``serve_decode`` (the CLI's function) at ``--batch 8
     --requests 64`` with the default prompt and new-token lengths, every
     request's tokens and vectors equal to the CPU engine's, launches
     equal to 6 x prefills + 20 x decode steps, tok/s beside
     ``sequential_generate``'s (same tokens), one decode step's p50 split
     into its kernels' device time and the rest, and the state round trip
     (uploading and downloading the two staging caches); an out-of-bounds
     ``pos`` raises ``ValueError`` on ``cuda`` before any launch; a decode
     artifact saved and loaded on ``cuda`` gives equal outputs;
 12. the verify gate: ``CompileOptions(verify="each")`` on ``cuda`` for every
     phase-6 module and every phase-11 module, zero diagnostics, the time
     spent in the verifier beside the compile's.
 13. the LM: every host op the port lowers x 8 dtypes on ``cuda`` against
     the CPU run (integers bit-equal, gelu and softmax within
     ``CARD_ULP_BOUND``); then codeqwen1.5-7b at its published config (32
     layers, d_model 4096, 32 heads with QKV bias, d_ff 13440, vocab
     92416, bf16; 8.19 B weights drawn from seed 0 on the card) with every
     GEMM of at least 8 rows routed through ``scheduled_kernels`` on the
     gemmini backend: 225 row-3 launches per prefill and per decode step
     (7 per layer and the head), 0 unrouted, 0 for a decode step at
     batch 4; routed against unrouted prefill logits within
     ``LM_LOGIT_TOL`` of the largest |logit|; ``ServingEngine`` at batch
     8 (16 prompts of 128 tokens, 16 new) routed and not, tok/s and
     launches; all ten archs at their smoke configs (f32; the two
     frontend archs with embeddings drawn with numpy) on ``cuda`` under
     the policy against the CPU (logits within F32_TOL, greedy tokens of
     a prefill and 4 decode steps equal, launches per call as the block
     kinds imply: ``dense_rows``); every (m, k,
     n, dtype, config) those runs launched against its plain version,
     timed beside ``bound`` and ``torch.matmul``; the prefill and decode
     step times at batch 8 with their kernels' share, and the peak of
     ``torch.cuda.max_memory_allocated``;
 14. the traced frontend (run after phase 12, before 13): each zoo model
     exported with this machine's ``torch.export`` and imported
     (``trace_model``, timed), its op list equal to the golden graph's;
     its buckets 1, 4, 16 and 64 built from one export with a symbolic
     batch dim (``ZooModel.trace_batched``), each graph equal to a static
     export at that batch, the two timed side by side;
     then compiled by name on ``cuda`` (through ``ZooModel.trace``) on
     gemmini and edge_npu in every mode: outputs bit-equal to the golden
     graph's module on ``cuda``, modeled cycles and launches per run
     equal, the compile time beside the trace time.  Phases 7 and 11
     check that ``serve_zoo`` and ``serve_decode`` booted from traced
     graphs;
 15. sharded plans on the one card (after 14): every zoo model on gemmini
     and edge_npu at meshes (1, 2) and (1, 4) (optimized; toycar naive
     too) and toycar's buckets at ``--batch 64`` on a (2, 2) mesh, on
     ``cuda``: outputs bit-equal to the devices = 1 module on ``cuda``,
     launches per call equal to the sum over the shards' plans, run p50
     beside devices = 1's; a sharded artifact saved and loaded on
     ``cuda``; ``serve_zoo`` for toycar ``--batch 64 --devices 4`` with
     256 requests, every response bit-equal to a per-request CPU run and
     the launches equal to what the dispatches imply.
 16. the other targets and block kinds (after 15, then after 13): the
     four zoo models in every mode on ``Target("tpu_v5e")`` on ``cuda``,
     bit-equal to the CPU run with the launches the plan implies (their
     kernel cases are in phase 5); then, each in turn with bf16 weights
     from seed 0 on the card after the previous model is freed:
     jamba-v0.1-52b at its published widths cut to 8 layers (one pattern
     group: 7 Mamba, 1 attention, 4 MoE and 4 dense MLPs), deepseek-v2-
     236b cut to 2 layers (the first-dense layer and one MoE layer; MLA)
     and xlstm-125m uncut: each block kind routed against unrouted on one
     input within BLOCK_TOL of its largest |out|; a prefill of 8 x 128
     tokens and a decode step with exactly 49 / 18 / 83 scheduled-kernel
     launches each (the f32 routers among them), the end-to-end logits
     and the router choices compared (printed, not gated); each served
     through ``ServingEngine`` (8 prompts, 16 new tokens), routed and not;
     every (m, k, n, dtype, config) they launched against its plain
     version, timed; prefill and decode-step times split into kernels and
     the rest, and the peak device memory.
 17. training on the card (after 16), unrouted, as the reference trains:
     a train step of a smoke arch under ``scheduled_kernels`` raises
     before any launch (the kernel has no backward); the flash backward
     against autograd through the plain forward at yi-34b's attention
     shapes (B = 2, 56 query heads over 8 KV heads, S = 1024, D = 128,
     chunks of 512), causal, windowed and block-skipped, f32 and bf16:
     dq, dk, dv within F32_TOL (f32) or FLASH_BF16_ULPS bf16 ulps of the
     largest |grad| (bf16), the backward's time (CUDA events around each
     call, the median of FLASH_BWD_TIMED) and peak memory of each; the ten smoke archs (f32, TF32 off)
     one train step each on ``cuda`` against the CPU: loss and grad_norm
     within F32_TOL, every gradient leaf within GRAD_LEAF_TOL of its max
     |grad|, the step's change to each parameter within UPDATE_TOL x lr
     where |grad| is clear of 0 (UPDATE_CLEAR) and one normalized step or
     less elsewhere;
     xlstm-125m uncut through ``launch.train.build_trainer`` (bf16, batch
     8 x 128, 12 steps, a checkpoint every 6 under ``build/chip_smoke/``):
     the loss finite and falling, a resume at step 12 bit-equal, a resume
     at step 6 (the step-12 checkpoint removed) bit-equal to the state
     saved there, with an injected failing step restored and retried and
     its loss at step 11 within RESUME_LOSS_TOL of the first run's; step
     p50, tok/s, save and restore times, checkpoint bytes, peak memory;
     then yi-34b at its published widths cut to 2 layers (bf16, 2.0 B
     weights), 3 steps at batch 2 x 1024: losses finite, the attention
     weights' gradients finite and non-zero, step times and peak memory,
     and a fourth step's forward-and-backward and AdamW timed apart.
 18. the emulated-intrinsic route (run right after phase 6): the 4 zoo
     models x gemmini, edge_npu x 3 modes compiled with ``Target(acc,
     mode, use_pallas=False)`` on ``cuda`` and on the CPU, with the
     descriptions' compute intrinsics wrapped to count their calls: on
     ``cuda`` each ``run``, ``run(use_plan=False)`` and ``run_many`` (both
     ways) bit-equal to the CPU run and to the kernel route's module on
     ``cuda``, the intrinsic calls per run equal to the reference's
     (``EMULATED_CALLS``), one run's plan steps issued under
     ``torch.cuda.set_sync_debug_mode("error")`` (no host copy, no wait;
     feeds uploaded and outputs read outside it), and 0 kernel launches
     in the window; run p50 of the emulated, interpreted and kernel
     routes.  Then a saturating intrinsic on ``cuda`` equal to the CPU and
     off the kernel's answer (its batched probe falls back), an in-place
     intrinsic stable over 5 runs, smaller tile limits refused at compile
     time, and ``integrate`` + ``backend.compile`` warning twice and equal
     to ``repro_torch.compile`` on both routes.
 19. the LM's multi-device layer (after 17), no kernel policy:
     xlstm-125m through ``launch.train.build_trainer`` on the card's
     ``make_elastic_mesh()`` (one NCCL rank, a (1, 1) ("data", "model")
     mesh; every state leaf a DTensor on ``cuda``) and through the
     unsharded trainer (``mesh=(1, 1)``), bf16, 8 x 128, 3 steps, seed
     0, both with deterministic algorithms: losses, final state and
     checkpoint sha256s bit-equal, the sharded checkpoint restored onto
     its placements bit-equal; step p50 of both and peak memory.  Then
     deepseek-v2 at its published widths cut to 2 layers, parameters and
     cache placed by ``param_specs`` / ``cache_specs`` on that mesh, a
     prefill of 4 x 64 tokens and 8 greedy steps through ``lm.prefill`` /
     ``lm.decode_step`` (what the dry run runs): tokens equal to the
     unsharded ``ServingEngine``'s.  Then four dry-run cells (DRYRUN_CELLS)
     on a fake 256- or 512-rank process group with meta tensors, in a
     subprocess that sees no card: each prints OK with its bytes, FLOPs,
     collective bytes, dominant term and wall time.

The launch counts are set to 0 just before each of phases 4, 6-10, the
paths of 11 (each serve call too), the LM's served runs and smoke
archs of 13, the traced modules' runs of 14, the sharded modules'
runs and serve call of 15, the tpu_v5e modules' runs and each
full-width model's routed run of 16, and phases 17, 18 and 19 (which
must launch none), and read just after; the
``launches`` of the kernels line are their sum.  It prints a ``{"kernels": [...]}`` line (the toycar@16
sums of phase 3; the per-case times of phases 5 and 13 go to the report
only, to keep the line short), a summary of the paths, and as its last
line ``{"ok": true, "device": {...}}``.  ``--report PATH`` also
writes everything measured to PATH as JSON.  Schedule caches and
artifacts are written under the checkout's ``build/chip_smoke/``, made
afresh by each run.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch").is_dir():
    sys.exit("chip_smoke.py: src/repro_torch not found; run it from a checkout of the repo")
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.core import ir, measure, pass_manager, pipeline, verify, zoo  # noqa: E402
from repro_torch.core.artifact import graph_fingerprint  # noqa: E402
from repro_torch.core.batching import pick_bucket, plan_chunks  # noqa: E402
from repro_torch.core.configurators import build_backend  # noqa: E402
from repro_torch.core.deprecation import ReproDeprecationWarning  # noqa: E402
from repro_torch.core.descriptions import make_gemmini_description  # noqa: E402
from repro_torch.core.executor import compile_host_op, to_numpy, to_tensor  # noqa: E402
from repro_torch.core.lowering import kernel_config_for  # noqa: E402
from repro_torch.core.scheduler import ExtendedCosaScheduler, ScheduleResult  # noqa: E402
from repro_torch.core.strategy import gemm_instances, workload_from_node  # noqa: E402
from repro_torch.frontend import trace_model  # noqa: E402
from repro_torch.kernels import build, gemm, ops  # noqa: E402
from repro_torch.kernels.gemm import GemmKernelConfig, gemm_plain, scheduled_gemm  # noqa: E402
from repro_torch.kernels.policy import ScheduledKernelPolicy, scheduled_kernels  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.kernels.ref import torch_dtype  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import flash, lm, moe  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.checkpoint import latest_step, restore_checkpoint  # noqa: E402
from repro_torch.launch.mesh import make_elastic_mesh  # noqa: E402
from repro_torch.parallel import policy as act_policy  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from torch.distributed.tensor import DTensor, distribute_tensor  # noqa: E402
from repro_torch.tree import flatten, tree_map  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.train import TrainState, make_train_step  # noqa: E402
from repro_torch.train import step as train_step_mod  # noqa: E402
from repro_torch.train import trainer as trainer_mod  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ServeConfig,
    ServingEngine,
    random_requests,
    sequential_generate,
)

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
#: phase 8: (model, batch) x accelerator, optimized, measured at this K
MEASURED_BUILDS = (("toycar_mlp", 16), ("qcnn", 16), ("transformer_block", 16))
MEASURE_K = 8
#: executor calls per timed candidate: time_executor's warmup + repeats
MEASURE_CALLS = sum(
    inspect.signature(measure.time_executor).parameters[p].default for p in ("warmup", "repeats")
)
#: phase 9: the batched module saved and booted, and its serve call
ARTIFACT_SERVE = ("toycar_mlp", "gemmini:optimized", 64, 256)
PIPELINED_SAMPLES = 10
#: phase 11: the decode forms, (seq, batch) and launches per call, and the
#: serve call (target, --batch, --requests; default prompt and new tokens)
DECODE = zoo.get_decode_model("attn_decode")
DECODE_SLOTS = 8
DECODE_PROMPT = 32
DECODE_FORMS = {"step LD": ((1, None), 6), f"step BLD b{DECODE_SLOTS}": ((1, DECODE_SLOTS), 4 + 2 * DECODE_SLOTS),
                f"prefill {DECODE_PROMPT}": ((DECODE_PROMPT, None), 6)}
DECODE_SERVE = ("gemmini:optimized", DECODE_SLOTS, 64)
#: phase 14: every zoo model traced and compiled by name on these, every
#: mode, and built at these buckets from one symbolic-batch export
FRONTEND_ACCELERATORS = ("gemmini", "edge_npu")
FRONTEND_BUCKETS = (1, 4, 16, 64)
#: phase 15: the unbatched meshes of every zoo model (optimized; toycar
#: naive too), the batched mesh (model, accelerator, mesh, --batch), and
#: the sharded serve call (model, target, --batch, --requests, --devices)
SHARD_MESHES = ((1, 2), (1, 4))
SHARD_BATCHED = ("toycar_mlp", "gemmini", (2, 2), 64)
SHARD_SERVE = ("toycar_mlp", "gemmini:optimized", 64, 256, 4)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return out


def device_ms(fn, launches: int = GRAPH_LAUNCHES) -> float:
    """Device time per call of ``fn``: CUDA events around one replay of a
    CUDA graph holding ``launches`` back-to-back calls (so host overhead
    between launches is not in the number)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


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


def plans(module) -> list:
    """The compiled plans one ``run`` of ``module`` executes: itself, or
    every shard of a ``ShardedModule``."""
    if isinstance(module, repro_torch.ShardedModule):
        return list(module.shards.values())
    return [module]


def plan_launches(module) -> dict[str, int]:
    """Launches of each instantiation that one ``run`` of ``module`` makes
    (a sharded module's: the sum over its shards' plans)."""
    out = {name: 0 for name in gemm.LAUNCHES}
    for plan in plans(module):
        for node, op in plan.ops.items():
            out[gemm.variant(op.executor.kernel_config)] += step_gemms(node)[1]
    return out


def dispatch_launches(module, batch_sizes) -> dict[str, int]:
    """The launches ``serve_zoo`` implies for a batched module: its warmup
    runs every bucket once, then each dispatch splits into ``plan_chunks``
    of the buckets (a single-request chunk takes the per-sample plan where
    there is one)."""
    buckets = module.bucket_sizes()
    expected = {v: 0 for v in gemm.LAUNCHES}
    for n in list(buckets) + list(batch_sizes):
        for size in plan_chunks(buckets, n):
            mod = (module.sample_module if size == 1 and module.sample_module is not None
                   else module.bucket_module(pick_bucket(buckets, size)))
            for v, c in plan_launches(mod).items():
                expected[v] += c
    return expected


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
    return sum(cases[case_key(node, op)]["ms"] * step_gemms(node)[1]
               for plan in plans(module) for node, op in plan.ops.items())


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
        with TraceSpy() as spy:
            gemm.reset_launches()  # this serve call's window starts here
            result = serve.serve_zoo(args)
            window = dict(gemm.LAUNCHES)  # read just after it
        check(spy.calls > 0, f"serve {name}: booted without the tracer")
        windows[f"serve {name}@{target} --batch {batch}"] = window
        module = result.module
        buckets = module.bucket_sizes()
        check(len(result.stats.batch_sizes) == result.stats.batches, f"serve {name}: dispatch record")
        expected = dispatch_launches(module, result.stats.batch_sizes)
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


# -- phases 8-10: the compile service ----------------------------------------


class WorkCounter:
    """Counts, while active, the compile work a restore must not do: DSE
    sweeps, candidate timings, pass-manager runs and rewrite-rule fires."""

    def __enter__(self):
        self.counts = {"sweeps": 0, "measurements": 0, "pass_runs": 0, "rewrite_fires": 0}
        self._saved = (ExtendedCosaScheduler._schedule_uncached, measure.time_executor,
                       pass_manager.PassManager.run, pass_manager.apply_rules)
        sweep, timer, pm_run, apply_rules = self._saved
        counts = self.counts

        def counted_sweep(sched, wl):
            counts["sweeps"] += 1
            return sweep(sched, wl)

        def counted_timer(*a, **kw):
            counts["measurements"] += 1
            return timer(*a, **kw)

        def counted_run(pm, graph, ctx=None):
            counts["pass_runs"] += 1
            return pm_run(pm, graph, ctx)

        def counted_rules(*a, **kw):
            fired = apply_rules(*a, **kw)
            counts["rewrite_fires"] += fired
            return fired

        ExtendedCosaScheduler._schedule_uncached = counted_sweep
        measure.time_executor = counted_timer
        pass_manager.PassManager.run = counted_run
        pass_manager.apply_rules = counted_rules
        return self

    def __exit__(self, *exc):
        (ExtendedCosaScheduler._schedule_uncached, measure.time_executor,
         pass_manager.PassManager.run, pass_manager.apply_rules) = self._saved
        return False


def int8_operands(dev, node, m: int, k: int, n: int, has_bias: bool, rng):
    """Operands of one launch of ``node``'s GEMM, laid out as the wrapper
    hands them to the kernel (the attention ``kᵀ`` as a contiguous copy)."""
    def ints(shape, lo=-100, hi=100, dtype=np.int8):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype)).to(dev)

    attention = bool(node.attrs.get("transpose_b")) and len(node.inputs[1].shape) == 3
    w = ints((n, k)).T.contiguous() if attention else ints((k, n))
    return ints((m, k)), w, (ints((n,), -2000, 2000, np.int32) if has_bias else None)


def run_p50_ms(module, feeds_list, samples: int = PATH_LATENCY_SAMPLES) -> float:
    lat = []
    for i in range(samples):
        t0 = time.perf_counter()
        module.run(feeds_list[i % len(feeds_list)])
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(lat, 50))


def measured_dse_phase(dev: torch.device, card_line: str, work: Path, windows: dict) -> dict:
    """Phase 8: measured DSE times the CUDA kernel, and a warm recompile
    times nothing."""
    cache_dir = work / "measured_cache"
    options = repro_torch.CompileOptions(measure_top_k=MEASURE_K, fresh_backend=True)
    rng = np.random.default_rng(2)
    builds, measured_keys = {}, set()
    gemm.reset_launches()  # the measured compiles' window starts here
    for name, batch in MEASURED_BUILDS:
        for acc in ("gemmini", "edge_npu"):
            label = f"{name}@{acc}:optimized b{batch}"
            target = repro_torch.Target(acc, device=str(dev), cache_dir=cache_dir)
            before = dict(gemm.LAUNCHES)
            t0 = time.perf_counter()
            module = repro_torch.compile(zoo.get_model(name).build(batch=batch), target, options=options)
            compile_s = time.perf_counter() - t0
            # every node whose measured key is new was timed: MEASURE_CALLS
            # executor calls per candidate, each a launch per GEMM instance
            expected, n_timed = {v: 0 for v in gemm.LAUNCHES}, 0
            for node, op in module.ops.items():
                key = (acc, workload_from_node(node).key())
                rec = op.strategy.schedule_result.measured
                check(rec is not None and rec["k"] == len(rec["latencies_s"]), f"{label}: measured record")
                if key in measured_keys:
                    continue
                measured_keys.add(key)
                n_timed += rec["k"]
                expected[gemm.variant(op.executor.kernel_config)] += (
                    MEASURE_CALLS * rec["k"] * step_gemms(node)[1])
            delta = {v: gemm.LAUNCHES[v] - before[v] for v in gemm.LAUNCHES}
            check(module.backend.n_measurements == n_timed,
                  f"{label}: {module.backend.n_measurements} measurements, {n_timed} candidates timed")
            check(delta == expected, f"{label}: launches during the compile {delta}, "
                  f"(warmup + repeats) x candidates x instances = {expected}")
            builds[label] = (name, acc, batch, module, compile_s, delta)
    windows["measured DSE compiles"] = dict(gemm.LAUNCHES)  # read just after them

    summary, kernel_us = {}, {}  # kernel_us: one device time per (shape, layout, config)
    for label, (name, acc, batch, module, compile_s, delta) in builds.items():
        model = zoo.get_model(name)
        feeds = [model.feeds(seed, batch=batch) for seed in range(PATH_FEEDS)]
        cpu = repro_torch.compile(model.build(batch=batch),
                                  repro_torch.Target(acc, device="cpu", cache=False))
        for f in feeds:
            got, want = module.run(f), cpu.run(f)
            check(all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want)),
                  f"{label}: measured-winner output on cuda != cpu output")
        modeled = repro_torch.compile(model.build(batch=batch),
                                      repro_torch.Target(acc, device=str(dev), cache=False))
        p50 = {"modeled": [], "measured": []}
        for _ in range(2):  # alternate: modeled, measured, modeled, measured
            p50["modeled"].append(run_p50_ms(modeled, feeds))
            p50["measured"].append(run_p50_ms(module, feeds))
        nodes, moved = [], 0
        for node, op in module.ops.items():
            sr = op.strategy.schedule_result
            rec = sr.measured
            (m, k, n), instances = step_gemms(node)
            cands = []
            for i, (sched, rep) in enumerate(sr.ranked()[:rec["k"]]):
                strat = module.backend.strategy_gen.generate(
                    node, ScheduleResult(best=sched, report=rep, n_candidates=sr.n_candidates,
                                         n_infeasible=sr.n_infeasible))
                cfg = kernel_config_for(module.desc, module.backend.mapping_gen, node, strat)
                case = (m, k, n, bool(node.attrs.get("transpose_b")), cfg)
                if case not in kernel_us:
                    x, w, b = int8_operands(dev, node, m, k, n, cfg.has_bias, rng)
                    kernel_us[case] = device_ms(lambda: scheduled_gemm(x, w, cfg, b)) * 1e3
                cands.append({
                    "modeled_cycles": rep.total_cycles, "blocks": f"{cfg.block_m}/{cfg.block_k}/{cfg.block_n}",
                    "raster": cfg.dataflow, "time_executor_us": rec["latencies_s"][i] * 1e6,
                    "kernel_us": kernel_us[case],
                })
            moved += rec["winner"] != 0
            nodes.append({"node": f"{node.op} {m}x{k}x{n}" + (f" x{instances}" if instances > 1 else ""),
                          "winner": rec["winner"], "candidates": cands})
            print(f"measured DSE {label} {nodes[-1]['node']}: winner {rec['winner']} "
                  f"({cands[rec['winner']]['blocks']} {cands[rec['winner']]['raster']})")
            for i, c in enumerate(cands):
                print(f"  candidate {i}: modeled {c['modeled_cycles']:.0f} cycles, blocks {c['blocks']} "
                      f"{c['raster']}, time_executor {c['time_executor_us']:.2f} us, kernel alone "
                      f"{c['kernel_us']:.3f} us{'  <- winner' if i == rec['winner'] else ''}")
        summary[label] = {
            "compile_s": compile_s, "launches_during_compile": {v: c for v, c in delta.items() if c},
            "measurements": module.backend.n_measurements, "nodes_moved": moved,
            "run_ms_p50_modeled_winner": p50["modeled"], "run_ms_p50_measured_winner": p50["measured"],
            "nodes": nodes,
        }
        print(f"measured DSE {label}: {module.backend.n_measurements} candidates timed in "
              f"{compile_s:.2f} s, {moved} of {len(nodes)} nodes moved off the modeled winner; "
              f"bit-equal to cpu; run p50 modeled winner {p50['modeled']} ms, measured winner "
              f"{p50['measured']} ms [{card_line}]")

    # a fresh process-level backend over the same cache: zero work
    gemm.reset_launches()
    for label, (name, acc, batch, module, _, _) in builds.items():
        repro_torch.clear_backend_cache()
        warm = repro_torch.compile(
            zoo.get_model(name).build(batch=batch),
            repro_torch.Target(acc, device=str(dev), cache_dir=cache_dir),
            options=repro_torch.CompileOptions(measure_top_k=MEASURE_K),
        )
        check(warm.backend.scheduler.n_solver_calls == 0 and warm.backend.n_measurements == 0,
              f"{label}: warm recompile did {warm.backend.scheduler.n_solver_calls} sweeps, "
              f"{warm.backend.n_measurements} measurements")
        check([op.strategy.schedule for op in warm.ops.values()]
              == [op.strategy.schedule for op in module.ops.values()], f"{label}: warm schedules differ")
        summary[label]["warm_recompile"] = {"sweeps": 0, "measurements": 0}
    check(sum(gemm.LAUNCHES.values()) == 0, f"warm recompiles launched {dict(gemm.LAUNCHES)}")
    print(f"measured DSE: {len(builds)} warm recompiles after clear_backend_cache(): 0 sweeps, "
          f"0 measurements, 0 launches")
    return summary


def artifact_phase(dev: torch.device, card_line: str, work: Path, windows: dict) -> dict:
    """Phase 9: a batched artifact saved, booted with zero work, and served."""
    name, target_spec, batch, requests = ARTIFACT_SERVE
    acc, mode = target_spec.split(":")
    model = zoo.get_model(name)
    path = work / f"{name}_b{batch}.art"
    t0 = time.perf_counter()
    compiled = repro_torch.compile(
        name,
        repro_torch.Target(acc, mode=mode, device=str(dev), batch_size=batch,
                           cache_dir=work / "artifact_cache"),
        options=repro_torch.CompileOptions(fresh_backend=True),
    )
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    repro_torch.save(compiled, path)
    save_s = time.perf_counter() - t0
    repro_torch.clear_backend_cache()
    with WorkCounter() as work_done:
        t0 = time.perf_counter()
        loaded = repro_torch.load(path, device=str(dev))
        load_s = time.perf_counter() - t0
    check(isinstance(loaded, repro_torch.BatchedModule), "artifact: not a batched module")
    check(loaded.bucket_sizes() == compiled.bucket_sizes(), "artifact: buckets differ")
    check(work_done.counts == {"sweeps": 0, "measurements": 0, "pass_runs": 0, "rewrite_fires": 0},
          f"artifact load did compile work: {work_done.counts}")
    subs = {f"b{b}": (loaded.bucket_module(b), compiled.bucket_module(b)) for b in loaded.bucket_sizes()}
    subs["sample"] = (loaded.sample_module, compiled.sample_module)
    gemm.reset_launches()  # the restored module's runs start here
    per_run = {}
    for label, (got, want) in subs.items():
        check(got.backend.scheduler.n_solver_calls == 0 and got.backend.n_measurements == 0,
              f"artifact {label}: restored backend counters")
        feeds = model.feeds(0, batch=None if label == "sample" else int(label[1:]))
        counts = []
        for mod in (got, want):
            before = dict(gemm.LAUNCHES)
            mod.run(feeds)
            counts.append({v: gemm.LAUNCHES[v] - before[v] for v in gemm.LAUNCHES})
        check(counts[0] == counts[1] == plan_launches(want),
              f"artifact {label}: launches per run {counts[0]}, compiled {counts[1]}")
        per_run[label] = {v: c for v, c in counts[0].items() if c}
    traffic = [model.feeds(seed) for seed in range(200, 300)]
    cpu = repro_torch.compile(model.build(), repro_torch.Target(acc, mode=mode, device="cpu", cache=False))
    for i, (feeds, got) in enumerate(zip(traffic, loaded.run_many(traffic))):
        want = cpu.run(feeds)
        check(np.array_equal(got[0], want[0]) and got[0].dtype == want[0].dtype,
              f"artifact: response {i} != per-request cpu result")
    windows["artifact module"] = dict(gemm.LAUNCHES)  # read just after its runs
    print(f"artifact {name} --batch {batch}: cold compile {cold_s * 1e3:.1f} ms, save {save_s * 1e3:.1f} ms, "
          f"load {load_s * 1e3:.1f} ms with {work_done.counts}; launches per run {per_run} equal the "
          f"compiled module's; {len(traffic)} responses bit-equal to per-request cpu runs [{card_line}]")

    args = argparse.Namespace(zoo=name, target=target_spec, batch=batch, requests=requests,
                              deadline_ms=SERVE_DEADLINE_MS, device=str(dev), artifact=str(path))
    repro_torch.clear_backend_cache()
    gemm.reset_launches()  # the artifact-booted serve call's window starts here
    with WorkCounter() as serve_work:
        result = serve.serve_zoo(args)
    windows[f"serve {name}@{target_spec} --artifact"] = dict(gemm.LAUNCHES)  # read just after it
    check(result.boot_how == "loaded artifact", "serve --artifact compiled")
    check(serve_work.counts == {"sweeps": 0, "measurements": 0, "pass_runs": 0, "rewrite_fires": 0},
          f"serve --artifact did compile work: {serve_work.counts}")
    for i, (feeds, got) in enumerate(zip(result.traffic, result.outputs)):
        want = cpu.run(feeds)
        check(np.array_equal(got[0], want[0]), f"serve --artifact: response {i} != per-request cpu result")
    lat_us = np.asarray(result.latencies_s) * 1e6
    p50, p99 = float(np.percentile(lat_us, 50)), float(np.percentile(lat_us, 99))
    print(f"serve {name} --artifact: boot {result.boot_s * 1e3:.1f} ms (cold compile {cold_s * 1e3:.1f} ms); "
          f"{requests} responses bit-equal to per-request cpu runs, "
          f"{requests / result.wall_s:.1f} req/s, latency p50 {p50:.1f} us / p99 {p99:.1f} us, "
          f"{result.stats.batches} dispatches (mean batch {result.stats.mean_batch():.1f}) [{card_line}]")
    return {"model": name, "batch": batch, "buckets": list(loaded.bucket_sizes()), "cold_compile_ms": cold_s * 1e3,
            "save_ms": save_s * 1e3, "load_ms": load_s * 1e3, "load_work": work_done.counts,
            "launches_per_run": per_run, "serve_boot_ms": result.boot_s * 1e3,
            "serve_req_per_s": requests / result.wall_s, "serve_p50_us": p50, "serve_p99_us": p99,
            "serve_dispatches": result.stats.batches}


def pipelined_phase(compiled: dict, card_line: str, windows: dict) -> dict:
    """Phase 10: every phase-6 module in optimized and naive, pipelined
    against sequential on the card."""
    summary = {}
    gemm.reset_launches()  # the pipelined runs' window starts here
    for (name, acc, mode, batch), mods in compiled.items():
        if mode not in ("optimized", "naive"):
            continue
        module = mods["cuda"]
        label = path_label(name, acc, mode, batch)
        feeds = [zoo.get_model(name).feeds(seed, batch=batch) for seed in range(PATH_FEEDS)]
        counts, outs = {}, {}
        for how in ("sequential", "pipelined"):
            before = dict(gemm.LAUNCHES)
            outs[how] = module.run_many(feeds, pipelined=how == "pipelined")
            counts[how] = {v: gemm.LAUNCHES[v] - before[v] for v in gemm.LAUNCHES}
        check(counts["pipelined"] == counts["sequential"],
              f"{label}: pipelined launches {counts['pipelined']} != sequential {counts['sequential']}")
        for a, b in zip(outs["pipelined"], outs["sequential"]):
            check(all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(a, b)),
                  f"{label}: pipelined output != sequential output")
        ms = {"sequential": [], "pipelined": []}
        for _ in range(PIPELINED_SAMPLES):
            for how in ("sequential", "pipelined"):
                t0 = time.perf_counter()
                module.run_many(feeds, pipelined=how == "pipelined")
                ms[how].append((time.perf_counter() - t0) * 1e3 / len(feeds))
        lanes = module.finalize().lane_sizes()
        summary[label] = {"lanes": lanes, **{f"{h}_ms_per_run_p50": float(np.percentile(v, 50))
                                             for h, v in ms.items()}}
        print(f"pipelined {label}: lanes {lanes}; bit-equal to sequential, launches equal "
              f"{ {v: c for v, c in counts['sequential'].items() if c} }; per run p50 sequential "
              f"{summary[label]['sequential_ms_per_run_p50']:.4f} ms, pipelined "
              f"{summary[label]['pipelined_ms_per_run_p50']:.4f} ms")
    windows["pipelined"] = dict(gemm.LAUNCHES)  # read just after the pipelined runs
    print(f"pipelined: {len(summary)} modules bit-equal to sequential on cuda [{card_line}]")
    return summary


def host_gemm_refused(dev: torch.device) -> None:
    """A conv that the description leaves on the host is refused on the
    card when the plan is built: the port runs no plain GEMM there."""
    desc = repro_torch.REGISTRY.get("gemmini")
    for tag, cc in list(desc.core_computes.items()):
        if cc.op == "conv2d":
            del desc.core_computes[tag]
    try:
        repro_torch.compile("qcnn", repro_torch.Target(desc, device=str(dev), cache=False))
    except NotImplementedError as e:
        check("conv2d" in str(e) and "no plain GEMM" in str(e), f"host conv refused as {e}")
        print(f"host GEMM on cuda: refused at compile time: {e}")
        return
    check(False, "a conv left on the host compiled for cuda")


# -- phases 11-12: the decode path and the verify gate ------------------------


def decode_label(acc: str, mode: str, form: str) -> str:
    return f"attn_decode@{acc}:{mode} {form}"


def decode_feeds(seq: int, batch, seed: int) -> dict[str, np.ndarray]:
    if seq == 1:
        return DECODE.feeds(seed=seed, batch=batch)
    rng = np.random.default_rng(seed)
    return {**DECODE.example_inputs(seq=seq),
            "x": rng.integers(-128, 128, (seq, DECODE.d_model)).astype(np.int8),
            "mask": zoo.prefill_mask(seq, DECODE.max_len)}


def compile_decode_paths(dev: torch.device) -> dict[tuple, dict]:
    """Every module of phase 11, on the card and on the CPU, keyed by
    (accelerator, mode, form)."""
    out = {}
    for acc in DECODE.accelerators:
        for mode in MODES:
            for form, ((seq, batch), _) in DECODE_FORMS.items():
                out[acc, mode, form] = {
                    where: repro_torch.compile(
                        DECODE.build(seq=seq, batch=batch),
                        repro_torch.Target(acc, mode=mode, device=str(dev) if where == "cuda" else "cpu"),
                    )
                    for where in ("cuda", "cpu")
                }
    return out


def decode_modules_phase(compiled: dict, cases: dict, card_line: str) -> dict:
    """Phase 11, modules: each decode form on the card, held to the CPU run."""
    summary = {}
    for (acc, mode, form), mods in compiled.items():
        (seq, batch), launches = DECODE_FORMS[form]
        got_m, want_m = mods["cuda"], mods["cpu"]
        label = decode_label(acc, mode, form)
        check(got_m.modeled_cycles() == want_m.modeled_cycles(), f"{label}: modeled cycles differ")
        per_run = plan_launches(got_m)
        check(sum(per_run.values()) == launches, f"{label}: the plan implies {per_run}, not {launches}")
        feeds = [decode_feeds(seq, batch, seed) for seed in range(PATH_FEEDS)]
        want = [want_m.run(f) for f in feeds]
        before = dict(gemm.LAUNCHES)
        got = [got_m.run(f) for f in feeds]
        for v, count in per_run.items():
            check(gemm.LAUNCHES[v] - before[v] == count * len(feeds),
                  f"{label}: {gemm.LAUNCHES[v] - before[v]} {v} launches for {len(feeds)} calls, "
                  f"the plan implies {count} per call")
        for g, w in zip(got, want):
            check(len(g) == len(w) == 3, f"{label}: outputs")
            for name, a, b in zip(("out", "k_cache", "v_cache"), g, w):
                check(a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b),
                      f"{label}: {name} on cuda != cpu")
        summary[label] = {
            "launches_per_call": {v: c for v, c in per_run.items() if c},
            "modeled_cycles": got_m.modeled_cycles()["total"],
            "run_ms_p50": run_p50_ms(got_m, feeds),
            "kernel_ms_per_run": kernel_ms_per_run(got_m, cases),
        }
        print(f"decode {label}: 3 outputs bit-equal to cpu; launches per call "
              f"{summary[label]['launches_per_call']}; run p50 {summary[label]['run_ms_p50']:.4f} ms "
              f"(kernels {summary[label]['kernel_ms_per_run']:.4f} ms device)")
    print(f"decode: {len(summary)} modules bit-equal to cpu on cuda [{card_line}]")
    return summary


def step_split(module, feeds_list, samples: int) -> dict:
    """Where one plan run's host time goes, p50 over ``samples`` runs of
    the plan's own steps: feed validation, the feed upload, each op's
    calls (host time to issue; an accelerator step is its kernel wrapper,
    which returns before the kernel ends), and the output download (which
    waits for the device)."""
    plan = module.finalize()
    parts: dict[str, list[float]] = {}
    for i in range(samples):
        feeds = feeds_list[i % len(feeds_list)]
        arena = plan.new_arena()
        took: dict[str, float] = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        module._check_feeds(feeds)
        t1 = time.perf_counter()
        for name, slot in plan.input_slots:
            arena[slot] = to_tensor(feeds[name], plan.device)
        took["validate feeds"], took["upload feeds"] = t1 - t0, time.perf_counter() - t1
        for s in plan.steps:
            key = f"{s.lane}: {s.op}"
            t = time.perf_counter()
            arena[s.slot] = s.fn(*[arena[a] for a in s.arg_slots])
            took[key] = took.get(key, 0.0) + time.perf_counter() - t
        t = time.perf_counter()
        for o in plan.output_slots:
            to_numpy(arena[o])
        took["download outputs"] = time.perf_counter() - t
        for k, v in took.items():
            parts.setdefault(k, []).append(v * 1e3)
    return {k: float(np.percentile(v, 50)) for k, v in sorted(parts.items(), key=lambda kv: -np.median(kv[1]))}


def decode_serve_phase(dev: torch.device, cases: dict, card_line: str, windows: dict) -> dict:
    """Phase 11, serving: ``serve_decode`` on the card against the CPU
    engine, then ``sequential_generate`` and the decode step's split."""
    target, slots, requests = DECODE_SERVE
    parser = serve.build_parser()
    args = parser.parse_args(["--zoo", DECODE.name, "--target", target, "--batch", str(slots),
                              "--requests", str(requests), "--device", str(dev)])
    check((args.prompt_len, args.new_tokens) == (32, 16), "serve defaults changed")
    with TraceSpy() as spy:
        gemm.reset_launches()  # the decode serve call's window starts here
        result = serve.serve_decode(args)
        window = dict(gemm.LAUNCHES)  # read just after it
    check(spy.calls == 2, f"serve {DECODE.name}: the engine compiled {spy.calls} traced graphs, not 2")
    windows[f"serve {DECODE.name}@{target} --batch {slots}"] = window
    report, engine = result.report, result.engine
    expected = {v: 0 for v in gemm.LAUNCHES}
    for mod, calls in ((engine.prefill_mod, report.prefills), (engine.decode_mod, report.decode_steps)):
        for v, c in plan_launches(mod).items():
            expected[v] += c * calls
    check(window == expected, f"serve {DECODE.name}: launches {window}, "
          f"{report.prefills} prefills and {report.decode_steps} steps imply {expected}")
    cpu_args = parser.parse_args(["--zoo", DECODE.name, "--target", target, "--batch", str(slots),
                                  "--requests", str(requests), "--device", "cpu"])
    cpu = serve.serve_decode(cpu_args).report
    check(len(report.requests) == requests and report.total_new_tokens == requests * args.new_tokens,
          f"serve {DECODE.name}: {report.total_new_tokens} tokens")
    for got, want in zip(report.requests, cpu.requests):
        check(got.done and got.tokens == want.tokens
              and all(np.array_equal(a, b) for a, b in zip(got.vectors, want.vectors)),
              f"serve {DECODE.name}: request {got.rid} differs from the cpu engine")
    check((report.decode_steps, report.prefills) == (cpu.decode_steps, cpu.prefills), "engine schedule differs")

    acc, mode = target.split(":")
    cfg = engine.cfg
    gemm.reset_launches()  # the sequential baseline's window starts here
    seq_reqs = random_requests(DECODE, requests, cfg.prompt_len, seed=0)
    seq = sequential_generate(DECODE, repro_torch.Target(acc, mode=mode, device=str(dev)), seq_reqs, cfg)
    windows[f"sequential {DECODE.name}@{target}"] = dict(gemm.LAUNCHES)
    for got, want in zip(seq_reqs, report.requests):
        check(got.tokens == want.tokens, f"sequential {DECODE.name}: request {got.rid} tokens differ")

    # one decode step of the engine's module, and what moves the state
    step_feeds = [DECODE.feeds(seed=s, batch=slots) for s in range(PATH_FEEDS)]
    step_p50 = run_p50_ms(engine.decode_mod, step_feeds, samples=LATENCY_SAMPLES)
    kernel_ms = kernel_ms_per_run(engine.decode_mod, cases)
    split = step_split(engine.decode_mod, step_feeds, LATENCY_SAMPLES)
    state = {k: step_feeds[0][k] for k in ("k_cache", "v_cache")}
    on_card = {k: to_tensor(v, dev) for k, v in state.items()}
    trips = []
    for _ in range(LATENCY_SAMPLES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        up = [to_tensor(v, dev) for v in state.values()]
        down = [to_numpy(t) for t in on_card.values()]
        trips.append((time.perf_counter() - t0) * 1e3)
    check(all(np.array_equal(to_numpy(u), state[k]) for u, k in zip(up, state)) and len(down) == 2,
          "state round trip")
    out = {
        "target": target, "slots": slots, "requests": requests, "prompt_len": cfg.prompt_len,
        "new_tokens": cfg.max_new_tokens, "boot_ms": result.boot_s * 1e3,
        "tokens": report.total_new_tokens, "wall_s": report.wall_s, "tok_per_s": report.tokens_per_s,
        "decode_steps": report.decode_steps, "prefills": report.prefills,
        "peak_occupancy": report.peak_occupancy, "launches": {v: c for v, c in window.items() if c},
        "sequential_tok_per_s": seq.tokens_per_s, "sequential_wall_s": seq.wall_s,
        "sequential_decode_steps": seq.decode_steps,
        "step_ms_p50": step_p50, "step_kernel_ms": kernel_ms, "step_rest_ms": step_p50 - kernel_ms,
        "state_round_trip_ms_p50": float(np.percentile(trips, 50)),
        "step_host_split_ms_p50": split,
    }
    print(f"serve {DECODE.name} on {target} --batch {slots} --requests {requests}: every request's "
          f"tokens and vectors equal the cpu engine's; {report.total_new_tokens} tokens in "
          f"{report.wall_s:.3f} s ({report.tokens_per_s:.1f} tok/s), {report.decode_steps} decode steps, "
          f"{report.prefills} prefills, peak pool occupancy {report.peak_occupancy:.3f}; launches "
          f"{out['launches']} [{card_line}]")
    print(f"sequential_generate {DECODE.name}: {seq.tokens_per_s:.1f} tok/s ({seq.decode_steps} batch-1 steps, "
          f"same tokens) against continuous {report.tokens_per_s:.1f} tok/s")
    print(f"decode step b{slots}: run p50 {step_p50:.4f} ms = kernels {kernel_ms:.4f} ms device + rest "
          f"{step_p50 - kernel_ms:.4f} ms; state round trip (2 caches up, 2 down) p50 "
          f"{out['state_round_trip_ms_p50']:.4f} ms")
    print(f"decode step b{slots} host split, p50 ms over {LATENCY_SAMPLES} runs: "
          + "; ".join(f"{k} {v:.4f}" for k, v in split.items()))
    return out


def decode_bounds_and_artifact(dev: torch.device, work: Path, card_line: str) -> dict:
    """Phase 11: an out-of-bounds append raises on the card before any
    launch; a decode artifact round-trips on the card."""
    module = repro_torch.compile(DECODE.build(batch=DECODE_SLOTS), repro_torch.Target("gemmini", device=str(dev)))
    feeds = DECODE.feeds(seed=4, batch=DECODE_SLOTS)
    bad = {**feeds, "pos": feeds["pos"].copy()}
    bad["pos"][3] = DECODE.max_len
    before = dict(gemm.LAUNCHES)
    try:
        module.run(bad)
    except ValueError as e:
        check("kv_cache_append out of bounds" in str(e) and "(slot 3)" in str(e), f"bounds error: {e}")
        message = str(e)
    else:
        check(False, "an out-of-bounds pos ran on cuda")
    check(gemm.LAUNCHES == before, "the out-of-bounds call launched kernels")
    path = work / "attn_decode_b8.art"
    repro_torch.save(module, path)
    loaded = repro_torch.load(path, device=str(dev))
    check(loaded.graph.cache_spec == module.graph.cache_spec, "decode artifact: cache_spec")
    for seed in range(PATH_FEEDS):
        f = DECODE.feeds(seed=seed, batch=DECODE_SLOTS)
        check(all(np.array_equal(a, b) for a, b in zip(loaded.run(f), module.run(f))),
              "decode artifact: outputs differ from the compiled module's")
    print(f"decode bounds on cuda: {message}; decode artifact saved and loaded on cuda, outputs equal "
          f"[{card_line}]")
    return {"bounds_error": message, "artifact": "equal"}


def verify_gate_phase(dev: torch.device, card_line: str) -> dict:
    """Phase 12: ``verify="each"`` on every phase-6 and phase-11 module on
    the card, zero diagnostics, and the verifier's share of the compile."""
    spent = {"ms": 0.0}
    graph_fn, plan_fn = verify.verify_graph, pipeline.verify_plan

    def timed(fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent["ms"] += (time.perf_counter() - t0) * 1e3
        return wrapper

    builds = [(f"{path_label(n, acc, mode, b)}", acc, mode, lambda n=n, b=b: zoo.get_model(n).build(batch=b))
              for n, acc in NEW_PATHS for mode in MODES for b in (None, MAIN_BUCKET)]
    builds += [(decode_label(acc, mode, form), acc, mode,
                lambda sb=sb: DECODE.build(seq=sb[0], batch=sb[1]))
               for acc in DECODE.accelerators for mode in MODES for form, (sb, _) in DECODE_FORMS.items()]
    compile_ms, modules = 0.0, []
    verify.verify_graph, pipeline.verify_plan = timed(graph_fn), timed(plan_fn)
    try:
        for label, acc, mode, build_graph in builds:
            t0 = time.perf_counter()
            modules.append((label, repro_torch.compile(
                build_graph(), repro_torch.Target(acc, mode=mode, device=str(dev)),
                options=repro_torch.CompileOptions(verify="each"))))
            compile_ms += (time.perf_counter() - t0) * 1e3
    finally:
        verify.verify_graph, pipeline.verify_plan = graph_fn, plan_fn
    gate_ms = spent["ms"]
    for label, module in modules:
        diags = verify.collect(module)
        check(diags == [], f"verify gate {label}: {[str(d) for d in diags]}")
    print(f"verify gate: {len(builds)} modules compiled on cuda with verify='each', 0 diagnostics; "
          f"{gate_ms:.1f} ms in the verifier of {compile_ms:.1f} ms of compiles "
          f"({gate_ms / compile_ms:.1%}) [{card_line}]")
    return {"modules": len(builds), "diagnostics": 0, "gate_ms": gate_ms, "compile_ms": compile_ms}


# -- phases 14-15: the traced frontend and sharded plans ------------------------


class TraceSpy:
    """Counts, while active, the calls of ``ZooModel.trace``,
    ``ZooModel.trace_batched`` and ``DecodeModel.trace``: the compiles
    that went through the frontend."""

    def __enter__(self):
        self.calls = 0
        self._saved = (zoo.ZooModel.trace, zoo.ZooModel.trace_batched, zoo.DecodeModel.trace)
        spy = self

        def counted(fn):
            def wrapper(*a, **kw):
                spy.calls += 1
                return fn(*a, **kw)
            return wrapper

        zoo.ZooModel.trace, zoo.ZooModel.trace_batched, zoo.DecodeModel.trace = (
            counted(f) for f in self._saved)
        return self

    def __exit__(self, *exc):
        zoo.ZooModel.trace, zoo.ZooModel.trace_batched, zoo.DecodeModel.trace = self._saved
        return False


def frontend_label(name: str, acc: str, mode: str) -> str:
    return f"traced {name}@{acc}:{mode}"


def frontend_phase(dev: torch.device, card_line: str, windows: dict) -> dict:
    """Phase 14: every zoo model exported on this machine's torch and
    imported (``trace_model``, timed alone); its buckets built from one
    symbolic-batch export, each equal to a static export at that batch,
    both timed; then compiled by name on the card in every mode on gemmini
    and edge_npu: outputs bit-equal to the golden graph's module on the
    card, modeled cycles and launches per run equal."""
    trace_ms, bucket_ms, compiled = {}, {}, {}
    for name in sorted(zoo.ZOO):
        model = zoo.get_model(name)
        t0 = time.perf_counter()
        graph = trace_model(model.torch_fn, model.example_inputs(), model.params(), name=name)
        trace_ms[name] = (time.perf_counter() - t0) * 1e3
        check([n.op for n in graph.toposort()] == [n.op for n in model.build().toposort()],
              f"traced {name}: op list differs from the golden graph")
        t0 = time.perf_counter()
        sample, build_bucket = model.trace_batched()
        symbolic = {b: build_bucket(b) for b in FRONTEND_BUCKETS}
        t1 = time.perf_counter()
        static = {None: model.trace(), **{b: model.trace(batch=b) for b in FRONTEND_BUCKETS}}
        bucket_ms[name] = {"symbolic": (t1 - t0) * 1e3, "static": (time.perf_counter() - t1) * 1e3}
        check(graph_fingerprint(sample) == graph_fingerprint(graph),
              f"traced {name}: the per-sample graph of trace_batched differs from trace()")
        for b in FRONTEND_BUCKETS:
            check(graph_fingerprint(symbolic[b]) == graph_fingerprint(static[b]),
                  f"traced {name}: bucket {b} from the symbolic-batch export differs from its static export")
        for acc in FRONTEND_ACCELERATORS:
            if acc not in model.accelerators:
                continue
            for mode in MODES:
                target = repro_torch.Target(acc, mode=mode, device=str(dev))
                with TraceSpy() as spy:
                    t0 = time.perf_counter()
                    traced = repro_torch.compile(name, target)
                    compile_ms = (time.perf_counter() - t0) * 1e3
                check(spy.calls == 1, f"{frontend_label(name, acc, mode)}: compiled without the tracer")
                t0 = time.perf_counter()
                golden = repro_torch.compile(model.build(), target)
                golden_ms = (time.perf_counter() - t0) * 1e3
                compiled[name, acc, mode] = (traced, golden, compile_ms, golden_ms)
    feeds = {name: [zoo.get_model(name).feeds(seed) for seed in range(PATH_FEEDS)] for name in zoo.ZOO}
    want = {key: [c[1].run(f) for f in feeds[key[0]]] for key, c in compiled.items()}
    summary = {}
    gemm.reset_launches()  # the traced modules' runs start here
    for (name, acc, mode), (traced, golden, compile_ms, golden_ms) in compiled.items():
        label = frontend_label(name, acc, mode)
        check(traced.modeled_cycles() == golden.modeled_cycles(), f"{label}: modeled cycles differ")
        per_run = plan_launches(traced)
        check(per_run == plan_launches(golden), f"{label}: launches per run {per_run} != golden")
        before = dict(gemm.LAUNCHES)
        got = [traced.run(f) for f in feeds[name]]
        for v, count in per_run.items():
            check(gemm.LAUNCHES[v] - before[v] == count * len(got),
                  f"{label}: {gemm.LAUNCHES[v] - before[v]} {v} launches for {len(got)} runs")
        for g, w in zip(got, want[name, acc, mode]):
            check(len(g) == len(w) and all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(g, w)),
                  f"{label}: traced output on cuda != golden output on cuda")
        summary[label] = {"compile_ms": compile_ms, "golden_compile_ms": golden_ms,
                          "launches_per_run": {v: c for v, c in per_run.items() if c},
                          "modeled_cycles": traced.modeled_cycles()["total"]}
    windows["frontend"] = dict(gemm.LAUNCHES)  # read just after them
    for name, ms in trace_ms.items():
        traced_ms = [c[2] for (n, _, _), c in compiled.items() if n == name]
        golden_ms = [c[3] for (n, _, _), c in compiled.items() if n == name]
        print(f"frontend {name}: torch.export + import {ms:.1f} ms; compile by name on {dev.type} "
              f"{min(traced_ms):.1f}-{max(traced_ms):.1f} ms (the golden graph's compile "
              f"{min(golden_ms):.1f}-{max(golden_ms):.1f} ms) over {len(traced_ms)} targets; "
              f"per-sample graph + buckets {list(FRONTEND_BUCKETS)}: "
              f"{bucket_ms[name]['symbolic']:.1f} ms from one symbolic-batch export, "
              f"{bucket_ms[name]['static']:.1f} ms from one static export each")
    print(f"frontend: {len(summary)} traced modules on {dev.type} bit-equal to the golden graphs, modeled cycles "
          f"and launches per run equal; torch {torch.__version__} [{card_line}]")
    return {"torch": torch.__version__, "trace_ms": trace_ms, "bucket_graphs_ms": bucket_ms,
            "modules": summary}


def shard_label(name: str, acc: str, mode: str, mesh, batch=None) -> str:
    return f"sharded {name}@{acc}:{mode} mesh {mesh[0]}x{mesh[1]}" + (f" --batch {batch}" if batch else "")


def compile_sharded_paths(dev: torch.device) -> dict[str, tuple]:
    """Every sharded module of phase 15 and its devices = 1 counterpart,
    compiled by name on the card, keyed by label."""
    out = {}
    for name in sorted(zoo.ZOO):
        model = zoo.get_model(name)
        for acc in FRONTEND_ACCELERATORS:
            if acc not in model.accelerators:
                continue
            for mode in ("optimized", "naive") if name == "toycar_mlp" else ("optimized",):
                single = repro_torch.compile(name, repro_torch.Target(acc, mode=mode, device=str(dev)))
                for mesh in SHARD_MESHES:
                    sharded = repro_torch.compile(
                        name, repro_torch.Target(acc, mode=mode, device=str(dev), mesh=mesh))
                    out[shard_label(name, acc, mode, mesh)] = (sharded, single, name, None)
    name, acc, mesh, batch = SHARD_BATCHED
    t = dict(mode="optimized", device=str(dev), batch_size=batch)
    single = repro_torch.compile(name, repro_torch.Target(acc, **t))
    sharded = repro_torch.compile(name, repro_torch.Target(acc, mesh=mesh, **t))
    for b in sharded.bucket_sizes():
        out[shard_label(name, acc, "optimized", sharded.bucket_module(b).mesh, b)] = (
            sharded.bucket_module(b), single.bucket_module(b), name, b)
    return out


def sharded_shards(modules) -> dict[str, object]:
    """Every shard plan of ``modules`` (label -> ShardedModule), for the
    kernel cases of phase 5 (only their configs are read)."""
    return {f"{label} shard {key}": shard for label, sharded in modules.items()
            for key, shard in sharded.shards.items()}


def sharded_serve_modules() -> dict[str, object]:
    """The sharded bucket modules phase 15's serve call builds, compiled
    for the CPU (only their configs are read)."""
    name, target, batch, _, devices = SHARD_SERVE
    acc, mode = target.split(":")
    module = repro_torch.compile(
        name, repro_torch.Target(acc, mode=mode, device="cpu", batch_size=batch, devices=devices))
    return {f"serve {name}@{target} --devices {devices} b{b}": module.bucket_module(b)
            for b in module.bucket_sizes()}


def sharded_phase(dev: torch.device, compiled: dict, cases: dict, card_line: str, work: Path,
                  windows: dict) -> dict:
    """Phase 15: every sharded module on the card against its devices = 1
    module on the card, launches per call equal to the sum over its shards'
    plans; run p50 beside devices = 1; a sharded artifact round trip on the
    card; ``serve_zoo`` with ``--devices``, every response held to a
    per-request CPU run."""
    feeds = {}
    for label, (sharded, single, name, batch) in compiled.items():
        feeds[label] = [zoo.get_model(name).feeds(seed, batch=batch) for seed in range(PATH_FEEDS)]
    want = {label: [single.run(f) for f in feeds[label]] for label, (_, single, _, _) in compiled.items()}
    summary = {}
    gemm.reset_launches()  # the sharded modules' runs start here
    for label, (sharded, single, name, batch) in compiled.items():
        per_call = plan_launches(sharded)
        before = dict(gemm.LAUNCHES)
        got = [sharded.run(f) for f in feeds[label]]
        for v, count in per_call.items():
            check(gemm.LAUNCHES[v] - before[v] == count * len(got),
                  f"{label}: {gemm.LAUNCHES[v] - before[v]} {v} launches for {len(got)} calls, "
                  f"its shards' plans imply {count} per call")
        for g, w in zip(got, want[label]):
            check(len(g) == len(w) and all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(g, w)),
                  f"{label}: sharded output on cuda != devices=1 output on cuda")
        summary[label] = {"mesh": list(sharded.mesh), "launches_per_call": {v: c for v, c in per_call.items() if c},
                          "modeled_cycles": sharded.modeled_cycles(), "single_modeled_cycles": single.modeled_cycles(),
                          "kernel_ms_per_call": kernel_ms_per_run(sharded, cases)}
    windows["sharded modules"] = dict(gemm.LAUNCHES)  # read just after them
    for label, (sharded, single, name, batch) in compiled.items():
        summary[label]["run_ms_p50"] = run_p50_ms(sharded, feeds[label])
        summary[label]["single_run_ms_p50"] = run_p50_ms(single, feeds[label])
        s = summary[label]
        print(f"{label}: bit-equal to devices=1 on cuda; launches per call {s['launches_per_call']} "
              f"(kernels {s['kernel_ms_per_call']:.4f} ms device); run p50 {s['run_ms_p50']:.4f} ms against "
              f"{s['single_run_ms_p50']:.4f} ms at devices=1; modeled total {s['modeled_cycles']['total']} "
              f"(comm {s['modeled_cycles']['comm']}) against {s['single_modeled_cycles']['total']}")

    # the p50 ladder of one model: devices 1, 2, 4
    name, acc = "toycar_mlp", "gemmini"
    ladder = {1: summary[shard_label(name, acc, "optimized", (1, 2))]["single_run_ms_p50"]}
    for mesh in SHARD_MESHES:
        ladder[mesh[0] * mesh[1]] = summary[shard_label(name, acc, "optimized", mesh)]["run_ms_p50"]
    print(f"sharded {name}@{acc}:optimized run p50 by devices: "
          + ", ".join(f"{d}: {ms:.4f} ms" for d, ms in ladder.items()) + f" [{card_line}]")

    # an artifact round trip on the card
    label = shard_label(name, acc, "optimized", SHARD_MESHES[-1])
    sharded = compiled[label][0]
    path = work / "toycar_sharded.art"
    repro_torch.save(sharded, path)
    loaded = repro_torch.load(path, device=str(dev))
    check(isinstance(loaded, repro_torch.ShardedModule) and loaded.mesh == sharded.mesh, "sharded artifact: mesh")
    check(plan_launches(loaded) == plan_launches(sharded), "sharded artifact: launches per call")
    for f, w in zip(feeds[label], want[label]):
        check(all(np.array_equal(a, b) for a, b in zip(loaded.run(f), w)), "sharded artifact: outputs differ")
    print(f"sharded artifact {label}: saved and loaded on cuda, outputs equal, launches per call "
          f"{plan_launches(loaded)}")

    # serve --devices
    name, target, batch, requests, devices = SHARD_SERVE
    args = argparse.Namespace(zoo=name, target=target, batch=batch, requests=requests,
                              deadline_ms=SERVE_DEADLINE_MS, device=str(dev), devices=devices)
    with TraceSpy() as spy:
        gemm.reset_launches()  # the sharded serve call's window starts here
        result = serve.serve_zoo(args)
        window = dict(gemm.LAUNCHES)  # read just after it
    check(spy.calls > 0, f"serve {name} --devices {devices}: booted without the tracer")
    windows[f"serve {name}@{target} --batch {batch} --devices {devices}"] = window
    check(all(isinstance(result.module.bucket_module(b), repro_torch.ShardedModule)
              for b in result.module.bucket_sizes()), f"serve {name} --devices {devices}: unsharded buckets")
    expected = dispatch_launches(result.module, result.stats.batch_sizes)
    check(window == expected, f"serve {name} --devices {devices}: launches {window}, the dispatches imply {expected}")
    acc, mode = target.split(":")
    cpu = repro_torch.compile(zoo.get_model(name).build(), repro_torch.Target(acc, mode=mode, device="cpu"))
    check(len(result.outputs) == requests, f"serve {name} --devices {devices}: {len(result.outputs)} responses")
    for i, (f, got) in enumerate(zip(result.traffic, result.outputs)):
        w = cpu.run(f)
        check(len(got) == 1 and got[0].dtype == w[0].dtype and np.array_equal(got[0], w[0]),
              f"serve {name} --devices {devices}: response {i} != per-request cpu result")
    lat_ms = np.asarray(result.latencies_s) * 1e3
    served = {"target": target, "batch": batch, "devices": devices, "requests": requests,
              "mesh": list(result.module.bucket_module(batch).mesh), "boot_ms": result.boot_s * 1e3,
              "req_per_s": requests / result.wall_s, "latency_ms_p50": float(np.percentile(lat_ms, 50)),
              "latency_ms_p99": float(np.percentile(lat_ms, 99)), "dispatches": result.stats.batches,
              "launches": {v: c for v, c in window.items() if c}}
    print(f"serve {name} on {target} --batch {batch} --devices {devices}: {requests} responses bit-equal to "
          f"per-request cpu runs; {served['req_per_s']:.1f} req/s, p50 {served['latency_ms_p50']:.4f} ms, "
          f"p99 {served['latency_ms_p99']:.4f} ms, {result.stats.batches} dispatches; boot "
          f"{served['boot_ms']:.1f} ms; launches {served['launches']} [{card_line}]")
    return {"modules": summary, "p50_by_devices": ladder, "serve": served}


# -- phase 13: the LM substrate on the card -----------------------------------

#: host ops of the port's plan, each dtype, on the card against the CPU;
#: float gelu and softmax within these ulp of the output dtype (gelu's at
#: 0.5 |x|): twice the CPU tests' bound against the reference, for the
#: card's own tanh/exp and reduction order
HOST_OP_DTYPES = ("int8", "int16", "int32", "int64", "uint8", "float16", "float32", "float64")
CARD_ULP_BOUND = {"gelu": 2, "softmax": 4}


def host_op_case(op: str, dtype: str):
    """(node, feeds) of one host op at one dtype, as ``tests/test_torch_host_ops.py``
    builds them."""
    rng = np.random.default_rng(0)

    def data(shape):
        if dtype.startswith(("int", "uint")):
            info = np.iinfo(dtype)
            return rng.integers(max(int(info.min), -300), min(int(info.max), 300) + 1, shape).astype(dtype)
        return (rng.normal(size=shape) * 3).astype(dtype)

    def inp(shape, name, dt=dtype):
        return ir.input_(shape, dt, name=name)

    shapes = {"transpose": (2, 3, 4), "reshape": (2, 3, 4), "flatten": (2, 3, 4),
              "max_pool2d": (2, 6, 6, 3), "kv_cache_read": (16, 8), "kv_cache_append": (16, 8)}
    x = inp(shapes.get(op, (3, 8)), "x")
    feeds = {"x": data(x.shape)}
    if op in ("add", "sub", "mul"):
        node = getattr(ir, op)(x, inp((3, 8), "y"))
        feeds["y"] = data((3, 8))
    elif op == "bias_add":
        node = ir.bias_add(x, inp((8,), "b"))
        feeds["b"] = data((8,))
    elif op == "kv_cache_append":
        node = ir.kv_cache_append(x, inp((2, 8), "u"), inp((), "pos", "int32"))
        feeds["u"], feeds["pos"] = data((2, 8)), np.asarray(5, np.int32)
    elif op == "shard_slice":
        node = ir.shard_slice(x, axis=1, rank=1, parts=2)
    else:
        node = {
            "relu": lambda: ir.relu(x), "gelu": lambda: ir.gelu(x), "softmax": lambda: ir.softmax(x),
            "clip": lambda: ir.clip(x, lo=3, hi=100), "requantize": lambda: ir.requantize(x, scale=0.37),
            "quantize": lambda: ir.quantize(x, scale=0.05), "dequantize": lambda: ir.dequantize(x, scale=0.05),
            "transpose": lambda: ir.transpose(x, (2, 0, 1)), "reshape": lambda: ir.reshape(x, (4, 6)),
            "flatten": lambda: ir.Node("flatten", [x], {}, shape=(2, 12), dtype=dtype),
            "max_pool2d": lambda: ir.max_pool2d(x, 2, 2), "kv_cache_read": lambda: ir.kv_cache_read(x),
        }[op]()
    return node, feeds


def host_ops_phase(dev: torch.device, card_line: str) -> dict:
    """Phase 13, host ops: every op the port lowers x 8 dtypes on the card
    against the port's CPU run (which the CPU tests hold to the
    reference): integers and every other float op bit-equal, gelu and
    softmax within ``CARD_ULP_BOUND``."""
    worst = {}
    ops = sorted(ir.HOST_OPS - {"im2col"})
    for op in ops:
        for dtype in HOST_OP_DTYPES:
            node, feeds = host_op_case(op, dtype)
            args = [feeds[i.name] for i in node.inputs]
            want = to_numpy(compile_host_op(node, torch.device("cpu"))(*(to_tensor(a, torch.device("cpu")) for a in args)))
            got = to_numpy(compile_host_op(node, dev)(*(to_tensor(a, dev) for a in args)))
            check(got.dtype == want.dtype and got.shape == want.shape, f"host op {op} {dtype}: dtype/shape")
            if want.dtype.kind == "f" and op in CARD_ULP_BOUND:
                at = 0.5 * feeds["x"].astype(np.float64) if op == "gelu" else want.astype(np.float64)
                scale = np.maximum(np.abs(at), np.finfo(want.dtype).tiny) * np.finfo(want.dtype).eps
                ulp = float(np.max(np.abs(got.astype(np.float64) - want.astype(np.float64)) / scale))
                check(ulp <= CARD_ULP_BOUND[op], f"host op {op} {dtype}: {ulp} ulp from the cpu run")
                worst[f"{op} {dtype}"] = ulp
            else:
                check(np.array_equal(got, want), f"host op {op} {dtype}: cuda != cpu")
    print(f"host ops: {len(ops)} ops x {len(HOST_OP_DTYPES)} dtypes on cuda equal the cpu run "
          f"(gelu, softmax ulp: {worst}) [{card_line}]")
    return {"cases": len(ops) * len(HOST_OP_DTYPES), "ulp": worst}


LM_ARCH = "codeqwen1_5_7b"
LM_BATCH, LM_PROMPT, LM_NEW, LM_REQUESTS = 8, 128, 16, 16
LM_MAX_LEN = LM_PROMPT + LM_NEW + 1
#: routed against unrouted bf16 logits, |diff| / max |logit| at the last
#: prompt position: bf16 keeps 8 bits (2**-8 = 0.4 %) and the two round
#: the bias and the product differently in each of 225 GEMMs
LM_LOGIT_TOL = 5e-2
LM_SMOKE_ARCHS = ARCH_IDS
LM_SMOKE_BATCH, LM_SMOKE_PROMPT, LM_SMOKE_STEPS = 8, 16, 4
LM_GRAPH_LAUNCHES = 10  # a head launch streams 757 MB
LM_DECODE_SAMPLES = 16
MIN_M = ScheduledKernelPolicy.min_m


def dense_rows(cfg, batch: int, seq: int, call: str) -> list[int]:
    """The m of every ``layers.dense`` one call makes, layer by layer
    (``lm.layer_kinds``): ``call`` is ``forward`` or ``prefill`` over
    ``seq`` positions (the frontend's included) or ``decode`` (one)."""
    s = 1 if call == "decode" else seq
    rows = batch * s
    out = []
    for kind, is_moe in lm.layer_kinds(cfg):
        if kind == "attn":  # q, k, v, o; MLA: q, kv_down, k_up, v_up, o
            out += [rows] * (5 if cfg.kv_lora_rank else 4)
        elif kind == "mamba":  # in_proj, (x_proj, dt_proj) per chunk, out_proj
            chunk = L.chunk_len(s, cfg.mamba.chunk)
            out += [rows] + [batch * chunk] * (2 * (s // chunk)) + [rows]
        elif kind == "mlstm":  # up, q, k, v, i, f, o gates, down per chunk
            chunk = L.chunk_len(s, cfg.attn_chunk)
            out += [batch * chunk] * (8 * (s // chunk))
        elif kind == "slstm":  # out
            out.append(rows)
        if is_moe:  # the router, the shared experts' MLP
            out += [rows] * (1 + (3 if cfg.moe.n_shared_experts else 0))
        elif cfg.d_ff:
            out += [rows] * (3 if cfg.mlp_kind == "swiglu" else 2)
    if not cfg.tie_embeddings:  # the head: every position in forward, the last in prefill
        out.append(rows if call == "forward" else batch)
    return out


def routed_per_call(cfg, batch: int, seq: int, call: str) -> int:
    """Scheduled-kernel launches of one call: its denses of at least
    ``min_m`` rows."""
    return sum(m >= MIN_M for m in dense_rows(cfg, batch, seq, call))


class GemmRecorder:
    """Records every (m, k, n, dtype, config) that reaches
    ``scheduled_gemm`` through ``kernels.ops`` while active (the calls
    pass straight through; the launch count stays the wrapper's)."""

    def __init__(self):
        self.calls: list[tuple] = []

    def __enter__(self):
        self._real = ops.scheduled_gemm

        def recording(x, w, cfg, bias=None):
            self.calls.append((x.shape[0], x.shape[1], w.shape[1], x.dtype, cfg))
            return self._real(x, w, cfg, bias)

        ops.scheduled_gemm = recording
        return self

    def __exit__(self, *exc):
        ops.scheduled_gemm = self._real
        return False


def lm_tokens(rng, vocab: int, count: int, length: int) -> list[np.ndarray]:
    return [rng.integers(0, vocab, size=(length,)).astype(np.int32) for _ in range(count)]


def lm_wave(prompts, dev) -> torch.Tensor:
    return torch.from_numpy(np.stack(prompts)).to(dev)


def lm_kernel_cases(dev: torch.device, calls: set[tuple], card_line: str) -> dict[tuple, dict]:
    """Each distinct (m, k, n, dtype, config) the LM launched, against its
    plain version (bf16: one bf16 ulp of the plain result at every K, the
    rounding of an f32 sum that differs in order; f32: F32_TOL), timed by
    CUDA-graph replay beside ``bound`` and ``torch.matmul``."""
    rng = np.random.default_rng(2)
    results = {}
    for key in sorted(calls, key=lambda c: (str(c[3]), c[0], c[1], c[2], c[4].has_bias)):
        m, k, n, dt, cfg = key
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev).to(dt)
        w = (torch.randn((k, n), device=dev) * (2.0 / (k + n)) ** 0.5).to(dt)
        b = torch.randn((n,), device=dev) if cfg.has_bias else None
        run = lambda: scheduled_gemm(x, w, cfg, b)  # noqa: E731
        plain = lambda: gemm_plain(x, w, cfg, b)  # noqa: E731
        label = (f"lm case {str(dt).removeprefix('torch.')} {m}x{k}x{n} {cfg.block_m}/{cfg.block_k}/"
                 f"{cfg.block_n} {cfg.dataflow}{' bias' if b is not None else ''}")
        err = compare(label, run(), plain())
        ms = device_ms(run, LM_GRAPH_LAUNCHES)
        p_ms = device_ms(plain, LM_GRAPH_LAUNCHES)
        lib = device_ms(lambda: torch.matmul(x, w), LM_GRAPH_LAUNCHES)
        in_dtype = str(dt).removeprefix("torch.")
        b_ms, by = bound(m, k, n, in_dtype, x.element_size(), 0 if b is None else 4 * n)
        geo = gemm.launch_geometry(m, k, n, cfg)
        results[key] = {"m": m, "k": k, "n": n, "dtype": in_dtype, "bias": b is not None,
                        "blocks": f"{cfg.block_m}/{cfg.block_k}/{cfg.block_n}", "dataflow": cfg.dataflow,
                        "ms": ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": lib,
                        "max_abs_err": err}
        print(f"{label}: us {ms * 1e3:.3f} bound_us {b_ms * 1e3:.3f} ({by}) torch.matmul_us {lib * 1e3:.3f} "
              f"plain_us {p_ms * 1e3:.3f} max_abs_err {err}; clusters {geo.grid[0]}x{geo.grid[1]} of "
              f"{geo.cluster} CTAs (col_split {geo.col_split} x k_split {geo.k_split}) [{card_line}]")
        del x, w, b
    torch.cuda.synchronize()
    print(f"lm cases: {len(results)} (m, k, n, dtype, config) cases equal their plain versions")
    return results


def tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, (*path, k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, (*path, i))
    else:
        yield path, tree


def smoke_frontend(rng, cfg, batch: int):
    """A frontend arch's embeddings [B, Nf, d] (f32, drawn with numpy), or
    None."""
    if not cfg.frontend:
        return None
    return torch.from_numpy(rng.normal(size=(batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))


def lm_smoke_phase(dev: torch.device, backend, windows: dict, card_line: str) -> set[tuple]:
    """Phase 13, step 4 (every arch since phase 16): the ten archs at their
    smoke configs (f32) on the card under the policy against the same
    parameters on the CPU: forward logits within F32_TOL (the kernel's
    3xTF32 against an f32 product), greedy tokens of a prefill and
    LM_SMOKE_STEPS decode steps equal, launches per call as the block
    kinds imply; the frontend archs take embeddings drawn with numpy."""
    calls = set()
    rng = np.random.default_rng(3)
    gemm.reset_launches()  # the smoke archs' window starts here
    for arch in LM_SMOKE_ARCHS:
        cfg = get_smoke_config(arch)
        cpu_params = lm.init_lm(0, cfg, device="cpu")
        params = tree_map(lambda t: t.to(dev), cpu_params)
        toks = lm_wave(lm_tokens(rng, cfg.vocab, LM_SMOKE_BATCH, LM_SMOKE_PROMPT), "cpu")
        fe = smoke_frontend(rng, cfg, LM_SMOKE_BATCH)
        seq = LM_SMOKE_PROMPT + (cfg.n_frontend_tokens if fe is not None else 0)
        per_call = {c: routed_per_call(cfg, LM_SMOKE_BATCH, seq, c) for c in ("forward", "prefill", "decode")}
        tokens = {}
        with scheduled_kernels(backend), torch.inference_mode(), GemmRecorder() as rec:
            before = gemm.LAUNCHES["gemm_float"]
            got, _ = lm.forward(params, cfg, toks.to(dev), None if fe is None else fe.to(dev))
            torch.cuda.synchronize()
            check(gemm.LAUNCHES["gemm_float"] - before == per_call["forward"],
                  f"{arch} smoke forward: {gemm.LAUNCHES['gemm_float'] - before} launches, not {per_call['forward']}")
            want, _ = lm.forward(cpu_params, cfg, toks, fe)
            err = max_err(got.cpu(), want)
            check(torch.allclose(got.cpu(), want, **F32_TOL), f"{arch} smoke forward: cuda vs cpu, max |err| {err}")
            for where, p in (("cuda", params), ("cpu", cpu_params)):
                d = dev if where == "cuda" else torch.device("cpu")
                c = lm.init_cache(cfg, LM_SMOKE_BATCH, seq + LM_SMOKE_STEPS, device=d)
                before = gemm.LAUNCHES["gemm_float"]
                logits, c = lm.prefill(p, cfg, toks.to(d), c, None if fe is None else fe.to(d))
                out = [torch.argmax(logits[:, -1:], -1)]
                for _ in range(LM_SMOKE_STEPS):
                    logits, c = lm.decode_step(p, cfg, c, out[-1])
                    out.append(torch.argmax(logits[:, -1:], -1))
                tokens[where] = torch.cat(out, 1).cpu()
                if where == "cuda":
                    launched = gemm.LAUNCHES["gemm_float"] - before
                    want_n = per_call["prefill"] + LM_SMOKE_STEPS * per_call["decode"]
                    check(launched == want_n,
                          f"{arch} smoke prefill + {LM_SMOKE_STEPS} steps: {launched} launches, not {want_n}")
        check(torch.equal(tokens["cuda"], tokens["cpu"]), f"{arch} smoke greedy tokens: cuda != cpu")
        calls |= set(rec.calls)
        print(f"lm smoke {arch}: forward logits cuda vs cpu max |err| {err:.3e} (rtol 1e-4, atol 1e-3); "
              f"greedy tokens of prefill + {LM_SMOKE_STEPS} steps equal ({tokens['cuda'].numel()}); "
              f"launches per forward / prefill / decode step {per_call['forward']} / {per_call['prefill']} / "
              f"{per_call['decode']} [{card_line}]")
    windows["LM smoke archs"] = dict(gemm.LAUNCHES)  # read just after them
    return calls


def lm_phase(dev: torch.device, card_line: str, windows: dict, cfg=None) -> dict:
    """Phase 13: codeqwen1.5-7b at its published config, full width and
    depth, bf16, weights from seed 0 on the card, served through
    ``ServingEngine`` with and without ``scheduled_kernels`` on the port's
    gemmini backend; the LM's kernel cases; the four smoke archs on the
    card against the CPU."""
    cfg = cfg or get_config(LM_ARCH)
    backend = build_backend(make_gemmini_description())
    per_call = routed_per_call(cfg, LM_BATCH, LM_PROMPT, "prefill")
    check(per_call == routed_per_call(cfg, LM_BATCH, LM_PROMPT, "decode"), "lm: prefill and decode launch counts")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm.init_lm(0, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(t.numel() for path, t in tree_leaves(params) if path[-1] in ("w", "table"))
    check(weights == cfg.param_count(), f"{cfg.name}: {weights} weights, param_count {cfg.param_count()}")
    print(f"lm {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"({cfg.n_kv_heads} kv), d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.param_dtype}: {weights:,} "
          f"weights drawn on {dev} in {init_s:.2f} s [{card_line}]")
    rng = np.random.default_rng(0)
    prompts = lm_tokens(rng, cfg.vocab, LM_REQUESTS, LM_PROMPT)
    waves = [prompts[i : i + LM_BATCH] for i in range(0, LM_REQUESTS, LM_BATCH)]

    # each wave's prefill and one decode step, routed and not: the shapes,
    # the launches per call, the logits and the first tokens
    calls: dict[str, list] = {"prefill": [], "decode": []}
    firsts, worst_rel, margin_rows, agree_rows = [], 0.0, 0, 0
    with torch.inference_mode():
        for wave in waves:
            toks = lm_wave(wave, dev)
            logits = {}
            for routed in (True, False):
                c = lm.init_cache(cfg, LM_BATCH, LM_MAX_LEN, device=dev)
                policy = scheduled_kernels(backend) if routed else contextlib.nullcontext()
                with policy, GemmRecorder() as rec:
                    gemm.reset_launches()
                    logits[routed], c = lm.prefill(params, cfg, toks, c)
                    torch.cuda.synchronize()
                    pf = dict(gemm.LAUNCHES)
                    n_pf = len(rec.calls)
                    gemm.reset_launches()
                    lm.decode_step(params, cfg, c, torch.argmax(logits[routed][:, -1:], -1))
                    torch.cuda.synchronize()
                    dc = dict(gemm.LAUNCHES)
                want = {v: (per_call if routed and v == "gemm_float" else 0) for v in gemm.LAUNCHES}
                check(pf == want and dc == want,
                      f"lm {'routed' if routed else 'unrouted'} prefill / decode step launches {pf} / {dc}, "
                      f"want {want} each")
                if routed and not calls["prefill"]:
                    calls["prefill"], calls["decode"] = rec.calls[:n_pf], rec.calls[n_pf:]
            p, u = logits[True][:, -1], logits[False][:, -1]
            scale = u.abs().max()
            rel = float((p - u).abs().max() / scale)
            worst_rel = max(worst_rel, rel)
            check(bool(torch.isfinite(p).all()) and rel <= LM_LOGIT_TOL,
                  f"lm routed vs unrouted prefill logits: {rel:.4f} of max |logit| > {LM_LOGIT_TOL}")
            top2 = torch.topk(u, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) / scale > LM_LOGIT_TOL
            same = torch.argmax(p, -1) == torch.argmax(u, -1)
            check(bool(same[clear].all()), "lm first tokens differ on a row whose top-2 margin exceeds the tolerance")
            margin_rows += int(clear.sum())
            agree_rows += int(same.sum())
            firsts.append(torch.argmax(p, -1).tolist())
    print(f"lm prefill launches: {per_call} per prefill and per decode step routed, 0 unrouted; routed vs "
          f"unrouted last-position logits within {worst_rel:.4f} of max |logit| (tolerance {LM_LOGIT_TOL}); "
          f"first tokens agree on {agree_rows}/{LM_REQUESTS} rows, on all {margin_rows} rows whose top-2 "
          f"margin exceeds the tolerance")

    # one decode step at batch 4 under the policy launches nothing (m < min_m)
    with torch.inference_mode():
        c4 = lm.init_cache(cfg, 4, LM_MAX_LEN, device=dev)
        logits4, c4 = lm.prefill(params, cfg, lm_wave(waves[0][:4], dev), c4)
        nxt = torch.argmax(logits4[:, -1:], -1)
        copy = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, c4)
        want4, _ = lm.decode_step(params, cfg, c4, nxt)
        gemm.reset_launches()
        with scheduled_kernels(backend):
            got4, _ = lm.decode_step(params, cfg, copy, nxt)
        torch.cuda.synchronize()
        check(sum(gemm.LAUNCHES.values()) == 0, f"lm decode step at batch 4 launched {gemm.LAUNCHES}")
        check(torch.equal(got4, want4), "lm decode step at batch 4: routed policy changed the logits")
    print("lm decode step at batch 4 under the policy: 0 launches (m = 4 < min_m = 8), logits equal the "
          "unrouted step's")

    # the served runs: the engine as the CLI builds it, with and without the policy
    scfg = ServeConfig(batch=LM_BATCH, max_len=LM_MAX_LEN, max_new_tokens=LM_NEW)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ReproDeprecationWarning)
        engine = ServingEngine(cfg, params, scfg)
    served = {}
    for routed in (True, False):
        gemm.reset_launches()  # the served window starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with scheduled_kernels(backend) if routed else contextlib.nullcontext():
            done = engine.generate(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        window = dict(gemm.LAUNCHES)  # read just after it
        calls_per_wave = 1 + LM_NEW
        want = {v: (per_call * calls_per_wave * len(waves) if routed and v == "gemm_float" else 0)
                for v in gemm.LAUNCHES}
        check(window == want, f"lm served {'routed' if routed else 'unrouted'}: launches {window}, want {want}")
        windows[f"LM served {'routed' if routed else 'unrouted'}"] = window
        tokens = [r.output for r in done]
        check(len(tokens) == LM_REQUESTS and all(len(t) == LM_NEW for t in tokens)
              and all(0 <= tok < cfg.vocab for t in tokens for tok in t), "lm served tokens")
        served[routed] = {"wall_s": wall, "tok_per_s": LM_REQUESTS * LM_NEW / wall, "tokens": tokens}
    routed_firsts = [t[0] for t in served[True]["tokens"]]
    check(routed_firsts == [tok for wave in firsts for tok in wave], "lm served first tokens differ from the prefill's")
    agree = sum(a == b for ra, rb in zip(served[True]["tokens"], served[False]["tokens"]) for a, b in zip(ra, rb))
    print(f"lm served {cfg.name} batch {LM_BATCH}, {LM_REQUESTS} prompts of {LM_PROMPT} tokens, {LM_NEW} new: "
          f"routed {served[True]['tok_per_s']:.1f} tok/s ({served[True]['wall_s']:.3f} s, "
          f"{windows['LM served routed']['gemm_float']} launches), unrouted {served[False]['tok_per_s']:.1f} "
          f"tok/s ({served[False]['wall_s']:.3f} s, 0 launches); {agree}/{LM_REQUESTS * LM_NEW} tokens agree "
          f"[{card_line}]")

    # kernel cases at the LM's shapes, and the smoke archs (which add their own)
    smoke_calls = lm_smoke_phase(dev, backend, windows, card_line)
    cases = lm_kernel_cases(dev, set(calls["prefill"]) | set(calls["decode"]) | smoke_calls, card_line)

    # prefill and decode step times at batch 8, routed and not
    timing = {}
    with torch.inference_mode():
        toks = lm_wave(waves[0], dev)
        for routed in (True, False):
            with scheduled_kernels(backend) if routed else contextlib.nullcontext():
                pf_ms, step_ms = [], []
                for _ in range(3):
                    c = lm.init_cache(cfg, LM_BATCH, LM_MAX_LEN, device=dev)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits, c = lm.prefill(params, cfg, toks, c)
                    torch.cuda.synchronize()
                    pf_ms.append((time.perf_counter() - t0) * 1e3)
                nxt = torch.argmax(logits[:, -1:], -1)
                for _ in range(LM_DECODE_SAMPLES):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits, c = lm.decode_step(params, cfg, c, nxt)
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    nxt = torch.argmax(logits[:, -1:], -1)
            timing[routed] = {"prefill_ms": float(np.median(pf_ms)), "decode_step_ms_p50": float(np.percentile(step_ms, 50))}
    k_prefill = sum(cases[c]["ms"] for c in calls["prefill"])
    k_step = sum(cases[c]["ms"] for c in calls["decode"])
    r = timing[True]
    print(f"lm batch {LM_BATCH} routed: prefill of {LM_PROMPT} tokens {r['prefill_ms']:.3f} ms (median of 3), "
          f"kernels {k_prefill:.3f} ms device ({k_prefill / r['prefill_ms']:.1%}); decode step p50 "
          f"{r['decode_step_ms_p50']:.3f} ms over {LM_DECODE_SAMPLES}, kernels {k_step:.3f} ms device "
          f"({k_step / r['decode_step_ms_p50']:.1%}); unrouted: prefill {timing[False]['prefill_ms']:.3f} ms, "
          f"decode step p50 {timing[False]['decode_step_ms_p50']:.3f} ms [{card_line}]")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"lm peak device memory: {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated) [{card_line}]")
    return {
        "arch": cfg.name, "weights": weights, "init_s": init_s, "per_call": per_call,
        "logit_rel_diff": worst_rel, "logit_tol": LM_LOGIT_TOL, "first_token_rows_agree": agree_rows,
        "margin_rows": margin_rows,
        "served": {("routed" if k else "unrouted"): {kk: vv for kk, vv in v.items() if kk != "tokens"}
                   for k, v in served.items()},
        "tokens_agree": agree, "tokens": LM_REQUESTS * LM_NEW,
        "timing": {("routed" if k else "unrouted"): v for k, v in timing.items()},
        "prefill_kernel_ms": k_prefill, "decode_step_kernel_ms": k_step,
        "peak_bytes": peak,
        "cases": [{k: v for k, v in c.items()} for c in cases.values()],
    }


# -- phase 16: tpu_v5e on the card; the other block kinds at full width --------

TPU_MODELS = ("toycar_mlp", "mlp_tiny", "qcnn", "transformer_block")
#: (arch, layers kept or None for the published depth, launches per
#: prefill and per decode step as (bf16, f32 routers)); each is served
#: through ServingEngine
FULL_WIDTH = (
    ("jamba_v0_1_52b", 8, (45, 4)),
    ("deepseek_v2_236b", 2, (17, 1)),
    ("xlstm_125m", None, (83, 0)),
)
FW_BATCH, FW_PROMPT, FW_NEW = 8, 128, 16
#: one block's routed against unrouted output on one input, |diff| / max
#: |out| (codeqwen's logit bound)
BLOCK_TOL = LM_LOGIT_TOL
#: a model with no router: its routed bf16 logits may sit at most this many
#: times further from an f32 run than its unrouted bf16 logits do
F32_GAP_RATIO = 2.0


def compile_tpu_paths(dev: torch.device) -> dict[tuple, dict]:
    """The four zoo models in every mode on tpu_v5e, per-sample, on the
    card and on the CPU, keyed as phase 6's modules."""
    out = {}
    for name in TPU_MODELS:
        model = zoo.get_model(name)
        for mode in MODES:
            out[name, "tpu_v5e", mode, None] = {
                where: repro_torch.compile(
                    model.build(), repro_torch.Target("tpu_v5e", mode=mode, device=str(dev) if where == "cuda" else "cpu")
                )
                for where in ("cuda", "cpu")
            }
    return out


def tpu_v5e_phase(compiled: dict, cases: dict, card_line: str, windows: dict) -> dict:
    """Phase 16, step 1: the 12 tpu_v5e modules on the card, bit-equal to
    the CPU run with the launches the plan implies (phase 6's checks)."""
    gemm.reset_launches()  # the tpu_v5e modules' runs start here
    summary = new_paths_phase(compiled, cases, card_line)
    windows["tpu_v5e modules"] = dict(gemm.LAUNCHES)  # read just after them
    return summary


class RouterRecorder:
    """Records the expert ids [T, k] of every ``moe.route`` call while
    active (the calls pass straight through)."""

    def __enter__(self):
        self._real = moe.route
        self.ids: list[torch.Tensor] = []

        def recording(params, cfg, xt):
            weights, idx, aux = self._real(params, cfg, xt)
            self.ids.append(idx)
            return weights, idx, aux

        moe.route = recording
        return self

    def __exit__(self, *exc):
        moe.route = self._real
        return False


def router_flips(routed: list[torch.Tensor], unrouted: list[torch.Tensor]) -> int:
    """(token, layer) pairs whose top-k expert set differs."""
    return sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum()) for a, b in zip(routed, unrouted))


def block_kind_checks(dev: torch.device, params, cfg, backend, card_line: str) -> dict:
    """Each block kind of a full-width model (the first layer of each),
    routed against unrouted on one input tensor [FW_BATCH, FW_PROMPT, d]
    in the compute dtype: within BLOCK_TOL of the largest |out|.  mLSTM
    is held in each of its forms: the parallel one of ``mlstm_block``,
    the chunk-recurrent one that ``lm.prefill`` serves, and a decode step
    from the state that the unrouted prefill leaves."""
    compute = torch_dtype(cfg.compute_dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    x = torch.randn((FW_BATCH, FW_PROMPT, cfg.d_model), generator=gen, device=dev).to(compute)
    positions = torch.arange(FW_PROMPT, device=dev)
    blocks = {
        "attn": lambda lp: A.attention_block(lp["block"], cfg, x, positions),
        "mamba": lambda lp: S.mamba_block(lp["block"], cfg, x)[0],
        "mlstm": lambda lp: X.mlstm_block(lp["block"], cfg, x),
        "slstm": lambda lp: X.slstm_block(lp["block"], cfg, x)[0],
    }
    todo = {}
    for lp, kind, is_moe in lm.iter_layers(params, cfg):
        label = "MLA attention" if kind == "attn" and cfg.kv_lora_rank else {"attn": "attention"}.get(kind, kind)
        todo.setdefault(label, lambda lp=lp, kind=kind: blocks[kind](lp))
        if kind == "mlstm" and "mlstm prefill" not in todo:
            fresh = X.init_mlstm_state(cfg, FW_BATCH, device=dev)
            with torch.inference_mode():
                _, state = X.mlstm_prefill(lp["block"], cfg, x, fresh, chunk=cfg.attn_chunk)
            todo["mlstm prefill"] = lambda lp=lp, st=fresh: X.mlstm_prefill(
                lp["block"], cfg, x, st, chunk=cfg.attn_chunk)[0]
            todo["mlstm decode step"] = lambda lp=lp, st=state: X.mlstm_decode_step(
                lp["block"], cfg, x[:, -1:], st)[0]
        if is_moe:
            todo.setdefault("MoE FFN", lambda lp=lp: moe.moe_ffn(lp["ffn"], cfg, x)[0])
        elif "ffn" in lp:
            todo.setdefault("dense MLP", lambda lp=lp: L.mlp(lp["ffn"], x, compute_dtype=compute))
    out = {}
    with torch.inference_mode():
        for label, fn in todo.items():
            with RouterRecorder() as rr_u:
                unrouted = fn()
            with scheduled_kernels(backend), RouterRecorder() as rr_r:
                routed = fn()
            torch.cuda.synchronize()
            scale = unrouted.float().abs().max()
            rel = float((routed.float() - unrouted.float()).abs().max() / scale)
            flips = router_flips(rr_r.ids, rr_u.ids)
            check(bool(torch.isfinite(routed).all()) and rel <= BLOCK_TOL,
                  f"{cfg.name} {label}: routed vs unrouted {rel:.4f} of max |out| > {BLOCK_TOL}")
            out[label] = {"rel": rel, "max_abs_out": float(scale), "router_flips": flips}
            print(f"lm {cfg.name} block {label}: routed vs unrouted on one input within {rel:.5f} of max |out| "
                  f"{float(scale):.3f} (tolerance {BLOCK_TOL}){f'; tokens routed differently {flips}' if rr_u.ids else ''} "
                  f"[{card_line}]")
    return out


def full_width_lm(dev: torch.device, card_line: str, windows: dict, arch: str, n_layers,
                  expected: tuple[int, int]) -> dict:
    """Phase 16: one arch at its published widths (cut to ``n_layers``),
    bf16 weights from seed 0 on the card: each block kind routed against
    unrouted; a prefill of FW_BATCH x FW_PROMPT tokens and a decode step,
    routed and not, with the launches per call, the end-to-end logits and
    the router choices compared; then served through ``ServingEngine``
    (FW_NEW new tokens), routed and not, in its launch window; prefill and
    decode step times and the peak memory."""
    cfg = get_config(arch).with_(n_layers=n_layers) if n_layers else get_config(arch)
    short = arch.split("_")[0]
    backend = build_backend(make_gemmini_description())
    per = {c: routed_per_call(cfg, FW_BATCH, FW_PROMPT, c) for c in ("prefill", "decode")}
    check(per["prefill"] == per["decode"] == sum(expected),
          f"{cfg.name}: the block kinds imply {per} launches per call, not {sum(expected)}")
    n_moe = sum(is_moe for _, is_moe in lm.layer_kinds(cfg))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm.init_lm(0, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(t.numel() for t in flatten(params))
    kinds = sorted({k for k, _ in lm.layer_kinds(cfg)})
    print(f"lm {cfg.name}: {cfg.n_layers} layers ({', '.join(kinds)}; {n_moe} MoE), d_model {cfg.d_model}, "
          f"{cfg.param_dtype}: {weights:,} weights drawn on {dev} in {init_s:.2f} s [{card_line}]")
    blocks = block_kind_checks(dev, params, cfg, backend, card_line)

    rng = np.random.default_rng(0)
    prompts = lm_tokens(rng, cfg.vocab, FW_BATCH, FW_PROMPT)
    toks = lm_wave(prompts, dev)
    max_len = FW_PROMPT + FW_NEW + 1
    calls: dict[str, list] = {}
    logits, routers = {}, {}
    with torch.inference_mode():
        for routed in (True, False):
            c = lm.init_cache(cfg, FW_BATCH, max_len, device=dev)
            policy = scheduled_kernels(backend) if routed else contextlib.nullcontext()
            with policy, GemmRecorder() as rec, RouterRecorder() as rr:
                gemm.reset_launches()
                logits[routed], c = lm.prefill(params, cfg, toks, c)
                torch.cuda.synchronize()
                pf, n_pf = dict(gemm.LAUNCHES), len(rec.calls)
                routers[routed] = list(rr.ids)
                gemm.reset_launches()
                lm.decode_step(params, cfg, c, torch.argmax(logits[routed][:, -1:], -1))
                torch.cuda.synchronize()
                dc = dict(gemm.LAUNCHES)
            want = {v: (per["prefill"] if routed and v == "gemm_float" else 0) for v in gemm.LAUNCHES}
            check(pf == want and dc == want, f"{cfg.name} {'routed' if routed else 'unrouted'} prefill / decode "
                  f"step launches {pf} / {dc}, want {want} each")
            if routed:
                calls["prefill"], calls["decode"] = rec.calls[:n_pf], rec.calls[n_pf:]
    for name, cl in calls.items():
        split = (sum(c[3] != torch.float32 for c in cl), sum(c[3] == torch.float32 for c in cl))
        check(split == expected, f"{cfg.name} {name}: (bf16, f32) launches {split}, want {expected}")
    p, u = logits[True][:, -1], logits[False][:, -1]
    e2e_rel = float((p - u).abs().max() / u.abs().max())
    flips = router_flips(routers[True], routers[False])
    check(bool(torch.isfinite(p).all()), f"{cfg.name}: routed prefill logits not finite")
    print(f"lm {cfg.name} launches: {per['prefill']} per prefill and per decode step routed ({expected[0]} bf16, "
          f"{expected[1]} f32), 0 unrouted; routed vs unrouted last-position logits {e2e_rel:.4f} of max |logit|, "
          f"first tokens agree on {int((p.argmax(-1) == u.argmax(-1)).sum())}/{FW_BATCH} rows; router choices "
          f"differ on {flips} of {FW_BATCH * FW_PROMPT * n_moe} (token, layer) pairs (not gated) [{card_line}]")

    served_runs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ReproDeprecationWarning)
        engine = ServingEngine(cfg, params, ServeConfig(batch=FW_BATCH, max_len=max_len, max_new_tokens=FW_NEW))
    for routed in (True, False):
        gemm.reset_launches()  # this arch's window starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with scheduled_kernels(backend) if routed else contextlib.nullcontext():
            tokens = [r.output for r in engine.generate(prompts)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        window = dict(gemm.LAUNCHES)  # read just after it
        want = {v: (per["prefill"] + FW_NEW * per["decode"] if routed and v == "gemm_float" else 0)
                for v in gemm.LAUNCHES}
        check(window == want, f"{cfg.name} {'routed' if routed else 'unrouted'} run: launches {window}, want {want}")
        check(all(0 <= t < cfg.vocab for row in tokens for t in row), f"{cfg.name}: tokens out of the vocabulary")
        if routed:
            windows[f"LM {short} routed"] = window
        served_runs["routed" if routed else "unrouted"] = {"wall_s": wall, "tok_per_s": FW_BATCH * FW_NEW / wall}
    print(f"lm {cfg.name} served at batch {FW_BATCH}, prompts of {FW_PROMPT}: routed "
          f"{served_runs['routed']['tok_per_s']:.1f} tok/s "
          f"({served_runs['routed']['wall_s']:.3f} s, {windows[f'LM {short} routed']['gemm_float']} launches), "
          f"unrouted {served_runs['unrouted']['tok_per_s']:.1f} tok/s ({served_runs['unrouted']['wall_s']:.3f} s, "
          f"0 launches) [{card_line}]")

    timing = {}
    with torch.inference_mode():
        for routed in (True, False):
            with scheduled_kernels(backend) if routed else contextlib.nullcontext():
                pf_ms, step_ms = [], []
                for _ in range(3):
                    c = lm.init_cache(cfg, FW_BATCH, max_len, device=dev)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out, c = lm.prefill(params, cfg, toks, c)
                    torch.cuda.synchronize()
                    pf_ms.append((time.perf_counter() - t0) * 1e3)
                nxt = torch.argmax(out[:, -1:], -1)
                for _ in range(LM_DECODE_SAMPLES):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out, c = lm.decode_step(params, cfg, c, nxt)
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    nxt = torch.argmax(out[:, -1:], -1)
            timing["routed" if routed else "unrouted"] = {
                "prefill_ms": float(np.median(pf_ms)), "decode_step_ms_p50": float(np.percentile(step_ms, 50))}
    peak = torch.cuda.max_memory_allocated(dev)
    f32_gap = None
    # no router can flip: hold each side to an f32 prefill of the same
    # weights and tokens (after the peak is read, which it would raise)
    if not n_moe:
        cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32")
        p32 = tree_map(lambda t: t.float() if t.is_floating_point() else t, params)
        with torch.inference_mode():
            ref = lm.prefill(p32, cfg32, toks, lm.init_cache(cfg32, FW_BATCH, max_len, device=dev))[0][:, -1]
        f32_gap = {side: float((v - ref).abs().max() / ref.abs().max()) for side, v in (("routed", p), ("unrouted", u))}
        del p32, ref
        check(f32_gap["routed"] <= F32_GAP_RATIO * f32_gap["unrouted"],
              f"{cfg.name}: routed logits {f32_gap['routed']:.4f} of max |logit| from an f32 prefill, more than "
              f"{F32_GAP_RATIO} x the unrouted {f32_gap['unrouted']:.4f}")
        print(f"lm {cfg.name} against an f32 prefill of the same weights and tokens (unrouted): routed last-position "
              f"logits {f32_gap['routed']:.4f} of max |logit| away, unrouted {f32_gap['unrouted']:.4f} (tolerance: "
              f"routed within {F32_GAP_RATIO} x unrouted) [{card_line}]")
    del params, engine, c, out
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.n_layers, "weights": weights, "init_s": init_s, "per_call": per,
            "split": expected, "blocks": blocks, "logit_rel_diff": e2e_rel, "f32_gap": f32_gap, "router_flips": flips,
            "router_pairs": FW_BATCH * FW_PROMPT * n_moe, "runs": served_runs,
            "timing": timing, "peak_bytes": peak, "calls": calls}


def full_width_phase(dev: torch.device, card_line: str, windows: dict) -> dict:
    """Phase 16, steps 2-4: jamba, deepseek-v2 and xlstm at full width,
    then every (m, k, n, dtype, config) they launched against its plain
    version, and each model's prefill and decode step split into kernels
    and the rest."""
    runs = [full_width_lm(dev, card_line, windows, *spec) for spec in FULL_WIDTH]
    calls = {c for r in runs for cl in r["calls"].values() for c in cl}
    cases = lm_kernel_cases(dev, calls, card_line)
    for r in runs:
        k = {name: sum(cases[c]["ms"] for c in cl) for name, cl in r.pop("calls").items()}
        t = r["timing"]["routed"]
        r["prefill_kernel_ms"], r["decode_step_kernel_ms"] = k["prefill"], k["decode"]
        print(f"lm {r['arch']} batch {FW_BATCH} routed: prefill of {FW_PROMPT} tokens {t['prefill_ms']:.3f} ms "
              f"(median of 3), kernels {k['prefill']:.3f} ms device ({k['prefill'] / t['prefill_ms']:.1%}); decode "
              f"step p50 {t['decode_step_ms_p50']:.3f} ms, kernels {k['decode']:.3f} ms device "
              f"({k['decode'] / t['decode_step_ms_p50']:.1%}), host and the rest "
              f"{t['decode_step_ms_p50'] - k['decode']:.3f} ms; unrouted: prefill "
              f"{r['timing']['unrouted']['prefill_ms']:.3f} ms, decode step p50 "
              f"{r['timing']['unrouted']['decode_step_ms_p50']:.3f} ms; peak device memory "
              f"{r['peak_bytes'] / 2**30:.2f} GiB [{card_line}]")
    return {"models": runs, "cases": list(cases.values())}


# -- phase 17: training on the card -------------------------------------------

#: the smoke arch whose train step is refused under the kernel policy
REFUSAL_ARCH = "yi_34b"
#: the flash backward at yi-34b's attention shapes: (B, query heads, KV
#: heads, S, D, chunk); (window, skip) per case, every case causal
FLASH_BWD_SHAPE = (2, 56, 8, 1024, 128, 512)
FLASH_BWD_CASES = {"causal": (0, False), "windowed 256": (256, False), "causal, block-skipped": (0, True)}
#: bf16: the custom backward within this many bf16 ulps of the largest
#: |grad| of autograd through the plain forward (both sum in f32; they
#: round the probabilities to bf16 at different points; 2 on the CPU at
#: S = 256)
FLASH_BF16_ULPS = 4
#: timed backward calls per case and form (their median), after a warm-up
FLASH_BWD_TIMED = 3
TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ = 2, 16
#: a smoke step's gradient leaves: max |cuda - cpu| within this share of
#: the leaf's max |grad|
GRAD_LEAF_TOL = 1e-4
#: a smoke step's change to each parameter, in units of its lr (the
#: schedule warmed up in one step, so lr is the config's): cuda within
#: UPDATE_TOL of the CPU where |grad| exceeds UPDATE_CLEAR of its leaf's
#: max (10x the gradient's own tolerance, so g's sign is the same on both);
#: elsewhere g's sign is noise and AdamW's first step is about sign(g), so
#: the change is held to one normalized step, |change / lr + wd p| <= 1;
#: both bounds also allow 2 f32 ulps of the parameter, the rounding of
#: the new parameter
UPDATE_TOL = 1e-3
UPDATE_CLEAR = 10 * GRAD_LEAF_TOL
#: xlstm-125m through build_trainer: the launcher's batch and sequence
XLSTM_TRAIN = dict(steps=12, global_batch=8, seq_len=128, checkpoint_every=6)
#: the resumed run's loss at the last step, relative to the first run's
#: (the embedding's backward sums with atomics on the card)
RESUME_LOSS_TOL = 0.01
#: (arch, layers kept, batch, sequence, steps)
YI_TRAIN = ("yi_34b", 2, 2, 1024, 3)


def train_batch(cfg, batch: int, seq: int, step: int, dev) -> dict[str, torch.Tensor]:
    """The synthetic pipeline's batch ``step`` (seed 1) on ``dev``; a
    frontend arch's embeddings are drawn with numpy by the pipeline."""
    pipe = SyntheticTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=1,
        n_frontend_tokens=cfg.n_frontend_tokens if cfg.frontend else 0, d_model=cfg.d_model))
    return {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(step).items()}


def train_refusal(dev: torch.device, card_line: str) -> None:
    """Phase 17, step 1: under ``scheduled_kernels`` a train step raises
    before any launch of any instantiation."""
    cfg = get_smoke_config(REFUSAL_ARCH)
    params = lm.init_lm(0, cfg, device=dev)
    opt = AdamWConfig()
    step = make_train_step(cfg, opt)
    batch = train_batch(cfg, TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ, 0, dev)
    before = dict(gemm.LAUNCHES)
    refusal = None
    with scheduled_kernels(build_backend(make_gemmini_description())):
        try:
            step(TrainState(params, adamw_init(opt, params)), batch)
        except RuntimeError as e:  # the refusal this step checks for
            refusal = str(e)
    torch.cuda.synchronize()
    check(refusal is not None and "no backward" in refusal,
          f"train step under scheduled_kernels on cuda: {refusal or 'no error'}, not the refusal")
    check(dict(gemm.LAUNCHES) == before, f"the refused train step launched {gemm.LAUNCHES} (was {before})")
    print(f"train refusal: a {cfg.name} train step under scheduled_kernels on {dev} raised before any launch "
          f"({refusal.split(':')[0]}: ... no backward ...); launch counts unchanged [{card_line}]")


def flash_backward_phase(dev: torch.device, card_line: str) -> dict:
    """Phase 17, step 2: the flash backward against autograd through the
    plain forward: per case and form a warm-up, then FLASH_BWD_TIMED
    timed calls, their median time and the last one's peak memory."""
    b, h, hkv, s, d, chunk = FLASH_BWD_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    shapes = {"q": (b, hkv, h // hkv, s, d), "k": (b, hkv, s, d), "v": (b, hkv, s, d), "g": (b, hkv, h // hkv, s, d)}
    base = {n: torch.randn(shape, generator=gen, device=dev) for n, shape in shapes.items()}
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, (window, skip) in FLASH_BWD_CASES.items():
            statics = (True, window, chunk, chunk, 0, skip)
            forms = {"custom": lambda *qkv: flash.flash_attention(*qkv, *statics),
                     "plain": lambda *qkv: flash._flash_fwd_impl(*qkv, *statics)[0]}
            runs = {}
            for form, fwd in forms.items():
                times = []
                for _ in range(1 + FLASH_BWD_TIMED):  # a warm-up, then the timed runs
                    ins = [base[n].to(dtype).requires_grad_() for n in "qkv"]
                    g_out = base["g"].to(dtype)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats(dev)
                    floor = torch.cuda.memory_allocated(dev)
                    o = fwd(*ins)
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    grads = torch.autograd.grad(o, ins, g_out)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                    peak = torch.cuda.max_memory_allocated(dev) - floor
                    del o, ins
                runs[form] = {"grads": grads, "ms": float(np.median(times[1:])), "peak_bytes": peak}
            errs = []
            for name, got, want in zip(("dq", "dk", "dv"), runs["custom"]["grads"], runs["plain"]["grads"]):
                err = max_err(got, want)
                if dtype == torch.float32:
                    check(torch.allclose(got, want, **F32_TOL), f"flash bwd f32 {label} {name}: max |err| {err}")
                else:
                    bound_ = FLASH_BF16_ULPS * float(bf16_ulp(want.float().abs().max()))
                    check(err <= bound_, f"flash bwd bf16 {label} {name}: max |err| {err} > {bound_}")
                check(bool(torch.isfinite(got).all()), f"flash bwd {label} {name}: not finite")
                errs.append(err)
            key = f"{str(dtype).split('.')[-1]} {label}"
            out[key] = {"max_abs_err": errs, **{f"{f}_{k}": runs[f][k] for f in runs for k in ("ms", "peak_bytes")}}
            del runs
            c = out[key]
            print(f"train flash bwd {key} (B {b}, {h} heads over {hkv}, S {s}, D {d}, chunks {chunk}): dq/dk/dv max "
                  f"|err| vs plain autograd {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}; backward {c['custom_ms']:.3f} ms "
                  f"custom vs {c['plain_ms']:.3f} ms plain (CUDA events around each call, median of "
                  f"{FLASH_BWD_TIMED}); peak over forward and backward {c['custom_peak_bytes'] / 2**30:.3f} vs "
                  f"{c['plain_peak_bytes'] / 2**30:.3f} GiB [{card_line}]")
    return out


def smoke_train_phase(dev: torch.device, card_line: str) -> dict:
    """Phase 17, step 3: the ten smoke archs (f32), one train step each on
    ``cuda`` against the same step on the CPU, the gradients that step
    takes (``value_and_grad``, which ``make_train_step`` calls) and the
    change it makes to each parameter."""
    out = {}
    opt = AdamWConfig(warmup_steps=1)
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        step = make_train_step(cfg, opt)
        cpu_params = lm.init_lm(0, cfg, device="cpu")
        res = {}
        for where, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
            params = tree_map(lambda t: t.to(d), cpu_params)
            batch = train_batch(cfg, TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ, 0, d)
            _, grads = train_step_mod.value_and_grad(params, cfg, batch)
            new, metrics = step(TrainState(params, adamw_init(opt, params)), batch)
            res[where] = {"loss": metrics["loss"].cpu(), "grad_norm": metrics["grad_norm"].cpu(),
                          "lr": float(metrics["lr"]), "grads": [t.cpu() for t in flatten(grads)],
                          "change": [(a - b_).cpu() for a, b_ in zip(flatten(new.params), flatten(params))]}
        got, want = res["cuda"], res["cpu"]
        for k in ("loss", "grad_norm"):
            check(torch.allclose(got[k], want[k], **F32_TOL), f"{arch} train {k}: cuda {got[k]} vs cpu {want[k]}")
        lr = want["lr"]
        lr_f32 = float(torch.tensor(opt.lr, dtype=torch.float32))
        check(got["lr"] == lr == lr_f32, f"{arch} train lr: cuda {got['lr']}, cpu {lr}, config {lr_f32}")
        grad_rel = upd_err = 0.0
        n_clear = n_all = 0
        for a, b_, ca, cb, p in zip(got["grads"], want["grads"], got["change"], want["change"], flatten(cpu_params),
                                    strict=True):
            scale = float(b_.abs().max())
            err = max_err(a, b_)
            check(err <= GRAD_LEAF_TOL * scale, f"{arch} train grad: cuda vs cpu max |err| {err} > "
                  f"{GRAD_LEAF_TOL} x leaf max {scale}")
            grad_rel = max(grad_rel, err / max(scale, 1e-30))
            clear = b_.abs() > UPDATE_CLEAR * scale
            u_cuda, u_cpu = ca.double() / lr, cb.double() / lr
            rounding = 2 * torch.exp2(torch.floor(torch.log2(p.double().abs().clamp_min(2.0**-126))) - 23) / lr
            if clear.any():
                e = max(((u_cuda - u_cpu).abs() - rounding)[clear].max().item(), 0.0)
                check(e <= UPDATE_TOL, f"{arch} train update: cuda vs cpu {e} lr > {UPDATE_TOL} lr")
                upd_err = max(upd_err, e)
            step_size = ((u_cuda + opt.weight_decay * p.double()).abs() - rounding).max().item()
            check(step_size <= 1 + UPDATE_TOL, f"{arch} train update: a normalized step of {step_size} > 1")
            n_clear += int(clear.sum())
            n_all += clear.numel()
        out[arch] = {"loss": float(got["loss"]), "loss_err": max_err(got["loss"], want["loss"]),
                     "grad_norm_err": max_err(got["grad_norm"], want["grad_norm"]),
                     "grad_max_rel_to_leaf_max": grad_rel, "update_max_err_in_lr": upd_err,
                     "update_share_compared": n_clear / n_all, "leaves": len(got["grads"])}
        print(f"train smoke {arch}: loss {float(got['loss']):.5f} (cuda vs cpu {out[arch]['loss_err']:.2e}), grad_norm "
              f"err {out[arch]['grad_norm_err']:.2e}, {len(got['grads'])} gradient leaves max |err| {grad_rel:.2e} of "
              f"the leaf's max (<= {GRAD_LEAF_TOL}); the step's change cuda vs cpu {upd_err:.2e} lr beyond the "
              f"parameter's rounding (<= {UPDATE_TOL}) "
              f"on the {100 * n_clear / n_all:.2f} % of parameters whose |grad| > {UPDATE_CLEAR} of the leaf's max, "
              f"one normalized step or less on the rest (lr {lr}, TF32 off) [{card_line}]")
    return out


class CheckpointTimer:
    """Times the trainer's checkpoint saves and the restores that found a
    checkpoint, and keeps what those restores returned, while active (the
    calls pass straight through)."""

    def __enter__(self):
        real_save, real_restore = self._real = (trainer_mod.save_checkpoint, trainer_mod.restore_checkpoint)
        self.save_s: list[float] = []
        self.restore_s: list[float] = []
        self.restored: list[tuple] = []

        def save(*a, **k):
            t0 = time.perf_counter()
            path = real_save(*a, **k)
            self.save_s.append(time.perf_counter() - t0)
            return path

        def restore(*a, **k):
            t0 = time.perf_counter()
            got = real_restore(*a, **k)
            if got[0] is not None:
                self.restore_s.append(time.perf_counter() - t0)
                self.restored.append(got)
            return got

        trainer_mod.save_checkpoint, trainer_mod.restore_checkpoint = save, restore
        return self

    def __exit__(self, *exc):
        trainer_mod.save_checkpoint, trainer_mod.restore_checkpoint = self._real
        return False


def xlstm_train_phase(dev: torch.device, card_line: str, work: Path) -> dict:
    """Phase 17, step 4: xlstm-125m uncut through ``build_trainer``: a
    run, a resume at its end, and a resume from its middle with an
    injected failing step."""
    ckpt = work / "train_xlstm"
    # unsharded: every leaf a whole tensor (phase 19 trains on a DeviceMesh)
    kw = dict(smoke=False, checkpoint_dir=str(ckpt), device=dev, mesh=(1, 1), **XLSTM_TRAIN)
    steps, every = XLSTM_TRAIN["steps"], XLSTM_TRAIN["checkpoint_every"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with CheckpointTimer() as timer:
        trainer, state, cfg = launch_train.build_trainer("xlstm_125m", **kw)
        trainer.cfg.log_every = 1
        real_step, calls, saved = trainer.train_step, [0], {}

        def keep_middle(st, batch):  # the state after `every` steps, on the host
            new, metrics = real_step(st, batch)
            calls[0] += 1
            if calls[0] == every:
                saved["params"] = [t.detach().cpu().clone() for t in flatten(new.params)]
            return new, metrics

        trainer.train_step = keep_middle
        final = trainer.run(state)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        losses = [h["loss"] for h in trainer.history]
        secs = [h["sec"] for h in trainer.history]
        check(len(losses) == steps and all(np.isfinite(losses)), f"xlstm train losses {losses}")
        check(losses[-1] < losses[0], f"xlstm train loss did not fall: {losses}")
        check(latest_step(str(ckpt)) == steps, f"xlstm train: latest checkpoint {latest_step(str(ckpt))}")
        ckpt_bytes = sum(f.stat().st_size for f in (ckpt / f"step_{every:08d}").iterdir())
        del state

        trainer2, state2, _ = launch_train.build_trainer("xlstm_125m", **kw)
        resumed = trainer2.run(state2)
        check(trainer2.history == [], f"the resumed run took steps: {trainer2.history}")
        check(all(torch.equal(a, b) for a, b in zip(flatten(resumed), flatten(final), strict=True)),
              "xlstm resumed at its last step: state differs from the run's")
        del trainer2, state2, resumed

        shutil.rmtree(ckpt / f"step_{steps:08d}")
        trainer3, state3, _ = launch_train.build_trainer("xlstm_125m", **kw)
        timer.restored.clear()
        trainer3.cfg.log_every = 1
        real3, fails = trainer3.train_step, [0]

        def flaky(st, batch):
            if fails[0] == 0:
                fails[0] += 1
                raise RuntimeError("injected device failure")
            return real3(st, batch)

        trainer3.train_step = flaky
        trainer3.run(state3)
        check(fails[0] == 1 and latest_step(str(ckpt)) == steps, "xlstm: the injected fault was not retried to the end")
        check([r[1] for r in timer.restored] == [every, every] and timer.restored[0][2]["data_step"] == every,
              f"xlstm resume and retry restored steps {[r[1] for r in timer.restored]}, not {every} twice")
        check(all(torch.equal(a.cpu(), b) for a, b in zip(flatten(timer.restored[0][0][0]), saved["params"],
                                                          strict=True)),
              f"xlstm restored parameters at step {every} differ from the ones saved")
        timer.restored.clear()
        last = {h["step"]: h["loss"] for h in trainer3.history}
        rel = abs(last[steps - 1] - losses[-1]) / abs(losses[-1])
        check(rel <= RESUME_LOSS_TOL, f"xlstm resumed loss at step {steps - 1} {last[steps - 1]} vs {losses[-1]}")
    del final, trainer, trainer3, state3
    torch.cuda.empty_cache()
    p50 = float(np.percentile(secs, 50))
    tokens = XLSTM_TRAIN["global_batch"] * XLSTM_TRAIN["seq_len"]
    out = {"losses": losses, "step_s": secs, "step_s_p50": p50, "tok_per_s": tokens / p50, "peak_bytes": peak,
           "save_s": timer.save_s, "restore_s": timer.restore_s, "checkpoint_bytes": ckpt_bytes,
           "resumed_loss_rel": rel}
    print(f"train {cfg.name} (bf16, {XLSTM_TRAIN['global_batch']} x {XLSTM_TRAIN['seq_len']}, {steps} steps): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; step p50 {p50 * 1e3:.1f} ms (first {secs[0] * 1e3:.1f}), "
          f"{tokens / p50:.0f} tok/s; peak {peak / 2**30:.2f} GiB; checkpoint {ckpt_bytes / 2**30:.2f} GiB, save "
          f"{np.median(timer.save_s):.2f} s, restore {np.median(timer.restore_s):.2f} s (medians of "
          f"{len(timer.save_s)} / {len(timer.restore_s)}); resumed at {steps} bit-equal, at {every} bit-equal with "
          f"an injected fault retried, its step-{steps - 1} loss within {rel:.2e} [{card_line}]")
    return out


def yi_train_phase(dev: torch.device, card_line: str) -> dict:
    """Phase 17, step 5: yi-34b at its published widths, cut to YI_TRAIN's
    layers, trained a few steps at batch x sequence."""
    arch, layers, batch, seq, steps = YI_TRAIN
    cfg = get_config(arch).with_(n_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init_lm(0, cfg, device=dev)
    weights = sum(t.numel() for t in flatten(params))
    opt = AdamWConfig(total_steps=steps, warmup_steps=max(steps // 20, 5))  # as build_trainer sets it
    state = TrainState(params, adamw_init(opt, params))
    del params
    (_, _), grads = train_step_mod.value_and_grad(state.params, cfg, train_batch(cfg, batch, seq, 0, dev))
    attn = grads["groups"]["pos0"]["block"]
    for name in ("q", "k", "v", "o"):
        g = attn[name]["w"].float()
        check(bool(torch.isfinite(g).all()) and all(float(g[i].abs().max()) > 0 for i in range(g.shape[0])),
              f"{cfg.name} attention {name} gradients not finite or zero in a layer")
    del grads, attn, g
    step_fn = make_train_step(cfg, opt)
    losses, secs = [], []
    for i in range(steps):
        b = train_batch(cfg, batch, seq, i, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        losses.append(float(metrics["loss"]))
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(np.isfinite(losses)), f"{cfg.name} train losses {losses}")
    # one more step's two halves timed apart: forward and backward, AdamW
    b = train_batch(cfg, batch, seq, steps, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (_, _), grads = train_step_mod.value_and_grad(state.params, cfg, b)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(opt, state.params, grads, state.opt_state)
    torch.cuda.synchronize()
    split = {"forward_backward_s": t1 - t0, "adamw_s": time.perf_counter() - t1}
    del state, metrics, grads
    torch.cuda.empty_cache()
    out = {"arch": cfg.name, "layers": layers, "weights": weights, "losses": losses, "step_s": secs,
           "peak_bytes": peak, **split}
    print(f"train {cfg.name} {layers} layers (d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, bf16, {weights:,} weights), batch {batch} x {seq}: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; step times {', '.join(f'{x * 1e3:.1f}' for x in secs)} ms "
          f"(a fourth step's forward and backward {split['forward_backward_s'] * 1e3:.1f} ms, AdamW "
          f"{split['adamw_s'] * 1e3:.1f} ms); attention gradients finite and non-zero; peak {peak / 2**30:.2f} GiB "
          f"[{card_line}]")
    return out


def train_phase(dev: torch.device, card_line: str, work: Path, windows: dict) -> dict:
    """Phase 17: training on the card, in one launch window that must
    count no launch of any instantiation."""
    train_refusal(dev, card_line)
    gemm.reset_launches()  # the training window starts here
    summary = {"flash_backward": flash_backward_phase(dev, card_line),
               "smoke": smoke_train_phase(dev, card_line),
               "xlstm": xlstm_train_phase(dev, card_line, work),
               "yi": yi_train_phase(dev, card_line)}
    windows["training (no policy)"] = dict(gemm.LAUNCHES)  # read just after it
    check(not any(windows["training (no policy)"].values()),
          f"training launched the scheduled kernel: {windows['training (no policy)']}")
    return summary


# -- phase 19: the LM's multi-device layer on a DeviceMesh ----------------------

#: xlstm-125m through build_trainer, unsharded (phase 17's trainer) and on
#: the (1, 1) mesh of this card: same seed, batch, sequence and steps
SHARDED_TRAIN = dict(steps=3, global_batch=8, seq_len=128, checkpoint_every=3, seed=0)
#: deepseek-v2 at its published widths cut to 2 of 60 layers (as phase
#: 16): (arch, layers, batch, prompt, greedy steps)
SHARDED_SERVE = ("deepseek_v2_236b", 2, 4, 64, 8)
#: the dry-run cells, each on a fake process group in a subprocess:
#: (arch, shape, multi-pod)
DRYRUN_CELLS = (("yi_34b", "train_4k", False), ("mixtral_8x7b", "decode_32k", True),
                ("deepseek_v2_236b", "decode_32k", False), ("jamba_v0_1_52b", "long_500k", False))


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _on_card(tree, dev: torch.device) -> bool:
    return all(isinstance(t, DTensor) and t.device.type == dev.type for t in flatten(tree))


def sharded_train_phase(dev: torch.device, card_line: str, work: Path) -> dict:
    """Phase 19, step 1: xlstm-125m trained by ``build_trainer`` on the
    card's (1, 1) mesh, every state leaf a DTensor, against the same run
    unsharded: losses, final state and checkpoint bytes bit-equal, and a
    save and restore of the sharded state bit-equal.  Both run with
    deterministic algorithms (the embedding's backward otherwise sums
    with atomics)."""
    mesh = make_elastic_mesh(device_type=dev.type)
    check(tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model"), f"elastic mesh {mesh}")
    steps = SHARDED_TRAIN["steps"]
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for label, given in (("unsharded", (1, 1)), ("sharded", mesh)):
            ckpt = work / f"train19_{label}"
            shutil.rmtree(ckpt, ignore_errors=True)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            trainer, state, cfg = launch_train.build_trainer(
                "xlstm_125m", smoke=False, checkpoint_dir=str(ckpt), device=dev, mesh=given, **SHARDED_TRAIN)
            if label == "sharded":
                check(_on_card(state, dev), "sharded xlstm state: a leaf is not a DTensor on the card")
            trainer.cfg.log_every = 1
            final = trainer.run(state)
            torch.cuda.synchronize()
            manifest = json.loads((ckpt / f"step_{steps:08d}" / "manifest.json").read_text())
            runs[label] = {"losses": [h["loss"] for h in trainer.history], "secs": [h["sec"] for h in trainer.history],
                           "peak": torch.cuda.max_memory_allocated(dev), "final": final, "ckpt": ckpt,
                           "hashes": [leaf["sha256"] for leaf in manifest["leaves"]]}
            del trainer, state
    finally:
        torch.use_deterministic_algorithms(False)
    plain, shard = runs["unsharded"], runs["sharded"]
    check(len(shard["losses"]) == steps and shard["losses"] == plain["losses"],
          f"sharded xlstm losses {shard['losses']} != unsharded {plain['losses']}")
    check(_on_card(shard["final"], dev), "sharded xlstm final state: a leaf is not a DTensor on the card")
    differ = [i for i, (a, b) in enumerate(zip(flatten(shard["final"]), flatten(plain["final"]), strict=True))
              if not torch.equal(_whole(a).cpu(), b.cpu())]  # the unsharded step counter is on the host
    check(not differ, f"sharded xlstm final state differs from the unsharded run's at leaves {differ}")
    check(shard["hashes"] == plain["hashes"], "sharded xlstm checkpoint bytes differ from the unsharded run's")
    t0 = time.perf_counter()
    restored, step, _ = restore_checkpoint(str(shard["ckpt"]), tuple(shard["final"]))
    restore_s = time.perf_counter() - t0
    check(step == steps and _on_card(restored, dev), "sharded xlstm restore: not DTensors on the card")
    check(all(a.placements == b.placements and torch.equal(_whole(a), _whole(b))
              for a, b in zip(flatten(restored), flatten(tuple(shard["final"])), strict=True)),
          "sharded xlstm checkpoint did not round-trip bit-equal")
    del restored
    out = {}
    for label, r in runs.items():
        out[label] = {"losses": r["losses"], "step_s": r["secs"], "step_s_p50": float(np.percentile(r["secs"], 50)),
                      "peak_bytes": r["peak"]}
    out["restore_s"] = restore_s
    print(f"sharded train xlstm-125m (bf16, {SHARDED_TRAIN['global_batch']} x {SHARDED_TRAIN['seq_len']}, {steps} "
          f"steps) on the {tuple(mesh.shape)} {mesh.device_type} mesh: losses "
          f"{', '.join(f'{x:.4f}' for x in shard['losses'])} bit-equal to the unsharded trainer's, final state and "
          f"checkpoint sha256s equal, sharded restore bit-equal ({restore_s:.2f} s); step p50 sharded "
          f"{out['sharded']['step_s_p50'] * 1e3:.1f} ms vs unsharded {out['unsharded']['step_s_p50'] * 1e3:.1f} ms; "
          f"peak {shard['peak'] / 2**30:.2f} / {plain['peak'] / 2**30:.2f} GiB [{card_line}]")
    del runs, plain, shard
    torch.cuda.empty_cache()
    return out


def sharded_serve_phase(dev: torch.device, card_line: str) -> dict:
    """Phase 19, step 2: the dry run's prefill and decode (``lm.prefill`` /
    ``lm.decode_step``) for real on the card's (1, 1) mesh: deepseek-v2 at
    its published widths cut to SHARDED_SERVE's layers, parameters placed
    by ``param_specs`` and the MLA latent cache by ``cache_specs``; its
    greedy tokens must equal the unsharded engine's."""
    arch, layers, batch, prompt_len, new = SHARDED_SERVE
    cfg = get_config(arch).with_(n_layers=layers)
    mesh = make_elastic_mesh(device_type=dev.type)
    act_policy.install(mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init_lm(0, cfg, device=dev)
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, cfg.vocab, prompt_len).astype(np.int32) for _ in range(batch)]
    max_len = prompt_len + new
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ReproDeprecationWarning)
        engine = ServingEngine(cfg, params, ServeConfig(batch=batch, max_len=max_len, max_new_tokens=new))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = [r.output for r in sorted(engine.generate(prompts), key=lambda r: r.rid)]
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0

    dparams = shd.shard_tree(params, shd.param_specs(cfg, params, mesh), mesh)
    del params, engine
    rows = shd.placements(shd.batch_spec(mesh), mesh)
    got = [[] for _ in range(batch)]
    with torch.no_grad():  # DTensor views of the stacked cache cannot be inference tensors
        cache = lm.init_cache(cfg, batch, max_len, device=dev)
        cache = shd.shard_tree(cache, shd.cache_specs(cfg, cache, mesh), mesh)
        check(_on_card(cache["prefix"], dev) and _on_card(cache["groups"], dev), "deepseek cache: not DTensors")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = distribute_tensor(torch.from_numpy(np.stack(prompts)).to(dev), mesh, rows)
        logits, cache = lm.prefill(dparams, cfg, toks, cache)
        cur = torch.argmax(_whole(logits)[:, -1:], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        for _ in range(new):
            for i, t in enumerate(cur[:, 0].tolist()):
                got[i].append(t)
            logits, cache = lm.decode_step(dparams, cfg, cache, distribute_tensor(cur, mesh, rows))
            cur = torch.argmax(_whole(logits)[:, -1:], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        decode_s = (time.perf_counter() - t1) / new
    peak = torch.cuda.max_memory_allocated(dev)
    latent = cache["prefix"][0]["latent"]
    check(got == want, f"sharded deepseek tokens {got} != the unsharded engine's {want}")
    out = {"arch": cfg.name, "layers": layers, "batch": batch, "prompt": prompt_len, "new_tokens": new,
           "tokens_equal": True, "unsharded_generate_s": plain_s, "sharded_prefill_s": prefill_s,
           "sharded_decode_step_s": decode_s, "peak_bytes": peak, "latent_placements": str(latent.placements)}
    print(f"sharded serve {cfg.name} {layers} of 60 layers (MLA, {cfg.moe.n_experts} experts, bf16) on the "
          f"{tuple(mesh.shape)} mesh, latent cache {latent.placements}: {batch} x {prompt_len} prompts, {new} greedy "
          f"tokens equal to the unsharded engine's; sharded prefill {prefill_s * 1e3:.1f} ms, decode step "
          f"{decode_s * 1e3:.1f} ms (unsharded generate {plain_s * 1e3:.1f} ms); peak {peak / 2**30:.2f} GiB "
          f"[{card_line}]")
    del dparams, cache, logits
    act_policy.set_policy(None)
    torch.cuda.empty_cache()
    return out


_DRYRUN = r"""
import json, sys
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES
print("[dryrun] roofline constants: " + dryrun.CONSTANTS["source"] + "; card: " + sys.argv[2])
reports = {}
for arch, shape, multi in json.loads(sys.argv[1]):
    cell = next(c for c in SHAPES if c.name == shape)
    rep = dryrun.run_cell(arch, cell, multi, None)
    tag = f"{arch} x {shape} x {dryrun.mesh_name(multi)}"
    print(dryrun.summary(tag, rep), flush=True)
    reports[tag] = {k: rep[k] for k in ("n_chips", "memory", "flops_per_device", "bytes_per_device",
                                         "collective_bytes_per_device", "collectives", "compute_s", "memory_s",
                                         "collective_s", "dominant", "roofline_fraction", "build_s", "step_s",
                                         "wall_s")}
print("DRYRUN " + json.dumps(reports))
"""


def dryrun_phase(card_line: str) -> dict:
    """Phase 19, step 3: DRYRUN_CELLS on a fake process group (256 or 512
    ranks, meta tensors) in a subprocess that sees no card; every cell
    must run (the subprocess exits non-zero otherwise)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _DRYRUN, json.dumps(DRYRUN_CELLS), card_line],
                          capture_output=True, text=True, env=env, timeout=900)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.startswith("[dryrun]"):
            print(line)
    check(proc.returncode == 0, f"dry run failed: {proc.stderr[-3000:]}")
    reports = json.loads(next(ln for ln in proc.stdout.splitlines() if ln.startswith("DRYRUN "))[7:])
    check(len(reports) == len(DRYRUN_CELLS), f"dry run reported {sorted(reports)}")
    print(f"dry run: {len(reports)} cells OK in {wall:.1f} s (subprocess) [counts per rank on meta tensors over a fake process group; "
          f"roofline terms from the H100 SXM5 datasheet; {card_line}]")
    return {"cells": reports, "subprocess_s": wall}


def sharded_lm_phase(dev: torch.device, card_line: str, work: Path) -> dict:
    """Phase 19: the LM's multi-device layer: sharded training and serving
    on the card's (1, 1) NCCL mesh, and the dry-run cells."""
    return {"train": sharded_train_phase(dev, card_line, work),
            "serve": sharded_serve_phase(dev, card_line),
            "dryrun": dryrun_phase(card_line)}


# -- phase 18: the emulated-intrinsic route and the interpreter on the card -----

#: intrinsic calls per run of each zoo model at batch 1 on the emulated
#: route, the same in every mode: (gemmini, edge_npu), as the reference's
#: numpy emulation makes them (tests/test_torch_emulated.py holds both)
EMULATED_CALLS = {"qcnn": (64, 386), "toycar_mlp": (912, 3616), "mlp_tiny": (8, 32),
                  "transformer_block": (136, 1088)}
EMULATED_ACCELERATORS = ("gemmini", "edge_npu")
EMULATED_FEEDS = 2
EMULATED_SAMPLES = 5
INTERPRETED_SAMPLES = 3


def counted_description(acc: str):
    """A fresh ``acc`` description whose compute intrinsics count their calls."""
    desc = repro_torch.REGISTRY.get(acc)
    calls = [0]
    for intr in desc.intrinsics.values():
        if intr.kind == "compute":
            def wrapped(a, b, acc_tile, _fn=intr.fn):
                calls[0] += 1
                return _fn(a, b, acc_tile)

            intr.fn = wrapped
    return desc, calls


def with_intrinsic(acc: str, fn):
    desc = repro_torch.REGISTRY.get(acc)
    for intr in desc.intrinsics.values():
        if intr.kind == "compute":
            intr.fn = fn
    return desc


def emulated_target(acc, mode: str, where) -> repro_torch.Target:
    return repro_torch.Target(acc, mode=mode, device=str(where), use_pallas=False)


def to_cpu(*args, **kwargs) -> bool:
    """Whether ``Tensor.to(*args, **kwargs)`` moves the tensor to the CPU."""
    for v in (*args, kwargs.get("device")):
        if isinstance(v, torch.Tensor):
            v = v.device
        if isinstance(v, (str, torch.device)) and torch.device(v).type == "cpu":
            return True
    return False


class NoHostReads:
    """While active, reading a CUDA tensor on the host raises: ``cpu``,
    ``numpy``, ``item``, ``tolist``, ``to`` a CPU device and the implicit
    conversions (``bool``, ``int``, ``float``).  A check beside the sync
    debug mode, which torch calls a prototype that does not yet detect
    every synchronizing operation."""

    NAMES = ("cpu", "numpy", "item", "tolist", "to", "__bool__", "__int__", "__float__", "__index__")

    def __enter__(self):
        self._own = {name: torch.Tensor.__dict__.get(name) for name in self.NAMES}
        self._saved = {name: getattr(torch.Tensor, name) for name in self.NAMES}

        def guard(name, fn):
            def guarded(t, *a, **kw):
                if t.is_cuda and (name != "to" or to_cpu(*a, **kw)):
                    raise RuntimeError(f"host read of a CUDA tensor ({name}) inside a step")
                return fn(t, *a, **kw)
            return guarded

        for name, fn in self._saved.items():
            setattr(torch.Tensor, name, guard(name, fn))
        return self

    def __exit__(self, *exc):
        for name, own in self._own.items():
            if own is None:
                delattr(torch.Tensor, name)  # inherited from the C base class
            else:
                setattr(torch.Tensor, name, own)
        return False


def steps_without_host_copy(module, feeds: dict) -> list[np.ndarray]:
    """One run of ``module``'s plan with its feeds put on the card first and
    every step issued under ``torch.cuda.set_sync_debug_mode("error")`` and
    ``NoHostReads``: a step that copies to or from the host, or waits for
    the card, raises."""
    plan = module.plan
    arena = plan.new_arena()
    for name, slot in plan.input_slots:
        arena[slot] = to_tensor(feeds[name], plan.device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with NoHostReads():
            for step in plan.steps:
                arena[step.slot] = step.fn(*[arena[i] for i in step.arg_slots])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [to_numpy(arena[i]) for i in plan.output_slots]


def same_outputs(got, want) -> bool:
    return len(got) == len(want) and all(
        g.shape == w.shape and g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want))


def wall_p50_ms(fn, samples: int) -> float:
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(times, 50))


def custom_intrinsic_checks(dev: torch.device, card_line: str) -> dict:
    """A saturating intrinsic changes the answer as on the CPU (and its
    batched probe falls back), an in-place one stays stable, and smaller
    tile limits are refused at compile time; the deprecated two-step flow
    equals the front door on both routes."""
    from repro_torch.core.example_graphs import quantized_conv_dense_graph
    from repro_torch.core.intrinsics import int32_tile_product

    out = {}
    model = zoo.get_model("transformer_block")
    feeds = model.feeds(0, batch=2)
    sat_calls, plain_calls = [0], [0]

    def saturating(a, b, acc_tile):
        sat_calls[0] += 1
        return acc_tile + torch.clamp(int32_tile_product(a, b), -300, 300)

    def plain(a, b, acc_tile):
        plain_calls[0] += 1
        return acc_tile + int32_tile_product(a, b)

    sat = {where: repro_torch.compile(model.build(batch=2), emulated_target(
        with_intrinsic("gemmini", saturating), "optimized", where)) for where in (dev, "cpu")}
    mul_add = repro_torch.compile(model.build(batch=2), emulated_target(
        with_intrinsic("gemmini", plain), "optimized", dev))
    kernel = repro_torch.compile(model.build(batch=2), repro_torch.Target("gemmini", device=str(dev)))
    sat_calls[0] = plain_calls[0] = 0
    got = sat[dev].run(feeds)
    check(same_outputs(got, sat["cpu"].run(feeds)), "saturating intrinsic: cuda != cpu")
    on_card = sat_calls[0] // 2
    check(not np.array_equal(got[0], kernel.run(feeds)[0]), "saturating intrinsic: equals the kernel's answer")
    mul_add.run(feeds)
    check(on_card > plain_calls[0], f"saturating intrinsic: {on_card} calls, the multiply-add "
          f"{plain_calls[0]}: the batched probe did not fall back")
    out["saturating"] = {"calls_per_run": on_card, "multiply_add_calls_per_run": plain_calls[0],
                         "codes_changed": int((got[0] != kernel.run(feeds)[0]).sum())}

    def inplace(a, b, acc_tile):
        acc_tile.add_(int32_tile_product(a, b))
        return acc_tile

    mlp = zoo.get_model("mlp_tiny")
    ip = {where: repro_torch.compile(mlp.build(), emulated_target(
        with_intrinsic("edge_npu", inplace), "optimized", where)) for where in (dev, "cpu")}
    f = mlp.feeds(3)
    first = ip[dev].run(f)
    check(same_outputs(first, ip["cpu"].run(f)), "in-place intrinsic: cuda != cpu")
    for _ in range(3):
        check(same_outputs(ip[dev].run(f), first), "in-place intrinsic: repeated runs differ")
    check(same_outputs(ip[dev].run(f, use_plan=False), first), "in-place intrinsic: interpreted != planned")
    out["in_place_runs_equal"] = 5

    def shrunk(acc):
        desc = repro_torch.REGISTRY.get(acc)
        for intr in desc.intrinsics.values():
            if intr.kind == "compute":
                intr.tile_limits = {"N": 4, "C": 4, "K": 4}
        return desc

    try:
        repro_torch.compile(zoo.get_model("toycar_mlp").build(), emulated_target(shrunk("gemmini"), "optimized", dev))
    except ValueError as e:
        check("Eq.(1) violated upstream" in str(e), f"smaller tile limits: {e}")
        out["tensorize_refusal"] = str(e)
    else:
        check(False, "smaller tile limits: compiled")

    x = {"x": np.random.default_rng(1).integers(-128, 128, (1, 10, 10, 8)).astype(np.int8)}
    legacy = {}
    for use_pallas in (False, True):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            backend = repro_torch.integrate("gemmini", use_pallas=use_pallas)
            module = backend.compile(quantized_conv_dense_graph(), device=str(dev))
        n = sum(issubclass(w.category, ReproDeprecationWarning) for w in caught)
        check(n == 2, f"legacy surface (use_pallas={use_pallas}): {n} deprecation warnings, expected 2")
        front = repro_torch.compile(quantized_conv_dense_graph(), repro_torch.Target(
            "gemmini", device=str(dev), use_pallas=use_pallas))
        legacy[use_pallas] = module.run(x)
        check(same_outputs(legacy[use_pallas], front.run(x)),
              f"legacy surface (use_pallas={use_pallas}): integrate + compile != repro_torch.compile")
    out["legacy_routes_agree"] = same_outputs(legacy[False], legacy[True])
    print(f"emulated: saturating intrinsic on cuda equal to cpu, {out['saturating']['codes_changed']} codes "
          f"off the kernel's, {on_card} intrinsic calls per run (multiply-add {plain_calls[0]}: the batched "
          f"probe fell back); in-place intrinsic stable over 5 runs; smaller tile limits refused; "
          f"integrate + backend.compile warned twice and equal repro_torch.compile on both routes "
          f"(routes agree: {out['legacy_routes_agree']}) [{card_line}]")
    return out


def emulated_phase(dev: torch.device, compiled: dict, card_line: str, windows: dict) -> dict:
    """Phase 18: the 24 emulated modules (4 zoo models x gemmini, edge_npu x
    3 modes) on the card against the CPU and the kernel route, with the
    intrinsic calls per run, the interpreter, no kernel launch and no host
    copy in the emulated window; then the custom intrinsics and the
    legacy surface."""
    t_phase = time.perf_counter()
    modules = {}
    for name in EMULATED_CALLS:
        model = zoo.get_model(name)
        for acc in EMULATED_ACCELERATORS:
            for mode in MODES:
                desc, calls = counted_description(acc)
                cpu_desc, _ = counted_description(acc)
                kern = compiled.get((name, acc, mode, None), {}).get("cuda") or repro_torch.compile(
                    model.build(), repro_torch.Target(acc, mode=mode, device=str(dev)))
                modules[name, acc, mode] = {
                    "cuda": repro_torch.compile(model.build(), emulated_target(desc, mode, dev)),
                    "cpu": repro_torch.compile(model.build(), emulated_target(cpu_desc, mode, "cpu")),
                    "kernel": kern, "calls": calls,
                }
    summary = {}
    wants = {}
    for (name, acc, mode), mods in modules.items():
        feeds = [zoo.get_model(name).feeds(seed) for seed in range(EMULATED_FEEDS)]
        wants[name, acc, mode] = [mods["cpu"].run(f) for f in feeds]
    gemm.reset_launches()  # the emulated window starts here
    for (name, acc, mode), mods in modules.items():
        label = path_label(name, acc, mode, None)
        emu, calls = mods["cuda"], mods["calls"]
        check(not emu.backend.use_pallas, f"{label}: not on the emulated route")
        check(emu.modeled_cycles() == mods["cpu"].modeled_cycles() == mods["kernel"].modeled_cycles(),
              f"{label}: modeled cycles differ")
        feeds = [zoo.get_model(name).feeds(seed) for seed in range(EMULATED_FEEDS)]
        want = wants[name, acc, mode]
        expected = EMULATED_CALLS[name][acc == "edge_npu"]
        for f, w in zip(feeds, want):
            calls[0] = 0
            check(same_outputs(emu.run(f), w), f"{label}: emulated cuda != cpu")
            check(calls[0] == expected, f"{label}: {calls[0]} intrinsic calls per run, expected {expected}")
            calls[0] = 0
            check(same_outputs(emu.run(f, use_plan=False), w), f"{label}: interpreted != cpu")
            check(calls[0] == expected, f"{label}: interpreted: {calls[0]} intrinsic calls per run")
        for got, w in zip(emu.run_many(feeds) + emu.run_many(feeds, use_plan=False), want + want):
            check(same_outputs(got, w), f"{label}: run_many != cpu")
        check(same_outputs(steps_without_host_copy(emu, feeds[0]), want[0]),
              f"{label}: steps under the sync check != cpu")
        summary[label] = {
            "intrinsic_calls_per_run": expected,
            "emulated_run_ms_p50": wall_p50_ms(lambda: emu.run(feeds[0]), EMULATED_SAMPLES),
            "interpreted_run_ms_p50": wall_p50_ms(lambda: emu.run(feeds[0], use_plan=False),
                                                  INTERPRETED_SAMPLES),
        }
    windows["emulated route"] = dict(gemm.LAUNCHES)  # read just after it
    check(not any(windows["emulated route"].values()),
          f"the emulated route launched the kernel: {windows['emulated route']}")
    for (name, acc, mode), mods in modules.items():
        label = path_label(name, acc, mode, None)
        feeds = [zoo.get_model(name).feeds(seed) for seed in range(EMULATED_FEEDS)]
        for f, w in zip(feeds, wants[name, acc, mode]):
            check(same_outputs(mods["kernel"].run(f), w), f"{label}: emulated != kernel route")
        summary[label]["kernel_run_ms_p50"] = wall_p50_ms(lambda: mods["kernel"].run(feeds[0]), EMULATED_SAMPLES)
        s_ = summary[label]
        print(f"emulated {label}: bit-equal to cpu and to the kernel route, {s_['intrinsic_calls_per_run']} "
              f"intrinsic calls per run, no host copy in its steps; run p50 emulated "
              f"{s_['emulated_run_ms_p50']:.3f} ms, interpreted {s_['interpreted_run_ms_p50']:.3f} ms, "
              f"kernel route {s_['kernel_run_ms_p50']:.3f} ms [{card_line}]")
    custom = custom_intrinsic_checks(dev, card_line)
    seconds = time.perf_counter() - t_phase
    print(f"emulated route: {len(summary)} modules on {dev.type}, 0 kernel launches in its window, "
          f"phase time {seconds:.1f} s [{card_line}]")
    return {"modules": summary, "custom": custom, "seconds": seconds}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="drive the port on one NVIDIA card")
    ap.add_argument("--report", help="also write everything measured to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False: this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    # schedule caches and artifacts live in the checkout, made afresh
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    os.environ["REPRO_TORCH_CACHE_DIR"] = str(work / "schedule_cache")
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
    decode_compiled = compile_decode_paths(dev)
    case_modules.update({decode_label(*key): mods["cpu"] for key, mods in decode_compiled.items()})
    sharded_compiled = compile_sharded_paths(dev)
    case_modules.update(sharded_shards({label: c[0] for label, c in sharded_compiled.items()}))
    tpu_compiled = compile_tpu_paths(dev)
    case_modules.update({path_label(*key): mods["cpu"] for key, mods in tpu_compiled.items()})
    case_modules.update(sharded_shards(sharded_serve_modules()))
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
    emulated = emulated_phase(dev, compiled, card_line, windows)  # phase 18: sets the counts to 0 first
    served = serve_phase(dev, cases, card_line, windows)
    measured = measured_dse_phase(dev, card_line, work, windows)
    artifact = artifact_phase(dev, card_line, work, windows)
    pipelined = pipelined_phase(compiled, card_line, windows)
    host_gemm_refused(dev)
    gemm.reset_launches()  # the decode modules' runs start here
    decode_paths = decode_modules_phase(decode_compiled, cases, card_line)
    windows["decode modules"] = dict(gemm.LAUNCHES)  # read just after them
    decode_served = decode_serve_phase(dev, cases, card_line, windows)
    decode_checks = decode_bounds_and_artifact(dev, work, card_line)
    gate = verify_gate_phase(dev, card_line)
    frontend = frontend_phase(dev, card_line, windows)  # sets the counts to 0 before its runs
    sharded = sharded_phase(dev, sharded_compiled, cases, card_line, work, windows)  # likewise
    tpu = tpu_v5e_phase(tpu_compiled, cases, card_line, windows)  # phase 16, step 1
    host_ops = host_ops_phase(dev, card_line)
    lm_run = lm_phase(dev, card_line, windows)  # sets the counts to 0 before each LM window
    full_width = full_width_phase(dev, card_line, windows)  # phase 16: likewise, after codeqwen is freed
    training = train_phase(dev, card_line, work, windows)  # phase 17, after phase 16's models are freed
    gemm.reset_launches()  # phase 19's window starts here
    sharded_lm = sharded_lm_phase(dev, card_line, work)
    windows["sharded LM and dry run (no policy)"] = dict(gemm.LAUNCHES)  # read just after it
    check(not any(windows["sharded LM and dry run (no policy)"].values()),
          f"phase 19 launched the scheduled kernel: {windows['sharded LM and dry run (no policy)']}")
    lm_cases = lm_run["cases"] + full_width["cases"]
    for window, counts in windows.items():
        print(f"launch window {window}: {counts}")
    both = ("qgemm_requant", "gemm_int32")
    path_kernels = {"toycar_mlp@gemmini": both, "new paths": both, "measured DSE compiles": both,
                    "artifact module": ("qgemm_requant",), "pipelined": both, "decode modules": both,
                    f"serve {DECODE.name}@{DECODE_SERVE[0]} --batch {DECODE_SLOTS}": both,
                    f"sequential {DECODE.name}@{DECODE_SERVE[0]}": both,
                    "frontend": both, "sharded modules": both,
                    f"serve {SHARD_SERVE[0]}@{SHARD_SERVE[1]} --batch {SHARD_SERVE[2]} --devices {SHARD_SERVE[4]}":
                        ("qgemm_requant",),
                    "LM served routed": ("gemm_float",), "LM smoke archs": ("gemm_float",),
                    "tpu_v5e modules": both, "LM jamba routed": ("gemm_float",),
                    "LM deepseek routed": ("gemm_float",), "LM xlstm routed": ("gemm_float",)}
    for window, names in path_kernels.items():
        for name in names:
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
                                                    if c["variant"] == name]
                               + [c["max_abs_err"] for c in lm_cases if name == "gemm_float"]),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "eager_ms": r["eager_ms"],
            "launch_floor_ms": r["launch_floor_ms"],
            "cluster8_floor_ms": r["cluster8_floor_ms"],
            "layer_ms": r["layer_ms"],
            "shapes": "toycar_mlp batch 16, 8 layers, summed; every path case and LM case in the report",
            "path_cases": sum(c["variant"] == name for c in cases.values()),
            "lm_cases": len(lm_cases) if name == "gemm_float" else 0,
        }
        for name, r in kernels.items()
    ]}
    path_cases = [
        {"variant": c["variant"], "shape": f"{c['m']}x{c['k']}x{c['n']}",
         "blocks": f"{c['blocks']} {c['dataflow']}",
         **{k: c[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")},
         **({"attention": True} if c["attention"] else {})}
        for c in cases.values()
    ]
    report = {"card": card_line, "build_s": build_s, "main_path": summary, "paths": paths,
              "serve": served, "measured_dse": measured, "artifact": artifact, "pipelined": pipelined,
              "decode_paths": decode_paths, "decode_serve": decode_served, "decode_checks": decode_checks,
              "verify_gate": gate, "host_ops": host_ops, "lm": lm_run, "launch_windows": windows,
              "frontend": frontend, "sharded": sharded, "tpu_v5e": tpu, "full_width": full_width,
              "training": training, "emulated": emulated, "sharded_lm": sharded_lm, "path_cases": path_cases}
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps({**report, **line}, indent=1))
    # the per-path summaries are long and printed above, path by path
    long = ("paths", "measured_dse", "pipelined", "decode_paths", "path_cases", "lm", "frontend", "sharded",
            "tpu_v5e", "full_width", "training", "emulated", "sharded_lm")
    print(json.dumps({k: v for k, v in report.items() if k not in long}))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
