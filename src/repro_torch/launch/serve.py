"""Accelerator-compiled zoo-model serving through the ``repro_torch.compile``
front door, with a micro-batching request queue.

    # on the card (the default device)
    python -m repro_torch.launch.serve --zoo toycar_mlp \
        --target gemmini:optimized --requests 256 --batch 16

    # on the CPU, with the kernels' plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve --zoo transformer_block \
        --target gemmini:optimized --batch 16 --device cpu

    # compile once and save the batched module; boot replicas from it with
    # no compile, no DSE and no pass pipeline
    python -m repro_torch.launch.serve --zoo toycar_mlp --batch 64 \
        --save-artifact toycar.art
    python -m repro_torch.launch.serve --zoo toycar_mlp --batch 64 \
        --artifact toycar.art

    # a decode-zoo model through the continuous-batching engine: --batch
    # decode slots, prompts up to --prompt-len rows, --new-tokens each
    python -m repro_torch.launch.serve --zoo attn_decode --batch 8 \
        --requests 64 --prompt-len 32 --new-tokens 16

Port of ``repro.launch.serve``: ``serve_zoo`` and ``serve_decode``, and
the ``--zoo`` CLI with ``--artifact`` / ``--save-artifact`` (zoo serving)
and ``--prompt-len`` / ``--new-tokens`` (decode serving).  Both functions
also return what they served (``ZooServeResult``, ``DecodeServeResult``),
so a caller can check the responses.  Sharded serving (``--devices``) and
LM serving (``--arch``) are not ported yet, and the CLI refuses them.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np

import repro_torch
from repro_torch.core.batching import BatchedModule
from repro_torch.core.zoo import ZOO, decode_model_names, get_decode_model, get_model, model_names
from repro_torch.serve import (
    BatchStats,
    ContinuousBatchingEngine,
    EngineConfig,
    MicroBatcher,
    ServeReport,
    random_requests,
)

#: reference flags whose serving paths the port does not have yet
_NOT_PORTED = {
    "arch": "--arch (LM serving)",
    "devices": "--devices (sharded serving)",
}


def _percentile(samples: list[float], pct: float) -> float:
    return float(np.percentile(np.asarray(samples), pct)) if samples else 0.0


@dataclass
class ZooServeResult:
    """What one ``serve_zoo`` call served: the module, the per-sample
    request feeds in submit order, each request's outputs, its latency
    (submit to result), the window's wall time and the dispatch stats."""

    module: BatchedModule
    target: repro_torch.Target
    traffic: list[dict[str, np.ndarray]]
    outputs: list[list[np.ndarray]]
    latencies_s: list[float]
    wall_s: float
    boot_s: float
    #: "compiled" or "loaded artifact"
    boot_how: str
    stats: BatchStats


def serve_zoo(args) -> ZooServeResult:
    """Serve a model-zoo network on an accelerator target: ONE batched
    ``repro_torch.compile`` call (one ExecutionPlan per batch bucket), then
    a micro-batching queue that collects up to ``--batch`` requests (or a
    deadline) and dispatches each batch as one bucketed execution."""
    model = get_model(args.zoo)
    target = repro_torch.Target.parse(
        args.target, batch_size=args.batch, device=getattr(args, "device", "cuda")
    )
    artifact = getattr(args, "artifact", None)
    if artifact:
        # AOT boot: restore the batched module from a saved artifact — no
        # compile, no DSE, no pass pipeline at startup
        t0 = time.perf_counter()
        module = repro_torch.load(artifact, device=target.device)
        t_boot = time.perf_counter() - t0
        if not isinstance(module, BatchedModule):
            raise SystemExit(
                f"--artifact {artifact} holds a single-shape module; the "
                f"serving loop needs a batched artifact (save a module "
                f"compiled with batch_buckets / Target(batch_size=...))"
            )
        boot_how = "loaded artifact"
    else:
        # batch_size=1 compiles the classic single-shape module; the
        # serving loop always wants the batched surface, so pin an
        # explicit unit bucket
        options = (
            repro_torch.CompileOptions(batch_buckets=(1,)) if args.batch <= 1 else None
        )
        t0 = time.perf_counter()
        module = repro_torch.compile(args.zoo, target, options=options)
        t_boot = time.perf_counter() - t0
        boot_how = "compiled"
    buckets = module.bucket_sizes()
    if getattr(args, "save_artifact", None):
        repro_torch.save(module, args.save_artifact)
        print(f"[serve] saved compile artifact to {args.save_artifact}")

    # warmup: run every bucket once (full chunks, so each bucket's plan is
    # touched) — the measured window never pays first-call costs, and a
    # fast target with few requests cannot end up timing an empty window
    for b in buckets:
        module.run_many([model.feeds(seed=0)] * b)

    traffic = [model.feeds(seed=s) for s in range(args.requests)]
    latencies: list[float] = []
    t0 = time.perf_counter()
    with MicroBatcher(
        module, max_batch=args.batch, max_delay_s=args.deadline_ms / 1e3
    ) as mb:
        pending = [(time.perf_counter(), mb.submit(feeds)) for feeds in traffic]
        outs = []
        for t_submit, fut in pending:
            outs.append(fut.result())
            latencies.append(time.perf_counter() - t_submit)
        stats = mb.stats
    dt = max(time.perf_counter() - t0, 1e-9)  # guard: never divide by zero

    n = max(len(outs), 1)
    cycles = module.modeled_cycles()  # largest bucket's plan
    print(
        f"[serve] {model.name} on {target.describe()}: {boot_how} "
        f"{len(buckets)} bucket plans {list(buckets)} in "
        f"{t_boot * 1e3:.1f} ms (cold start)"
    )
    print(
        f"[serve] {n} requests in {dt:.3f}s ({n / dt:.0f} req/s); latency "
        f"p50 {_percentile(latencies, 50) * 1e6:.1f} us / "
        f"p99 {_percentile(latencies, 99) * 1e6:.1f} us; "
        f"{stats.batches} dispatches, mean batch {stats.mean_batch():.1f}"
    )
    print(
        f"[serve] modeled cycles/request at batch {buckets[-1]}: "
        f"{cycles['total'] / buckets[-1]:,.0f} "
        f"(accel {cycles['accel'] / buckets[-1]:,.0f} / "
        f"host {cycles['host'] / buckets[-1]:,.0f} / "
        f"comm {cycles.get('comm', 0.0) / buckets[-1]:,.0f})"
    )
    if outs:
        print(f"[serve] sample output: {np.asarray(outs[0][0]).ravel()[:8]}")
    return ZooServeResult(
        module=module,
        target=target,
        traffic=traffic,
        outputs=outs,
        latencies_s=latencies,
        wall_s=dt,
        boot_s=t_boot,
        boot_how=boot_how,
        stats=stats,
    )


@dataclass
class DecodeServeResult:
    """What one ``serve_decode`` call served: the engine (its two compiled
    modules and its block pool), the target, the report (every request
    with its tokens and vectors) and the engine's compile time."""

    engine: ContinuousBatchingEngine
    target: repro_torch.Target
    report: ServeReport
    boot_s: float


def serve_decode(args) -> DecodeServeResult:
    """Serve a decode-zoo model through the continuous-batching engine:
    two compiled ExecutionPlans (prefill + batched decode step) over a
    block-based KV pool, finished slots backfilled from the queue."""
    model = get_decode_model(args.zoo)
    target = repro_torch.Target.parse(args.target, device=getattr(args, "device", "cuda"))
    prompt_len = min(args.prompt_len, model.max_len - args.new_tokens)
    if prompt_len < 1:
        raise SystemExit(
            f"--new-tokens {args.new_tokens} leaves no room for a prompt "
            f"inside the {model.max_len}-row KV cache"
        )
    cfg = EngineConfig(
        batch=args.batch,
        prompt_len=prompt_len,
        max_new_tokens=args.new_tokens,
    )
    t0 = time.perf_counter()
    engine = ContinuousBatchingEngine(model, target, cfg)
    t_boot = time.perf_counter() - t0
    requests = random_requests(model, args.requests, cfg.prompt_len, seed=0)
    report = engine.run(requests)
    print(
        f"[serve] {model.name} on {target.describe()}: continuous batching, "
        f"{cfg.batch} decode slots, compiled prefill+decode plans in "
        f"{t_boot * 1e3:.1f} ms (cold start)"
    )
    print(
        f"[serve] {len(report.requests)} requests, {report.total_new_tokens} tokens "
        f"in {report.wall_s:.3f}s ({report.tokens_per_s:.0f} tok/s); "
        f"{report.decode_steps} decode steps, {report.prefills} prefills"
    )
    print(
        f"[serve] block pool: {report.n_blocks} blocks x {report.block_size} "
        f"rows, peak occupancy {report.peak_occupancy:.1%}"
    )
    print("[serve] sample tokens:", requests[0].tokens[:8])
    return DecodeServeResult(engine=engine, target=target, report=report, boot_s=t_boot)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="serve a zoo model on an accelerator target through a "
        "micro-batching queue",
    )
    ap.add_argument("--zoo", help="zoo model to serve on an accelerator target")
    ap.add_argument(
        "--target",
        default="gemmini:optimized",
        help="accelerator[:mode] (Target.parse syntax)",
    )
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument(
        "--deadline-ms",
        type=float,
        default=2.0,
        help="micro-batching deadline: max wait after the oldest queued "
        "request before dispatching a partial batch",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device the compiled module runs on: cuda (default, the "
        "card) or cpu (the kernels' plain versions)",
    )
    ap.add_argument(
        "--artifact",
        help="boot from a batched compile artifact (repro_torch.save) "
        "instead of compiling",
    )
    ap.add_argument(
        "--save-artifact",
        help="save the served batched module as a compile artifact here",
    )
    ap.add_argument(
        "--prompt-len",
        type=int,
        default=32,
        help="decode zoo: static prefill length (prompts up to this many rows)",
    )
    ap.add_argument(
        "--new-tokens",
        type=int,
        default=16,
        help="decode zoo: tokens generated per request",
    )
    ap.add_argument("--arch", help=argparse.SUPPRESS)
    ap.add_argument("--devices", type=int, help=argparse.SUPPRESS)
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    refused = [what for dest, what in _NOT_PORTED.items() if getattr(args, dest) is not None]
    if refused:
        raise SystemExit(
            f"not available in repro_torch yet: {', '.join(refused)}; "
            f"only --zoo serving of the model zoo and the decode zoo is ported"
        )
    if not args.zoo:
        raise SystemExit("pass --zoo <model> (a zoo model to serve)")
    if args.zoo not in ZOO and args.zoo not in decode_model_names():
        raise SystemExit(
            f"unknown zoo model {args.zoo!r}; available: "
            f"{', '.join(model_names() + decode_model_names())}"
        )
    if args.requests < 1:
        raise SystemExit("--requests must be >= 1")
    if args.batch < 1:
        raise SystemExit("--batch must be >= 1")
    if args.zoo in decode_model_names():
        if args.artifact or args.save_artifact:
            raise SystemExit(
                "--artifact / --save-artifact boot batched zoo serving; the decode "
                "zoo compiles its prefill and decode plans inside the engine"
            )
        serve_decode(args)
    else:
        serve_zoo(args)


if __name__ == "__main__":
    main()
