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

    # an LM (random weights from seed 0) through the wave-based engine;
    # --smoke serves the arch's reduced config
    PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1_5_7b \
        --smoke --device cpu

Port of ``repro.launch.serve``: ``serve_zoo``, ``serve_decode`` and
``serve_lm``, and the CLI with ``--zoo`` (``--artifact`` /
``--save-artifact`` for zoo serving, ``--prompt-len`` / ``--new-tokens``
for decode serving) and ``--arch`` / ``--smoke`` (LM serving, with the
same ``--prompt-len`` / ``--new-tokens``).  Each function also returns
what it served (``ZooServeResult``, ``DecodeServeResult``,
``LMServeResult``), so a caller can check the responses.  As in the
reference, ``serve_lm`` installs no kernel policy.  ``--devices N``
serves a zoo model through sharded plans on a ``(data, model)`` mesh, all
of whose shards run on ``--device``.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

import repro_torch
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.batching import BatchedModule
from repro_torch.core.zoo import ZOO, decode_model_names, get_decode_model, get_model, model_names
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.serve import (
    BatchStats,
    ContinuousBatchingEngine,
    EngineConfig,
    MicroBatcher,
    Request,
    ServeConfig,
    ServeReport,
    ServingEngine,
    random_requests,
)


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
        args.target,
        batch_size=args.batch,
        device=getattr(args, "device", "cuda"),
        devices=getattr(args, "devices", 1),
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
    mesh_note = ""
    if target.devices > 1:
        dp, mp = target.resolved_mesh
        mesh_note = f" on a (data={dp}, model={mp}) mesh"
    print(
        f"[serve] {model.name} on {target.describe()}: {boot_how} "
        f"{len(buckets)} bucket plans {list(buckets)}{mesh_note} in "
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


@dataclass
class LMServeResult:
    """What one ``serve_lm`` call served: the config, every request with
    its generated tokens, and the wall time of ``generate``."""

    cfg: ModelConfig
    requests: list[Request]
    wall_s: float

    @property
    def tokens_per_s(self) -> float:
        return sum(len(r.output) for r in self.requests) / max(self.wall_s, 1e-9)


def serve_lm(args) -> LMServeResult:
    """Serve an LM arch (its published config, or ``--smoke``'s reduced
    one) with random weights from seed 0 through ``ServingEngine``:
    ``--requests`` prompts of ``--prompt-len`` random tokens, in waves of
    ``--batch``, ``--new-tokens`` greedy tokens each."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.frontend:
        raise SystemExit(f"{cfg.name} needs frontend embeddings; use a text arch for the demo")
    params = lm.init_lm(0, cfg, device=getattr(args, "device", "cuda"))
    engine = ServingEngine(
        cfg,
        params,
        ServeConfig(
            batch=args.batch,
            max_len=args.prompt_len + args.new_tokens + 1,
            max_new_tokens=args.new_tokens,
        ),
    )
    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(0, cfg.vocab, size=(args.prompt_len,)).astype(np.int32)
        for _ in range(args.requests)
    ]
    t0 = time.perf_counter()
    done = engine.generate(prompts)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    result = LMServeResult(cfg=cfg, requests=done, wall_s=time.perf_counter() - t0)
    total_tokens = sum(len(r.output) for r in done)
    print(
        f"[serve] {cfg.name} on {engine.device}: {len(done)} requests, {total_tokens} "
        f"tokens in {result.wall_s:.2f}s ({result.tokens_per_s:.1f} tok/s)"
    )
    print("[serve] sample output:", done[0].output[:16])
    return result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="serve a zoo model on an accelerator target through a "
        "micro-batching queue, or an LM arch through the wave-based engine",
    )
    ap.add_argument("--zoo", help="zoo model to serve on an accelerator target")
    ap.add_argument("--arch", help="LM architecture to serve (repro_torch.configs)")
    ap.add_argument(
        "--smoke", action="store_true", help="--arch: serve the arch's reduced smoke config"
    )
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
        help="torch device the compiled module (or the LM) runs on: cuda "
        "(default, the card) or cpu (the kernels' plain versions)",
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
        help="decode zoo: static prefill length (prompts up to this many "
        "rows); --arch: prompt length",
    )
    ap.add_argument(
        "--new-tokens",
        type=int,
        default=16,
        help="decode zoo and --arch: tokens generated per request",
    )
    ap.add_argument(
        "--devices",
        type=int,
        default=1,
        help="mesh size for --zoo: compile one ExecutionPlan per shard of "
        "a (data, model) mesh and serve through the sharded executor "
        "(every shard on --device)",
    )
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if bool(args.zoo) == bool(args.arch):
        raise SystemExit(
            "pass --zoo <model> (a zoo model to serve) or --arch <arch> (an LM), "
            "exactly one of them"
        )
    if args.requests < 1:
        raise SystemExit("--requests must be >= 1")
    if args.batch < 1:
        raise SystemExit("--batch must be >= 1")
    if args.devices != 1 and (args.arch or args.zoo in decode_model_names()):
        raise SystemExit(
            "--devices shards a batched zoo model; stateful decode graphs and "
            "LM archs cannot be shard-partitioned (serve them with --devices 1)"
        )
    if args.arch:
        serve_lm(args)
        return
    if args.zoo not in ZOO and args.zoo not in decode_model_names():
        raise SystemExit(
            f"unknown zoo model {args.zoo!r}; available: "
            f"{', '.join(model_names() + decode_model_names())}"
        )
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
