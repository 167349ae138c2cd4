"""Multi-pod dry run: run every (arch x shape x mesh) cell's step on a
fake process group.

This is the proof that the distribution config is coherent without the
hardware: the train step, ``lm.prefill`` or ``lm.decode_step`` of each
cell must run on the 16x16 single-pod mesh AND the 2x16x16 multi-pod
mesh, every parameter, optimizer moment, cache and input placed as a
DTensor by the sharding rules.  The process group is PyTorch's fake one
(``torch.distributed`` backend ``"fake"``, 256 or 512 ranks in this one
process, rank 0's view), and every tensor is a meta tensor: shapes and
dtypes without storage, so a 236 B-parameter model "fits" on any host,
and a local op costs microseconds.  A step that runs proves the specs are coherent, as the
reference's ``compile()`` does.

Port of ``repro.launch.dryrun``, with the reference's CLI and its
``cell_config``, ``input_specs``, ``build_cell``, ``run_cell`` and
``main``.  Each cell's report (one JSON per cell in ``--out``) has the
reference's keys where a counterpart exists, all of them counts per
rank (rank 0), not device measurements:

* ``memory.argument_bytes``: the exact sum of the local shard bytes of
  the step's arguments (a cache's ``len`` counts as the reference's int32
  scalar); ``memory.peak_bytes``: the most bytes live at once during the
  step, arguments included, from a dispatch-mode tally of the (meta)
  storages the local ops create and free;
* ``flops_per_device``: the local ops' FLOPs (``torch.utils.flop_counter``'s
  formulas on the shapes each rank computes); ``bytes_per_device``: the
  bytes each non-view local op reads and writes;
* ``collectives``: the bytes each kind of collective returns to the rank
  (the ``_c10d_functional`` ops DTensor issues), summed;
* ``compute_s``, ``memory_s``, ``collective_s``, ``dominant``,
  ``model_flops_per_device``, ``useful_flops_ratio`` and
  ``roofline_fraction``, as the reference reckons them; the wall time of
  the build and of the step.

The eager step replays every loop iteration (layers, attention chunk
pairs, recurrent steps), so the counts cover the whole step.  The
reference's scan-body probe (``build_body_probe``, which charges the
scan iterations XLA's cost analysis counts once) and its HLO parser
(``collective_bytes``) have no counterpart: there is no HLO and no scan.

The roofline constants are an NVIDIA H100 SXM5's, from NVIDIA's
datasheet (dense bf16 tensor-core FLOP/s at the 700 W limit, HBM3
bytes/s, NVLink 4 bytes/s in one direction); they are not measured.  The
model axis is 16 wide, and an NVLink domain (one HGX board) holds 8
GPUs: half of every model-axis collective crosses the network between
boards, so one NVLink constant flatters ``collective_s``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_34b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --jobs 8 --cell-timeout 2400

``--jobs N`` runs each cell in its own process, N at a time (longest
first), stops a cell after ``--cell-timeout`` seconds, and writes
``sweep.json`` beside the reports.

Shape-cell semantics: ``train_4k`` runs the train step, ``prefill_32k``
the prefill, ``decode_*``/``long_*`` one decode step against a cache
filled to its last position; long_500k runs only for the SSM/hybrid
archs.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import time
import traceback
import weakref
from typing import NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ShapeCell, shapes_for
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import policy
from repro_torch.parallel import sharding as shd
from repro_torch.train.step import TrainState, make_train_step
from repro_torch.tree import flatten, tree_map

# ---------------------------------------------------------------------------
# roofline constants: NVIDIA H100 SXM5 datasheet (not measured)
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s per GPU, at 700 W
HBM_BW = 3.35e12  # HBM3 bytes/s per GPU
LINK_BW = 450e9  # NVLink 4: 900 GB/s per GPU over both directions, 450 GB/s each way
CONSTANTS = {
    "source": "NVIDIA H100 SXM5 datasheet (not measured)",
    "peak_flops_bf16_dense": PEAK_FLOPS,
    "hbm_bytes_per_s": HBM_BW,
    "nvlink_bytes_per_s_one_direction": LINK_BW,
    "note": "a 16-wide model axis spans two 8-GPU NVLink domains; "
    "collective_s at the NVLink rate flatters it",
}

DEFAULT_OUT = "experiments/dryrun_torch"


class Sds(NamedTuple):
    """A shape and a dtype: an input without its values."""

    shape: tuple[int, ...]
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def cell_config(arch: str, cell: ShapeCell, base: ModelConfig | None = None) -> ModelConfig:
    """The cell's config: ``arch``'s published one (or ``base``), with the
    int8 KV cache in the decode cells."""
    cfg = base if base is not None else get_config(arch)
    if cell.kind == "decode" and not cfg.kv_lora_rank:
        # int8-quantized KV for the big decode cells (MLA latents stay bf16)
        cfg = cfg.with_(kv_cache_dtype="int8")
    return cfg


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    b, s = cell.global_batch, cell.seq_len
    nf = cfg.n_frontend_tokens if cfg.frontend else 0
    s_text = s - nf
    if cell.kind == "train":
        batch = {
            "inputs": Sds((b, s_text), torch.int32),
            "targets": Sds((b, s_text), torch.int32),
        }
        if nf:
            batch["frontend"] = Sds((b, nf, cfg.d_model), torch.bfloat16)
        return {"batch": batch}
    if cell.kind == "prefill":
        batch = {"inputs": Sds((b, s_text), torch.int32)}
        if nf:
            batch["frontend"] = Sds((b, nf, cfg.d_model), torch.bfloat16)
        return {"batch": batch}
    # decode: one token against a cache of length s
    return {"token": Sds((b, 1), torch.int32)}


def _place(sds: Sds, spec, mesh):
    """A value-less (meta) tensor of ``sds`` placed on ``mesh`` by ``spec``."""
    return shd.shard_tree(torch.empty(sds.shape, dtype=sds.dtype, device="meta"), spec, mesh)


def _abstract_params(cfg: ModelConfig):
    """``init_lm``'s tree for ``cfg`` as meta tensors (shapes and dtypes,
    no storage; drawn under ``FakeTensorMode``, which draws nothing)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = lm.init_lm(0, cfg, device="cpu")
    return tree_map(lambda t: torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta"), fake)


def build_cell(
    arch: str,
    cell: ShapeCell,
    mesh,
    *,
    block_skip: bool = False,
    attn_chunk: int | None = None,
    boundary: str = "seq",
    capacity_factor: float | None = None,
    base: ModelConfig | None = None,
):
    """(step function, its arguments, config), the arguments meta tensors
    (no storage) placed on ``mesh``.

    The keyword knobs are the reference's hillclimb variants: causal
    KV-chunk skipping, attention chunk size, the layer-boundary sharding
    mode, and the MoE capacity factor.  ``base`` replaces the published
    config (a reduced one, for tests).
    """
    policy.install(mesh, boundary=boundary)
    cfg = cell_config(arch, cell, base)
    if attn_chunk:
        cfg = cfg.with_(attn_chunk=attn_chunk)
    if capacity_factor and cfg.moe:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
    b = cell.global_batch
    dp = tuple(shd.dp_axes(mesh))

    params = _abstract_params(cfg)
    pspecs = shd.param_specs(cfg, params, mesh)
    dparams = shd.shard_tree(params, pspecs, mesh)
    specs = input_specs(cfg, cell)

    if cell.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype="float32")
        opt = adamw_init(opt_cfg, params)
        ospecs = shd.opt_state_specs(cfg, opt, pspecs)
        # the step counter stays the host scalar AdamW reads on the host
        dopt = {k: shd.shard_tree(opt[k], ospecs[k], mesh) for k in ("m", "v")} | {"step": opt["step"]}
        batch = {k: _place(v, shd.P(dp, *(None,) * (len(v.shape) - 1)), mesh) for k, v in specs["batch"].items()}
        step = make_train_step(cfg, opt_cfg, block_skip=block_skip)
        return step, (TrainState(dparams, dopt), batch), cfg

    cache = lm.init_cache(cfg, b, cell.seq_len, device="meta")
    dcache = shd.shard_tree(cache, shd.cache_specs(cfg, cache, mesh), mesh)

    if cell.kind == "prefill":
        batch = {k: _place(v, shd.P(dp, *(None,) * (len(v.shape) - 1)), mesh) for k, v in specs["batch"].items()}

        def prefill_fn(params, tokens, cache, frontend=None):
            return lm.prefill(params, cfg, tokens, cache, frontend)

        args = (dparams, batch["inputs"], dcache)
        if "frontend" in batch:
            args += (batch["frontend"],)
        return prefill_fn, args, cfg

    # decode: one token against the filled cache; batch=1 cells
    # (long_500k) cannot shard the token batch dim
    dp_size = 1
    for a in dp:
        dp_size *= policy.mesh_shape(mesh)[a]
    bdp = dp if b % dp_size == 0 else None
    token = _place(specs["token"], shd.P(bdp, None), mesh)
    dcache["len"] = cell.seq_len - 1

    def decode_fn(params, cache, token):
        return lm.decode_step(params, cfg, cache, token)

    return decode_fn, (dparams, dcache, token), cfg


# ---------------------------------------------------------------------------
# the per-rank tally
# ---------------------------------------------------------------------------


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def argument_bytes(args) -> int:
    """The exact local bytes of a step's arguments on one rank (an int
    leaf, a cache's ``len``, is the reference's int32 scalar)."""
    total = 0
    for leaf in flatten(args):
        if isinstance(leaf, torch.Tensor):
            t = _local(leaf)
            total += t.numel() * t.element_size()
        elif isinstance(leaf, int):
            total += 4
    return total


_COLLECTIVES = (
    "all_gather_into_tensor",
    "all_gather_into_tensor_coalesced",
    "all_reduce",
    "all_reduce_coalesced",
    "reduce_scatter_tensor",
    "reduce_scatter_tensor_coalesced",
    "all_to_all_single",
    "broadcast",
)


def _tensors(x) -> list:
    """The tensors of an op's arguments or outputs (a tensor, or a list or
    tuple holding tensors)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for t in x if isinstance(t, torch.Tensor)]
    return []


class Tally:
    """Per-rank counts of a step's local ops (a ``TorchDispatchMode``
    that lets DTensor lower each op to its local ops first): FLOPs, bytes
    read and written, collective bytes, and the live and peak bytes of
    the storages the ops create.  Only ops on the step's meta tensors
    count: host scalars alone are not device work, and DTensor's own
    global-shape metadata runs (on fake tensors) are paused out."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._sizes: dict[int, int] = {}
        self._paused = 0

    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live (arguments)."""
        for leaf in flatten(tree):
            if isinstance(leaf, torch.Tensor):
                self._see(_local(leaf))

    def _see(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def record(self, func, args, kwargs, out) -> None:
        if self._paused:
            return
        outs = _tensors(out)
        tensors = _tensors(args) + _tensors(tuple(kwargs.values())) + outs
        meta = False
        for t in tensors:
            if isinstance(t, FakeTensor):
                return
            meta = meta or t.is_meta
        if not meta:
            return
        packet = func._overloadpacket
        if packet in self.flop_registry:
            self.flops += self.flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace == "_c10d_functional" and func.__name__.split(".")[0] in _COLLECTIVES:
            name = func.__name__.split(".")[0]
            self.collectives[name] = self.collectives.get(name, 0.0) + sum(
                t.numel() * t.element_size() for t in outs
            )
        if func.is_view:
            return  # no data moves, no storage is made
        self.bytes += sum(t.numel() * t.element_size() for t in tensors)
        for t in outs:
            self._see(t)

    @contextlib.contextmanager
    def counting(self):
        """Count the local ops run inside, DTensor's metadata runs apart."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.utils._python_dispatch import TorchDispatchMode

        tally = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented  # let DTensor lower it to local ops first
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                tally.record(func, args, kwargs, out)
                return out

        meta_run = ShardingPropagator._propagate_tensor_meta_non_cached

        def paused(prop, *a, **k):
            tally._paused += 1
            try:
                return meta_run(prop, *a, **k)
            finally:
                tally._paused -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = paused
        try:
            with _Mode():
                yield self
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = meta_run


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------


def analyze(tally: Tally, arg_bytes: int, cfg: ModelConfig, cell: ShapeCell, n_chips: int) -> dict:
    flops_dev = float(tally.flops)
    bytes_dev = float(tally.bytes)
    coll_total = float(sum(tally.collectives.values()))
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = coll_total / LINK_BW

    n_tok = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    nd = cfg.active_param_count()
    model_flops = (6 if cell.kind == "train" else 2) * nd * n_tok
    model_flops_dev = model_flops / n_chips

    dominant = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", collective_s), key=lambda kv: kv[1]
    )[0]
    slowest = max(compute_s, memory_s, collective_s)
    return {
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_total,
        "collectives": dict(tally.collectives),
        "memory": {"argument_bytes": arg_bytes, "peak_bytes": int(tally.peak)},
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops_per_device": model_flops_dev,
        "useful_flops_ratio": model_flops_dev / flops_dev if flops_dev else 0.0,
        "roofline_fraction": (model_flops_dev / PEAK_FLOPS) / slowest if slowest > 0 else 0.0,
    }


# ---------------------------------------------------------------------------
# the fake process group
# ---------------------------------------------------------------------------


def start_fake_group(world_size: int) -> None:
    """A fake ``world_size``-rank process group in this process (rank 0);
    one of another size is torn down first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of each card, or a note that
    this host has none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return "no card on this host"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "no card on this host"


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(
    arch: str,
    cell: ShapeCell,
    multi_pod: bool,
    out_dir: str | None,
    variant: str = "",
    mesh=None,
    base: ModelConfig | None = None,
    **knobs,
):
    """Build and run one cell on the production mesh (or ``mesh``, a
    ``DeviceMesh`` over a fake group the caller started; ``base`` a
    config in place of the published one) and return (and write to
    ``out_dir``) its report."""
    from repro_torch.launch.mesh import make_production_mesh

    if mesh is None:
        start_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    n_chips = mesh.size()
    t0 = time.perf_counter()
    fn, args, cfg = build_cell(arch, cell, mesh, base=base, **knobs)
    t_build = time.perf_counter() - t0
    arg_bytes = argument_bytes(args)
    tally = Tally()
    tally.hold(args)
    with tally.counting():
        out = fn(*args)
    del out
    t_step = time.perf_counter() - t0 - t_build
    policy.set_policy(None)

    report = {
        "arch": arch,
        "shape": cell.name,
        "mesh": "x".join(str(n) for n in mesh.shape),
        "n_chips": n_chips,
        "variant": variant,
        "knobs": dict(knobs),
        "build_s": t_build,
        "step_s": t_step,
        "wall_s": t_build + t_step,
        **analyze(tally, arg_bytes, cfg, cell, n_chips),
        "constants": CONSTANTS,
        "counts": "per rank, counted on fake tensors; not device measurements",
        "status": "ok",
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}__{cell.name}__{report['mesh'].replace('x', '_')}"
        if variant:
            tag += f"__{variant}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(report, f, indent=1)
    return report


def summary(tag: str, rep: dict) -> str:
    return (
        f"[dryrun] {tag}: OK args/rank={rep['memory']['argument_bytes'] / 2**30:.3f}GiB "
        f"peak/rank={rep['memory']['peak_bytes'] / 2**30:.3f}GiB "
        f"flops/rank={rep['flops_per_device']:.4g} coll/rank={rep['collective_bytes_per_device'] / 2**30:.3f}GiB "
        f"dominant={rep['dominant']} roofline={rep['roofline_fraction']:.3f} wall={rep['wall_s']:.1f}s"
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="dry-run every arch x shape x mesh cell on a fake process group")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    # hillclimb knobs (variants land in --out with a __<variant> tag)
    ap.add_argument("--variant", default="")
    ap.add_argument("--block-skip", action="store_true")
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--boundary", choices=["seq", "none"], default="seq")
    ap.add_argument("--capacity-factor", type=float, default=None)
    # a sweep over many cells: each cell in its own process, N at a time
    ap.add_argument("--jobs", type=int, default=1, help="cells run at once, each in its own process")
    ap.add_argument("--cell-timeout", type=float, default=None,
                    help="with --jobs: seconds a cell may take before it is stopped and listed as timed out")
    return ap


def _cell_cost(arch: str, cell: ShapeCell) -> float:
    """A rough order for a parallel sweep (longest first): prefill cells
    replay every attention chunk pair of every layer."""
    weight = {"prefill": 64.0, "train": 3.0, "decode": 1.0}[cell.kind]
    return weight * get_config(arch).n_layers


def sweep(tasks, args, knob_argv: list[str]) -> int:
    """Run each (arch, cell, multi_pod) of ``tasks`` as its own
    ``python -m repro_torch.launch.dryrun`` process, ``args.jobs`` at a
    time; print each cell's line (or its failure, or its timeout) and
    write ``sweep.json`` (status and wall time per cell) to ``args.out``.
    Returns the number of cells that did not end OK."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    def one(task):
        arch, cell, mp = task
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", cell.name,
               "--mesh", "multi" if mp else "single", "--out", args.out, *knob_argv]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=args.cell_timeout)
        except subprocess.TimeoutExpired:
            return task, "timeout", time.perf_counter() - t0, f"stopped after {args.cell_timeout:.0f} s"
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[dryrun] ") and " x " in ln]
        status = "ok" if proc.returncode == 0 else "fail"
        detail = lines[-1] if lines else proc.stderr.strip().splitlines()[-1:]
        return task, status, time.perf_counter() - t0, detail

    rows = []
    with ThreadPoolExecutor(args.jobs) as pool:
        for (arch, cell, mp), status, wall, detail in pool.map(one, sorted(tasks, key=lambda t: -_cell_cost(*t[:2]))):
            print(f"[sweep] {arch} x {cell.name} x {mesh_name(mp)}: {status} in {wall:.1f} s: {detail}", flush=True)
            rows.append({"arch": arch, "shape": cell.name, "mesh": mesh_name(mp), "status": status,
                         "process_s": wall, "detail": detail if isinstance(detail, str) else " ".join(detail)})
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "sweep.json"), "w") as f:
        json.dump({"card": card_line(), "jobs": args.jobs, "cell_timeout_s": args.cell_timeout, "cells": rows},
                  f, indent=1)
    return sum(r["status"] != "ok" for r in rows)


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    knobs = dict(
        block_skip=args.block_skip,
        attn_chunk=args.attn_chunk,
        boundary=args.boundary,
        capacity_factor=args.capacity_factor,
    )
    print(f"[dryrun] roofline constants: {CONSTANTS['source']}; card: {card_line()}")

    archs = ARCH_IDS if args.all or not args.arch else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    if args.jobs > 1:
        knob_argv = ["--boundary", args.boundary]
        if args.variant:
            knob_argv += ["--variant", args.variant]
        if args.block_skip:
            knob_argv.append("--block-skip")
        if args.attn_chunk:
            knob_argv += ["--attn-chunk", str(args.attn_chunk)]
        if args.capacity_factor:
            knob_argv += ["--capacity-factor", str(args.capacity_factor)]
        tasks = [
            (arch, cell, mp)
            for arch in archs
            for cell in shapes_for(get_config(arch))
            if not args.shape or cell.name == args.shape
            for mp in meshes
            if not (args.skip_existing and os.path.exists(
                os.path.join(args.out, f"{arch}__{cell.name}__{mesh_name(mp).replace('x', '_')}.json")))
        ]
        failures = sweep(tasks, args, knob_argv)
        if failures:
            raise SystemExit(f"{failures} dry-run cells did not end OK")
        return

    failures = 0
    for arch in archs:
        cells = shapes_for(get_config(arch))
        if args.shape:
            cells = [c for c in cells if c.name == args.shape]
        for cell in cells:
            for mp in meshes:
                tag = f"{arch} x {cell.name} x {mesh_name(mp)}"
                mesh_tag = mesh_name(mp).replace("x", "_")
                existing = os.path.join(args.out, f"{arch}__{cell.name}__{mesh_tag}.json")
                if args.skip_existing and os.path.exists(existing):
                    print(f"[dryrun] {tag}: skipped (exists)")
                    continue
                try:
                    rep = run_cell(arch, cell, mp, args.out, variant=args.variant, **knobs)
                    print(summary(tag, rep), flush=True)
                except Exception as e:
                    failures += 1
                    print(f"[dryrun] {tag}: FAIL {type(e).__name__}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
