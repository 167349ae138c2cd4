"""End-to-end training entry point.

Single-host example, on the card (the default device):

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm_125m --smoke \
        --steps 200 --batch 8 --seq 128

and on the CPU, with ``--device cpu``.

Port of ``repro.launch.train``: ``build_trainer`` and the CLI, with a
``device`` (``--device``, ``cuda`` by default; a ``cuda`` request without
a card raises).  As in the reference, the trainer is sharded: the mesh is
``mesh or make_elastic_mesh(device_type=...)`` (the running process
group's ranks; one rank started in this process when none runs: NCCL on
the card, gloo on the CPU), installed as the activation policy; the
parameters and optimizer state are placed on it as DTensors by
``param_specs`` / ``opt_state_specs`` (``shard_tree``), and
``shard_batch`` distributes each host batch over the data axes, as the
reference's ``P(dp)``.  ``mesh`` given as a shape or an axis mapping
instead of a ``DeviceMesh`` installs the policy for that shape and keeps
every leaf a whole tensor on ``device`` (the unsharded trainer).
"""

from __future__ import annotations

import argparse

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

from repro_torch.api import torch_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import policy
from repro_torch.parallel import sharding as shd
from repro_torch.train import Trainer, TrainerConfig, TrainState, make_train_step
from repro_torch.train.trainer import default_checkpoint_dir


def build_trainer(
    arch: str,
    *,
    smoke: bool = True,
    steps: int = 100,
    global_batch: int = 8,
    seq_len: int = 128,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 25,
    lr: float = 3e-4,
    mesh=None,
    block_skip: bool = False,
    seed: int = 0,
    device: str | torch.device = "cuda",
):
    """(trainer, initial state, config) for ``arch`` on ``device``, sharded
    over ``mesh`` (a ``DeviceMesh``; the elastic mesh by default; a shape
    or an axis mapping trains unsharded with that shape's policy); the
    checkpoints go to ``checkpoint_dir`` (default: ``repro_torch_ckpt`` in
    the temporary directory)."""
    dev = torch_device(device, "build_trainer")
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    mesh = mesh if mesh is not None else make_elastic_mesh(device_type=dev.type)
    sharded = isinstance(mesh, DeviceMesh)
    policy.install(mesh)

    params = lm.init_lm(seed, cfg, device=dev)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps, warmup_steps=max(steps // 20, 5))
    opt_state = adamw_init(opt_cfg, params)
    if sharded:
        pspecs = shd.param_specs(cfg, params, mesh)
        ospecs = shd.opt_state_specs(cfg, opt_state, pspecs)
        params = shd.shard_tree(params, pspecs, mesh)
        opt_state = shd.shard_tree(opt_state, ospecs, mesh)
        dp = tuple(shd.dp_axes(mesh))
    state = TrainState(params, opt_state)
    step_fn = make_train_step(cfg, opt_cfg, block_skip=block_skip)

    pipe = SyntheticTokenPipeline(
        DataConfig(
            vocab=cfg.vocab,
            seq_len=seq_len,
            global_batch=global_batch,
            seed=seed,
            n_frontend_tokens=cfg.n_frontend_tokens if cfg.frontend else 0,
            d_model=cfg.d_model,
        )
    )

    def shard_batch(host_batch):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host_batch.items()}
        if not sharded:
            return batch
        return {
            k: distribute_tensor(v, mesh, shd.placements(shd.P(dp, *(None,) * (v.dim() - 1)), mesh))
            for k, v in batch.items()
        }

    trainer = Trainer(
        cfg=TrainerConfig(
            total_steps=steps,
            checkpoint_every=checkpoint_every,
            checkpoint_dir=checkpoint_dir or default_checkpoint_dir(),
        ),
        train_step=step_fn,
        pipeline=pipe,
        shard_batch=shard_batch,
    )
    return trainer, state, cfg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="train an LM arch on synthetic tokens")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument(
        "--ckpt",
        default=None,
        help="checkpoint directory (default: repro_torch_ckpt in the temporary directory)",
    )
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--block-skip", action="store_true")
    ap.add_argument(
        "--device", default="cuda", help="torch device to train on: cuda (default) or cpu"
    )
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    trainer, state, cfg = build_trainer(
        args.arch,
        smoke=args.smoke,
        steps=args.steps,
        global_batch=args.batch,
        seq_len=args.seq,
        checkpoint_dir=args.ckpt,
        lr=args.lr,
        block_skip=args.block_skip,
        device=args.device,
    )
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params on {args.device}")
    state = trainer.run(state)
    losses = [h["loss"] for h in trainer.history]
    if losses:
        print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
