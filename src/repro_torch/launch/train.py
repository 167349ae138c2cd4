"""End-to-end training entry point.

Single-host example, on the card (the default device):

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm_125m --smoke \
        --steps 200 --batch 8 --seq 128

and on the CPU, with ``--device cpu``.

Port of ``repro.launch.train``: ``build_trainer`` and the CLI, with a
``device`` (``--device``, ``cuda`` by default; a ``cuda`` request without
a card raises).  The mesh is ``mesh_factorization(1)`` — one card, (1, 1)
— installed as the activation policy; on one card every parameter and
batch lives whole, so nothing is sharded (the reference's ``shard_tree``
and its ``jit`` in/out shardings have no counterpart).  Parameters come
from ``init_lm(seed, cfg, device=)``, and ``shard_batch`` moves each host
batch to the device.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.api import torch_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.launch.mesh import mesh_factorization
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import policy
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
    """(trainer, initial state, config) for ``arch`` on ``device``; the
    checkpoints go to ``checkpoint_dir`` (default: ``repro_torch_ckpt`` in
    the temporary directory)."""
    dev = torch_device(device, "build_trainer")
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    policy.install(mesh or mesh_factorization(1))

    params = lm.init_lm(seed, cfg, device=dev)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps, warmup_steps=max(steps // 20, 5))
    state = TrainState(params, adamw_init(opt_cfg, params))
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
        return {k: torch.from_numpy(v).to(dev) for k, v in host_batch.items()}

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
