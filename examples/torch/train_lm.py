"""End-to-end training example: train an xLSTM-125M-family model (reduced
width, same block structure) with the fault-tolerant trainer —
checkpoints, resume, deterministic data.

    PYTHONPATH=src python examples/torch/train_lm.py --steps 300 [--device cuda|cpu]

The trainer is sharded over the elastic ``DeviceMesh`` of the running
process group; with none running, a one-rank group is started for the run
(NCCL on the card, gloo on the CPU) and shut down after it.  A run killed
part-way resumes from its newest checkpoint when started again with the
same ``--ckpt``.  At full width the identical entry point runs the published
config: ``python -m repro_torch.launch.train --arch xlstm_125m --steps ...``.
"""

import argparse
import os
import tempfile

import torch.distributed as dist

from repro_torch.launch.train import build_trainer
from repro_torch.parallel import policy


DEFAULT_CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")


def run(device: str = "cuda", arch: str = "xlstm_125m", steps: int = 300, batch: int = 8,
        seq: int = 128, ckpt: str = DEFAULT_CKPT, log_every: int = 10) -> dict:
    """Train (or resume) to ``steps``.  Returns ``{"cfg", "trainer",
    "state"}``; ``trainer.history`` holds the loss every ``log_every``
    steps.  The process group and the activation policy are left as they
    were found."""
    started = not dist.is_initialized()
    before = policy.get_policy()
    try:
        trainer, state, cfg = build_trainer(
            arch,
            smoke=True,  # reduced width; block structure identical to the paper config
            steps=steps,
            global_batch=batch,
            seq_len=seq,
            checkpoint_dir=ckpt,
            checkpoint_every=max(steps // 4, 10),
            lr=1e-3,
            device=device,
        )
        trainer.cfg.log_every = log_every
        return {"cfg": cfg, "trainer": trainer, "state": trainer.run(state)}
    finally:
        policy.set_policy(before)
        if started and dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--arch", default="xlstm_125m")
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--device", default="cuda", help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)

    r = run(args.device, args.arch, args.steps, args.batch, args.seq, args.ckpt)
    cfg, trainer = r["cfg"], r["trainer"]
    print(f"training {cfg.name} ({cfg.param_count()/1e6:.1f}M params) "
          f"for {args.steps} steps on {args.device}")
    losses = [h["loss"] for h in trainer.history]
    if losses:
        print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({'DECREASED' if losses[-1] < losses[0] else 'no progress'})")
    if trainer.straggler_events:
        print("straggler events at steps:", trainer.straggler_events)


if __name__ == "__main__":
    main()
