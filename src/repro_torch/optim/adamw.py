"""AdamW + cosine schedule as pure functions on a parameter tree.

Moment dtype is configurable: f32 default; bf16 moments halve optimizer
memory.  Global-norm clipping included.  State is a tree mirroring
params.

Port of ``repro.optim.adamw``: the same f32 arithmetic per leaf, in the
same order (the global norm sums the leaves in ``jax.tree.leaves``'
order, ``repro_torch.tree.flatten``), the bias corrections from an
int32 step, new parameters cast back to their dtype.  Not
``torch.optim.AdamW``, whose decoupled decay is rounded differently.
The update runs under ``torch.no_grad`` and returns new tensors; nothing
is written in place.  The step counter is an int32 scalar kept on the
host, wherever the parameters are: the schedule and the bias corrections
are reckoned there and reach the device's kernels as scalars, so the
update never waits for the device.

A sharded state (DTensor leaves placed by ``sharding.opt_state_specs``)
updates shard by shard: each gradient is reduced onto its parameter's
shards first, the global norm is reduced once, and a replicated
DTensor step counter is read back to the host once per update.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
import operator
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, distribute_tensor

from repro_torch.tree import flatten, unflatten
from repro_torch.kernels.ref import torch_dtype


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    moment_dtype: str = "float32"


@functools.cache
def _cosf():
    """The C library's single-precision cosine, which XLA's f32 ``cos``
    on the CPU equals bit for bit (``torch.cos`` differs in the last bit
    on about 5 % of inputs)."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.cosf.restype = ctypes.c_float
    libm.cosf.argtypes = [ctypes.c_float]
    return libm.cosf


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (the host's int32 step counter), in
    f32, bit-equal to the reference's."""
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    arg = math.pi * t
    cos = 0.5 * (1 + torch.tensor(_cosf()(arg.item()), dtype=torch.float32))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def adamw_init(cfg: AdamWConfig, params):
    dt = torch_dtype(cfg.moment_dtype)
    flat = flatten(params)

    def zeros():
        return unflatten(params, (torch.zeros(p.shape, dtype=dt, device=p.device) for p in flat))

    return {
        "m": zeros(),
        "v": zeros(),
        "step": torch.zeros((), dtype=torch.int32),
    }


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in leaf order.  Over
    DTensors each leaf's sum is kept partial on every mesh dim (pending
    sums, and one rank's copy of a replicated sum), so the total is
    reduced once."""
    total = functools.reduce(
        operator.add, (_partial(torch.sum(torch.square(g.to(torch.float32)))) for g in flatten(tree))
    )
    if isinstance(total, DTensor):
        total = total.redistribute(total.device_mesh, [Replicate()] * total.device_mesh.ndim)
    return torch.sqrt(total)


def _partial(x):
    """A DTensor scalar as pending sums on every mesh dim (where it is
    replicated, the rank at coordinate 0 keeps the value and the others
    hold 0); anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh, local = x.device_mesh, x.to_local()
    for i, p in enumerate(x.placements):
        if p.is_replicate() and mesh.get_local_rank(i) != 0:
            local = torch.zeros_like(local)
    return DTensor.from_local(local, mesh, [Partial()] * mesh.ndim, run_check=False)


def _host_step(step: torch.Tensor) -> torch.Tensor:
    """The step counter on the host (a replicated DTensor counter is read
    back once)."""
    return (step.full_tensor() if isinstance(step, DTensor) else step).cpu()


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """Returns (new_params, new_state, metrics)."""
    step = _host_step(state["step"]) + 1  # the host's counter (a no-op move)
    lr = cosine_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    gnorm = _global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    mdt = torch_dtype(cfg.moment_dtype)
    f32 = torch.float32

    def upd(p, g, m, v):
        if isinstance(g, DTensor):  # a pending gradient reduced onto the parameter's shards
            g = g.redistribute(p.device_mesh, p.placements)
        g = g.to(f32) * scale
        m32 = cfg.b1 * m.to(f32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(f32) + (1 - cfg.b2) * g * g
        update = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        update = update + cfg.weight_decay * p.to(f32)
        new_p = p.to(f32) - lr * update
        return new_p.to(p.dtype), m32.to(mdt), v32.to(mdt)

    out = [
        upd(p, g, m, v)
        for p, g, m, v in zip(
            flatten(params), flatten(grads), flatten(state["m"]), flatten(state["v"]), strict=True
        )
    ]
    new_params, new_m, new_v = (unflatten(params, (o[i] for o in out)) for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    old_step = state["step"]
    if isinstance(old_step, DTensor):  # the counter stays where the state keeps it
        step = distribute_tensor(step.to(old_step.device), old_step.device_mesh, old_step.placements)
    return new_params, {"m": new_m, "v": new_v, "step": step}, metrics
