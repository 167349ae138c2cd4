"""Training step: next-token cross-entropy + AdamW.

The step is pure (params, opt_state, batch) -> (params, opt_state,
metrics).  Frontend archs ([vlm]/[audio]) receive precomputed embeddings
in the batch; loss is computed over the text positions only.

Port of ``repro.train.step``.  Gradients come from
``torch.autograd.grad`` over the parameter leaves (the reference's
``jax.value_and_grad``), taken from fresh leaves that share the state's
storage, so the state passed in is never changed.  A parameter that the
loss does not reach gets a zero gradient, as in JAX.  The step runs
unrouted: under ``scheduled_kernels`` the model's ``dense`` refuses to
be differentiated (``repro_torch.models.layers.dense``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import flatten, unflatten
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.parallel.policy import on_mesh


class TrainState(NamedTuple):
    params: Any
    opt_state: Any


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim written out in its own ops,
    forward and backward, so that it runs on a DTensor whose last dim is
    sharded: the row max and the row sum are partial per shard and
    all-reduced ([B, S] each), where ``torch.logsumexp`` would gather the
    logits.  On whole tensors it gives ``torch.logsumexp``'s bits and
    gradient."""

    @staticmethod
    def forward(ctx, x):
        m = torch.amax(x, dim=-1, keepdim=True)
        m = torch.where(torch.abs(m) == float("inf"), torch.zeros_like(m), m)
        out = torch.log(torch.sum(torch.exp(x - m), dim=-1)) + m[..., 0]
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return grad[..., None] * torch.exp(x - out[..., None])


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions with target >= 0.

    The log-sum-exp is ``_LogSumExp`` on every path, so a sharded and an
    unsharded run do the same arithmetic.  On whole tensors the gold logit
    is gathered.  On a DTensor (the vocab dim sharded over ``model``,
    ``sharding.logits_spec``) it is the reference's form, the sum of
    ``logits * one_hot`` over the vocabulary, which reduces per shard and
    all-reduces instead of gathering the vocabulary.  Both forms give the
    same number and gradient: the one-hot sum has one non-zero term."""
    from torch.distributed.tensor import DTensor

    mask = targets >= 0
    tgt = torch.clamp_min(targets, 0).long()
    l32 = logits.to(torch.float32)
    logz = _LogSumExp.apply(l32)
    if isinstance(l32, DTensor):
        vocab = torch.arange(l32.shape[-1], device=l32.device)
        gold = torch.sum(l32 * (tgt[..., None] == vocab), dim=-1)
    else:
        gold = torch.gather(l32, -1, tgt[..., None])[..., 0]
    ce = (logz - gold) * mask
    return ce.sum() / torch.clamp_min(mask.sum(), 1)


@on_mesh
def loss_fn(
    params,
    cfg: ModelConfig,
    batch: dict[str, torch.Tensor],
    *,
    block_skip: bool = False,
):
    logits, aux = lm.forward(
        params,
        cfg,
        batch["inputs"],
        batch.get("frontend"),
        block_skip=block_skip,
    )
    nf = cfg.n_frontend_tokens if cfg.frontend else 0
    text_logits = logits[:, nf:]
    loss = cross_entropy(text_logits, batch["targets"])
    return loss + aux, {"loss": loss, "aux_loss": aux}


@on_mesh
def value_and_grad(params, cfg: ModelConfig, batch, *, block_skip: bool = False):
    """((total loss, metrics), gradient tree of ``params``' structure),
    every value detached."""
    leaves = [p.detach().requires_grad_() for p in flatten(params)]
    with torch.enable_grad():
        total, metrics = loss_fn(unflatten(params, iter(leaves)), cfg, batch, block_skip=block_skip)
        grads = torch.autograd.grad(total, leaves, allow_unused=True, materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics), unflatten(params, iter(grads))


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor (a DTensor's sums reduced)."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(
    cfg: ModelConfig, opt_cfg: AdamWConfig, *, block_skip: bool = False
):
    def train_step(state: TrainState, batch):
        (total, metrics), grads = value_and_grad(state.params, cfg, batch, block_skip=block_skip)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, state.params, grads, state.opt_state
        )
        metrics = {**metrics, **opt_metrics, "total_loss": total}
        return TrainState(new_params, new_opt), {k: _whole(v) for k, v in metrics.items()}

    return train_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, cfg, batch)
        return metrics

    return eval_step
