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


class TrainState(NamedTuple):
    params: Any
    opt_state: Any


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions with target >= 0.

    The gold logit is gathered; the reference sums ``logits * one_hot``
    over the vocabulary instead (its sharded-vocab form), which has one
    non-zero term and so gives the same number and gradient without the
    [B, S, V] one-hot product."""
    mask = targets >= 0
    tgt = torch.clamp_min(targets, 0).long()
    l32 = logits.to(torch.float32)
    logz = torch.logsumexp(l32, dim=-1)
    gold = torch.gather(l32, -1, tgt[..., None])[..., 0]
    ce = (logz - gold) * mask
    return ce.sum() / torch.clamp_min(mask.sum(), 1)


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


def value_and_grad(params, cfg: ModelConfig, batch, *, block_skip: bool = False):
    """((total loss, metrics), gradient tree of ``params``' structure),
    every value detached."""
    leaves = [p.detach().requires_grad_() for p in flatten(params)]
    with torch.enable_grad():
        total, metrics = loss_fn(unflatten(params, iter(leaves)), cfg, batch, block_skip=block_skip)
        grads = torch.autograd.grad(total, leaves, allow_unused=True, materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics), unflatten(params, iter(grads))


def make_train_step(
    cfg: ModelConfig, opt_cfg: AdamWConfig, *, block_skip: bool = False
):
    def train_step(state: TrainState, batch):
        (total, metrics), grads = value_and_grad(state.params, cfg, batch, block_skip=block_skip)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, state.params, grads, state.opt_state
        )
        metrics = {**metrics, **opt_metrics, "total_loss": total}
        return TrainState(new_params, new_opt), metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, cfg, batch)
        return metrics

    return eval_step
