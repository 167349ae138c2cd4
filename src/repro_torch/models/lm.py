"""LM assembly: embedding -> pattern-grouped blocks -> norm -> head.

Layers are organized as ``n_groups`` repeats of ``cfg.pattern``; the
parameters of the repeats are stacked along axis 0 (``params["groups"]``),
and prefix layers (``params["prefix"]``, a list) sit outside the stack.
Where the reference scans over the groups, the port loops over ``g`` and
indexes each stacked tensor, so a reference parameter tree converts leaf
by leaf (``params_from_numpy``).

Three entry points mirror the shape cells: ``forward``, ``prefill``
(fill the caches, last-position logits) and ``decode_step`` (one token).

Port of ``repro.models.lm`` for the dense family: ``pattern == ("attn",)``
with no MoE, no MLA and no modality frontend.  Any other block kind, MoE,
MLA or a frontend raises ``NotImplementedError`` (ROADMAP Queue A item
5).  ``jax.checkpoint`` (training only) and the sharding ``constrain``
calls are left out; the serving path runs under ``torch.inference_mode``.
The cache is written in place (``repro_torch.models.cache``): ``prefill``
and ``decode_step`` return the cache they were given, updated.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.api import torch_device
from repro_torch.kernels.ref import torch_dtype
from repro_torch.models import attention as A
from repro_torch.models import cache as C
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

NOT_PORTED = "ROADMAP.md Queue A item 5"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a dense LM that the
    port runs: attention blocks only, no MoE, no MLA, no frontend."""
    problems = []
    if any(kind != "attn" for kind in cfg.pattern):
        problems.append(f"block kinds {sorted(set(cfg.pattern) - {'attn'})}")
    if cfg.moe is not None:
        problems.append("MoE layers")
    if cfg.kv_lora_rank:
        problems.append("MLA attention (kv_lora_rank)")
    if cfg.frontend:
        problems.append(f"the {cfg.frontend} frontend")
    if problems:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) needs {', '.join(problems)}, which the "
            f"port does not run yet: {NOT_PORTED}"
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(gen, cfg: ModelConfig, dtype, lead=()):
    p: dict[str, Any] = {
        "ln1": L.init_rmsnorm(cfg.d_model, dtype, device=gen.device, lead=lead),
        "block": A.init_attention(gen, cfg, dtype, lead=lead),
    }
    if cfg.d_ff:
        p["ln2"] = L.init_rmsnorm(cfg.d_model, dtype, device=gen.device, lead=lead)
        p["ffn"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, kind=cfg.mlp_kind, lead=lead)
    return p


def n_prefix_layers(cfg: ModelConfig) -> int:
    return cfg.moe.first_dense if cfg.moe else 0


def n_scan_groups(cfg: ModelConfig) -> int:
    n = cfg.n_layers - n_prefix_layers(cfg)
    p = len(cfg.pattern)
    if n % p:
        raise ValueError(f"{cfg.name}: {n} layers do not divide into pattern groups of {p}")
    return n // p


def init_lm(seed: int, cfg: ModelConfig, *, device="cuda"):
    """Random parameters in ``cfg.param_dtype`` on ``device`` (the card by
    default), drawn from a ``torch.Generator`` seeded with ``seed`` on that
    device: each tensor in float32, one at a time, then cast."""
    check_supported(cfg)
    dev = torch_device(device, "init_lm")
    dtype = torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: dict[str, Any] = {
        "embed": L.init_embedding(gen, cfg.vocab, cfg.d_model, dtype),
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = L.init_dense(gen, cfg.d_model, cfg.vocab, dtype=dtype)
    params["prefix"] = [_init_layer(gen, cfg, dtype) for _ in range(n_prefix_layers(cfg))]
    lead = (n_scan_groups(cfg),)
    params["groups"] = {f"pos{p}": _init_layer(gen, cfg, dtype, lead) for p in range(len(cfg.pattern))}
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _to_tensor(arr, device, dtype):
    arr = np.array(arr)  # a writable copy
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_numpy(tree, cfg: ModelConfig, *, device, dtype=None):
    """The reference's ``init_lm`` parameter tree, with numpy leaves, as
    the port's: the same nesting, each leaf a tensor on ``device`` (in
    ``dtype`` when given, else the leaf's own)."""
    check_supported(cfg)
    ng = n_scan_groups(cfg)
    for kind_params in tree["groups"].values():
        lead = np.asarray(kind_params["ln1"]["scale"]).shape[0]
        if lead != ng:
            raise ValueError(f"{cfg.name}: the tree stacks {lead} groups, the config {ng}")
    dev = torch.device(device)
    dt = torch_dtype(dtype) if dtype is not None else None
    return _tree_map(lambda a: _to_tensor(a, dev, dt), tree)


def _group(tree, g: int):
    """Group ``g``'s slice of a stacked tree (views, no copies)."""
    return _tree_map(lambda t: t[g], tree)


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    compute = torch_dtype(cfg.compute_dtype)
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x, compute_dtype=compute)
    return L.dense(params["head"], x, compute_dtype=compute)


# ---------------------------------------------------------------------------
# forward (eval)
# ---------------------------------------------------------------------------


def _ffn(lp, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if "ffn" in lp:
        h2 = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + L.mlp(lp["ffn"], h2, compute_dtype=torch_dtype(cfg.compute_dtype))
    return x


def _apply_layer_train(lp, cfg: ModelConfig, x, positions, *, block_skip=False):
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x = x + A.attention_block(lp["block"], cfg, h, positions, block_skip=block_skip)
    return _ffn(lp, cfg, x)


def _embed_inputs(params, cfg: ModelConfig, tokens, frontend_embeds):
    if frontend_embeds is not None:
        raise NotImplementedError(f"modality frontends are not ported yet: {NOT_PORTED}")
    x = L.embed(params["embed"], tokens).to(torch_dtype(cfg.compute_dtype))
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions


def _layers(params):
    """Each layer's parameters in order: the prefix, then group by group
    (views of the stacked tensors)."""
    yield from params["prefix"]
    stacked = params["groups"]
    first = next(iter(stacked.values()))
    for g in range(first["ln1"]["scale"].shape[0]):
        grp = _group(stacked, g)
        for p in range(len(grp)):
            yield grp[f"pos{p}"]


def forward(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    frontend_embeds: torch.Tensor | None = None,
    *,
    block_skip: bool = False,
):
    """tokens [B, S] -> (logits [B, S, V] f32, aux_loss)."""
    check_supported(cfg)
    x, positions = _embed_inputs(params, cfg, tokens, frontend_embeds)
    for lp in _layers(params):
        x = _apply_layer_train(lp, cfg, x, positions, block_skip=block_skip)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _head(params, cfg, x)
    return logits.to(torch.float32), torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device):
    """Allocate the full decode cache (prefix + stacked groups) on
    ``device``; ``len`` is the number of positions filled."""
    check_supported(cfg)
    dev = torch.device(device)
    prefix = [C.make_attn_cache(cfg, batch, max_len, device=dev) for _ in range(n_prefix_layers(cfg))]
    lead = (n_scan_groups(cfg),)
    groups = {
        f"pos{p}": C.make_attn_cache(cfg, batch, max_len, device=dev, lead=lead)
        for p in range(len(cfg.pattern))
    }
    return {"prefix": prefix, "groups": groups, "len": 0}


def _layer_caches(cache):
    """Each layer's cache views, in the order of ``_layers``."""
    yield from cache["prefix"]
    stacked = cache["groups"]
    first = next(iter(stacked.values()))
    for g in range(first["k"].shape[0]):
        grp = _group(stacked, g)
        for p in range(len(grp)):
            yield grp[f"pos{p}"]


def _apply_layer_prefill(lp, cfg: ModelConfig, x, positions, lcache, start: int):
    """Like the train apply, but fills the layer cache at ``start``."""
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v, mla = A.qkv_project(lp["block"], cfg, h, positions)
    window = cfg.window if cfg.attn_kind == "swa" else 0
    out = A.blockwise_attention(
        q, k, v, causal=True, window=window, chunk_q=cfg.attn_chunk, chunk_kv=cfg.attn_chunk
    )
    compute = torch_dtype(cfg.compute_dtype)
    x = x + L.dense(lp["block"]["o"], A._merge_heads(out), compute_dtype=compute)
    C.write_attn_cache(cfg, lcache, k, v, mla, start)
    return _ffn(lp, cfg, x)


def prefill(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    cache,
    frontend_embeds: torch.Tensor | None = None,
):
    """Run the prompt, filling ``cache`` (built by ``init_cache``) in
    place.  Returns (last-position logits [B, 1, V] f32, cache).  As in the
    reference, the prompt's positions count from 0 whatever ``cache["len"]``."""
    check_supported(cfg)
    x, positions = _embed_inputs(params, cfg, tokens, frontend_embeds)
    start = cache["len"]
    for lp, lcache in zip(_layers(params), _layer_caches(cache), strict=True):
        x = _apply_layer_prefill(lp, cfg, x, positions, lcache, start)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = _head(params, cfg, x)
    cache["len"] = start + positions.shape[0]
    return logits.to(torch.float32), cache


def _apply_layer_decode(lp, cfg: ModelConfig, x, lcache, cur_len: int, positions):
    """One-token step.  x [B,1,d]; cur_len = tokens already in the cache,
    ``positions`` = [cur_len], this token's position."""
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    compute = torch_dtype(cfg.compute_dtype)
    q, k, v, mla = A.qkv_project(lp["block"], cfg, h, positions)
    C.write_attn_cache(cfg, lcache, k, v, mla, cur_len)
    window = cfg.window if cfg.attn_kind == "swa" else 0
    kc, vc = C.read_attn_cache(cfg, lcache, compute)
    out = A.decode_attention(q, kc, vc, cur_len + 1, window=window)
    x = x + L.dense(lp["block"]["o"], A._merge_heads(out), compute_dtype=compute)
    return _ffn(lp, cfg, x)


def decode_step(params, cfg: ModelConfig, cache, token: torch.Tensor):
    """token [B, 1] -> (logits [B, 1, V] f32, cache), the cache updated in
    place."""
    check_supported(cfg)
    cur_len = cache["len"]
    x = L.embed(params["embed"], token).to(torch_dtype(cfg.compute_dtype))
    # made on the device (no host-to-device copy, which would wait for the
    # queued work)
    positions = torch.arange(cur_len, cur_len + 1, device=x.device)
    for lp, lcache in zip(_layers(params), _layer_caches(cache), strict=True):
        x = _apply_layer_decode(lp, cfg, x, lcache, cur_len, positions)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _head(params, cfg, x)
    cache["len"] = cur_len + 1
    return logits.to(torch.float32), cache
