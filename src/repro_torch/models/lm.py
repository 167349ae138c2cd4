"""LM assembly: embedding -> pattern-grouped blocks -> norm -> head.

Layers are organized as ``n_groups`` repeats of ``cfg.pattern`` (a tuple
of block kinds: ``attn``, ``mamba``, ``mlstm``, ``slstm``, ``kda``); the
parameters of the repeats are stacked along axis 0 (``params["groups"]``),
and DeepSeek-style "first k layers dense" prefix layers
(``params["prefix"]``, a list) sit outside the stack.  A published layer
order that is not whole repeats (``config.HybridMLAConfig``: Kimi-Linear's
27 = 1 dense + 6 x 4 + 2) keeps the layers past the last whole repeat in
a tail (``params["suffix"]``, a list, present only where it has layers).  Where the
reference scans over the groups, the port loops over ``g`` and indexes
each stacked tensor, so a reference parameter tree converts leaf by leaf
(``params_from_numpy``).

Three entry points mirror the shape cells: ``forward``, ``prefill``
(fill the caches, last-position logits) and ``decode_step`` (one token).
A modality frontend's embeddings ([B, Nf, d], vision patches or audio
frames) are prepended to the token embeddings by ``forward`` and
``prefill``, as in the reference.

Port of ``repro.models.lm``, with the reference's ``constrain`` calls
(the embedding output, each group's and each layer's residual stream,
the logits): on DTensor parameters (placed by
``repro_torch.parallel.sharding``) they lay out the activations, and the
entry points run under DTensor's ``implicit_replication``; on plain
tensors they are identities.  ``forward`` is differentiable and writes
nothing in place, while the unsharded serving path runs under
``torch.inference_mode``.  The caches are written in place: the KV and
MLA caches by ``repro_torch.models.cache``, the Mamba and xLSTM states
(stacked over the groups like the KV cache) by copying each block's new
state into them; ``prefill`` and ``decode_step`` return the cache they
were given, updated.

Under ``repro_torch.tracing.recording`` the serving entry points record
spans: ``lm.prefill`` / ``lm.decode_step`` around each call, ``lm.embed``
and ``lm.head`` inside it, ``layer.<kind>`` around each block (its norm
and residual included) and ``layer.ffn`` / ``layer.moe`` around each
FFN sub-layer, and in an attention block ``attn.qkv``, ``attn.core``
(the prefill attention, ``attention.prefill_core``, which picks the
kernel or ``blockwise_attention`` and counts ``attn.kernel_calls`` or
``attn.plain_calls`` by the design that ran; or the cache read and the
decode attention), ``attn.out`` and ``attn.cache_write``; MLA's projections
record ``mla.q``, ``mla.kv_down`` and (in the prefill) ``mla.up`` inside
``attn.qkv``.  MLA's decode step makes no k or v: it projects q and the
latent (``attention.mla_project``), caches the latent and attends in
latent space (``attention.mla_decode_attention``).  A KDA block
(``models/kda.py``) records ``layer.kda`` and its own spans, and keeps
its recurrent state and convolution tails in the cache as a Mamba block
does, its state updated in place.  Where every layer is MLA attention
or KDA, a cache made with ``graphs=True`` (``ServingEngine``'s on a
card) replays the decode step as CUDA graphs cut at each MoE router
(``_DecodeGraphs``).
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch import tracing
from repro_torch.api import torch_device
from repro_torch.kernels import build
from repro_torch.kernels.policy import get_policy
from repro_torch.kernels.ref import torch_dtype
from repro_torch.models import attention as A
from repro_torch.models import cache as C
from repro_torch.models import kda as K
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.models.config import HybridMLAConfig, ModelConfig
from repro_torch.parallel.policy import constrain, on_mesh
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

#: the span of each block kind (built once, so a span off costs no string)
_LAYER_SPANS = {kind: f"layer.{kind}" for kind in ("attn", "mamba", "mlstm", "slstm", "kda")}


def _position_is_moe(cfg: ModelConfig, pos: int) -> bool:
    m = cfg.moe
    if m is None:
        return False
    p = len(cfg.pattern)
    if not (p % m.every == 0 or m.every % p == 0 or m.every == 1):
        raise ValueError(f"{cfg.name}: MoE periodicity must align with the pattern for stacking")
    return pos >= m.offset and (pos - m.offset) % m.every == 0


def _init_layer(gen, cfg: ModelConfig, kind: str, is_moe: bool, dtype, lead=()):
    p: dict[str, Any] = {"ln1": L.init_rmsnorm(cfg.d_model, dtype, device=gen.device, lead=lead)}
    if kind == "attn":
        p["block"] = A.init_attention(gen, cfg, dtype, lead=lead)
    elif kind == "mamba":
        p["block"] = S.init_mamba(gen, cfg, dtype, lead=lead)
    elif kind == "mlstm":
        p["block"] = X.init_mlstm(gen, cfg, dtype, lead=lead)
    elif kind == "slstm":
        p["block"] = X.init_slstm(gen, cfg, dtype, lead=lead)
    elif kind == "kda":
        p["block"] = K.init_kda(gen, cfg, dtype, lead=lead)
    else:
        raise ValueError(kind)
    if is_moe:
        p["ln2"] = L.init_rmsnorm(cfg.d_model, dtype, device=gen.device, lead=lead)
        p["ffn"] = M.init_moe(gen, cfg, dtype, lead=lead)
    elif cfg.d_ff:
        p["ln2"] = L.init_rmsnorm(cfg.d_model, dtype, device=gen.device, lead=lead)
        p["ffn"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, kind=cfg.mlp_kind, lead=lead)
    return p


def n_prefix_layers(cfg: ModelConfig) -> int:
    return cfg.moe.first_dense if cfg.moe else 0


def _has_tail(cfg: ModelConfig) -> bool:
    """Whether the configuration publishes its layer order (``layer_types``),
    which may end part-way through a repeat of its pattern."""
    return isinstance(cfg, HybridMLAConfig) and bool(cfg.layer_types)


def n_scan_groups(cfg: ModelConfig) -> int:
    n = cfg.n_layers - n_prefix_layers(cfg)
    p = len(cfg.pattern)
    if n % p and not _has_tail(cfg):
        raise ValueError(f"{cfg.name}: {n} layers do not divide into pattern groups of {p}")
    return n // p


def suffix_kinds(cfg: ModelConfig) -> list[tuple[str, bool]]:
    """(block kind, MoE FFN) of the layers past the last whole repeat of the
    pattern, each at its position in the pattern (none but for a published
    order that ends part-way)."""
    first = n_prefix_layers(cfg) + n_scan_groups(cfg) * len(cfg.pattern)
    return [(cfg.layer_kind(i), _position_is_moe(cfg, p)) for p, i in enumerate(range(first, cfg.n_layers))]


def layer_kinds(cfg: ModelConfig) -> list[tuple[str, bool]]:
    """(block kind, MoE FFN) of each layer in order: the prefix, then the
    groups position by position, then the tail (each tail layer at its
    position in the pattern).  A published order must be what this layout
    holds: its prefix and tail as published, its groups the pattern."""
    prefix = [(cfg.layer_kind(i), False) for i in range(n_prefix_layers(cfg))]
    group = [(kind, _position_is_moe(cfg, p)) for p, kind in enumerate(cfg.pattern)]
    kinds = prefix + group * n_scan_groups(cfg) + suffix_kinds(cfg)
    if _has_tail(cfg) and [k for k, _ in kinds] != list(cfg.layer_types):
        raise ValueError(f"{cfg.name}: the layer order {cfg.layer_types} is not the prefix, whole repeats of "
                         f"{cfg.pattern} and a tail")
    return kinds


def init_lm(seed: int, cfg: ModelConfig, *, device="cuda"):
    """Random parameters in ``cfg.param_dtype`` on ``device`` (the card by
    default), drawn from a ``torch.Generator`` seeded with ``seed`` on that
    device: each tensor in float32, one at a time, then cast."""
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
    params["prefix"] = [
        _init_layer(gen, cfg, cfg.layer_kind(i), False, dtype) for i in range(n_prefix_layers(cfg))
    ]
    lead = (n_scan_groups(cfg),)
    params["groups"] = {
        f"pos{p}": _init_layer(gen, cfg, kind, _position_is_moe(cfg, p), dtype, lead)
        for p, kind in enumerate(cfg.pattern)
    }
    if suffix_kinds(cfg):
        params["suffix"] = [_init_layer(gen, cfg, kind, is_moe, dtype) for kind, is_moe in suffix_kinds(cfg)]
    return params


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
    ng = n_scan_groups(cfg)
    for kind_params in tree["groups"].values():
        lead = np.asarray(kind_params["ln1"]["scale"]).shape[0]
        if lead != ng:
            raise ValueError(f"{cfg.name}: the tree stacks {lead} groups, the config {ng}")
    dev = torch.device(device)
    dt = torch_dtype(dtype) if dtype is not None else None
    return tree_map(lambda a: _to_tensor(a, dev, dt), tree)


def opt_state_from_numpy(state, cfg: ModelConfig, *, device):
    """The reference's ``adamw_init`` / ``adamw_update`` state ({"m", "v",
    "step"}, numpy leaves) as the port's: the moments as
    ``params_from_numpy`` converts a parameter tree, on ``device``; the
    step an int32 scalar on the host, where ``repro_torch.optim`` keeps
    it."""
    return {
        "m": params_from_numpy(state["m"], cfg, device=device),
        "v": params_from_numpy(state["v"], cfg, device=device),
        "step": torch.tensor(np.asarray(state["step"]).item(), dtype=torch.int32),
    }


def _group(tree, g: int):
    """Group ``g``'s slice of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[g], tree)


def _stacked(tree, cfg: ModelConfig):
    """Each entry of a prefix + stacked-groups (+ tail) tree (parameters or
    caches) in layer order (views of the stacked tensors)."""
    yield from tree["prefix"]
    for g in range(n_scan_groups(cfg)):
        grp = _group(tree["groups"], g)
        for p in range(len(cfg.pattern)):
            yield grp[f"pos{p}"]
    yield from tree.get("suffix", ())


def iter_layers(params, cfg: ModelConfig):
    """(parameters, block kind, MoE FFN) of each layer in order."""
    for lp, (kind, is_moe) in zip(_stacked(params, cfg), layer_kinds(cfg), strict=True):
        yield lp, kind, is_moe


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    compute = torch_dtype(cfg.compute_dtype)
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x, compute_dtype=compute)
    return L.dense(params["head"], x, compute_dtype=compute)


# ---------------------------------------------------------------------------
# forward (eval)
# ---------------------------------------------------------------------------


def _ffn(lp, cfg: ModelConfig, is_moe: bool, x: torch.Tensor, router=None):
    """The residual FFN sub-layer (dense MLP or MoE) -> (x, aux loss or
    None); ``router`` as ``moe.moe_ffn`` takes it."""
    if "ffn" not in lp:
        return x, None
    with tracing.span("layer.moe" if is_moe else "layer.ffn"):
        h2 = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        if is_moe:
            f, aux = M.moe_ffn(lp["ffn"], cfg, h2) if router is None else M.moe_ffn(lp["ffn"], cfg, h2, router)
            return x + f, aux
        return x + L.mlp(lp["ffn"], h2, compute_dtype=torch_dtype(cfg.compute_dtype)), None


def _apply_layer_train(lp, cfg: ModelConfig, kind: str, is_moe: bool, x, positions, *, block_skip=False):
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if kind == "attn":
        y = A.attention_block(lp["block"], cfg, h, positions, block_skip=block_skip)
    elif kind == "mamba":
        y, _ = S.mamba_block(lp["block"], cfg, h)
    elif kind == "mlstm":
        y = X.mlstm_block(lp["block"], cfg, h)
    elif kind == "slstm":
        y, _ = X.slstm_block(lp["block"], cfg, h)
    elif kind == "kda":
        y, _ = K.kda_block(lp["block"], cfg, h)
    else:
        raise ValueError(kind)
    return _ffn(lp, cfg, is_moe, x + y)


def _embed_inputs(params, cfg: ModelConfig, tokens, frontend_embeds):
    """Token embeddings in the compute dtype, a frontend's embeddings
    prepended where the config has a frontend, and their positions."""
    x = L.embed(params["embed"], tokens).to(torch_dtype(cfg.compute_dtype))
    if cfg.frontend and frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(device=x.device, dtype=x.dtype), x], dim=1)
    x = constrain(x, "dp", "boundary", None)  # batch on data + Megatron-SP seq shard
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions


def _group_body(gp, cfg: ModelConfig, x, aux, positions, block_skip: bool):
    """One repeat of ``cfg.pattern`` -> (x, aux plus its MoE layers' aux)."""
    x = constrain(x, "dp", "boundary", None)
    for p, kind in enumerate(cfg.pattern):
        x, a = _apply_layer_train(
            gp[f"pos{p}"], cfg, kind, _position_is_moe(cfg, p), x, positions, block_skip=block_skip
        )
        x = constrain(x, "dp", "boundary", None)
        if a is not None:
            aux = aux + a
    return x, aux


@on_mesh
def forward(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    frontend_embeds: torch.Tensor | None = None,
    *,
    block_skip: bool = False,
):
    """tokens [B, S] (+ frontend embeds [B, Nf, d]) -> (logits [B, Nf + S,
    V] f32, aux loss: the sum of the MoE layers' load-balance losses,
    f32).  Differentiable: with ``cfg.remat`` each pattern group's
    activations are recomputed in the backward
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of
    its scan body); the prefix layers are not."""
    x, positions = _embed_inputs(params, cfg, tokens, frontend_embeds)
    for i, lp in enumerate(params["prefix"]):
        x, _ = _apply_layer_train(
            lp, cfg, cfg.layer_kind(i), False, x, positions, block_skip=block_skip
        )
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(n_scan_groups(cfg)):
        gp = _group(params["groups"], g)
        if cfg.remat:
            x, aux = checkpoint(
                _group_body, gp, cfg, x, aux, positions, block_skip, use_reentrant=False
            )
        else:
            x, aux = _group_body(gp, cfg, x, aux, positions, block_skip)
    for lp, (kind, is_moe) in zip(params.get("suffix", ()), suffix_kinds(cfg), strict=True):
        x, a = _apply_layer_train(lp, cfg, kind, is_moe, x, positions, block_skip=block_skip)
        if a is not None:
            aux = aux + a
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = constrain(_head(params, cfg, x), "dp", None, "tp")
    return logits.to(torch.float32), aux


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def _empty_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, device, lead=()):
    if kind == "attn":
        return C.make_attn_cache(cfg, batch, max_len, device=device, lead=lead)
    if kind == "mamba":
        dt = torch_dtype(cfg.compute_dtype)
        return S.init_mamba_state(cfg, batch, dt, device=device, lead=lead)._asdict()
    if kind == "mlstm":
        return X.init_mlstm_state(cfg, batch, device=device, lead=lead)._asdict()
    if kind == "slstm":
        return X.init_slstm_state(cfg, batch, device=device, lead=lead)._asdict()
    if kind == "kda":
        return K.init_kda_state(cfg, batch, torch_dtype(cfg.compute_dtype), device=device, lead=lead)._asdict()
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device, graphs: bool = False):
    """Allocate the full decode cache (prefix + stacked groups) on
    ``device``: a KV (or MLA) cache per attention layer, a recurrent state
    per Mamba / xLSTM layer; ``len`` is the number of positions filled.
    With ``graphs`` the cache also keeps ``decode_step``'s CUDA graphs
    (``graphs_fit``), captured at its first step that can replay them."""
    dev = torch.device(device)
    prefix = [
        _empty_layer_cache(cfg, cfg.layer_kind(i), batch, max_len, dev)
        for i in range(n_prefix_layers(cfg))
    ]
    lead = (n_scan_groups(cfg),)
    groups = {
        f"pos{p}": _empty_layer_cache(cfg, kind, batch, max_len, dev, lead)
        for p, kind in enumerate(cfg.pattern)
    }
    cache = {"prefix": prefix, "groups": groups, "len": 0}
    if suffix_kinds(cfg):
        cache["suffix"] = [_empty_layer_cache(cfg, kind, batch, max_len, dev) for kind, _ in suffix_kinds(cfg)]
    if graphs:
        cache["graphs"] = None
    return cache


def _store_state(lcache: dict, state) -> None:
    """Write a recurrent block's new state into its cache views in place
    (a DTensor state is laid out as its cache first, and each shard
    copies its own slice; a state the block already wrote in place is
    left as it is)."""
    for name, t in state._asdict().items():
        dst = lcache[name]
        if isinstance(dst, DTensor):
            dst.to_local().copy_(t.redistribute(dst.device_mesh, dst.placements).to_local())
        elif not (t.data_ptr() == dst.data_ptr() and t.shape == dst.shape and t.stride() == dst.stride()):
            dst.copy_(t)


def _apply_layer_prefill(lp, cfg: ModelConfig, kind, is_moe, x, positions, lcache, start: int):
    """Like the train apply, but fills the layer cache (a KV cache at
    ``start``, or a recurrent state)."""
    with tracing.span(_LAYER_SPANS.get(kind, "layer")):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if kind == "attn":
            with tracing.span("attn.qkv"):
                q, k, v, mla = A.qkv_project(lp["block"], cfg, h, positions)
            with tracing.span("attn.core"):
                out = A.on_local_heads(functools.partial(A.prefill_core, cfg), q, k, v)
            compute = torch_dtype(cfg.compute_dtype)
            with tracing.span("attn.out"):
                y = L.dense(lp["block"]["o"], A._merge_heads(out), compute_dtype=compute)
            with tracing.span("attn.cache_write"):
                C.write_attn_cache(cfg, lcache, k, v, mla, start)
        elif kind == "mamba":
            y, st = S.mamba_block(lp["block"], cfg, h, S.MambaState(**lcache))
            _store_state(lcache, st)
        elif kind == "mlstm":
            y, st = X.mlstm_prefill(lp["block"], cfg, h, X.MLSTMState(**lcache), chunk=cfg.attn_chunk)
            _store_state(lcache, st)
        elif kind == "slstm":
            y, st = X.slstm_block(lp["block"], cfg, h, X.SLSTMState(**lcache))
            _store_state(lcache, st)
        elif kind == "kda":
            # a prompt at position 0 starts from zeros, whatever the cache
            # held (the engine's one graphed cache serves every wave)
            y, st = K.kda_block(lp["block"], cfg, h, K.KDAState(**lcache) if start else None, into=lcache["S"])
            _store_state(lcache, st)
        else:
            raise ValueError(kind)
        x = x + y
    return _ffn(lp, cfg, is_moe, x)[0]


@on_mesh
def prefill(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    cache,
    frontend_embeds: torch.Tensor | None = None,
):
    """Run the prompt (after the frontend's embeddings, if any), filling
    ``cache`` (built by ``init_cache``) in place.  Returns (last-position
    logits [B, 1, V] f32, cache).  As in the reference, the prompt's
    positions count from 0 whatever ``cache["len"]``."""
    with tracing.span("lm.prefill"):
        with tracing.span("lm.embed"):
            x, positions = _embed_inputs(params, cfg, tokens, frontend_embeds)
        start = cache["len"]
        npre, period = n_prefix_layers(cfg), len(cfg.pattern)
        layers = zip(iter_layers(params, cfg), _stacked(cache, cfg), strict=True)
        for i, ((lp, kind, is_moe), lcache) in enumerate(layers):
            in_group = i >= npre
            if in_group and (i - npre) % period == 0:
                x = constrain(x, "dp", "boundary", None)
            x = _apply_layer_prefill(lp, cfg, kind, is_moe, x, positions, lcache, start)
            if in_group:
                x = constrain(x, "dp", "boundary", None)
        with tracing.span("lm.head"):
            x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
            logits = _head(params, cfg, x).to(torch.float32)
        cache["len"] = start + positions.shape[0]
        return logits, cache


def _apply_layer_decode(lp, cfg: ModelConfig, kind, is_moe, x, lcache, cur_len, positions, router=None):
    """One-token step.  x [B,1,d]; cur_len = tokens already in the cache
    (an int, or for MLA the device tensor [cur_len]), ``positions`` =
    [cur_len], this token's position on the device (MLA attends
    ``positions + 1`` positions)."""
    with tracing.span(_LAYER_SPANS.get(kind, "layer")):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        compute = torch_dtype(cfg.compute_dtype)
        if kind == "attn":
            if cfg.kv_lora_rank:  # MLA: the latent is cached and attended; no k or v is made
                with tracing.span("attn.qkv"):
                    q, latent, k_rope = A.mla_project(lp["block"], cfg, h, positions)
                with tracing.span("attn.cache_write"):
                    C.write_attn_cache(cfg, lcache, None, None, (latent, k_rope), cur_len)
                with tracing.span("attn.core"):
                    dh = cfg.head_dim_
                    # the length read on the device, in the eager step as in the graphs
                    out = A.mla_decode_attention(
                        lp["block"], cfg, q[..., :dh], q[..., dh:], lcache["latent"], lcache["k_rope"], positions + 1
                    )
            else:
                with tracing.span("attn.qkv"):
                    q, k, v, mla = A.qkv_project(lp["block"], cfg, h, positions)
                with tracing.span("attn.cache_write"):
                    C.write_attn_cache(cfg, lcache, k, v, mla, cur_len)
                with tracing.span("attn.core"):
                    window = cfg.window if cfg.attn_kind == "swa" else 0
                    kc, vc = C.read_attn_cache(cfg, lcache, compute)
                    out = A.decode_attention(q, kc, vc, cur_len + 1, window=window)
            with tracing.span("attn.out"):
                y = L.dense(lp["block"]["o"], A._merge_heads(out), compute_dtype=compute)
        elif kind == "mamba":
            y, st = S.mamba_decode_step(lp["block"], cfg, h, S.MambaState(**lcache))
            _store_state(lcache, st)
        elif kind == "mlstm":
            y, st = X.mlstm_decode_step(lp["block"], cfg, h, X.MLSTMState(**lcache))
            _store_state(lcache, st)
        elif kind == "slstm":
            y, st = X.slstm_decode_step(lp["block"], cfg, h, X.SLSTMState(**lcache))
            _store_state(lcache, st)
        elif kind == "kda":
            y, st = K.kda_block(lp["block"], cfg, h, K.KDAState(**lcache), into=lcache["S"])
            _store_state(lcache, st)
        else:
            raise ValueError(kind)
        x = x + y
    return _ffn(lp, cfg, is_moe, x, router)[0]


def graphs_fit(cfg: ModelConfig) -> bool:
    """Whether ``decode_step`` can run the model's step as CUDA graphs:
    MLA attention or KDA in every layer.  The absorbed decode reads its
    length from the device (the kernel stops there, the plain version
    masks the rest), and KDA's step is the same recurrence from the state
    in place, so every step of a cache has one shape."""
    return bool(cfg.kv_lora_rank) and all(kind in ("attn", "kda") for kind, _ in layer_kinds(cfg))


def _replays(params, token: torch.Tensor) -> bool:
    """Whether this step may replay graphs: plain CUDA tensors, nothing
    recording (its counters read the device back) or differentiating, and
    no product routed to the scheduled GEMM, whose launches are counted
    on the host (a batch of fewer than the policy's ``min_m`` rows)."""
    table, pol = params["embed"]["table"], get_policy()
    return (table.is_cuda and not isinstance(table, DTensor) and tracing.active() is None
            and not torch.is_grad_enabled() and (pol is None or token.shape[0] < pol.min_m))


def _decode_body(params, cfg: ModelConfig, cache, token, cur_len, positions, router=None):
    """Embedding, every layer and the head of one decode step -> logits
    [B, 1, V] f32 (``cur_len`` and ``positions`` as
    ``_apply_layer_decode`` takes them)."""
    with tracing.span("lm.embed"):
        x = L.embed(params["embed"], token).to(torch_dtype(cfg.compute_dtype))
    npre, period = n_prefix_layers(cfg), len(cfg.pattern)
    layers = zip(iter_layers(params, cfg), _stacked(cache, cfg), strict=True)
    for i, ((lp, kind, is_moe), lcache) in enumerate(layers):
        if i >= npre and (i - npre) % period == 0:
            x = constrain(x, "dp", "boundary", None)
        x = _apply_layer_decode(lp, cfg, kind, is_moe, x, lcache, cur_len, positions, router)
    with tracing.span("lm.head"):
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return _head(params, cfg, x).to(torch.float32)


class _DecodeGraphs:
    """A cache's decode step as CUDA graphs, one before each MoE layer's
    router and one after the last: the host launches a graph where the
    eager step launches a few hundred kernels.  Between the graphs each
    router runs eagerly through ``moe.route``, as the eager step calls
    it, on the input the graph before it left, and its weights and
    experts are copied into the buffers the graph after it reads.  The
    token and the position are read from device buffers, so one capture
    serves every step of the cache; the graphs share one memory pool and
    replay in the order they were captured.  The port's kernels count their
    launches on the host as they are issued, so the counts the capture
    recorded (``launches``) are taken off at capture and added at each
    replay."""

    def __init__(self, params, cfg: ModelConfig, cache, token: torch.Tensor):
        dev, t = token.device, token.numel()
        self.token = token.clone()
        self.pos = torch.full((1,), cache["len"], dtype=torch.long, device=dev)
        k = cfg.moe.top_k if cfg.moe is not None else 0
        self.routed = [
            (torch.empty(t, k, dtype=torch.float32, device=dev), torch.empty(t, k, dtype=torch.long, device=dev))
            for _, _, is_moe in iter_layers(params, cfg)
            if is_moe
        ]
        self.routers: list = []  # (the MoE FFN's parameters, its router's input), in order
        self.graphs: list = []
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        # the recurrent states (KDA's) before the eager step, put back after
        # it: the replay advances them from where the step found them
        states = [(t, t.clone()) for lc, (kind, _) in zip(_stacked(cache, cfg), layer_kinds(cfg), strict=True)
                  if kind != "attn" for t in lc.values()]
        with torch.cuda.stream(stream):
            # one eager step on the capture's stream first (cuBLAS's state for
            # it; its routers run through moe.route too); it writes the cache
            # row that the replay writes again
            _decode_body(params, cfg, cache, self.token, self.pos, self.pos)
            for t, saved in states:
                t.copy_(saved)
            stream.synchronize()
            del states
            before = build.launches()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=pool)

            def cut(ffn, _cfg, xt):
                nonlocal graph
                graph.capture_end()
                self.graphs.append(graph)
                self.routers.append((ffn, xt))
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=pool)
                weights, idx = self.routed[len(self.routers) - 1]
                return weights, idx, None

            self.logits = _decode_body(params, cfg, cache, self.token, self.pos, self.pos, cut)
            graph.capture_end()
            self.graphs.append(graph)
        torch.cuda.current_stream(dev).wait_stream(stream)
        # the kernels counted while capturing ran nowhere: they launch at each replay
        self.launches = {key: n - before[key] for key, n in build.launches().items() if n != before[key]}
        build.add_launches(self.launches, -1)

    def __call__(self, cfg: ModelConfig, token: torch.Tensor, cur_len: int) -> torch.Tensor:
        self.token.copy_(token)
        self.pos.fill_(cur_len)
        for graph, router, routed in zip(self.graphs, self.routers + [None], self.routed + [None], strict=True):
            graph.replay()
            if router is not None:
                ffn, xt = router
                weights, idx, _ = M.route(ffn, cfg, xt)
                routed[0].copy_(weights)
                routed[1].copy_(idx)
        build.add_launches(self.launches)
        return self.logits.clone()


@on_mesh
def decode_step(params, cfg: ModelConfig, cache, token: torch.Tensor):
    """token [B, 1] -> (logits [B, 1, V] f32, cache), the cache updated in
    place.  A cache made with ``graphs=True`` for a model that
    ``graphs_fit`` replays the step as CUDA graphs (``_DecodeGraphs``,
    captured at the first step that ``_replays``); the logits are then a
    copy of the graphs' output, and the routers still run through
    ``moe.route``."""
    cur_len = cache["len"]
    if "graphs" in cache and graphs_fit(cfg) and _replays(params, token):
        if cache["graphs"] is None:
            cache["graphs"] = _DecodeGraphs(params, cfg, cache, token)
        logits = cache["graphs"](cfg, token, cur_len)
        cache["len"] = cur_len + 1
        return logits, cache
    with tracing.span("lm.decode_step"):
        # made on the device (no host-to-device copy, which would wait for
        # the queued work)
        positions = torch.arange(cur_len, cur_len + 1, device=token.device)
        logits = _decode_body(params, cfg, cache, token, cur_len, positions)
        cache["len"] = cur_len + 1
        return logits, cache
