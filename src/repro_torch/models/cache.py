"""Decode-time state: KV caches (bf16, f32 or int8-quantized) and MLA
latent caches, structured per pattern position and stacked across scan
groups (the recurrent states of Mamba and xLSTM live beside them, in
``repro_torch.models.lm``).

int8 KV quantization (per token-head symmetric scale) halves the cache
footprint and ties directly into the paper's quantized-operator story.

Port of ``repro.models.cache``.  Two deliberate differences from the
reference:

* ``write_attn_cache`` writes in place, into the cache's own tensors
  (usually views of the stacked group caches), and returns the same dict.
  The reference's ``dynamic_update_slice`` is functional; copying a full
  cache per layer per decode step would dominate a step at full width.
* a write past the end (``pos + S > max_len``) raises ``ValueError``.
  ``dynamic_update_slice`` clamps the start index instead, silently
  overwriting the last rows.

The MLA cache keeps the reference's dtypes: ``k_rope`` is always
bfloat16, whatever ``kv_cache_dtype`` says, and the latent is bfloat16
when ``kv_cache_dtype`` is ``"int8"`` (it is never quantized).
"""

from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.kernels.ref import torch_dtype
from repro_torch.models.config import ModelConfig

# ---------------------------------------------------------------------------
# quantized KV storage
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor):
    """[..., S, D] -> int8 values + f32 per-(…,S) scale (round half to even)."""
    x32 = x.to(torch.float32)
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-8)
    q = torch.clamp(torch.round(x32 / scale), -128, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16):
    return (q.to(torch.float32) * scale).to(dtype)


# ---------------------------------------------------------------------------
# cache constructors
# ---------------------------------------------------------------------------


def make_attn_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, device=None, lead=()
) -> dict[str, Any]:
    """Zeroed K/V (and int8 scale) tensors, [*lead, B, Hkv, max_len, D];
    for MLA the latent [*lead, B, max_len, r] and k_rope [*lead, B,
    max_len, dr]."""
    if cfg.kv_lora_rank:
        latent_dtype = torch.bfloat16 if cfg.kv_cache_dtype == "int8" else torch_dtype(cfg.kv_cache_dtype)
        return {
            "latent": torch.zeros((*lead, batch, max_len, cfg.kv_lora_rank), dtype=latent_dtype, device=device),
            "k_rope": torch.zeros((*lead, batch, max_len, cfg.qk_rope_dim), dtype=torch.bfloat16, device=device),
        }
    dh = cfg.head_dim_
    kvd = torch.int8 if cfg.kv_cache_dtype == "int8" else torch_dtype(cfg.kv_cache_dtype)
    shape = (*lead, batch, cfg.n_kv_heads, max_len, dh)
    cache = {
        "k": torch.zeros(shape, dtype=kvd, device=device),
        "v": torch.zeros(shape, dtype=kvd, device=device),
    }
    if cfg.kv_cache_dtype == "int8":
        cache["k_scale"] = torch.zeros((*shape[:-1], 1), dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros((*shape[:-1], 1), dtype=torch.float32, device=device)
    return cache


def _write(dst: torch.Tensor, src: torch.Tensor, pos: int) -> None:
    s, max_len = src.shape[-2], dst.shape[-2]
    if pos < 0 or pos + s > max_len:
        raise ValueError(
            f"KV cache write of {s} rows at position {pos} overflows the "
            f"{max_len}-row cache"
        )
    if isinstance(dst, DTensor):
        _write_sharded(dst, src, pos)
        return
    dst[..., pos : pos + s, :] = src.to(dst.dtype)


def _write_sharded(dst, src: torch.Tensor, pos: int) -> None:
    """The write into a DTensor cache, shard by shard: ``src`` laid out as
    ``dst`` but whole along the rows, then each shard writes the rows
    that fall in its own slice of the positions (the sequence-parallel
    caches shard them over the model axis)."""
    row = dst.ndim - 2
    want = [Replicate() if p == Shard(row) else p for p in dst.placements]
    if isinstance(src, DTensor):
        src = src.redistribute(dst.device_mesh, want)
    else:
        src = distribute_tensor(src, dst.device_mesh, want)
    local, src = dst.to_local(), src.to_local()
    # this shard's first row: mesh dims split the rows in order, each into
    # ceil-sized chunks (DTensor's layout)
    first, extent = 0, dst.shape[row]
    for i, p in enumerate(dst.placements):
        if p == Shard(row):
            chunk = -(-extent // dst.device_mesh.size(i))
            c = dst.device_mesh.get_local_rank(i)
            first += c * chunk
            extent = max(0, min(chunk, extent - c * chunk))
    lo = max(pos, first)
    hi = min(pos + src.shape[row], first + local.shape[row])
    if lo < hi:
        local[..., lo - first : hi - first, :] = src[..., lo - pos : hi - pos, :].to(local.dtype)


def write_attn_cache(cfg: ModelConfig, cache: dict, k, v, mla_payload, pos: int):
    """Insert keys/values (k/v [B, Hkv, S, D]), or the MLA payload
    (latent [B, S, r], k_rope [B, S, dr]), at positions [pos, pos + S) in
    place; returns ``cache``.  Raises ``ValueError`` when the rows do not
    fit."""
    pos = int(pos)
    if cfg.kv_lora_rank:
        latent, k_rope = mla_payload
        _write(cache["latent"], latent, pos)
        _write(cache["k_rope"], k_rope, pos)
        return cache
    if cfg.kv_cache_dtype == "int8":
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        for name, t in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
            _write(cache[name], t, pos)
        return cache
    _write(cache["k"], k, pos)
    _write(cache["v"], v, pos)
    return cache


def read_attn_cache(cfg: ModelConfig, cache: dict, dtype=torch.bfloat16):
    """Return dequantized (k, v), or the MLA payload (latent, k_rope); a
    float cache comes back in its own dtype."""
    if cfg.kv_lora_rank:
        return cache["latent"], cache["k_rope"]
    if cfg.kv_cache_dtype == "int8":
        return (
            dequantize_kv(cache["k"], cache["k_scale"], dtype),
            dequantize_kv(cache["v"], cache["v_scale"], dtype),
        )
    return cache["k"], cache["v"]
