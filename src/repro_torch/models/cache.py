"""Decode-time state: KV caches (bf16, f32 or int8-quantized), structured
per pattern position and stacked across scan groups.

int8 KV quantization (per token-head symmetric scale) halves the cache
footprint and ties directly into the paper's quantized-operator story.

Port of ``repro.models.cache`` for attention caches.  Two deliberate
differences from the reference:

* ``write_attn_cache`` writes in place, into the cache's own tensors
  (usually views of the stacked group caches), and returns the same dict.
  The reference's ``dynamic_update_slice`` is functional; copying a full
  cache per layer per decode step would dominate a step at full width.
* a write past the end (``pos + S > max_len``) raises ``ValueError``.
  ``dynamic_update_slice`` clamps the start index instead, silently
  overwriting the last rows.

The MLA latent cache (``kv_lora_rank``) waits for the MLA slice
(ROADMAP Queue A item 5) and raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.ref import torch_dtype
from repro_torch.models.config import ModelConfig

#: what the MLA branches raise
MLA_NOT_PORTED = (
    "MLA compressed-KV attention (kv_lora_rank) is not ported yet: "
    "ROADMAP.md Queue A item 5"
)


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
    """Zeroed K/V (and int8 scale) tensors, [*lead, B, Hkv, max_len, D]."""
    if cfg.kv_lora_rank:
        raise NotImplementedError(MLA_NOT_PORTED)
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
    dst[..., pos : pos + s, :] = src.to(dst.dtype)


def write_attn_cache(cfg: ModelConfig, cache: dict, k, v, mla_payload, pos: int):
    """Insert keys/values at positions [pos, pos + S) in place (k/v are
    [B, Hkv, S, D]); returns ``cache``.  Raises ``ValueError`` when the
    rows do not fit."""
    if cfg.kv_lora_rank:
        raise NotImplementedError(MLA_NOT_PORTED)
    pos = int(pos)
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
    """Return dequantized (k, v); a float cache comes back in its own dtype."""
    if cfg.kv_lora_rank:
        raise NotImplementedError(MLA_NOT_PORTED)
    if cfg.kv_cache_dtype == "int8":
        return (
            dequantize_kv(cache["k"], cache["k_scale"], dtype),
            dequantize_kv(cache["v"], cache["v_scale"], dtype),
        )
    return cache["k"], cache["v"]
