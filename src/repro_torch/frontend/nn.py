"""Plain-torch spellings of the quantized-NN idioms the frontend recognizes.

The quantization helpers are ordinary torch compositions, written in the
shape the importer raises back into single IR ops; model code is free to
inline the same expressions by hand:

    quantize(x, s)    = clamp(round(x / s), -128, 127).to(int8)    -> ir.quantize
    requantize(x, s)  = clamp(round(x * s), iinfo range).to(int8)  -> ir.requantize
    dequantize(x, s)  = x.to(float32) * s                          -> ir.dequantize

The other five are ``torch.library`` custom ops in the ``repro_torch``
namespace, each with a fake (shape) function, so ``torch.export`` keeps
every call as one node the importer maps 1:1 onto an IR op:

    dense(x, w)                = matmul, integers accumulate wide (int32) -> ir.dense
    conv2d(x, w, stride, pad)  = NHWC/HWIO conv, integers to int32        -> ir.conv2d
    max_pool2d(x, size, str.)  = NHWC square window max                   -> ir.max_pool2d
    kv_cache_read(c)           = c (identity; marks state consumption)    -> ir.kv_cache_read
    kv_cache_append(c, u, p)   = write u's rows at sequence position p    -> ir.kv_cache_append

Each has its reason to be an op: torch has no ``preferred_element_type``
(an int8 ``torch.matmul`` wraps in int8), aten's conv and pooling are
NCHW where the IR is NHWC/HWIO, and the cache ops must appear as one node
each, as the reference's named jits do.

Port of ``repro.frontend.nn``.  The ops' eager bodies are plain torch on
the tensors' device (integer operands accumulate in int64, which torch
multiplies on the CPU); they are the twins' eager semantics and never run
on a compiled path, where the IR op runs on the scheduled kernel or the
host ops instead.
"""

from typing import Optional

import torch
import torch.nn.functional as F


def quantize(x, scale: float, dtype=torch.int8):
    """Symmetric quantization: round(x / scale), clipped to [-128, 127]."""
    return torch.clamp(torch.round(x / scale), -128, 127).to(dtype)


def requantize(x, scale: float, dtype=torch.int8):
    """Requantization: round(x * scale) with a saturating cast to ``dtype``."""
    info = torch.iinfo(dtype)
    return torch.clamp(torch.round(x * scale), info.min, info.max).to(dtype)


def dequantize(x, scale: float):
    return x.to(torch.float32) * scale


def _wide_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.is_floating_point():
        return torch.matmul(x, w)
    return torch.matmul(x.to(torch.int64), w.to(torch.int64)).to(torch.int32)


def _out_dtype(x: torch.Tensor) -> torch.dtype:
    return x.dtype if x.is_floating_point() else torch.int32


@torch.library.custom_op("repro_torch::dense", mutates_args=())
def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x[..., C] @ w[C, K]; integer operands accumulate wide (int32),
    matching ``ir.dense``.  A 3-D ``w`` is the batched
    activation-activation matmul ``x[B, M, C] @ w[B, C, K]``."""
    return _wide_matmul(x, w)


@dense.register_fake
def _dense_fake(x, w):
    if w.dim() == 3:
        shape = (x.shape[0], x.shape[1], w.shape[-1])
    else:
        shape = (*x.shape[:-1], w.shape[-1])
    return x.new_empty(shape, dtype=_out_dtype(x))


def _conv_shape(x, w, stride: int, padding: int):
    n, h, wd, _ = x.shape
    kh, kw, _, co = w.shape
    return (n, (h + 2 * padding - kh) // stride + 1, (wd + 2 * padding - kw) // stride + 1, co)


@torch.library.custom_op("repro_torch::conv2d", mutates_args=())
def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NHWC conv with HWIO weights; integer operands accumulate to int32."""
    kh, kw, ci, co = w.shape
    xp = F.pad(x, (0, 0, padding, padding, padding, padding)) if padding else x
    cols = xp.unfold(1, kh, stride).unfold(2, kw, stride)  # n, oh, ow, c, kh, kw
    n, oh, ow = cols.shape[:3]
    cols = cols.permute(0, 1, 2, 4, 5, 3).reshape(n, oh, ow, kh * kw * ci)
    return _wide_matmul(cols, w.reshape(kh * kw * ci, co))


@conv2d.register_fake
def _conv2d_fake(x, w, stride=1, padding=0):
    return x.new_empty(_conv_shape(x, w, stride, padding), dtype=_out_dtype(x))


def _pool_shape(x, size: int, stride: int):
    n, h, w, c = x.shape
    return (n, (h - size) // stride + 1, (w - size) // stride + 1, c)


@torch.library.custom_op("repro_torch::max_pool2d", mutates_args=())
def max_pool2d(x: torch.Tensor, size: int = 2, stride: Optional[int] = None) -> torch.Tensor:
    """NHWC max pooling with a square window (no padding)."""
    stride = size if stride is None else stride
    _, oh, ow, _ = _pool_shape(x, size, stride)
    out = None
    for i in range(size):
        for j in range(size):
            win = x[:, i : i + oh * stride : stride, j : j + ow * stride : stride, :]
            out = win.clone() if out is None else torch.maximum(out, win)
    return out


@max_pool2d.register_fake
def _max_pool2d_fake(x, size=2, stride=None):
    return x.new_empty(_pool_shape(x, size, size if stride is None else stride))


@torch.library.custom_op("repro_torch::kv_cache_read", mutates_args=())
def kv_cache_read(cache: torch.Tensor) -> torch.Tensor:
    """Materialize the KV cache for attention -> ``ir.kv_cache_read``
    (numerically the identity)."""
    return cache.clone()


@kv_cache_read.register_fake
def _kv_cache_read_fake(cache):
    return torch.empty_like(cache)


@torch.library.custom_op("repro_torch::kv_cache_append", mutates_args=())
def kv_cache_append(cache: torch.Tensor, update: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Write ``update``'s rows into a copy of ``cache`` at sequence position
    ``pos`` (axis -2) -> ``ir.kv_cache_append``.

    ``pos`` is a scalar, or ``[B]`` for per-request positions on a batched
    ``[B, L, D]`` cache.  A write past the end raises ``ValueError``, as
    the IR executor does."""
    s, limit = update.shape[-2], cache.shape[-2]
    out = cache.clone()
    starts = [int(pos)] if pos.dim() == 0 else [int(p) for p in pos.reshape(-1)]
    for b, p in enumerate(starts):
        if p < 0 or p + s > limit:
            raise ValueError(f"kv_cache_append out of bounds: pos {p} + {s} > {limit}")
        if pos.dim() == 0:
            out[..., p : p + s, :] = update
        else:
            out[b, ..., p : p + s, :] = update[b]
    return out


@kv_cache_append.register_fake
def _kv_cache_append_fake(cache, update, pos):
    return torch.empty_like(cache)
