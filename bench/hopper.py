"""One NVIDIA H100 SXM's published rates (NVIDIA's data sheet: dense, no
sparsity, at the 700 W limit) and the least time of a matrix product.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``PEAK_OPS_PER_S``,
``bound``), with one change: a float32 product is held to the TF32
tensor-core rate, since the port's float32 form runs on the tensor cores.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"int8": 1979e12, "bfloat16": 989e12, "float16": 989e12, "float32": 495e12}
#: the peak that model FLOP utilisation is stated against (bf16 dense)
MFU_PEAK_FLOPS = PEAK_FLOPS["bfloat16"]
ITEM_BYTES = {"int8": 1, "bfloat16": 2, "float16": 2, "float32": 4}


def gemm_least_s(m: int, k: int, n: int, in_dtype: str, out_dtype: str, bias_dtype: str | None) -> float:
    """The least time of out[m, n] = x[m, k] @ w[k, n] (+ bias[n]) on the
    card: the larger of its operations over the peak rate and its bytes
    over the memory bandwidth, each input byte read once and each output
    byte written once."""
    nbytes = (m * k + k * n) * ITEM_BYTES[in_dtype] + m * n * ITEM_BYTES[out_dtype]
    if bias_dtype is not None:
        nbytes += n * ITEM_BYTES[bias_dtype]
    return max(2.0 * m * k * n / PEAK_FLOPS[in_dtype], nbytes / HBM_BYTES_PER_S)
