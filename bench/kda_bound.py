"""The least time of KDA's recurrence on one H100 (``csrc/kda_recurrent.cu``,
``kda_recurrent_kernel``): a launch over q, k [B, T, H, K] and v [B, T, H,
V] in bf16, g [B, T, H, K] and beta [B, T, H] in f32, from and to a [B,
H, K, V] f32 state, at the published rates of ``hopper.py``, whatever
implements it.

Operations: 7 K V a token and head (the decay's multiply, S^T k, the
rank-one update and S^T q, the last three a multiply and an add each).
Bytes: q, k, v and the output o in bf16, g and beta in f32 for each of
the B T tokens and H heads, and the state read and written once.  The
least time is the larger of the operations over the bf16 peak and the
bytes over the memory bandwidth.
"""

from __future__ import annotations

import hopper


def kda_flops(b: int, t: int, h: int, k: int, v: int) -> float:
    return 7.0 * k * v * h * b * t


def kda_bytes(b: int, t: int, h: int, k: int, v: int) -> float:
    per_token = 2 * (2 * k + 2 * v) + 4 * k + 4
    return float(b * t * h * per_token + b * h * k * v * 4 * 2)


def kda_least_s(b: int, t: int, h: int, k: int, v: int) -> float:
    return max(kda_flops(b, t, h, k, v) / hopper.PEAK_FLOPS["bfloat16"],
               kda_bytes(b, t, h, k, v) / hopper.HBM_BYTES_PER_S)
