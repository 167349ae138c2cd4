"""The least time of the fused prefill attention on one H100
(``csrc/attention_wgmma.cu``, ``prefill_attention_kernel<D, Dv>``): a
causal launch over q [B, H, S, Dqk], k [B, H, S, Dqk] and v [B, H, S,
Dv] in bf16, at the published rates of ``hopper.py``.

Operations: the two products over the causal pairs, 2 B H S (S + 1) / 2
(Dqk + Dv).  Bytes: q, k, v read once and the output [B, H, S, Dv]
written once, 2 B H S (2 Dqk + 2 Dv) (MLA's k is the expanded one each
head reads).  The least time is the larger of the operations over the
bf16 peak and the bytes over the memory bandwidth.
"""

from __future__ import annotations

import hopper


def attention_flops(b: int, h: int, s: int, dqk: int, dv: int) -> float:
    return 2.0 * b * h * s * (s + 1) / 2 * (dqk + dv)


def attention_bytes(b: int, h: int, s: int, dqk: int, dv: int) -> float:
    return 2.0 * b * h * s * (2 * dqk + 2 * dv)


def attention_least_s(b: int, h: int, s: int, dqk: int, dv: int) -> float:
    return max(attention_flops(b, h, s, dqk, dv) / hopper.PEAK_FLOPS["bfloat16"],
               attention_bytes(b, h, s, dqk, dv) / hopper.HBM_BYTES_PER_S)
