"""Public wrappers around the scheduled GEMM kernel.

They flatten leading batch dims into m, make the operands contiguous and
bring the bias to the accumulator's dtype, then call the kernel.  The
kernel masks ragged edges, so there is no padding here; where the tensors
lie decides what runs (see ``scheduled_gemm``).

Port of ``repro.kernels.ops``.  The reference's ``use_pallas=False``
branch has no counterpart: the plain version follows the tensor's device.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.gemm import GemmKernelConfig, scheduled_gemm
from repro_torch.kernels.qgemm import scheduled_qgemm


def _operands(x: torch.Tensor, w: torch.Tensor, bias, acc_dtype: str):
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    w2 = w.contiguous()
    if bias is not None:
        bias = bias.to(ref.torch_dtype(acc_dtype)).contiguous()
    return x2, w2, bias


def matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg: GemmKernelConfig,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """epilogue(x @ w + bias) with leading batch dims on x flattened into m."""
    *batch, m_in, _ = x.shape
    x2, w2, b = _operands(x, w, bias, cfg.acc_dtype)
    if b is not None and not cfg.has_bias:
        cfg = replace(cfg, has_bias=True)
    out = scheduled_gemm(x2, w2, cfg, b)
    return out.reshape(*batch, m_in, w.shape[1])


def qmatmul(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    bias: torch.Tensor | None,
    cfg: GemmKernelConfig,
) -> torch.Tensor:
    """Quantized generalized dense (int8 in/out, fused requant+clip)."""
    *batch, m_in, _ = x_q.shape
    x2, w2, b = _operands(x_q, w_q, bias, "int32")
    out = scheduled_qgemm(x2, w2, b, cfg)
    return out.reshape(*batch, m_in, w_q.shape[1])
