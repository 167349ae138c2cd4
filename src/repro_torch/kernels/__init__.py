"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  Port of ``repro.kernels``."""

from repro_torch.kernels.gemm import GemmKernelConfig, scheduled_gemm
from repro_torch.kernels.qgemm import scheduled_qgemm

__all__ = ["GemmKernelConfig", "scheduled_gemm", "scheduled_qgemm"]
