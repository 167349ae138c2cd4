"""The scheduled GEMM kernel — the Hopper lowering of the paper's mapping
generator output.

Port of ``repro.kernels.gemm`` (the TPU kernel ``_gemm_kernel``, reached
through ``pl.pallas_call``).  The extended-CoSA ``Schedule`` fixes the
buffer tile shape (block_m/k/n) and the dataflow.  On the card
(``csrc/gemm.cu``) each (block_m x block_n) output block of the config is
one thread-block cluster of up to 8 CTAs, and the dataflow sets the raster
order of the clusters (OS: m outer, WS: n outer, as ``grid_for``).  At the
serving shapes (M = 16) the time is the launch plus one pass over K, so
the cluster spreads a block over several SMs: its CTAs split the block's
columns into tiles of at most 128 and its K range into slices of whole
32-deep stages, each CTA runs its slice on the tensor cores (``mma.sync``:
int8 m16n8k32 with an int32 accumulator that wraps mod 2**32 as the
reference's does; bf16 m16n8k16; f32 as 3xTF32 m16n8k8, within float32
rounding), and the partial sums meet through distributed shared memory in
a fixed rank order, so two launches give the same bits.  The epilogue
(bias, then requantize + clip or an activation, then the cast) runs once
on the full sum before the one store.  ``launch_geometry`` is that split,
a pure function of the shape and the config; block_k no longer shapes the
launch (integer sums are exact in any order, float sums within rounding).

Kernel-naming convention: m, k, n are the GEMM dims (paper's N, C, K).

``scheduled_gemm`` launches the CUDA kernel for a CUDA tensor and raises if
it cannot; for a CPU tensor it runs the plain PyTorch version
(``repro_torch.kernels.ref``); any other device raises.  The kernel masks
ragged edges itself, so operands need not be multiples of the block shape.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass

import torch

from repro_torch.kernels import build, ref


@dataclass(frozen=True)
class GemmKernelConfig:
    """Everything the mapping generator derives from a Schedule."""

    block_m: int
    block_k: int
    block_n: int
    dataflow: str = "OS"  # OS: blocks m outer; WS: blocks n outer
    acc_dtype: str = "float32"
    out_dtype: str = "float32"
    # epilogue (quantized generalized op): requantize+clip, or activation
    requant_scale: float | None = None
    clip_lo: float | None = None
    clip_hi: float | None = None
    activation: str | None = None
    has_bias: bool = False

    def grid_for(self, m: int, k: int, n: int) -> tuple[int, int, int]:
        gm, gk, gn = m // self.block_m, k // self.block_k, n // self.block_n
        if self.dataflow == "WS":
            return (gn, gm, gk)
        return (gm, gn, gk)


#: depth of one K stage, widest column tile of a CTA, largest (portable)
#: cluster: the constants kStageK, kTileN and kMaxCluster of csrc/gemm.cu
STAGE_K = 32
TILE_N = 128
MAX_CLUSTER = 8


@dataclass(frozen=True)
class LaunchGeometry:
    """How one launch of ``csrc/gemm.cu`` covers an (m, k, n) product.

    ``grid`` counts the config's output blocks in raster order, (outer,
    inner) as ``GemmKernelConfig.grid_for`` orders them; each block is a
    cluster of ``col_split * k_split`` CTAs.  Rank r of a cluster takes the
    column tiles ``r // k_split + i * col_split`` (``col_tile`` columns
    each) and the K slice ``k_slices()[r % k_split]``."""

    grid: tuple[int, int]
    col_split: int
    k_split: int
    col_tile: int
    k: int

    @property
    def cluster(self) -> int:
        return self.col_split * self.k_split

    @property
    def stages(self) -> int:
        return -(-self.k // STAGE_K)

    def k_slices(self) -> list[tuple[int, int]]:
        """Each K slice as [begin, end) in elements: whole stages, balanced,
        the last cut at k (the kernel's rule)."""
        s = self.stages
        return [
            (i * s // self.k_split * STAGE_K, min((i + 1) * s // self.k_split * STAGE_K, self.k))
            for i in range(self.k_split)
        ]


def _pow2_ceil(v: int) -> int:
    return 1 << (v - 1).bit_length()


def _pow2_floor(v: int) -> int:
    return 1 << (v.bit_length() - 1)


@functools.lru_cache(maxsize=4096)
def launch_geometry(m: int, k: int, n: int, cfg: GemmKernelConfig) -> LaunchGeometry:
    """The cluster split of each config block, for m, n >= 1.

    Columns first: the block's columns (at most ``block_n``, at most n)
    spread over the fewest power-of-two CTAs whose tiles are at most
    ``TILE_N`` wide (multiples of 16, the kernel's copy granule), up to
    ``MAX_CLUSTER``; wider blocks loop over tiles.  The cluster's remaining
    room splits K, into a power of two of at most one slice per stage.  A
    block of one column tile and one stage is one CTA."""
    grid_m, grid_n = -(-m // cfg.block_m), -(-n // cfg.block_n)
    grid = (grid_n, grid_m) if cfg.dataflow == "WS" else (grid_m, grid_n)
    cols = min(cfg.block_n, n)
    col_split = min(MAX_CLUSTER, _pow2_ceil(-(-cols // TILE_N)))
    per_cta = -(-cols // col_split)
    col_tile = min(TILE_N, (per_cta + 15) // 16 * 16)
    k_split = min(MAX_CLUSTER // col_split, _pow2_floor(max(-(-k // STAGE_K), 1)))
    return LaunchGeometry(grid, col_split, k_split, col_tile, k)


def vector_copies(t: torch.Tensor, *row_lengths: int) -> bool:
    """Whether the kernel may stage ``t`` with 16-byte ``cp.async``: its
    base and every row offset it is cut at (``row_lengths``, in elements)
    are 16-byte aligned.  Otherwise it copies element by element."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(r * size % 16 == 0 for r in row_lengths)


def copy_paths(x: torch.Tensor, w: torch.Tensor, cfg: GemmKernelConfig) -> tuple[bool, bool]:
    """(x, w): whether each operand is staged with 16-byte copies.  x is cut
    at its rows; w at its rows and, with more than one block of columns, at
    every block's first column."""
    k, n = w.shape
    grid_n = -(-n // cfg.block_n)
    return vector_copies(x, k), vector_copies(w, n, cfg.block_n if grid_n > 1 else n)


#: kernel launches per instantiation of ``csrc/gemm.cu``, counted where the
#: kernel launches and nowhere else (the plain version never counts); a
#: serving dispatcher thread launches beside the caller's, so the count
#: moves under a lock
LAUNCHES: dict[str, int] = {"qgemm_requant": 0, "gemm_int32": 0, "gemm_float": 0}
_launches_lock = threading.Lock()


def record_launch(cfg: GemmKernelConfig) -> None:
    """Count one launch of the instantiation ``cfg`` selects."""
    with _launches_lock:
        LAUNCHES[variant(cfg)] += 1


def reset_launches() -> None:
    with _launches_lock:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


_IN_TYPES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
_OUT_TYPES = {torch.int8: 0, torch.int32: 1, torch.float32: 2, torch.bfloat16: 3}
_EPILOGUES = {None: 0, "relu": 1, "gelu": 2, "requant": 3}
#: (input, accumulator) -> output types and epilogues the kernel is built for
_SUPPORTED = {
    (torch.int8, torch.int32): (
        (torch.int8, torch.int32, torch.float32),
        (None, "relu", "requant"),
    ),
    (torch.float32, torch.float32): (
        (torch.float32, torch.bfloat16),
        (None, "relu", "gelu"),
    ),
    (torch.bfloat16, torch.float32): (
        (torch.float32, torch.bfloat16),
        (None, "relu", "gelu"),
    ),
}


def _epilogue(cfg: GemmKernelConfig) -> str | None:
    return "requant" if cfg.requant_scale is not None else cfg.activation


def variant(cfg: GemmKernelConfig) -> str:
    """Which instantiation of the kernel a config selects (the key of
    ``LAUNCHES``)."""
    if cfg.requant_scale is not None:
        return "qgemm_requant"
    if cfg.acc_dtype == "int32":
        return "gemm_int32"
    return "gemm_float"


def _check(x: torch.Tensor, w: torch.Tensor, cfg: GemmKernelConfig, bias) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(
            f"scheduled_gemm needs x[m,k] @ w[k,n], got "
            f"{tuple(x.shape)} @ {tuple(w.shape)}"
        )
    if cfg.has_bias != (bias is not None):
        raise ValueError("cfg.has_bias does not match bias argument")
    if bias is not None and tuple(bias.shape) != (w.shape[1],):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({w.shape[1]},)")
    if x.dtype != w.dtype:
        raise ValueError(f"operand dtypes differ: {x.dtype} vs {w.dtype}")
    acc_t = ref.torch_dtype(cfg.acc_dtype)
    supported = _SUPPORTED.get((x.dtype, acc_t))
    if (
        supported is None
        or ref.torch_dtype(cfg.out_dtype) not in supported[0]
        or _epilogue(cfg) not in supported[1]
    ):
        raise ValueError(
            f"the scheduled GEMM kernel has no instantiation for {x.dtype} inputs, "
            f"{cfg.acc_dtype} accumulator, {cfg.out_dtype} output and epilogue "
            f"{_epilogue(cfg)!r}"
        )
    if cfg.requant_scale is not None and (cfg.clip_lo is None or cfg.clip_hi is None):
        raise ValueError("a requantizing config needs clip_lo and clip_hi")
    if min(cfg.block_m, cfg.block_k, cfg.block_n) < 1:
        raise ValueError(f"block shape must be positive: {cfg}")


def gemm_plain(
    x: torch.Tensor, w: torch.Tensor, cfg: GemmKernelConfig, bias=None
) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device."""
    if cfg.requant_scale is not None:
        return ref.qgemm_ref(
            x,
            w,
            bias,
            requant_scale=cfg.requant_scale,
            clip_lo=cfg.clip_lo,
            clip_hi=cfg.clip_hi,
            out_dtype=cfg.out_dtype,
        )
    return ref.gemm_ref(
        x,
        w,
        bias,
        acc_dtype=cfg.acc_dtype,
        out_dtype=cfg.out_dtype,
        activation=cfg.activation,
    )


def _library() -> ctypes.CDLL:
    lib = build.load("gemm")
    if lib.repro_scheduled_gemm.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.repro_scheduled_gemm.argtypes = [
            p, p, p, p,  # x, w, bias, out
            i, i, i,  # m, k, n
            i, i, i,  # block_m, block_n, weight_stationary
            i, i, i,  # col_split, k_split, col_tile
            i, i,  # vec_x, vec_w
            i, i, i,  # in_type, out_type, epilogue
            f, f, f,  # scale, clip_lo, clip_hi
            p,  # stream
        ]
        lib.repro_scheduled_gemm.restype = ctypes.c_int
        lib.repro_noop.argtypes = [i, p]
        lib.repro_noop.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(
    x: torch.Tensor, w: torch.Tensor, cfg: GemmKernelConfig, bias
) -> torch.Tensor:
    operands = {"x": x, "w": w} if bias is None else {"x": x, "w": w, "bias": bias}
    for name, t in operands.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    acc_t = ref.torch_dtype(cfg.acc_dtype)
    if bias is not None and bias.dtype != acc_t:
        raise ValueError(f"bias must be {acc_t} (the accumulator type), got {bias.dtype}")
    m, k = x.shape
    n = w.shape[1]
    out_t = ref.torch_dtype(cfg.out_dtype)
    out = torch.empty((m, n), dtype=out_t, device=x.device)
    if m == 0 or n == 0:
        return out
    geo = launch_geometry(m, k, n, cfg)
    vec_x, vec_w = copy_paths(x, w, cfg)
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.repro_scheduled_gemm(
            x.data_ptr(),
            w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(),
            m,
            k,
            n,
            cfg.block_m,
            cfg.block_n,
            int(cfg.dataflow == "WS"),
            geo.col_split,
            geo.k_split,
            geo.col_tile,
            int(vec_x),
            int(vec_w),
            _IN_TYPES[x.dtype],
            _OUT_TYPES[out_t],
            _EPILOGUES[_epilogue(cfg)],
            0.0 if cfg.requant_scale is None else cfg.requant_scale,
            0.0 if cfg.clip_lo is None else cfg.clip_lo,
            0.0 if cfg.clip_hi is None else cfg.clip_hi,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"scheduled GEMM kernel launch failed: CUDA error {rc} ({msg})")
    record_launch(cfg)
    return out


def launch_noop(device: torch.device, cluster: int = 1) -> None:
    """Launch the source's empty kernel, as one cluster of ``cluster`` CTAs,
    on ``device``'s current stream: the floor under a launch's device
    time, for measurements."""
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.repro_noop(cluster, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")


def scheduled_gemm(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg: GemmKernelConfig,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Out[m, n] = epilogue(x[m, k] @ w[k, n] (+ bias[n])).

    Any m, k, n: the kernel masks the ragged edge of the block grid.  A
    CUDA tensor launches the kernel (or raises), a CPU tensor runs the
    plain version, any other device raises.  The bias, when given, is in
    the accumulator's dtype."""
    _check(x, w, cfg, bias)
    if x.device.type == "cuda":
        return _launch(x, w, cfg, bias)
    if x.device.type == "cpu":
        return gemm_plain(x, w, cfg, bias)
    raise ValueError(f"scheduled_gemm runs on cuda or cpu tensors, not {x.device}")
