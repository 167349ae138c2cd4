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

The float form has a second design for bf16 products of at least 64 rows
(``csrc/gemm_wgmma.cu``): one CTA per tile of the config's block (cut
where ``wgmma`` cannot take it whole), a producer warp streaming x and w
through a ring of TMA loads, consumer warpgroups running ``wgmma``, and a
split K over a cluster only where the tiles leave most SMs idle.
``design`` picks one of the two before any launch, from the dtypes, the
shape, the bases' alignment and the config (``wgmma_geometry``); nothing
falls back from one to the other.

``scheduled_gemm`` launches the CUDA kernel for a CUDA tensor and raises if
it cannot; for a CPU tensor it runs the plain PyTorch version
(``repro_torch.kernels.ref``); any other device raises.  The kernel masks
ragged edges itself, so operands need not be multiples of the block shape.
"""

from __future__ import annotations

import ctypes
import functools
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


#: the wgmma design (csrc/gemm_wgmma.cu): the depth of a stage (one 128-byte
#: swizzle row of bf16), the instruction widths it is built for (the
#: 128-byte swizzle atom of an N-major w is 64 columns), the tile heights (64
#: rows per m64 tile: one warpgroup of one, two of one, two of two), the
#: deepest ring, the shared memory a block may use and an SM holds (each
#: block resident costs 1 KB more), the card's SMs, and the kernel's fixed
#: shared-memory header and alignment slack
WG_STAGE_K = 64
WG_WIDTHS = (64, 128, 256)
WG_HEIGHTS = (256, 128, 64)
WG_MAX_STAGES = 4
WG_SMEM_LIMIT = 232_448
WG_SM_SMEM = 233_472
WG_SMS = 132
WG_SMEM_FIXED = 2048


@dataclass(frozen=True)
class WgmmaGeometry:
    """How one launch of ``csrc/gemm_wgmma.cu`` covers an (m, k, n) product.

    ``grid`` counts the config's blocks in raster order (outer, inner), as
    ``GemmKernelConfig.grid_for`` orders them; each block is ``sub`` (rows,
    columns) CTA tiles of ``tile`` (rows, columns), adjacent in the launch,
    rows outer; each tile is a cluster of ``k_split`` CTAs, rank r taking
    the K slice ``k_slices()[r]``.  A tile's rows and columns stop at its
    block's edge and the matrix's; ``inst_n`` is the instruction's width
    (columns past the tile are computed and not stored)."""

    m: int
    k: int
    n: int
    block: tuple[int, int]
    grid: tuple[int, int]
    sub: tuple[int, int]
    tile: tuple[int, int]
    inst_n: int
    k_split: int
    stages: int
    weight_stationary: bool

    @property
    def consumers(self) -> int:
        """Consumer warpgroups per CTA."""
        return 1 if self.tile[0] == 64 else 2

    @property
    def m_tiles(self) -> int:
        """m64 tiles per consumer warpgroup."""
        return self.tile[0] // 64 // self.consumers

    @property
    def threads(self) -> int:
        return 128 * self.consumers + 32

    @property
    def stage_bytes(self) -> int:
        return self.tile[0] * WG_STAGE_K * 2 + WG_STAGE_K * self.inst_n * 2

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a CTA: the ring (or the f32 partial sums
        or the finished tile staged over it, if larger), the mbarriers'
        header and the 1024-byte alignment slack (the kernel's own rule)."""
        ring = self.stages * self.stage_bytes
        staged = self.tile[0] * (self.inst_n + 8) * 4
        return WG_SMEM_FIXED + max(ring, staged)

    def k_slices(self) -> list[tuple[int, int]]:
        """Each rank's K slice as [begin, end) in elements: whole stages,
        balanced, the last cut at k.  The launch passes each slice's first
        stage to the kernel, which takes its slice from there."""
        s = -(-self.k // WG_STAGE_K)
        return [
            (r * s // self.k_split * WG_STAGE_K, min((r + 1) * s // self.k_split * WG_STAGE_K, self.k))
            for r in range(self.k_split)
        ]

    def tiles(self) -> list[tuple[tuple[int, int], tuple[int, int], tuple[int, int]]]:
        """Each cluster's (block (bm, bn), [row0, row_end), [col0, col_end))
        in launch order, the empty ones (past m or n) included as the
        kernel sees them."""
        out = []
        block_m, block_n = self.block
        sub_m, sub_n = self.sub
        for outer in range(self.grid[0]):
            for inner in range(self.grid[1]):
                bm, bn = (inner, outer) if self.weight_stationary else (outer, inner)
                for sub in range(sub_m * sub_n):
                    r0 = bm * block_m + sub // sub_n * self.tile[0]
                    c0 = bn * block_n + sub % sub_n * self.tile[1]
                    r1 = min(r0 + self.tile[0], (bm + 1) * block_m, self.m)
                    c1 = min(c0 + self.tile[1], (bn + 1) * block_n, self.n)
                    out.append(((bm, bn), (r0, r1), (c0, c1)))
        return out


def _filled(extent: int, block: int, sub: int, tile: int) -> int:
    """The tiles along one dimension that hold any of its ``extent`` rows
    (or columns): ``sub`` tiles of ``tile`` from the start of each block,
    counted without listing them (a prefill's product has tens of
    thousands)."""
    return sum(min(sub, -(-(extent - start) // tile)) for start in range(0, extent, block))


@functools.lru_cache(maxsize=4096)
def wgmma_geometry(m: int, k: int, n: int, cfg: GemmKernelConfig) -> WgmmaGeometry | None:
    """The wgmma design's tiles for the config's blocks, or None where the
    rule refuses the block (it then stays on the mma.sync design).

    The rule.  A block is first cut to the matrix (a block wider or taller
    than the product covers what is there).  A block of fewer than 64 rows
    is refused (a wgmma tile has 64), and so is one whose width is not a
    multiple of 8: TMA loads a box only from a 16-byte aligned column, so
    every tile must start on one.  Columns: a block of at most 256 columns
    is one tile, a wider one ``ceil(block_n / 256)`` tiles of equal width
    rounded up to 8, the last cut at the block's edge; the instruction's
    width is the tile's rounded up to 64, 128 or 256.
    Rows: the tile is the tallest of 256, 128 and 64 rows that the block
    holds and the registers allow (256 rows, two m64 tiles per warpgroup,
    take a width of at most 128), so a block is ``ceil(block_m / tile)``
    tiles, the last cut at its edge.  The ring holds up to 4 stages within
    227 KB, at least 3; a one-warpgroup tile takes at most the stages that
    let three of its CTAs share an SM (still at least 3), since more
    warpgroups issuing ``wgmma`` on an SM beat a deeper ring there (3
    stages of a 64 x 128 tile).  K splits over a cluster only where the
    tiles number fewer than half the card's 132 SMs: by the largest power
    of two that is at most 8 (the portable cluster), at most the SMs per
    tile (so the CTAs stay within the SMs) and at most K's 64-deep stages
    (so each rank takes at least one); the ring's depth does not bound
    it."""
    block_m, block_n = min(cfg.block_m, m), min(cfg.block_n, n)
    if block_m < 64 or cfg.block_n % 8 or k < 1:
        return None
    sub_n = -(-block_n // 256)
    tile_n = -(-block_n // sub_n // 8) * 8
    inst_n = next(w for w in WG_WIDTHS if w >= tile_n)
    tile_m = next(h for h in WG_HEIGHTS if h <= block_m and (h < 256 or inst_n <= 128))
    sub_m = -(-block_m // tile_m)
    grid_m, grid_n = -(-m // cfg.block_m), -(-n // cfg.block_n)
    grid = (grid_n, grid_m) if cfg.dataflow == "WS" else (grid_m, grid_n)
    shape = (m, k, n, (cfg.block_m, cfg.block_n), grid, (sub_m, sub_n), (tile_m, tile_n), inst_n)
    one = WgmmaGeometry(*shape, 1, WG_MAX_STAGES, cfg.dataflow == "WS")
    room = WG_SMEM_LIMIT if one.consumers == 2 else WG_SM_SMEM // 3 - 1024
    stages = max(3, min(WG_MAX_STAGES, (room - WG_SMEM_FIXED) // one.stage_bytes))
    tiles = _filled(m, cfg.block_m, sub_m, tile_m) * _filled(n, cfg.block_n, sub_n, tile_n)  # one.tiles() not empty
    k_split = 1
    if 2 * tiles < WG_SMS:
        k_split = _pow2_floor(min(MAX_CLUSTER, WG_SMS // tiles, -(-k // WG_STAGE_K)))
    geo = WgmmaGeometry(*shape, k_split, stages, cfg.dataflow == "WS")
    return geo if geo.smem_bytes <= WG_SMEM_LIMIT else None


def design(x: torch.Tensor, w: torch.Tensor, cfg: GemmKernelConfig) -> str:
    """Which design of the kernel runs ``x @ w`` under ``cfg``: ``wgmma``
    for a bf16 product of at least 64 rows whose k and n are multiples of
    8 and whose bases are 16-byte aligned (TMA's rules), with no requantize
    and a block the tile rule admits (``wgmma_geometry``); ``mma_sync`` for
    everything else.  Decided before any launch."""
    m, k = x.shape
    n = w.shape[1]
    if wgmma_admits(m, k, n, x.dtype, cfg) and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0:
        return "wgmma"
    return "mma_sync"


def wgmma_admits(m: int, k: int, n: int, dtype: torch.dtype, cfg: GemmKernelConfig) -> bool:
    """``design``'s rule without the bases' alignment: what a shape, a
    dtype and a config decide."""
    return (
        dtype == torch.bfloat16
        and cfg.requant_scale is None
        and m >= 64
        and k % 8 == 0
        and n % 8 == 0
        and wgmma_geometry(m, k, n, cfg) is not None
    )


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


#: kernel launches per instantiation of ``csrc/gemm.cu`` (``build.LaunchCounts``)
LAUNCHES = build.LaunchCounts("qgemm_requant", "gemm_int32", "gemm_float")
#: the float form's launches by design (their sum is LAUNCHES["gemm_float"])
DESIGN_LAUNCHES = build.LaunchCounts("gemm_float/mma_sync", "gemm_float/wgmma")
#: the benchmark's name for ``build.reset_launches``, which zeros every kernel's counts
reset_launches = build.reset_launches


def record_launch(cfg: GemmKernelConfig, kernel_design: str = "mma_sync") -> None:
    """Count one launch of the instantiation ``cfg`` selects, made by the
    design ``kernel_design``."""
    name = variant(cfg)
    if name == "gemm_float":
        LAUNCHES.record(name, (DESIGN_LAUNCHES, f"gemm_float/{kernel_design}"))
    else:
        LAUNCHES.record(name)


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


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the argument types of csrc/gemm.cu's entry point
_MMA_SYNC_ARGS = [
    _P, _P, _P, _P,  # x, w, bias, out
    _I, _I, _I,  # m, k, n
    _I, _I, _I,  # block_m, block_n, weight_stationary
    _I, _I, _I,  # col_split, k_split, col_tile
    _I, _I,  # vec_x, vec_w
    _I, _I, _I,  # in_type, out_type, epilogue
    _F, _F, _F,  # scale, clip_lo, clip_hi
    _P,  # stream
]


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
    if design(x, w, cfg) == "wgmma":
        return _launch_wgmma(x, w, cfg, bias, out)
    geo = launch_geometry(m, k, n, cfg)
    vec_x, vec_w = copy_paths(x, w, cfg)
    lib = build.load("gemm")
    with torch.cuda.device(x.device):
        rc = build.bind(lib.repro_scheduled_gemm, _MMA_SYNC_ARGS)(
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
    build.check(lib, rc, "scheduled GEMM kernel")
    record_launch(cfg)
    return out


#: the argument types of csrc/gemm_wgmma.cu's entry point
_WGMMA_ARGS = [
    _P, _P, _P, _P,  # x, w, bias, out
    _I, _I, _I,  # m, k, n
    _I, _I, _I,  # block_m, block_n, weight_stationary
    _I, _I, _I,  # tile_m, tile_n, inst_n
    _I, _I, _I, _P, _I,  # sub_m, sub_n, k_split, k_begin, stages
    _I, _I,  # out_type, epilogue
    _P,  # stream
]


def _launch_wgmma(x, w, cfg: GemmKernelConfig, bias, out: torch.Tensor) -> torch.Tensor:
    m, k = x.shape
    n = w.shape[1]
    geo = wgmma_geometry(m, k, n, cfg)
    k_begin = (ctypes.c_int * geo.k_split)(*(b // WG_STAGE_K for b, _ in geo.k_slices()))
    lib = build.load("gemm")
    with torch.cuda.device(x.device):
        rc = build.bind(lib.repro_wgmma_gemm, _WGMMA_ARGS)(
            x.data_ptr(),
            w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(),
            m,
            k,
            n,
            cfg.block_m,
            cfg.block_n,
            int(geo.weight_stationary),
            geo.tile[0],
            geo.tile[1],
            geo.inst_n,
            geo.sub[0],
            geo.sub[1],
            geo.k_split,
            k_begin,
            geo.stages,
            _OUT_TYPES[out.dtype],
            _EPILOGUES[_epilogue(cfg)],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(lib, rc, "scheduled GEMM kernel (wgmma)")
    record_launch(cfg, "wgmma")
    return out


def launch_noop(device: torch.device, cluster: int = 1) -> None:
    """Launch the source's empty kernel, as one cluster of ``cluster`` CTAs,
    on ``device``'s current stream: the floor under a launch's device
    time, for measurements."""
    lib = build.load("gemm")
    with torch.cuda.device(device):
        rc = build.bind(lib.repro_noop, [_I, _P])(cluster, torch.cuda.current_stream(device).cuda_stream)
    build.check(lib, rc, "empty kernel")


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
