"""The scheduled GEMM's second float design (``csrc/gemm_wgmma.cu``): the
dispatch rule, the launch geometry and the LM products it takes.

The wgmma + TMA kernel runs only on the card; here the rule that picks it
(``gemm.design``), its geometry (``gemm.wgmma_geometry``, a pure
function) and the per-design launch counts are checked on the CPU, where
every product runs the plain version, which is held to the reference's
interpret-mode kernel at a shape the rule admits.  The LM products are
enumerated by running each published config's prefill at batch 8 x 128
on meta tensors under the gemmini policy, with ``ops.scheduled_gemm``
replaced by a recorder (no storage, no arithmetic).  The tests marked
``cuda`` hold the kernel to its plain version on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gemm_wgmma.py
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import GemmKernelConfig as RefConfig
from repro.kernels import ops as ref_ops
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.configurators import build_backend
from repro_torch.core.descriptions import make_gemmini_description
from repro_torch.kernels import gemm, ops
from repro_torch.kernels.gemm import GemmKernelConfig, gemm_plain, scheduled_gemm
from repro_torch.kernels.policy import scheduled_kernels
from repro_torch.launch.dryrun import _abstract_params
from repro_torch.models import lm


@pytest.fixture(autouse=True)
def _no_launches(request):
    gemm.reset_launches()
    yield
    if "cuda_card" not in request.fixturenames:
        assert sum(gemm.LAUNCHES.values()) == 0, "a CPU tensor launched the CUDA kernel"
    gemm.reset_launches()


def _bf16(shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """The same values, contiguous, with the base one element off 16 bytes."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


# -- the dispatch rule ---------------------------------------------------------

_BF16 = dict(out_dtype="bfloat16")


@pytest.mark.parametrize(
    "case,m,k,n,dtype,cfg,want",
    [
        ("bf16 m = 64", 64, 128, 64, torch.bfloat16, GemmKernelConfig(64, 64, 64, "WS", **_BF16), "wgmma"),
        ("bf16 m = 63", 63, 128, 64, torch.bfloat16, GemmKernelConfig(64, 64, 64, "WS", **_BF16), "mma_sync"),
        ("bf16 m = 1024", 1024, 4096, 4096, torch.bfloat16, GemmKernelConfig(64, 256, 128, "WS", **_BF16), "wgmma"),
        ("bf16 f32 out, bias, gelu", 128, 64, 64, torch.bfloat16,
         GemmKernelConfig(128, 64, 64, "OS", activation="gelu", has_bias=True), "wgmma"),
        ("k % 8 != 0", 128, 100, 64, torch.bfloat16, GemmKernelConfig(64, 64, 64, "WS", **_BF16), "mma_sync"),
        ("n % 8 != 0", 128, 64, 100, torch.bfloat16, GemmKernelConfig(64, 64, 64, "WS", **_BF16), "mma_sync"),
        ("n = 4 (xlstm's gates)", 1024, 1536, 4, torch.bfloat16, GemmKernelConfig(256, 128, 16, "OS", **_BF16),
         "mma_sync"),
        ("block_m < 64", 1024, 64, 64, torch.bfloat16, GemmKernelConfig(32, 64, 64, "WS", **_BF16), "mma_sync"),
        ("block_n % 8 != 0", 1024, 64, 296, torch.bfloat16, GemmKernelConfig(64, 64, 100, "WS", **_BF16),
         "mma_sync"),
        ("block_n % 8 == 0, n ragged", 1024, 64, 296, torch.bfloat16, GemmKernelConfig(64, 64, 104, "WS", **_BF16),
         "wgmma"),
        ("block_m cut to m < 64", 63, 64, 64, torch.bfloat16, GemmKernelConfig(256, 64, 64, "WS", **_BF16),
         "mma_sync"),
        ("f32 inputs", 1024, 64, 64, torch.float32, GemmKernelConfig(64, 64, 64, "WS"), "mma_sync"),
        ("int8 -> int32", 1024, 64, 64, torch.int8,
         GemmKernelConfig(64, 64, 64, "WS", acc_dtype="int32", out_dtype="int32"), "mma_sync"),
        ("int8 requantize", 1024, 64, 64, torch.int8,
         GemmKernelConfig(64, 64, 64, "WS", acc_dtype="int32", out_dtype="int8", requant_scale=0.01,
                          clip_lo=-128, clip_hi=127), "mma_sync"),
    ],
)
def test_design_rule_case_by_case(case, m, k, n, dtype, cfg, want):
    x, w = torch.zeros((m, k), dtype=dtype), torch.zeros((k, n), dtype=dtype)
    assert gemm.design(x, w, cfg) == want, case
    assert gemm.wgmma_admits(m, k, n, dtype, cfg) == (want == "wgmma"), case


@pytest.mark.parametrize("which", ["x", "w", "both"])
def test_unaligned_base_stays_on_mma_sync(which):
    """TMA needs 16-byte aligned bases: a view one element off takes the
    mma.sync design, whose element copies take any base."""
    cfg = GemmKernelConfig(64, 64, 64, "WS", **_BF16)
    x, w = _bf16((128, 64)), _bf16((64, 64), seed=1)
    assert gemm.design(x, w, cfg) == "wgmma"
    xx = _misaligned(x) if which in ("x", "both") else x
    ww = _misaligned(w) if which in ("w", "both") else w
    assert xx.data_ptr() % 16 or ww.data_ptr() % 16
    assert gemm.design(xx, ww, cfg) == "mma_sync"
    assert gemm.wgmma_admits(128, 64, 64, torch.bfloat16, cfg)  # the shape alone is admitted
    assert torch.equal(scheduled_gemm(xx, ww, cfg), scheduled_gemm(x, w, cfg))


def test_cpu_tensors_run_the_plain_version_under_either_design():
    """On the CPU a product the rule sends to wgmma runs the plain version
    and counts no launch of either design."""
    cfg = GemmKernelConfig(64, 64, 64, "WS", activation="relu", has_bias=True)
    x, w = _bf16((96, 64)), _bf16((64, 32), seed=1)
    b = torch.linspace(-1, 1, 32)
    assert gemm.design(x, w, cfg) == "wgmma"
    assert torch.equal(scheduled_gemm(x, w, cfg, b), gemm_plain(x, w, cfg, b))
    assert gemm.DESIGN_LAUNCHES == {"gemm_float/mma_sync": 0, "gemm_float/wgmma": 0}


def test_design_launches_count_each_design_under_gemm_float():
    """Both designs count under ``LAUNCHES["gemm_float"]``; the per-design
    counts split it, and ``reset_launches`` clears both."""
    flt = GemmKernelConfig(64, 64, 64, "WS", **_BF16)
    q = GemmKernelConfig(16, 16, 16, "WS", acc_dtype="int32", out_dtype="int8", requant_scale=0.1,
                         clip_lo=-128, clip_hi=127)
    gemm.record_launch(flt, "wgmma")
    gemm.record_launch(flt, "wgmma")
    gemm.record_launch(flt)
    gemm.record_launch(q)
    assert gemm.LAUNCHES == {"qgemm_requant": 1, "gemm_int32": 0, "gemm_float": 3}
    assert gemm.DESIGN_LAUNCHES == {"gemm_float/mma_sync": 1, "gemm_float/wgmma": 2}
    gemm.reset_launches()
    assert not any(gemm.LAUNCHES.values()) and not any(gemm.DESIGN_LAUNCHES.values())


@pytest.mark.parametrize("out_dtype,activation,bias", [("bfloat16", "relu", False), ("float32", "gelu", True)])
def test_admitted_product_matches_the_interpret_kernel(out_dtype, activation, bias):
    """At a shape the rule admits (bf16, m = 64, ragged k and n against the
    blocks), the port's product equals the reference's Pallas kernel in
    interpret mode: one bf16 ulp (bf16 out) or rtol = atol = 1e-4 (f32 out;
    the two sum in different orders)."""
    rng = np.random.default_rng(7)
    m, k, n = 64, 40, 24
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32) if bias else None
    fields = dict(block_m=64, block_k=16, block_n=16, dataflow="WS", out_dtype=out_dtype,
                  activation=activation, has_bias=bias)
    rcfg, tcfg = RefConfig(**fields, interpret=True), GemmKernelConfig(**fields)
    xt, wt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    assert gemm.design(xt, wt, tcfg) == "wgmma"
    want = np.asarray(ref_ops.matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), rcfg,
                                     None if b is None else jnp.asarray(b), use_pallas=True).astype(jnp.float32))
    got = ops.matmul(xt, wt, tcfg, None if b is None else torch.from_numpy(b)).float().numpy()
    if out_dtype == "bfloat16":
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0**-6))) - 7)
        assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# -- the geometry --------------------------------------------------------------

_BLOCKS = [(64, 64, 8), (64, 256, 128), (128, 128, 96), (128, 64, 64), (192, 64, 40), (256, 64, 128),
           (256, 64, 256), (256, 32, 512), (512, 64, 288)]


def _geometries():
    for m in (64, 65, 1000, 1030):
        for n in (8, 96, 288):
            for k in (8, 520):
                for blocks in _BLOCKS:
                    for dataflow in ("OS", "WS"):
                        yield m, k, n, GemmKernelConfig(*blocks, dataflow)


_ALL = list(_geometries())


@pytest.mark.parametrize("m", [64, 65, 1000, 1030])
def test_geometry_tiles_cover_every_output_once(m):
    for mm, k, n, cfg in _ALL:
        if mm != m:
            continue
        geo = gemm.wgmma_geometry(m, k, n, cfg)
        assert geo is not None, (m, k, n, cfg)
        seen = np.zeros((m, n), dtype=np.int32)
        for _, (r0, r1), (c0, c1) in geo.tiles():
            assert r1 - r0 <= geo.tile[0] and c1 - c0 <= geo.tile[1] <= geo.inst_n
            if r0 < r1 and c0 < c1:
                seen[r0:r1, c0:c1] += 1
        assert (seen == 1).all(), (m, k, n, cfg)


def test_geometry_rasters_like_grid_for():
    """The blocks come in ``GemmKernelConfig.grid_for``'s order (WS: n
    outer), each block's tiles adjacent."""
    for m, k, n, cfg in _ALL:
        geo = gemm.wgmma_geometry(m, k, n, cfg)
        order = [blk for blk, _, _ in geo.tiles()]
        runs = [b for i, b in enumerate(order) if i == 0 or order[i - 1] != b]
        assert len(runs) == len(set(runs)) == geo.grid[0] * geo.grid[1]  # each block's tiles adjacent
        gm, gn = -(-m // cfg.block_m), -(-n // cfg.block_n)
        nest = cfg.grid_for(gm * cfg.block_m, k, gn * cfg.block_n)[:2]
        assert geo.grid == nest
        if cfg.dataflow == "WS":
            assert runs == [(bm, bn) for bn in range(gn) for bm in range(gm)]
        else:
            assert runs == [(bm, bn) for bm in range(gm) for bn in range(gn)]
        assert all(len([b for b in order if b == blk]) == geo.sub[0] * geo.sub[1] for blk in runs)


def test_geometry_k_slices_tile_k():
    for m, k, n, cfg in _ALL:
        geo = gemm.wgmma_geometry(m, k, n, cfg)
        slices = geo.k_slices()
        assert len(slices) == geo.k_split
        assert slices[0][0] == 0 and slices[-1][1] == k
        for (_, e0), (b1, _) in zip(slices, slices[1:]):
            assert e0 == b1
        for b, e in slices:
            assert b < e and b % gemm.WG_STAGE_K == 0 and (e % gemm.WG_STAGE_K == 0 or e == k)
        counts = [-(-(e - b) // gemm.WG_STAGE_K) for b, e in slices]
        assert max(counts) - min(counts) <= 1


def test_geometry_fits_the_card():
    """Shared memory within 232,448 bytes, x's TMA box (a stage's depth by
    the tile's rows, the rows passed to the kernel) at most 256 per
    dimension, accumulators within the register budget, the split K a
    power of two within the portable cluster and the SMs."""
    for m, k, n, cfg in _ALL:
        geo = gemm.wgmma_geometry(m, k, n, cfg)
        assert geo.smem_bytes <= 232_448
        assert 1 <= gemm.WG_STAGE_K <= 256 and 1 <= geo.tile[0] <= 256
        assert geo.inst_n in gemm.WG_WIDTHS and geo.tile[0] in gemm.WG_HEIGHTS
        assert geo.tile[1] % 8 == 0 and all(c0 % 8 == 0 for _, _, (c0, _) in geo.tiles())  # TMA's columns
        assert geo.m_tiles * geo.inst_n // 2 <= 128
        assert geo.threads == 128 * geo.consumers + 32
        assert 3 <= geo.stages <= gemm.WG_MAX_STAGES
        ks = geo.k_split
        assert ks & (ks - 1) == 0 and ks <= gemm.MAX_CLUSTER and geo.tile[0] % ks == 0
        live = sum(r0 < r1 and c0 < c1 for _, (r0, r1), (c0, c1) in geo.tiles())
        assert ks == 1 or (2 * live < gemm.WG_SMS and ks * live <= gemm.WG_SMS)


@pytest.mark.parametrize("m, n, block, dataflow", [(11776, 3072, (96, 128), "WS"), (1000, 1000, (96, 128), "OS"),
                                                    (130, 600, (256, 512), "WS"), (64, 64, (64, 64), "OS")])
def test_the_split_counts_the_tiles_it_would_list(m, n, block, dataflow):
    """``wgmma_geometry`` counts the clusters' non-empty tiles without
    listing them (``_filled``): the count ``tiles()`` lists, here and for
    every geometry of the suite."""
    extra = (m, 512, n, GemmKernelConfig(block[0], 64, block[1], dataflow, **_BF16))
    for mm, k, nn, cfg in [*_ALL, extra]:
        geo = gemm.wgmma_geometry(mm, k, nn, cfg)
        listed = sum(r0 < r1 and c0 < c1 for _, (r0, r1), (c0, c1) in geo.tiles())
        counted = gemm._filled(mm, geo.block[0], geo.sub[0], geo.tile[0]) * gemm._filled(nn, geo.block[1], geo.sub[1],
                                                                                        geo.tile[1])
        assert counted == listed, (mm, nn, cfg)


def test_one_warpgroup_tiles_let_three_ctas_share_an_sm():
    """A one-warpgroup tile's ring leaves room for three of its CTAs on an
    SM (233,472 bytes, 1 KB more per resident block) up to the widest
    instruction, whose 3-stage ring holds one; two-warpgroup tiles take
    4 stages."""
    for m, k, n, cfg in _ALL:
        geo = gemm.wgmma_geometry(m, k, n, cfg)
        if geo.consumers == 1 and geo.inst_n <= 128:
            assert 3 * (geo.smem_bytes + 1024) <= gemm.WG_SM_SMEM
        if geo.consumers == 2:
            assert geo.stages == gemm.WG_MAX_STAGES
    assert gemm.wgmma_geometry(1024, 4096, 4096, GemmKernelConfig(64, 256, 128, "WS")).stages == 3


@pytest.mark.parametrize(
    "shape,blocks,tile,inst_n,k_split",
    [
        ((1024, 4096, 4096), (64, 256, 128, "WS"), (64, 128), 128, 1),  # codeqwen q/k/v/o
        ((1024, 13440, 4096), (128, 128, 128, "WS"), (128, 128), 128, 1),  # codeqwen down
        ((1024, 8192, 288), (128, 128, 96, "WS"), (128, 96), 128, 4),  # jamba x_proj: 24 tiles
        ((1024, 5120, 27392), (128, 256, 80, "WS"), (128, 80), 128, 1),  # qwen1.5-32b gate/up
        ((1024, 6144, 128), (64, 256, 128, "WS"), (64, 128), 128, 8),  # granite's 16 tiles
        ((1024, 5120, 576), (128, 256, 64, "WS"), (128, 64), 64, 1),  # deepseek kv_down
        ((2048, 512, 2048), (256, 64, 256, "OS"), (128, 256), 256, 1),  # 256 rows need width <= 128
        ((2048, 512, 2048), (256, 64, 128, "OS"), (256, 128), 128, 1),
        ((1024, 512, 512), (256, 64, 256, "OS"), (128, 256), 256, 8),  # 16 tiles
    ],
)
def test_geometry_of_named_shapes(shape, blocks, tile, inst_n, k_split):
    geo = gemm.wgmma_geometry(*shape, GemmKernelConfig(*blocks))
    assert (geo.tile, geo.inst_n, geo.k_split) == (tile, inst_n, k_split)


# -- the LM products -----------------------------------------------------------

_BACKEND = []


def _backend():
    if not _BACKEND:
        _BACKEND.append(build_backend(make_gemmini_description()))
    return _BACKEND[0]


def _products(cfg, batch: int, seq: int) -> list[tuple]:
    """Every (m, k, n, dtype, config) one prefill of ``batch`` x ``seq``
    tokens routes, on meta tensors."""
    calls = []

    def record(x, w, kcfg, bias=None):
        calls.append((x.shape[0], x.shape[1], w.shape[1], x.dtype, kcfg))
        out = torch.bfloat16 if kcfg.out_dtype == "bfloat16" else torch.float32
        return torch.empty((x.shape[0], w.shape[1]), dtype=out, device=x.device)

    real = ops.scheduled_gemm
    ops.scheduled_gemm = record
    try:
        params = _abstract_params(cfg)
        front = cfg.n_frontend_tokens if cfg.frontend else 0
        cache = lm.init_cache(cfg, batch, seq + front + 1, device="meta")
        toks = torch.zeros((batch, seq), dtype=torch.int64, device="meta")
        fe = (torch.empty((batch, front, cfg.d_model), dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                          else torch.float32, device="meta") if front else None)
        with scheduled_kernels(_backend()), torch.inference_mode():
            lm.prefill(params, cfg, toks, cache, fe) if fe is not None else lm.prefill(params, cfg, toks, cache)
    finally:
        ops.scheduled_gemm = real
    return calls


#: (wgmma, mma_sync) launches of one prefill at batch 8 x 128 per arch: the
#: mma.sync ones are the head (8 rows), the f32 MoE routers and xlstm's
#: 4-wide gates
_LM_SPLIT = {
    "paligemma_3b": (126, 1),
    "mixtral_8x7b": (128, 33),
    "deepseek_v2_236b": (480, 60),
    "qwen1_5_32b": (448, 1),
    "granite_34b": (528, 1),
    "codeqwen1_5_7b": (224, 1),
    "yi_34b": (420, 1),
    "musicgen_medium": (288, 1),
    "xlstm_125m": (62, 21),
    "jamba_v0_1_52b": (176, 17),
}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_lm_prefill_product_takes_the_design_the_rule_names(arch):
    """At batch 8 x 128 every bf16 product of 1024 rows with k and n
    multiples of 8 takes wgmma (the gemmini blocks all admit); the head
    (8 rows), the f32 routers and xlstm's 4-wide gates stay on mma.sync."""
    cfg = get_config(arch)
    calls = _products(cfg, 8, 128)
    assert calls
    split = [0, 0]
    for m, k, n, dtype, kcfg in calls:
        rule = gemm.wgmma_admits(m, k, n, dtype, kcfg)
        plain = dtype == torch.bfloat16 and m >= 64 and k % 8 == 0 and n % 8 == 0
        assert rule == plain, (arch, m, k, n, dtype, kcfg)
        if m < 64 or dtype == torch.float32 or n % 8:
            assert not rule
        split[0 if rule else 1] += 1
    assert tuple(split) == _LM_SPLIT[arch]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_arch_products_stay_on_mma_sync(arch):
    """The smoke configs compute in f32: every product they route stays on
    the mma.sync design (its 3xTF32 form)."""
    cfg = get_smoke_config(arch)
    calls = _products(cfg, 8, 16)
    assert calls
    assert all(dtype == torch.float32 and not gemm.wgmma_admits(m, k, n, dtype, kcfg)
               for m, k, n, dtype, kcfg in calls)


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda_card() -> str:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the wgmma kernel runs only there")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,blocks,out_dtype,activation,bias",
    [
        ((65, 8, 8), (64, 8, 8, "WS"), "bfloat16", "gelu", True),
        ((1030, 520, 96), (64, 64, 64, "OS"), "float32", "relu", True),
        ((1000, 520, 288), (256, 64, 512, "OS"), "bfloat16", None, False),
        ((1024, 8192, 288), (128, 128, 96, "WS"), "bfloat16", None, False),
    ],
)
def test_wgmma_matches_plain_on_the_card(cuda_card, shape, blocks, out_dtype, activation, bias):
    """w at the LM's initial scale, sqrt(2 / (k + n)), as ``chip_smoke.py``'s
    LM cases: the sums are then O(1), so two f32 summation orders differ
    by far less than the bf16 ulp of the result that the check allows."""
    m, k, n = shape
    cfg = GemmKernelConfig(*blocks, out_dtype=out_dtype, activation=activation, has_bias=bias)
    gen = torch.Generator(device=cuda_card)
    gen.manual_seed(0)
    x = torch.randn((m, k), generator=gen, device=cuda_card).bfloat16()
    w = (torch.randn((k, n), generator=gen, device=cuda_card) * (2.0 / (k + n)) ** 0.5).bfloat16()
    b = torch.randn((n,), generator=gen, device=cuda_card) if bias else None
    assert gemm.design(x, w, cfg) == "wgmma"
    got, again = scheduled_gemm(x, w, cfg, b), scheduled_gemm(x, w, cfg, b)
    want = gemm_plain(x, w, cfg, b)
    assert torch.equal(got, again)
    if out_dtype == "bfloat16":
        ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(2.0**-6))) - 7)
        assert bool(((got.float() - want.float()).abs() <= ulp).all())
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    assert gemm.DESIGN_LAUNCHES["gemm_float/wgmma"] == 2
    gemm.reset_launches()
