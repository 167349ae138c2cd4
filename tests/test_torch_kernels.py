"""The port's kernel modules against the reference's Pallas kernel.

``repro_torch.kernels.ops.qmatmul``/``matmul`` on CPU tensors run the
kernel's plain PyTorch version; the reference runs ``_gemm_kernel`` through
``pl.pallas_call`` in interpret mode (``use_pallas=True`` on an
``interpret=True`` config).  Inputs are made with numpy from a seed and
handed to both.  Integer paths must be bit-exact; float32 is held to
rtol=atol=1e-4 (the two sum in different orders), bf16 to one bf16 ulp of
the reference output.  Interpret mode costs about a second a call, so the
interpret cases are few and small; the wider sweeps hold the port to the
reference's pure-jnp ``ref`` oracles, which cost nothing.
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import GemmKernelConfig as RefConfig
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import build, gemm, ops, ref
from repro_torch.kernels.gemm import GemmKernelConfig, scheduled_gemm
from repro_torch.kernels.qgemm import scheduled_qgemm


def _configs(**fields):
    return RefConfig(**fields, interpret=True), GemmKernelConfig(**fields)


def _int8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits), floored at 2**-6 where the
    ulp gets finer than the f32 summation-order error of these sums."""
    mag = np.maximum(np.abs(x), 2.0**-6)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.fixture(autouse=True)
def _no_launches():
    gemm.reset_launches()
    yield
    assert sum(gemm.LAUNCHES.values()) == 0, "a CPU tensor launched the CUDA kernel"


# -- int8 requantizing GEMM (instantiation 1) vs the interpret-mode kernel ---


@pytest.mark.parametrize(
    "dataflow,shape,blocks,bias,clip",
    [
        ("OS", (21, 40, 24), (16, 16, 16), True, (-128, 127)),
        ("WS", (16, 32, 48), (16, 32, 16), False, (0, 127)),
        ("WS", (9, 48, 20), (8, 16, 16), True, (-32, 31)),
    ],
)
def test_qmatmul_matches_interpret_kernel(dataflow, shape, blocks, bias, clip):
    m, k, n = shape
    rng = np.random.default_rng(7)
    x, w = _int8(rng, (m, k)), _int8(rng, (k, n))
    b = rng.integers(-2000, 2000, (n,)).astype(np.int32) if bias else None
    rcfg, tcfg = _configs(
        block_m=blocks[0], block_k=blocks[1], block_n=blocks[2], dataflow=dataflow,
        acc_dtype="int32", out_dtype="int8", requant_scale=1.0 / 64.0,
        clip_lo=clip[0], clip_hi=clip[1], has_bias=bias,
    )
    want = np.asarray(
        ref_ops.qmatmul(
            jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
            rcfg, use_pallas=True,
        )
    )
    got = ops.qmatmul(
        torch.from_numpy(x), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), tcfg,
    ).numpy()
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert got.min() >= clip[0] and got.max() <= clip[1]


# -- raw int8 -> int32 GEMM (instantiation 2) --------------------------------


@pytest.mark.parametrize("bias", [False, True])
def test_int32_matmul_matches_interpret_kernel(bias):
    rng = np.random.default_rng(3)
    x, w = _int8(rng, (2, 11, 40)), _int8(rng, (40, 24))  # batch dims fold into m
    b = rng.integers(-(2**31), 2**31 - 1, (24,), dtype=np.int64).astype(np.int32) if bias else None
    rcfg, tcfg = _configs(
        block_m=16, block_k=16, block_n=16, dataflow="WS",
        acc_dtype="int32", out_dtype="int32", has_bias=bias,
    )
    want = np.asarray(
        ref_ops.matmul(
            jnp.asarray(x), jnp.asarray(w), rcfg, None if b is None else jnp.asarray(b),
            use_pallas=True,
        )
    )
    got = ops.matmul(
        torch.from_numpy(x), torch.from_numpy(w), tcfg,
        None if b is None else torch.from_numpy(b),
    ).numpy()
    assert got.dtype == want.dtype == np.int32 and got.shape == (2, 11, 24)
    np.testing.assert_array_equal(got, want)


def test_int32_accumulator_wraps_like_the_reference():
    """Sums past int32 wrap mod 2**32, as the reference's int32 accumulator
    (and its int64-accumulate-then-cast emulation) does."""
    x = np.full((1, 4), 127, np.int8)
    w = np.full((4, 1), 127, np.int8)
    b = np.array([2**31 - 10], np.int32)
    cfg = GemmKernelConfig(1, 4, 1, acc_dtype="int32", out_dtype="int32", has_bias=True)
    got = ops.matmul(torch.from_numpy(x), torch.from_numpy(w), cfg, torch.from_numpy(b))
    want = np.asarray(
        ref_ref.gemm_ref(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            acc_dtype=jnp.int32, out_dtype=jnp.int32,
        )
    )
    assert want[0, 0] < 0  # the reference wrapped
    np.testing.assert_array_equal(got.numpy(), want)


# -- float GEMM (instantiation 3) --------------------------------------------


@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_f32_matmul_matches_interpret_kernel(activation):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(20, 48)).astype(np.float32)
    w = rng.normal(size=(48, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    rcfg, tcfg = _configs(
        block_m=16, block_k=16, block_n=16, dataflow="OS",
        activation=activation, has_bias=True,
    )
    want = np.asarray(
        ref_ops.matmul(jnp.asarray(x), jnp.asarray(w), rcfg, jnp.asarray(b), use_pallas=True)
    )
    got = ops.matmul(torch.from_numpy(x), torch.from_numpy(w), tcfg, torch.from_numpy(b)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bf16_matmul_matches_interpret_kernel():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(16, 48)).astype(np.float32)
    w = rng.normal(size=(48, 32)).astype(np.float32)
    rcfg, tcfg = _configs(
        block_m=16, block_k=16, block_n=16, dataflow="WS",
        out_dtype="bfloat16", activation="relu",
    )
    want = np.asarray(
        ref_ops.matmul(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), rcfg, use_pallas=True
        ).astype(jnp.float32)
    )
    got = ops.matmul(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16), tcfg
    )
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= _bf16_ulp(want)), np.max(np.abs(got - want))


# -- wider sweeps against the reference's pure-jnp oracles -------------------


@pytest.mark.parametrize("seed", range(6))
def test_qgemm_sweep_matches_reference_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    m, k, n = (int(v) for v in rng.integers(1, 90, 3))
    lo = int(rng.integers(-128, 0))
    hi = int(rng.integers(0, 128))
    scale = float(2.0 ** -int(rng.integers(4, 9)))
    x, w = _int8(rng, (m, k)), _int8(rng, (k, n))
    b = rng.integers(-5000, 5000, (n,)).astype(np.int32)
    want = np.asarray(
        ref_ref.qgemm_ref(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            requant_scale=scale, clip_lo=lo, clip_hi=hi,
        )
    )
    cfg = GemmKernelConfig(
        int(rng.integers(1, 33)), int(rng.integers(1, 65)), int(rng.integers(1, 65)),
        dataflow=("OS", "WS")[seed % 2], requant_scale=scale, clip_lo=lo, clip_hi=hi,
        out_dtype="int8",
    )
    got = scheduled_qgemm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), cfg)
    np.testing.assert_array_equal(got.numpy(), want)


def test_requantize_rounds_half_to_even():
    """jnp.round is half-to-even; so is the port's requantize."""
    x = np.array([[1, 3, 5, -1, -3]], np.int8).T  # (5, 1)
    w = np.array([[1]], np.int8)
    cfg = GemmKernelConfig(8, 8, 8, requant_scale=0.5, clip_lo=-128, clip_hi=127, out_dtype="int8")
    got = scheduled_qgemm(torch.from_numpy(x), torch.from_numpy(w), None, cfg).numpy().ravel()
    np.testing.assert_array_equal(got, [0, 2, 2, 0, -2])


# -- the wrapper's contract ----------------------------------------------------


def test_config_mirrors_reference_minus_interpret():
    ref_fields = [f.name for f in dataclasses.fields(RefConfig)]
    port_fields = [f.name for f in dataclasses.fields(GemmKernelConfig)]
    assert port_fields == [f for f in ref_fields if f != "interpret"]
    assert GemmKernelConfig(16, 16, 16, "WS").grid_for(32, 64, 48) == RefConfig(
        16, 16, 16, "WS"
    ).grid_for(32, 64, 48)


def test_other_devices_raise():
    x = torch.empty((4, 8), dtype=torch.int8, device="meta")
    w = torch.empty((8, 4), dtype=torch.int8, device="meta")
    cfg = GemmKernelConfig(4, 8, 4, acc_dtype="int32", out_dtype="int32")
    with pytest.raises(ValueError, match="cuda or cpu"):
        scheduled_gemm(x, w, cfg)


@pytest.mark.parametrize(
    "cfg,match",
    [
        (GemmKernelConfig(8, 8, 8, acc_dtype="int32", out_dtype="int8", activation="gelu"), "no instantiation"),
        (GemmKernelConfig(8, 8, 8, acc_dtype="float32", out_dtype="int32"), "no instantiation"),
        (GemmKernelConfig(8, 8, 8, acc_dtype="int32", out_dtype="int32", has_bias=True), "has_bias"),
        (GemmKernelConfig(8, 8, 8, acc_dtype="int32", out_dtype="int8", requant_scale=0.5), "clip"),
        (GemmKernelConfig(0, 8, 8, acc_dtype="int32", out_dtype="int32"), "positive"),
    ],
)
def test_unsupported_configs_raise_on_every_device(cfg, match):
    x = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((8, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match=match):
        scheduled_gemm(x, w, cfg)


def test_qgemm_requires_scale():
    cfg = GemmKernelConfig(8, 8, 8)
    x = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="requant_scale"):
        scheduled_qgemm(x, x.T.contiguous(), None, cfg)


def test_plain_versions_on_empty_and_zero_depth_shapes():
    cfg = GemmKernelConfig(8, 8, 8, acc_dtype="int32", out_dtype="int32", has_bias=True)
    b = torch.arange(3, dtype=torch.int32)
    out = scheduled_gemm(torch.zeros((2, 0), dtype=torch.int8), torch.zeros((0, 3), dtype=torch.int8), cfg, b)
    np.testing.assert_array_equal(out.numpy(), np.broadcast_to(np.arange(3), (2, 3)))
    assert ref.int_matmul(torch.zeros((0, 4), dtype=torch.int8), torch.zeros((4, 2), dtype=torch.int8)).shape == (0, 2)


def test_kernel_library_is_keyed_by_its_source():
    """The library of ``csrc/gemm.cu`` lives under ``build/`` at the root of
    the checkout, named by a hash of the source and the nvcc flags, which
    target sm_90a without fast math."""
    path = build.library_path("gemm")
    root = build.CSRC.parents[3]
    assert path.parent == root / "build" / "repro_torch_kernels"
    assert path.name.startswith("libgemm-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert not any("fast_math" in f for f in build.NVCC_FLAGS)
    assert (root / "src" / "repro_torch" / "kernels" / "csrc" / "gemm.cu").exists()


class _StubLibrary:
    """A loaded library's error-string entry point, and nothing else."""

    @staticmethod
    def repro_cuda_error_string(rc: int) -> bytes:
        return f"error string {rc}".encode()


@pytest.mark.parametrize(
    "rc, message",
    [
        (700, "some kernel launch failed: CUDA error 700 (error string 700)"),
        (build.ENCODE_ERROR + 1, "some kernel: cuTensorMapEncodeTiled failed: CUresult 1"),
        (build.NO_ENCODER, "some kernel: the CUDA driver has no cuTensorMapEncodeTiled"),
    ],
    ids=["cuda error", "encode error", "no encoder"],
)
def test_check_turns_every_return_code_into_its_error(rc, message):
    """One decoder for every entry point: a CUDA error with its string,
    and ``hopper.cuh``'s two tensor-map codes; 0 passes."""
    build.check(_StubLibrary(), 0, "some kernel")
    with pytest.raises(RuntimeError) as err:
        build.check(_StubLibrary(), rc, "some kernel")
    assert str(err.value) == message


def test_one_reset_zeros_every_kernels_launches_and_threads_all_count():
    """Every kernel's counts form one table; concurrent launches from 8
    threads are all counted, and one reset zeros the whole table."""
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import kda, mla, scan

    flt = GemmKernelConfig(64, 64, 64, "WS", out_dtype="bfloat16")
    workers, per = 8, 2000

    def launch():
        for _ in range(per):
            gemm.record_launch(flt, "wgmma")
            KA.LAUNCHES.record("prefill_attention")
            scan.LAUNCHES.record("selective_scan")
            mla.LAUNCHES.record("mla_decode", (mla.LAUNCHES, "mla_decode_combine"))
            kda.LAUNCHES.record("kda_recurrent")

    threads = [threading.Thread(target=launch) for _ in range(workers)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        n = workers * per
        assert build.launches() == {"qgemm_requant": 0, "gemm_int32": 0, "gemm_float": n,
                                    "gemm_float/mma_sync": 0, "gemm_float/wgmma": n,
                                    "prefill_attention": n, "selective_scan": n,
                                    "mla_decode": n, "mla_decode_combine": n, "kda_recurrent": n}
    finally:
        gemm.reset_launches()
    assert len(build.launches()) == 10 and not any(build.launches().values())
    assert not any(KA.LAUNCHES.values()) and not any(scan.LAUNCHES.values()) and not any(mla.LAUNCHES.values())
    assert not any(kda.LAUNCHES.values())


def test_kernel_build_outside_a_checkout_raises(monkeypatch, tmp_path):
    """An installed copy has no checkout to build in: naming the missing
    source tree beats writing a library beside the interpreter."""
    installed = tmp_path / "lib" / "python3.12" / "site-packages" / "repro_torch" / "kernels" / "build.py"
    monkeypatch.setattr(build, "__file__", str(installed))
    with pytest.raises(RuntimeError, match="not running from a checkout"):
        build.library_path("gemm")
    assert not (tmp_path / "lib" / "python3.12" / "build").exists()


# -- the kernel's launch geometry (csrc/gemm.cu's cluster split) --------------

_GEOMETRY_CASES = [
    # (m, k, n), (block_m, block_k, block_n)
    ((16, 640, 128), (16, 128, 128)),
    ((16, 640, 128), (16, 640, 128)),
    ((16, 128, 640), (16, 128, 640)),
    ((16, 128, 640), (16, 128, 128)),
    ((16, 128, 8), (16, 128, 16)),
    ((16, 8, 128), (16, 16, 128)),
    ((1, 640, 128), (16, 128, 128)),
    ((37, 100, 75), (16, 32, 64)),
    ((16, 4096, 128), (16, 128, 128)),
    ((16, 2**17 + 64, 8), (16, 128, 8)),
    ((16, 2**17 + 64, 1024), (16, 128, 1024)),
    ((64, 96, 2000), (32, 32, 2000)),
    ((5, 33, 520), (8, 16, 520)),
    ((3, 0, 7), (4, 4, 4)),
]


@pytest.mark.parametrize("dataflow", ["OS", "WS"])
@pytest.mark.parametrize("shape,blocks", _GEOMETRY_CASES)
def test_launch_geometry_k_slices_tile_k_in_whole_stages(shape, blocks, dataflow):
    m, k, n = shape
    geo = gemm.launch_geometry(m, k, n, GemmKernelConfig(*blocks, dataflow))
    slices = geo.k_slices()
    assert len(slices) == geo.k_split
    assert slices[0][0] == 0 and slices[-1][1] == k
    for (b0, e0), (b1, _) in zip(slices, slices[1:]):
        assert e0 == b1  # contiguous, no overlap
    for b, e in slices:
        assert b % gemm.STAGE_K == 0 and (e % gemm.STAGE_K == 0 or e == k)
        assert b < e or k == 0  # no CTA gets an empty slice
    stage_counts = [-(-(e - b) // gemm.STAGE_K) for b, e in slices]
    assert max(stage_counts) - min(stage_counts) <= 1  # balanced


@pytest.mark.parametrize("dataflow", ["OS", "WS"])
@pytest.mark.parametrize("shape,blocks", _GEOMETRY_CASES)
def test_launch_geometry_clusters_and_column_tiles(shape, blocks, dataflow):
    m, k, n = shape
    cfg = GemmKernelConfig(*blocks, dataflow)
    geo = gemm.launch_geometry(m, k, n, cfg)
    assert 1 <= geo.cluster <= gemm.MAX_CLUSTER
    for split in (geo.col_split, geo.k_split):
        assert split & (split - 1) == 0  # powers of two
    assert geo.col_tile % 16 == 0 and 16 <= geo.col_tile <= gemm.TILE_N
    cols = min(cfg.block_n, n)
    tiles = -(-cols // geo.col_tile)
    # every column tile has a CTA, and no more CTAs than tiles go unused
    assert geo.col_split == gemm.MAX_CLUSTER or geo.col_split < 2 * tiles
    assert tiles <= geo.col_split or geo.col_tile == gemm.TILE_N
    assert geo.k_split <= max(geo.stages, 1)
    if cols <= gemm.TILE_N and k <= gemm.STAGE_K:
        assert geo.cluster == 1  # the block fits one CTA and one stage
    assert gemm.launch_geometry(m, k, n, cfg) is geo  # cached per shape and config


@pytest.mark.parametrize("dataflow", ["OS", "WS"])
def test_launch_geometry_rasters_like_grid_for(dataflow):
    """The clusters walk the blocks in the order of the config's grid: for
    shapes that are whole blocks, ``grid`` is ``grid_for``'s first two axes;
    ragged shapes round up."""
    cfg = GemmKernelConfig(16, 32, 64, dataflow)
    for m, k, n in ((32, 64, 128), (48, 96, 192), (16, 32, 64)):
        assert gemm.launch_geometry(m, k, n, cfg).grid == cfg.grid_for(m, k, n)[:2]
        assert gemm.launch_geometry(m, k, n, cfg).grid == RefConfig(
            16, 32, 64, dataflow
        ).grid_for(m, k, n)[:2]
    outer, inner = gemm.launch_geometry(37, 100, 75, cfg).grid
    assert (outer, inner) == ((2, 3) if dataflow == "WS" else (3, 2))


def test_launch_geometry_spreads_the_toycar_blocks():
    """toycar_mlp@16 as compiled: the 16x640x128 layer splits K over a full
    cluster in every mode, naive's (16, 128, 640) block splits its columns,
    and no layer is left on one CTA unless it is one stage deep."""
    import repro_torch
    from repro_torch.core import zoo

    for mode in ("optimized", "baseline", "naive"):
        module = repro_torch.compile(
            zoo.get_model("toycar_mlp").build(batch=16),
            repro_torch.Target("gemmini", mode=mode, device="cpu", cache=False),
        )
        geos = []
        for node, op in module.ops.items():
            x, w = node.inputs[0], node.inputs[1]
            m, k, n = int(np.prod(x.shape[:-1])), x.shape[-1], w.shape[-1]
            geos.append(((m, k, n), op.executor.kernel_config, gemm.launch_geometry(m, k, n, op.executor.kernel_config)))
        (shape0, _, first), (shape7, cfg7, last) = geos[0], geos[-1]
        assert shape0 == (16, 640, 128) and first.k_split == gemm.MAX_CLUSTER
        assert shape7 == (16, 128, 640)
        if mode == "naive":
            assert cfg7.block_n == 640 and last.col_split > 1 and last.cluster > 1
        for (m, k, n), _, geo in geos:
            assert geo.cluster > 1 or k <= gemm.STAGE_K


@pytest.mark.parametrize(
    "dtype,shape,offset,lengths,want",
    [
        (torch.int8, (16, 640), 0, (640,), True),
        (torch.int8, (16, 8), 0, (8,), False),  # toycar layer 5: x rows of 8 bytes
        (torch.int8, (128, 8), 0, (8,), False),  # toycar layer 4: w rows of 8 bytes
        (torch.int8, (16, 640), 1, (640,), False),  # base one byte off
        (torch.float32, (37, 100), 0, (100,), True),  # 400-byte rows
        (torch.float32, (100, 75), 0, (75,), False),
        (torch.float32, (16, 128), 1, (128,), False),
        (torch.bfloat16, (16, 128), 0, (128, 64), True),
        (torch.int8, (128, 128), 0, (128, 75), False),  # a block width off 16 bytes
    ],
)
def test_vector_copies_needs_aligned_base_and_rows(dtype, shape, offset, lengths, want):
    numel = int(np.prod(shape))
    buf = torch.zeros(numel + 64, dtype=dtype)
    skip = (-buf.data_ptr() % 16) // buf.element_size()  # land on a 16-byte boundary first
    t = buf[skip + offset: skip + offset + numel].view(shape)
    assert gemm.vector_copies(t, *lengths) is want
