"""The port's ``tpu_v5e`` description against the reference's, on the CPU.

The description's constants are the reference's TPU cost model, so its
fingerprint, its validation and every modeled cycle must equal the
reference's.  The four zoo models in every mode on ``Target("tpu_v5e",
device="cpu")`` are held to ``repro.compile`` of the reference's golden
graphs (the reference runs its Pallas kernel in interpret mode): the
op sequence, the schedules, ``modeled_cycles()`` key by key and the
outputs (bit-equal: every path is int8).  The description's torch
functions are held to their ``jax.lax`` originals: the im2col patches
bit-equal to ``lax.conv_general_dilated_patches``, the bf16 and int8
computes within float32 summation order (rtol = atol = 1e-5) and exactly.
Under ``scheduled_kernels`` on a ``tpu_v5e`` backend the smoke LMs' GEMMs
take the reference's configs, and their logits stay within 1e-4 of the
plain run's, as the reference's ``tests/test_system.py`` holds its policy.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import build_backend as ref_build_backend
from repro.core import ir as ref_ir
from repro.core import zoo as ref_zoo
from repro.core.descriptions import make_tpu_v5e_description as ref_tpu_v5e
from repro.kernels import policy as ref_policy
import repro_torch
from repro_torch.configs import get_smoke_config
from repro_torch.core import ir, zoo
from repro_torch.core.configurators import build_backend
from repro_torch.core.descriptions import make_tpu_v5e_description
from repro_torch.kernels import gemm, ops, policy
from repro_torch.models import lm

MODES = ("naive", "baseline", "optimized")
MODELS = ("toycar_mlp", "mlp_tiny", "qcnn", "transformer_block")


@pytest.fixture(autouse=True)
def _no_launches():
    gemm.reset_launches()
    yield
    policy.set_policy(None)
    assert sum(gemm.LAUNCHES.values()) == 0, "a CPU tensor launched the CUDA kernel"


def _fn(desc, kind, name):
    """A registered function of a description by its name."""
    if kind == "preprocessing":
        return next(p.fn for p in desc.preprocessing if p.name == name)
    if kind == "compute":
        return desc.core_computes[name].fn
    return desc.intrinsics[name].fn


def test_description_matches_the_reference():
    got, want = make_tpu_v5e_description(), ref_tpu_v5e()
    assert got.fingerprint() == want.fingerprint()
    assert got.arch.to_dict() == want.arch.to_dict()
    assert repro_torch.validate_description(got) == repro.validate_description(want) == []
    assert sorted(got.core_computes) == sorted(want.core_computes)
    assert sorted(got.intrinsics) == sorted(want.intrinsics)
    assert [p.name for p in got.preprocessing] == [p.name for p in want.preprocessing]
    assert repro_torch.REGISTRY.get("tpu_v5e").fingerprint() == want.fingerprint()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", MODELS)
def test_zoo_on_tpu_v5e_matches_the_reference(name, mode):
    ref = repro.compile(ref_zoo.get_model(name).build(), repro.Target("tpu_v5e", mode=mode, cache=False))
    got = repro_torch.compile(
        zoo.get_model(name).build(), repro_torch.Target("tpu_v5e", mode=mode, device="cpu", cache=False)
    )
    assert [(n.op, n.target) for n in got.graph.toposort()] == [(n.op, n.target) for n in ref.graph.toposort()]
    strip = lambda m: [  # noqa: E731  (node names carry each package's own counter)
        {**d, "workload": {k: v for k, v in d["workload"].items() if k != "name"}} for d in m.schedules().values()
    ]
    assert strip(got) == strip(ref)
    want_cycles, got_cycles = ref.modeled_cycles(), got.modeled_cycles()
    assert sorted(got_cycles) == sorted(want_cycles)
    for key in want_cycles:
        assert got_cycles[key] == want_cycles[key], key
    model = zoo.get_model(name)
    for seed in range(2):
        feeds = model.feeds(seed)
        for g, w in zip(got.run(feeds), ref.run(feeds), strict=True):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    # every offloaded step takes the schedule's 128-aligned C / K blocks
    cfgs = [op.executor.kernel_config for op in got.ops.values()]
    assert cfgs and all(c.block_k % 128 == 0 and c.block_n % 128 == 0 for c in cfgs)


def _qdense_graph(pkg, seed=0):
    """The reference's ``tests/test_system.py`` quantized dense."""
    rng = np.random.default_rng(seed)
    x = pkg.input_((4, 96), "int8", name="x")
    w_fp = pkg.const(rng.normal(size=(80, 96)).astype(np.float32) * 0.02, name="w_fp")
    w_q = pkg.quantize(pkg.transpose(w_fp, (1, 0)), scale=0.02)
    b = pkg.const(rng.integers(-100, 100, size=(80,)).astype(np.int32), name="bias")
    out = pkg.clip(pkg.requantize(pkg.bias_add(pkg.dense(x, w_q), b), scale=0.25))
    return pkg.Graph([out], name="qdense")


@pytest.mark.parametrize("mode", ["proposed", "c_toolchain", "naive"])
def test_backend_modes_are_bit_exact_on_tpu_v5e(mode):
    x = np.random.default_rng(1).integers(-128, 128, size=(4, 96)).astype(np.int8)
    want = ref_ir.execute_graph(_qdense_graph(ref_ir), {"x": x})[0]
    module = build_backend(make_tpu_v5e_description()).compile_graph(_qdense_graph(ir), mode=mode, device="cpu")
    np.testing.assert_array_equal(module.run({"x": x})[0], want)
    ref_module = ref_build_backend(ref_tpu_v5e()).compile_graph(_qdense_graph(ref_ir), mode=mode)
    assert module.modeled_cycles() == ref_module.modeled_cycles()


@pytest.mark.parametrize(
    "shape,kh,kw,stride",
    [((2, 7, 6, 3), 3, 3, 1), ((2, 7, 6, 3), 3, 2, 2), ((1, 12, 12, 8), 3, 3, 1), ((3, 5, 9, 1), 1, 4, 1)],
)
def test_im2col_matches_conv_general_dilated_patches(shape, kh, kw, stride):
    x = np.random.default_rng(2).integers(-128, 128, size=shape).astype(np.int8)
    want = np.asarray(_fn(ref_tpu_v5e(), "preprocessing", "im2col_tpu")(jnp.asarray(x), kh, kw, stride))
    got = _fn(make_tpu_v5e_description(), "preprocessing", "im2col_tpu")(x, kh, kw, stride)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_computes_and_intrinsics_match_the_reference():
    rng = np.random.default_rng(3)
    ref_desc, desc = ref_tpu_v5e(), make_tpu_v5e_description()
    x = rng.normal(size=(16, 128)).astype(np.float32)
    w = rng.normal(size=(128, 64)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    for tag in ("tpu_gemm_bf16", "tpu_gemm_conv"):
        want = np.asarray(_fn(ref_desc, "compute", tag)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
        got = _fn(desc, "compute", tag)(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    xq = rng.integers(-128, 128, size=(16, 128)).astype(np.int8)
    wq = rng.integers(-128, 128, size=(128, 64)).astype(np.int8)
    bq = rng.integers(-5000, 5000, size=(64,)).astype(np.int32)
    args = (0.05, 0.02, 0.5)
    want = np.asarray(_fn(ref_desc, "compute", "tpu_qgemm_int8")(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(bq), *args))
    got = _fn(desc, "compute", "tpu_qgemm_int8")(torch.from_numpy(xq), torch.from_numpy(wq), torch.from_numpy(bq), *args)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    acc = rng.normal(size=(16, 64)).astype(np.float32)
    want = np.asarray(_fn(ref_desc, "intrinsic", "tpu.mxu_matmul")(jnp.asarray(x), jnp.asarray(w), jnp.asarray(acc)))
    got = _fn(desc, "intrinsic", "tpu.mxu_matmul")(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(acc))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    acc_i = rng.integers(-1000, 1000, size=(16, 64)).astype(np.int32)
    want = np.asarray(_fn(ref_desc, "intrinsic", "tpu.mxu_matmul_int8")(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(acc_i)))
    got = _fn(desc, "intrinsic", "tpu.mxu_matmul_int8")(torch.from_numpy(xq), torch.from_numpy(wq), torch.from_numpy(acc_i))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(_fn(ref_desc, "preprocessing", "to_bf16")(w).astype(jnp.float32))
    np.testing.assert_array_equal(_fn(desc, "preprocessing", "to_bf16")(w).float().numpy(), want)
    np.testing.assert_array_equal(
        _fn(desc, "preprocessing", "quantize_w_int8")(w), _fn(ref_desc, "preprocessing", "quantize_w_int8")(w)
    )


@pytest.mark.parametrize("arch", ["codeqwen1_5_7b", "jamba_v0_1_52b"])
def test_scheduled_kernels_on_tpu_v5e_route_a_smoke_lm(arch, monkeypatch):
    """Every dense of m >= 8 takes the reference policy's config from the
    ``tpu_v5e`` backend (128-aligned K and N blocks), and the routed logits
    equal the plain run's within 1e-4."""
    calls = []
    real = ops.scheduled_gemm

    def spy(x, w, cfg, bias=None):
        calls.append((x.shape[0], x.shape[1], w.shape[1], cfg))
        return real(x, w, cfg, bias)

    monkeypatch.setattr(ops, "scheduled_gemm", spy)
    cfg = get_smoke_config(arch)
    params = lm.init_lm(0, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 8)).astype(np.int32))
    with torch.inference_mode():
        plain, _ = lm.forward(params, cfg, toks)
        with policy.scheduled_kernels(build_backend(make_tpu_v5e_description())):
            routed, _ = lm.forward(params, cfg, toks)
    np.testing.assert_allclose(routed.numpy(), plain.numpy(), rtol=1e-4, atol=1e-4)
    assert calls and all(c[3].block_k % 128 == 0 and c[3].block_n % 128 == 0 for c in calls)
    ref_pol = ref_policy.ScheduledKernelPolicy(ref_build_backend(ref_tpu_v5e()))
    for m, k, n, cfg_ in {(c[0], c[1], c[2], c[3]) for c in calls}:
        want = ref_pol.config_for(m, k, n, jnp.float32, has_bias=cfg_.has_bias)
        got = {f.name: getattr(cfg_, f.name) for f in dataclasses.fields(cfg_)}
        assert got == {f: v for f, v in dataclasses.asdict(want).items() if f != "interpret"}
