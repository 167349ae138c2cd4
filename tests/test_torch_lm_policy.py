"""The scheduled-kernel policy (``repro_torch.kernels.policy``) against the
reference's: the same kernel configs from the gemmini backend, ``dense``
routed through ``scheduled_gemm`` for m >= 8 and unrouted below, and the
routed smoke LM against the reference's routed LM (the Pallas kernel in
interpret mode).

On the CPU the routed product runs the kernel's plain version: float32
with the bias added in the accumulator, where the unrouted ``x @ w`` adds
it afterwards.  Routed against unrouted is held to 1e-4, as the
reference's own ``tests/test_system.py`` holds its policy; the port's
routed LM against the reference's to rtol = atol = 1e-4 (f32, summation
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core import build_backend as ref_build_backend
from repro.core.descriptions import make_gemmini_description as ref_gemmini
from repro.kernels import policy as ref_policy
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro_torch.configs import get_smoke_config
from repro_torch.core.configurators import build_backend
from repro_torch.core.descriptions import make_gemmini_description
from repro_torch.kernels import gemm, ops, policy
from repro_torch.models import layers, lm

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def backends():
    return ref_build_backend(ref_gemmini()), build_backend(make_gemmini_description())


@pytest.fixture(autouse=True)
def _clean():
    gemm.reset_launches()
    yield
    policy.set_policy(None)
    assert sum(gemm.LAUNCHES.values()) == 0, "a CPU tensor launched the CUDA kernel"


@pytest.fixture
def spy(monkeypatch):
    """Every (m, k, n, config) that reaches ``scheduled_gemm`` through
    ``ops.matmul``."""
    calls = []
    real = ops.scheduled_gemm

    def recording(x, w, cfg, bias=None):
        calls.append((x.shape[0], x.shape[1], w.shape[1], cfg))
        return real(x, w, cfg, bias)

    monkeypatch.setattr(ops, "scheduled_gemm", recording)
    return calls


def _fields(cfg):
    return (cfg.block_m, cfg.block_k, cfg.block_n, cfg.dataflow, cfg.acc_dtype, cfg.out_dtype,
            cfg.activation, cfg.requant_scale, cfg.has_bias)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 7, 8, 16, 40, 128, 1024])
def test_config_for_matches_the_reference(backends, m, dtype):
    ref_backend, backend = backends
    ref_pol = ref_policy.ScheduledKernelPolicy(ref_backend)
    pol = policy.ScheduledKernelPolicy(backend)
    for k, n in ((64, 64), (64, 128), (128, 64), (64, 512), (4096, 13440), (13440, 4096)):
        for bias in (False, True):
            want = ref_pol.config_for(m, k, n, jnp.dtype(dtype), has_bias=bias)
            got = pol.config_for(m, k, n, dtype, has_bias=bias)
            if m < 8:
                assert got is None and want is None
                continue
            assert _fields(got) == _fields(want), (m, k, n, dtype, bias)
            assert got.out_dtype == dtype and got.acc_dtype == "float32"


def test_config_for_returns_none_when_nothing_schedules(backends):
    class Refusing:
        def schedule(self, wl):
            raise RuntimeError("no feasible schedule")

    pol = policy.ScheduledKernelPolicy(backends[1])
    pol.backend = type("B", (), {"scheduler": Refusing(), "mapping_gen": None})()
    assert pol.config_for(64, 64, 64, torch.float32, has_bias=False) is None


def test_scheduled_kernels_installs_and_removes_the_policy(backends):
    assert policy.get_policy() is None
    with policy.scheduled_kernels(backends[1]) as pol:
        assert policy.get_policy() is pol and pol.min_m == 8
    assert policy.get_policy() is None


@pytest.mark.parametrize("bias", [False, True])
def test_routed_dense_matches_unrouted(backends, spy, bias):
    """As the reference's ``test_scheduled_kernel_policy_integration``:
    a 64x256 @ 256x512 dense, routed and not."""
    gen = torch.Generator().manual_seed(0)
    p = layers.init_dense(gen, 256, 512, bias=bias)
    if bias:
        p["b"] = torch.randn(512, generator=gen)
    x = torch.randn((4, 16, 256), generator=gen)  # m = 64 from the leading dims
    base = layers.dense(p, x)
    assert not spy
    with policy.scheduled_kernels(backends[1]):
        routed = layers.dense(p, x)
    assert routed.dtype == x.dtype and routed.shape == base.shape
    np.testing.assert_allclose(routed.numpy(), base.numpy(), **TOL)
    assert [c[:3] for c in spy] == [(64, 256, 512)] and spy[0][3].has_bias == bias
    assert len(backends[1].scheduler._cache) >= 1


def test_dense_below_min_m_stays_unrouted(backends, spy):
    gen = torch.Generator().manual_seed(1)
    p = layers.init_dense(gen, 64, 32, bias=True)
    x = torch.randn((7, 64), generator=gen)
    with policy.scheduled_kernels(backends[1]):
        out = layers.dense(p, x)
    assert not spy
    torch.testing.assert_close(out, x @ p["w"] + p["b"], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routed_dense_keeps_the_input_dtype(backends, spy, dtype):
    gen = torch.Generator().manual_seed(2)
    p = layers.init_dense(gen, 64, 128, bias=True, dtype=dtype)
    x = torch.randn((16, 64), generator=gen).to(dtype)
    with policy.scheduled_kernels(backends[1]):
        out = layers.dense(p, x)
    assert out.dtype == dtype and spy[0][3].out_dtype == str(dtype).removeprefix("torch.")


def test_routed_lm_matches_the_routed_reference(backends, spy):
    """The smoke codeqwen forward with every dense of m >= 8 on the
    scheduled kernel: the port's (plain version) against the reference's
    (Pallas interpret mode)."""
    ref_backend, backend = backends
    ref_cfg = ref_get_smoke_config("codeqwen1_5_7b")
    cfg = get_smoke_config("codeqwen1_5_7b")
    ref_params = ref_lm.init_lm(jax.random.key(0), ref_cfg)
    params = lm.params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    with ref_policy.scheduled_kernels(ref_backend, interpret=True):
        want, _ = ref_lm.forward(ref_params, ref_cfg, jnp.asarray(toks))
        want = np.asarray(want)
    with policy.scheduled_kernels(backend), torch.inference_mode():
        got, _ = lm.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # q, k, v, o, gate, up, down per layer, and the head: all m = 16
    assert len(spy) == 7 * cfg.n_layers + 1
    assert {c[0] for c in spy} == {16}
    unrouted, _ = lm.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), unrouted.detach().numpy(), **TOL)


def test_decode_below_min_m_runs_unrouted(backends, spy):
    """A decode step at batch 2 (m = 2 < 8) routes nothing; at batch 8
    every dense routes, as in the reference's policy."""
    cfg = get_smoke_config("granite_34b")  # gelu MLP: 6 GEMMs a layer
    params = lm.init_lm(0, cfg, device="cpu")
    with policy.scheduled_kernels(backends[1]), torch.inference_mode():
        for batch, routed in ((2, 0), (8, 6 * cfg.n_layers + 1)):
            spy.clear()
            c = lm.init_cache(cfg, batch, 8, device="cpu")
            lm.prefill(params, cfg, torch.zeros((batch, 4), dtype=torch.int32), c)
            # the layers see m = 4 * batch >= 8 rows, the head only the last
            # position's batch rows
            assert len(spy) == 6 * cfg.n_layers + (batch >= 8)
            spy.clear()
            lm.decode_step(params, cfg, c, torch.zeros((batch, 1), dtype=torch.int32))
            assert len(spy) == routed and all(call[0] == batch for call in spy)


def test_reference_layers_agree_on_the_unrouted_dense():
    """Unrouted dense, rmsnorm, RoPE and the two MLPs against the reference
    layer by layer."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    tx = torch.from_numpy(x)
    w = rng.normal(size=(32, 48)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    want = ref_layers.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    got = layers.dense({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    scale = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm({"scale": torch.from_numpy(scale)}, tx).numpy(),
        np.asarray(ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))), **TOL,
    )
    pos = np.arange(6)
    cos, sin = layers.rope_tables(torch.from_numpy(pos), 32)
    rcos, rsin = ref_layers.rope_tables(jnp.asarray(pos), 32)
    np.testing.assert_allclose(cos.numpy(), np.asarray(rcos), **TOL)
    np.testing.assert_allclose(
        layers.apply_rope(tx, cos, sin).numpy(),
        np.asarray(ref_layers.apply_rope(jnp.asarray(x), rcos, rsin)), **TOL,
    )
    for kind in ("swiglu", "gelu"):
        ref_p = ref_layers.init_mlp(jax.random.key(3), 32, 64, kind=kind)
        p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref_p)
        np.testing.assert_allclose(
            layers.mlp(p, tx).numpy(), np.asarray(ref_layers.mlp(ref_p, jnp.asarray(x))), **TOL
        )
    table = rng.normal(size=(50, 32)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 3))
    np.testing.assert_array_equal(
        layers.embed({"table": torch.from_numpy(table)}, torch.from_numpy(toks)).numpy(),
        np.asarray(ref_layers.embed({"table": jnp.asarray(table)}, jnp.asarray(toks))),
    )
    np.testing.assert_allclose(
        layers.unembed({"table": torch.from_numpy(table)}, tx).numpy(),
        np.asarray(ref_layers.unembed({"table": jnp.asarray(table)}, jnp.asarray(x))), **TOL,
    )
