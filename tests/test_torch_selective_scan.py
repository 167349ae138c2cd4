"""Mamba's selective scan (``repro_torch.kernels.scan``): the plain version
the wrapper takes off the card, the wrapper's checks, and the kernel.

On the CPU: the Mamba block, whose scan is the plain version here, held
to the reference's ``mamba_block`` in float32 at lengths of one, several
and many chunks, from zeros and from a given state; the wrapper against
a position-by-position float64 loop at both state sizes the kernel is
built for; and the wrapper refusing a wrong dtype, shape or layout on
every device.  Tests marked ``cuda`` hold the kernel to the plain version
on the card, at jamba's layer and at a decode step from a state (bf16),
at ragged sizes (f32), and count its launches:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_selective_scan.py

This file imports JAX only inside the fixture of the reference, so the
card, which has no JAX, collects it.
"""

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import scan
from repro_torch.models import ssm

#: jamba-v0.1's Mamba layer at the benchmark's batch and longest wave
JAMBA_LAYER = (8, 1024, 8192, 16)


def inputs(bsz, s, d_in, n, dtype, *, state=False, seed=0, device="cpu"):
    """(u, dt, a_log, d, b, c, h0) drawn from ``seed`` as a Mamba layer
    makes them: u after SiLU; dt as dt_proj gives it, with a few entries
    past softplus's threshold and far below zero; A_log near log(1..n)."""
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen)

    u = torch.nn.functional.silu(draw(bsz, s, d_in))
    dt = draw(bsz, s, d_in)
    dt.view(-1)[::97] = 25.0
    dt.view(-1)[1::89] = -30.0
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32)).expand(d_in, n) + 0.1 * draw(d_in, n)
    d = 1.0 + 0.1 * draw(d_in)
    b, c = draw(bsz, s, n), draw(bsz, s, n)
    h0 = draw(bsz, d_in, n) if state else None
    low = [t.to(dtype) for t in (u, dt, b, c)]
    out = (low[0], low[1], a_log.contiguous(), d, low[2], low[3], h0)
    return tuple(None if t is None else t.to(device) for t in out)


def mamba_counts(rec):
    return {k: v for k, v in rec.counters.items() if k.startswith("mamba.")}


def sequential(u, dt, a_log, d, b, c, h0):
    """The scan one position at a time, in float64."""
    u, dt, a_log, d, b, c = (t.double() for t in (u, dt, a_log, d, b, c))
    bsz, s, d_in = u.shape
    h = torch.zeros((bsz, d_in, a_log.shape[1]), dtype=torch.float64) if h0 is None else h0.double()
    a = -torch.exp(a_log)
    ys = []
    for t in range(s):
        delta = torch.nn.functional.softplus(dt[:, t])  # [B, d_in]
        h = torch.exp(delta[..., None] * a) * h + (delta * u[:, t])[..., None] * b[:, t, None, :]
        ys.append((h * c[:, t, None, :]).sum(-1) + d * u[:, t])
    return torch.stack(ys, 1), h


# ---------------------------------------------------------------------------
# the plain version (CPU)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    """(the reference's ssm module, its smoke config, its block's
    parameters, the port's config and the same parameters as tensors)."""
    import jax
    from repro.configs import get_smoke_config as ref_get_smoke_config
    from repro.models import ssm as ref_ssm

    ref_cfg, cfg = ref_get_smoke_config("jamba_v0_1_52b"), get_smoke_config("jamba_v0_1_52b")
    ref_p = ref_ssm.init_mamba(jax.random.key(11), ref_cfg)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref_p)
    return ref_ssm, ref_cfg, ref_p, cfg, p


@pytest.mark.parametrize("state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("s", [1, 7, 128, 384])
def test_the_plain_scan_matches_the_references_block(reference, s, state):
    import jax.numpy as jnp

    ref_ssm, ref_cfg, ref_p, cfg, p = reference
    rng = np.random.default_rng(s)
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    h0 = rng.normal(size=(2, d_in, mc.d_state)).astype(np.float32)
    conv = rng.normal(size=(2, mc.d_conv - 1, d_in)).astype(np.float32)
    ref_state = ref_ssm.MambaState(h=jnp.asarray(h0), conv=jnp.asarray(conv)) if state else None
    port_state = ssm.MambaState(h=torch.from_numpy(h0), conv=torch.from_numpy(conv)) if state else None
    want, want_st = ref_ssm.mamba_block(ref_p, ref_cfg, jnp.asarray(x), ref_state)
    with tracing.recording() as rec:
        got, got_st = ssm.mamba_block(p, cfg, torch.from_numpy(x), port_state)
    assert mamba_counts(rec) == {"mamba.plain_calls": 1}
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(got_st.h.numpy(), np.asarray(want_st.h), **tol)
    np.testing.assert_array_equal(got_st.conv.numpy(), np.asarray(want_st.conv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", scan.STATE_SIZES)
@pytest.mark.parametrize("state", [False, True], ids=["zeros", "state"])
def test_the_wrapper_off_the_card_is_the_sequential_scan(n, dtype, state):
    """Three chunks of 16, the last ragged; y rounded once to the inputs'
    dtype, h in float32."""
    args = inputs(2, 37, 24, n, dtype, state=state, seed=n)
    y, h = scan.selective_scan(*args, chunk=16)
    want_y, want_h = sequential(*args)
    assert y.dtype == dtype and h.dtype == torch.float32
    eps = 2.0**-8 if dtype == torch.bfloat16 else 1e-6
    scale = want_y.abs().max()
    assert ((y.double() - want_y).abs() <= eps * want_y.abs() + 1e-6 * scale).all()
    torch.testing.assert_close(h.double(), want_h, rtol=1e-5, atol=1e-6 * float(want_h.abs().max()))


def _variant(name):
    """The wrapper's arguments at a small size with one thing wrong."""
    u, dt, a_log, d, b, c, h0 = inputs(2, 5, 16, 8, torch.float32, state=True)
    proj = torch.randn(2, 5, 16 + 8 + 8)
    return {
        "u in float16": (u.half(), dt, a_log, d, b, c, h0),
        "dt in bfloat16": (u, dt.bfloat16(), a_log, d, b, c, h0),
        "a_log in bfloat16": (u, dt, a_log.bfloat16(), d, b, c, h0),
        "h0 in bfloat16": (u, dt, a_log, d, b, c, h0.bfloat16()),
        "u not [B, S, d_in]": (u[0], dt, a_log, d, b, c, h0),
        "dt one position short": (u, dt[:, :4].contiguous(), a_log, d, b, c, h0),
        "a_log over other channels": (u, dt, a_log[:8].contiguous(), d, b, c, h0),
        "d over other channels": (u, dt, a_log, d[:8].contiguous(), b, c, h0),
        "b of another state size": (u, dt, a_log, d, torch.randn(2, 5, 4), c, h0),
        "h0 of another batch": (u, dt, a_log, d, b, c, h0[:1].contiguous()),
        "u transposed": (u.transpose(0, 1).contiguous().transpose(0, 1), dt, a_log, d, b, c, h0),
        "b split off the projection": (u, dt, a_log, d, torch.split(proj, [16, 8, 8], -1)[1], c, h0),
        "h0 a strided view": (u, dt, a_log, d, b, c, torch.randn(2, 16, 16)[..., ::2]),
    }[name]


VARIANTS = ["u in float16", "dt in bfloat16", "a_log in bfloat16", "h0 in bfloat16", "u not [B, S, d_in]",
            "dt one position short", "a_log over other channels", "d over other channels",
            "b of another state size", "h0 of another batch", "u transposed", "b split off the projection",
            "h0 a strided view"]


@pytest.mark.parametrize("name", VARIANTS)
def test_the_wrapper_refuses_a_wrong_dtype_shape_or_layout(name):
    args = _variant(name)
    assert scan.scan_refusal(*args) is not None
    with pytest.raises(ValueError, match="selective scan"):
        scan.selective_scan(*args)


def test_a_differentiated_block_runs_the_plain_version():
    """The kernel has no backward: a block whose parameters require grad
    takes the plain version on every device, and its gradient flows."""
    cfg = get_smoke_config("jamba_v0_1_52b")
    gen = torch.Generator().manual_seed(0)
    p = ssm.init_mamba(gen, cfg)
    p["A_log"].requires_grad_()
    x = torch.randn(2, 9, cfg.d_model)
    with tracing.recording() as rec:
        y, _ = ssm.mamba_block(p, cfg, x)
    y.sum().backward()
    assert mamba_counts(rec) == {"mamba.plain_calls": 1}
    assert p["A_log"].grad is not None and bool(torch.isfinite(p["A_log"].grad).all())


# ---------------------------------------------------------------------------
# the kernel (the card)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the selective scan kernel runs only there")
    return torch.device("cuda", 0)


def _against_plain(args, chunk=128):
    """The kernel's (y, h) and the plain version's on the same tensors."""
    before = scan.LAUNCHES["selective_scan"]
    got = scan.selective_scan(*args)
    want = scan.selective_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert scan.LAUNCHES["selective_scan"] == before + 1
    return got, want


def _close(got, want):
    (y, h), (py, ph) = got, want
    assert y.dtype == py.dtype and h.dtype == torch.float32
    if y.dtype == torch.bfloat16:  # both round one f32 value once: at most one bf16 step apart
        step = torch.exp2(torch.floor(torch.log2(py.float().abs().clamp_min(2.0**-60))) - 7)
        assert ((y.float() - py.float()).abs() <= step + 1e-5 * py.float().abs().max()).all()
    else:
        torch.testing.assert_close(y, py, rtol=1e-5, atol=1e-5 * float(py.abs().max()))
    torch.testing.assert_close(h, ph, rtol=1e-4, atol=1e-5 * float(ph.abs().max()))


@pytest.mark.cuda
def test_the_kernel_matches_the_plain_version_at_jambas_layer(card):
    args = inputs(*JAMBA_LAYER, torch.bfloat16, device=card)
    _close(*_against_plain(args))


@pytest.mark.cuda
def test_the_kernel_matches_the_plain_version_at_a_decode_step(card):
    bsz, _, d_in, n = JAMBA_LAYER
    args = inputs(bsz, 1, d_in, n, torch.bfloat16, state=True, seed=1, device=card)
    _close(*_against_plain(args))


@pytest.mark.cuda
@pytest.mark.parametrize("n", scan.STATE_SIZES)
def test_the_kernel_matches_the_plain_version_at_ragged_sizes_in_f32(card, n):
    """S past a tile and a group, d_in past a CTA's channels."""
    args = inputs(3, 45, 200, n, torch.float32, state=True, seed=n, device=card)
    _close(*_against_plain(args, chunk=16))


@pytest.mark.cuda
def test_one_launch_a_call_counted_as_a_kernel_call_and_bit_equal_twice(card):
    args = inputs(2, 70, 256, 16, torch.bfloat16, device=card)
    before = scan.LAUNCHES["selective_scan"]
    with tracing.recording() as rec:
        first = scan.selective_scan(*args)
        again = scan.selective_scan(*args)
    torch.cuda.synchronize()
    assert scan.LAUNCHES["selective_scan"] == before + 2
    assert mamba_counts(rec) == {"mamba.kernel_calls": 2}
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    scan.selective_scan_plain(*args)
    assert scan.LAUNCHES["selective_scan"] == before + 2


@pytest.mark.cuda
def test_the_kernel_refuses_what_it_is_not_built_for(card):
    args = list(inputs(2, 5, 16, 4, torch.float32, device=card))
    with pytest.raises(ValueError, match="d_state 4"):
        scan.selective_scan(*args)
    args = list(inputs(2, 5, 16, 8, torch.float32, device=card))
    args[2] = args[2].clone().requires_grad_()
    with pytest.raises(ValueError, match="requires grad"):
        scan.selective_scan(*args)


@pytest.mark.cuda
def test_a_jamba_block_on_the_card_calls_the_kernel_once(card):
    cfg = get_smoke_config("jamba_v0_1_52b")
    gen = torch.Generator(device=card).manual_seed(0)
    p = ssm.init_mamba(gen, cfg)
    x = torch.randn(2, 40, cfg.d_model, device=card)
    before = scan.LAUNCHES["selective_scan"]
    with torch.inference_mode(), tracing.recording() as rec:
        y, st = ssm.mamba_block(p, cfg, x)
    torch.cuda.synchronize()
    assert mamba_counts(rec) == {"mamba.kernel_calls": 1} and scan.LAUNCHES["selective_scan"] == before + 1
    cpu_p = {k: (v.cpu() if isinstance(v, torch.Tensor) else {kk: vv.cpu() for kk, vv in v.items()})
             for k, v in p.items()}
    want, want_st = ssm.mamba_block(cpu_p, cfg, x.cpu())
    torch.testing.assert_close(y.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st.h.cpu(), want_st.h, rtol=1e-4, atol=1e-4)
