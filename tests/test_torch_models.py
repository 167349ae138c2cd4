"""The port's LM substrate (``repro_torch.models``, ``repro_torch.configs``)
against the reference's, on the CPU.

Parameters come from the reference's ``init_lm(jax.random.key(0), cfg)``,
converted leaf by leaf with ``params_from_numpy``; tokens are drawn with
numpy from a seed.  The four dense archs at their smoke configs cover MHA
(qwen1.5, codeqwen1.5 with QKV bias), GQA (yi, kv = 2) and MQA with the
gelu MLP (granite, kv = 1); the other block kinds are held in
``tests/test_torch_lm_kinds.py``.  Both packages compute in float32 and sum in
different orders (XLA against torch), so logits are held to
rtol = atol = 1e-4 (observed about 2e-6 on logits of magnitude 2);
integer and quantized values are bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import cache as ref_cache
from repro.models import config as ref_config
from repro.models import lm as ref_lm
from repro_torch.configs import ARCH_IDS, all_configs, canonical, get_config, get_smoke_config
from repro_torch.kernels import gemm
from repro_torch.models import cache, config, lm

DENSE = ("qwen1_5_32b", "yi_34b", "granite_34b", "codeqwen1_5_7b")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _no_launches():
    gemm.reset_launches()
    yield
    assert sum(gemm.LAUNCHES.values()) == 0, "a CPU tensor launched the CUDA kernel"


def _models(arch, **overrides):
    """(reference cfg, reference params, port cfg, port params)."""
    ref_cfg = ref_get_smoke_config(arch).with_(**overrides)
    cfg = get_smoke_config(arch).with_(**overrides)
    ref_params = ref_lm.init_lm(jax.random.key(0), ref_cfg)
    params = lm.params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return ref_cfg, ref_params, cfg, params


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


# -- configs -------------------------------------------------------------------


def test_configs_match_the_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == dataclasses.asdict(
            ref_get_smoke_config(arch)
        )
    assert canonical("codeqwen1.5-7b") == "codeqwen1_5_7b"
    assert [s.name for s in config.SHAPES] == [s.name for s in ref_config.SHAPES]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_the_reference(arch):
    cfg, ref_cfg = all_configs()[arch], ref_get_config(arch)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    assert [s.name for s in config.shapes_for(cfg)] == [s.name for s in ref_config.shapes_for(ref_cfg)]


def test_codeqwen_published_width():
    cfg = get_config("codeqwen1_5_7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == (
        32, 4096, 32, 32, 13440, 92416
    )
    assert cfg.qkv_bias and cfg.param_dtype == "bfloat16"
    assert cfg.param_count() == 8_189_378_560  # 8.19 B: 16.4 GB in bf16


# -- init ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_init_lm_has_the_reference_layout(arch):
    """Same tree, shapes and dtypes as the reference's ``init_lm``; the
    draws are the port's own, reproducible from the seed."""
    ref_cfg = ref_get_smoke_config(arch)
    cfg = get_smoke_config(arch)
    want = jax.tree.map(np.asarray, ref_lm.init_lm(jax.random.key(0), ref_cfg))
    got = lm.init_lm(0, cfg, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == jax.tree.structure(
        jax.tree.map(lambda a: 0, want)
    )
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape and str(g.dtype).removeprefix("torch.") == str(w.dtype)
    again = lm.init_lm(0, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(again)))
    other = lm.init_lm(1, cfg, device="cpu")
    assert not torch.equal(got["head"]["w"], other["head"]["w"])
    # weights at the reference's scale: N(0, 2 / (d_in + d_out)), biases zero
    w = got["groups"]["pos0"]["block"]["q"]["w"]
    assert abs(float(w.std()) - (2.0 / sum(w.shape[1:])) ** 0.5) < 0.02


def test_init_lm_defaults_to_the_card():
    cfg = get_smoke_config("codeqwen1_5_7b")
    if torch.cuda.is_available():
        assert lm.init_lm(0, cfg)["head"]["w"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        lm.init_lm(0, cfg)


def test_params_from_numpy_converts_bf16_and_checks_depth():
    ref_cfg = ref_get_smoke_config("codeqwen1_5_7b").with_(param_dtype="bfloat16")
    cfg = get_smoke_config("codeqwen1_5_7b").with_(param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, ref_lm.init_lm(jax.random.key(0), ref_cfg))
    params = lm.params_from_numpy(tree, cfg, device="cpu")
    w = params["groups"]["pos0"]["ffn"]["up"]["w"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(), tree["groups"]["pos0"]["ffn"]["up"]["w"].astype(np.float32)
    )
    assert lm.params_from_numpy(tree, cfg, device="cpu", dtype="float32")["head"]["w"].dtype == torch.float32
    with pytest.raises(ValueError, match="stacks 2 groups"):
        lm.params_from_numpy(tree, cfg.with_(n_layers=4), device="cpu")


# -- forward, prefill, decode ----------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_the_reference(arch):
    ref_cfg, ref_params, cfg, params = _models(arch)
    toks = _tokens(cfg, 2, 40)  # 40 = one full attn chunk of 32 and a ragged one
    want, want_aux = ref_lm.forward(ref_params, ref_cfg, jnp.asarray(toks))
    with torch.inference_mode():
        got, aux = lm.forward(params, cfg, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 40, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("arch", ["yi_34b", "granite_34b"])
def test_block_skip_forward_matches_the_reference(arch):
    """The block-skip forward (GQA and MQA; the skip's KV ranges are held
    to the reference's for every case in ``tests/test_torch_flash.py``)."""
    ref_cfg, ref_params, cfg, params = _models(arch, attn_chunk=16)
    toks = _tokens(cfg, 1, 48)
    want, _ = ref_lm.forward(ref_params, ref_cfg, jnp.asarray(toks), block_skip=True)
    got, _ = lm.forward(params, cfg, torch.from_numpy(toks), block_skip=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "arch,kv_dtype,tol",
    [pytest.param(arch, "float32", TOL, id=arch) for arch in DENSE]
    # a bf16 cache rounds K/V and the attention weights to bf16, and the two
    # packages' bf16 value products round differently: one bf16 step at
    # magnitude 1 is 2**-7
    + [pytest.param("codeqwen1_5_7b", "bfloat16", dict(rtol=1e-2, atol=1e-2), id="bf16-cache")],
)
def test_prefill_then_decode_match_the_reference(arch, kv_dtype, tol):
    """As ``tests/test_models.py``'s consistency test: prefill 16 tokens,
    then two decode steps, each step's logits against the reference's."""
    ref_cfg, ref_params, cfg, params = _models(arch, kv_cache_dtype=kv_dtype)
    b, s, max_len = 2, 16, 48
    toks = _tokens(cfg, b, s)
    ref_c = ref_lm.init_cache(ref_cfg, b, max_len)
    c = lm.init_cache(cfg, b, max_len, device="cpu")
    want, ref_c = ref_lm.prefill(ref_params, ref_cfg, jnp.asarray(toks), ref_c)
    with torch.inference_mode():
        got, c = lm.prefill(params, cfg, torch.from_numpy(toks), c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    assert c["len"] == int(ref_c["len"]) == s
    for _ in range(2):
        nxt = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        want, ref_c = ref_lm.decode_step(ref_params, ref_cfg, ref_c, jnp.asarray(nxt))
        with torch.inference_mode():
            got, c = lm.decode_step(params, cfg, c, torch.from_numpy(nxt))
        assert tuple(got.shape) == (b, 1, cfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    # the caches hold the same keys and values
    for name in ("k", "v"):
        ref_t = np.asarray(ref_c["groups"]["pos0"][name].astype(jnp.float32))
        np.testing.assert_allclose(c["groups"]["pos0"][name].float().numpy(), ref_t, **tol)


def test_prefill_then_decode_match_forward():
    """The port's own consistency: decode after prefill gives forward's
    logits at the next position (f32 cache)."""
    _, _, cfg, params = _models("yi_34b", kv_cache_dtype="float32")
    toks = _tokens(cfg, 2, 16)
    with torch.inference_mode():
        full, _ = lm.forward(params, cfg, torch.from_numpy(toks))
        c = lm.init_cache(cfg, 2, 32, device="cpu")
        pf, c = lm.prefill(params, cfg, torch.from_numpy(toks), c)
        nxt = torch.argmax(full[:, -1:], -1)
        dec, c = lm.decode_step(params, cfg, c, nxt)
        full2, _ = lm.forward(params, cfg, torch.cat([torch.from_numpy(toks), nxt.int()], 1))
    np.testing.assert_allclose(pf[:, 0].numpy(), full[:, -1].numpy(), **TOL)
    np.testing.assert_allclose(dec[:, 0].numpy(), full2[:, -1].numpy(), **TOL)


def test_int8_cache_prefill_then_decode_match_the_reference():
    """The quantized cache end to end: prefill and one decode step with
    int8 K/V against the reference (the K/V it quantizes agree to f32
    rounding, so a code can move by one step: logits within 1e-2)."""
    ref_cfg, ref_params, cfg, params = _models("granite_34b", kv_cache_dtype="int8")
    toks = _tokens(cfg, 2, 16)
    ref_c = ref_lm.init_cache(ref_cfg, 2, 24)
    c = lm.init_cache(cfg, 2, 24, device="cpu")
    assert c["groups"]["pos0"]["k"].dtype == torch.int8
    assert tuple(c["groups"]["pos0"]["k_scale"].shape) == ref_c["groups"]["pos0"]["k_scale"].shape
    want, ref_c = ref_lm.prefill(ref_params, ref_cfg, jnp.asarray(toks), ref_c)
    got, c = lm.prefill(params, cfg, torch.from_numpy(toks), c)
    nxt = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    want, ref_c = ref_lm.decode_step(ref_params, ref_cfg, ref_c, jnp.asarray(nxt))
    got, c = lm.decode_step(params, cfg, c, torch.from_numpy(nxt))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-2, atol=1e-2)


# -- the KV cache ----------------------------------------------------------------


def test_quantize_kv_is_bit_equal():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 16, 32)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0  # an all-zero row takes the floor scale
    x[0, 0, 1, :4] = [2.5, -2.5, 0.5, 127.0]  # ties round half to even
    want_q, want_s = ref_cache.quantize_kv(jnp.asarray(x))
    got_q, got_s = cache.quantize_kv(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = cache.dequantize_kv(got_q, got_s, dt).float().numpy()
        want = np.asarray(ref_cache.dequantize_kv(want_q, want_s, jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kv_dtype", ["int8", "bfloat16", "float32"])
def test_write_then_read_match_the_reference(kv_dtype):
    cfg = get_smoke_config("yi_34b").with_(kv_cache_dtype=kv_dtype)
    ref_cfg = ref_get_smoke_config("yi_34b").with_(kv_cache_dtype=kv_dtype)
    rng = np.random.default_rng(4)
    c = cache.make_attn_cache(cfg, 2, 12, device="cpu")
    ref_c = ref_cache.make_attn_cache(ref_cfg, 2, 12)
    assert sorted(c) == sorted(ref_c)
    for name in c:
        assert tuple(c[name].shape) == ref_c[name].shape
        assert str(c[name].dtype).removeprefix("torch.") == str(ref_c[name].dtype)
    for pos, s in ((0, 5), (5, 1), (6, 6)):
        k = rng.normal(size=(2, cfg.n_kv_heads, s, cfg.head_dim_)).astype(np.float32)
        v = rng.normal(size=k.shape).astype(np.float32)
        ref_c = ref_cache.write_attn_cache(ref_cfg, ref_c, jnp.asarray(k), jnp.asarray(v), None, pos)
        out = cache.write_attn_cache(cfg, c, torch.from_numpy(k), torch.from_numpy(v), None, pos)
        assert out is c  # in place
    for name in c:
        np.testing.assert_array_equal(
            c[name].float().numpy(), np.asarray(ref_c[name].astype(jnp.float32))
        )
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = cache.read_attn_cache(cfg, c, dt)
        want = ref_cache.read_attn_cache(ref_cfg, ref_c, jdt)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))


def test_cache_overflow_raises_where_the_reference_clamps():
    """A deliberate difference: ``dynamic_update_slice`` clamps a start
    index that would overflow and overwrites the last rows; the port
    raises ``ValueError`` and leaves the cache as it was."""
    cfg = get_smoke_config("qwen1_5_32b").with_(kv_cache_dtype="float32")
    ref_cfg = ref_get_smoke_config("qwen1_5_32b").with_(kv_cache_dtype="float32")
    k = np.ones((1, cfg.n_kv_heads, 3, cfg.head_dim_), np.float32)
    ref_c = ref_cache.write_attn_cache(
        ref_cfg, ref_cache.make_attn_cache(ref_cfg, 1, 8), jnp.asarray(k), jnp.asarray(k), None, 6
    )
    assert np.asarray(ref_c["k"])[0, 0, 5:, 0].tolist() == [1.0, 1.0, 1.0]  # clamped to start 5
    c = cache.make_attn_cache(cfg, 1, 8, device="cpu")
    for pos in (6, -1):
        with pytest.raises(ValueError, match="overflows the 8-row cache"):
            cache.write_attn_cache(cfg, c, torch.from_numpy(k), torch.from_numpy(k), None, pos)
    assert not c["k"].any()
    # and through decode: a full cache refuses the next token
    params = lm.init_lm(0, cfg, device="cpu")
    full = lm.init_cache(cfg, 1, 4, device="cpu")
    lm.prefill(params, cfg, torch.zeros((1, 4), dtype=torch.int32), full)
    with pytest.raises(ValueError, match="overflows the 4-row cache"):
        lm.decode_step(params, cfg, full, torch.zeros((1, 1), dtype=torch.int32))


def test_prefill_and_decode_update_the_cache_in_place():
    """The port's cache is written in place: the returned cache is the one
    passed in, its tensors the same storage, and the stacked group tensors
    hold every layer's rows."""
    _, _, cfg, params = _models("codeqwen1_5_7b", kv_cache_dtype="float32")
    c = lm.init_cache(cfg, 1, 10, device="cpu")
    k_before = c["groups"]["pos0"]["k"]
    with torch.inference_mode():
        _, out = lm.prefill(params, cfg, torch.from_numpy(_tokens(cfg, 1, 6)), c)
        assert out is c and out["groups"]["pos0"]["k"] is k_before and c["len"] == 6
        _, out = lm.decode_step(params, cfg, c, torch.zeros((1, 1), dtype=torch.int32))
    assert out is c and c["len"] == 7
    filled = k_before.abs().sum(dim=(1, 2, 4)) > 0  # [groups, positions]
    assert filled[:, :7].all() and not filled[:, 7:].any()
