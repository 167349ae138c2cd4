"""The LM substrate's other block kinds in the port (``repro_torch.models.
{moe,ssm,xlstm}``, MLA attention and its cache, the frontend stubs, every
kind in ``lm``) against the reference's, on the CPU.

Parameters come from the reference's ``init_lm(jax.random.key(0), cfg)``
(or its block ``init_*``), converted leaf by leaf; tokens, frontend
embeddings and activations are drawn with numpy from a seed.  Both
packages compute in float32 and sum in different orders (XLA against
torch), and the port's log-step Mamba scan associates the products
differently from ``jax.lax.associative_scan``, so float outputs are held
to rtol = atol = 1e-4 (observed at most 5e-6 on logits of magnitude 2),
as the dense archs are.  The MoE routing (expert ids, slots, drops) is
compared exactly.  Prefill and decode use float32 caches and a no-drop
MoE capacity, as the reference's own consistency test does
(``tests/test_models.py``); MLA's ``k_rope`` cache stays bfloat16 there,
in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import attention as ref_attention
from repro.models import cache as ref_cache
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.models import xlstm as ref_xlstm
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core.configurators import build_backend
from repro_torch.core.descriptions import make_gemmini_description
from repro_torch.kernels import gemm, ops, policy, scan
from repro_torch.models import attention, cache, lm, moe, ssm, xlstm

TOL = dict(rtol=1e-4, atol=1e-4)
NOT_DENSE = ("paligemma_3b", "mixtral_8x7b", "deepseek_v2_236b", "musicgen_medium", "xlstm_125m",
             "jamba_v0_1_52b")


@pytest.fixture(autouse=True)
def _no_launches():
    gemm.reset_launches()
    yield
    policy.set_policy(None)
    assert sum(gemm.LAUNCHES.values()) == 0, "a CPU tensor launched the CUDA kernel"


def _no_drop(cfg):
    return cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0)) if cfg.moe else cfg


def _models(arch, consistent=False):
    """(reference cfg, reference params, port cfg, port params); with
    ``consistent``, float32 caches and a no-drop MoE capacity."""
    ref_cfg, cfg = ref_get_smoke_config(arch), get_smoke_config(arch)
    if consistent:
        ref_cfg = _no_drop(ref_cfg).with_(kv_cache_dtype="float32")
        cfg = _no_drop(cfg).with_(kv_cache_dtype="float32")
    ref_params = ref_lm.init_lm(jax.random.key(0), ref_cfg)
    params = lm.params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return ref_cfg, ref_params, cfg, params


def _inputs(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    fe = None
    if cfg.frontend:
        fe = rng.normal(size=(b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return toks, fe


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _block_params(tree):
    """A reference block's parameter dict as the port's (f32 tensors)."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# -- the whole LM ----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_aux_match_the_reference(arch):
    ref_cfg, ref_params, cfg, params = _models(arch)
    toks, fe = _inputs(cfg, 2, 16)
    want, want_aux = ref_lm.forward(ref_params, ref_cfg, jnp.asarray(toks), _j(fe))
    with torch.inference_mode():
        got, aux = lm.forward(params, cfg, torch.from_numpy(toks), _t(fe))
    total = 16 + (cfg.n_frontend_tokens if cfg.frontend else 0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, total, cfg.vocab)
    _close(got.numpy(), want)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-7)
    assert (float(aux) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", NOT_DENSE)
def test_prefill_then_decode_match_the_reference(arch):
    """Prefill 16 tokens (after the frontend's embeddings), then two decode
    steps, each step's logits and the recurrent states against the
    reference's."""
    ref_cfg, ref_params, cfg, params = _models(arch, consistent=True)
    b, s, max_len = 2, 16, 48
    toks, fe = _inputs(cfg, b, s)
    ref_c = ref_lm.init_cache(ref_cfg, b, max_len)
    c = lm.init_cache(cfg, b, max_len, device="cpu")
    want, ref_c = ref_lm.prefill(ref_params, ref_cfg, jnp.asarray(toks), ref_c, _j(fe))
    with torch.inference_mode():
        got, out = lm.prefill(params, cfg, torch.from_numpy(toks), c, _t(fe))
    assert out is c and c["len"] == int(ref_c["len"])
    _close(got.numpy(), want)
    for _ in range(2):
        nxt = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        want, ref_c = ref_lm.decode_step(ref_params, ref_cfg, ref_c, jnp.asarray(nxt))
        with torch.inference_mode():
            got, c = lm.decode_step(params, cfg, c, torch.from_numpy(nxt))
        assert tuple(got.shape) == (b, 1, cfg.vocab)
        _close(got.numpy(), want)
    # every cache leaf (KV, latent, recurrent state) holds the reference's values
    ref_leaves = jax.tree_util.tree_leaves_with_path({"prefix": ref_c["prefix"], "groups": ref_c["groups"]})
    got_leaves = jax.tree_util.tree_leaves({"prefix": c["prefix"], "groups": c["groups"]})
    assert len(got_leaves) == len(ref_leaves)
    for (path, w), g in zip(ref_leaves, got_leaves):
        assert tuple(g.shape) == w.shape, path
        _close(g.float().numpy(), np.asarray(w.astype(jnp.float32)), dict(rtol=1e-3, atol=1e-4))


@pytest.mark.parametrize("arch", NOT_DENSE)
def test_init_lm_and_init_cache_have_the_reference_layout(arch):
    """Same trees, shapes and dtypes as the reference's ``init_lm`` and
    ``init_cache`` (prefix layers, stacked groups, the state caches)."""
    ref_cfg, cfg = ref_get_smoke_config(arch), get_smoke_config(arch)
    for got, want in (
        (lm.init_lm(0, cfg, device="cpu"), ref_lm.init_lm(jax.random.key(0), ref_cfg)),
        (lm.init_cache(cfg, 2, 12, device="cpu"), ref_lm.init_cache(ref_cfg, 2, 12)),
    ):
        got = {k: v for k, v in got.items() if k != "len"}
        want = {k: v for k, v in want.items() if k != "len"}
        assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == jax.tree.structure(
            jax.tree.map(lambda a: 0, want)
        )
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert tuple(g.shape) == w.shape and str(g.dtype).removeprefix("torch.") == str(w.dtype)


def test_layer_kinds_follow_the_pattern_and_the_moe_layout():
    jamba = get_smoke_config("jamba_v0_1_52b")
    kinds = lm.layer_kinds(jamba)
    assert [k for k, _ in kinds] == list(jamba.pattern) and [m for _, m in kinds] == [False, True] * 4
    deepseek = get_smoke_config("deepseek_v2_236b")
    assert lm.layer_kinds(deepseek) == [("attn", False), ("attn", True), ("attn", True)]
    assert lm.layer_kinds(get_smoke_config("xlstm_125m")) == [("mlstm", False), ("slstm", False)] * 2
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        assert [moe_ for _, moe_ in lm.layer_kinds(cfg)] == [cfg.is_moe_layer(i) for i in range(cfg.n_layers)]


def test_frontend_embeddings_are_prepended():
    """A frontend arch's logits at the text positions depend on the
    prepended embeddings; a config without a frontend ignores them, as the
    reference's does."""
    _, _, cfg, params = _models("paligemma_3b")
    toks, fe = _inputs(cfg, 1, 6)
    with torch.inference_mode():
        text_only, _ = lm.forward(params, cfg, torch.from_numpy(toks))
        with_fe, _ = lm.forward(params, cfg, torch.from_numpy(toks), torch.from_numpy(fe))
    assert tuple(with_fe.shape) == (1, cfg.n_frontend_tokens + 6, cfg.vocab)
    assert not torch.allclose(with_fe[:, cfg.n_frontend_tokens :], text_only)
    _, _, dense_cfg, dense_params = _models("yi_34b")
    t = torch.from_numpy(toks % dense_cfg.vocab)
    with torch.inference_mode():
        a, _ = lm.forward(dense_params, dense_cfg, t)
        b, _ = lm.forward(dense_params, dense_cfg, t, torch.zeros((1, 3, dense_cfg.d_model)))
    assert torch.equal(a, b)


# -- MoE -----------------------------------------------------------------------


def _ref_routing(params, cfg, x):
    """The reference's routing and GShard slot bookkeeping (``moe_ffn``'s
    own lines, G = 1): expert ids [T, k], slot positions and kept pairs
    [T*k], and the slot -> token + 1 map [E, C]."""
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    xt = x.reshape(t, -1)
    probs = jax.nn.softmax(ref_layers.dense(params["router"], xt.astype(jnp.float32)), axis=-1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    cap = int(max(-(-t * m.top_k * m.capacity_factor // m.n_experts), min(t, 16)))
    flat = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat, m.n_experts, dtype=jnp.int32)
    pos = ((jnp.cumsum(onehot, axis=0) - onehot) * onehot).sum(-1)
    keep = pos < cap
    safe = jnp.where(keep, pos, cap - 1)
    token_of = jnp.tile(jnp.arange(t)[:, None], (1, m.top_k)).reshape(-1)
    slots = jnp.zeros((m.n_experts, cap), jnp.int32).at[flat, safe].max(jnp.where(keep, token_of + 1, 0))
    return idx, safe, keep, slots, cap


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "deepseek_v2_236b", "jamba_v0_1_52b"])
def test_moe_ffn_with_drops_matches_the_reference(arch):
    """capacity_factor 1.0 on 4 x 64 tokens: some (token, choice) pairs
    are dropped; the port drops the same ones into the same slots, and
    its output and aux loss equal the reference's (shared experts too, for
    deepseek)."""
    ref_cfg = ref_get_smoke_config(arch)
    ref_cfg = ref_cfg.with_(moe=dataclasses.replace(ref_cfg.moe, capacity_factor=1.0))
    cfg = get_smoke_config(arch).with_(moe=dataclasses.replace(get_smoke_config(arch).moe, capacity_factor=1.0))
    ref_p = ref_moe.init_moe(jax.random.key(3), ref_cfg)
    p = _block_params(ref_p)
    x = np.random.default_rng(4).normal(size=(4, 64, cfg.d_model)).astype(np.float32)

    idx, safe, keep, slots, cap = _ref_routing(ref_p, ref_cfg, jnp.asarray(x))
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, got_idx, _ = moe.route(p, cfg, xt)
    assert moe.capacity(cfg.moe, xt.shape[0]) == cap
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    got_safe, got_keep, got_slots = moe.dispatch(got_idx, cfg.moe.n_experts, cap)
    np.testing.assert_array_equal(got_keep.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(got_safe.numpy(), np.asarray(safe))
    np.testing.assert_array_equal(got_slots.numpy(), np.asarray(slots))
    assert 0 < int((~got_keep).sum()) < got_keep.numel() // 2  # drops happen, within bounds

    want, want_aux = ref_moe.moe_ffn(ref_p, ref_cfg, jnp.asarray(x))
    got, aux = moe.moe_ffn(p, cfg, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got.numpy(), want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-7)
    # a token whose every choice was dropped gets no routed output
    dropped_all = (~got_keep).reshape(-1, cfg.moe.top_k).all(-1)
    if cfg.moe.n_shared_experts == 0 and dropped_all.any():
        assert float(got.reshape(-1, cfg.d_model)[dropped_all].abs().max()) == 0.0


def test_moe_capacity_floor_keeps_small_batches():
    """min(T, 16) slots: a decode batch of 8 tokens never drops."""
    m = get_smoke_config("mixtral_8x7b").moe
    assert moe.capacity(m, 8) == 8
    assert moe.capacity(m, 256) == int(np.ceil(256 * m.top_k * m.capacity_factor / m.n_experts))
    idx = torch.zeros((8, m.top_k), dtype=torch.int64)  # every choice on expert 0
    idx[:, 1] = 1
    _, keep, slots = moe.dispatch(idx, m.n_experts, moe.capacity(m, 8))
    assert bool(keep.all()) and slots[0].tolist() == list(range(1, 9))


# -- Mamba ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba():
    ref_cfg, cfg = ref_get_smoke_config("jamba_v0_1_52b"), get_smoke_config("jamba_v0_1_52b")
    ref_p = ref_ssm.init_mamba(jax.random.key(5), ref_cfg)
    x = np.random.default_rng(6).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    return ref_cfg, ref_p, cfg, _block_params(ref_p), x


def test_mamba_block_chunked_and_unchunked_match_the_reference(mamba):
    ref_cfg, ref_p, cfg, p, x = mamba
    want, want_st = ref_ssm.mamba_block(ref_p, ref_cfg, jnp.asarray(x))
    y1, st1 = ssm.mamba_block(p, cfg, torch.from_numpy(x))  # chunk 16: two chunks
    cfg2 = cfg.with_(mamba=dataclasses.replace(cfg.mamba, chunk=32))
    y2, st2 = ssm.mamba_block(p, cfg2, torch.from_numpy(x))  # one chunk
    for y, st in ((y1, st1), (y2, st2)):
        _close(y.numpy(), want)
        _close(st.h.numpy(), want_st.h)
        np.testing.assert_array_equal(st.conv.numpy(), np.asarray(want_st.conv))


def test_mamba_decode_matches_the_block_and_the_reference(mamba):
    ref_cfg, ref_p, cfg, p, x = mamba
    x = x[:1, :8]
    y_full, _ = ssm.mamba_block(p, cfg, torch.from_numpy(x))
    st, ref_st, ys = None, None, []
    for t in range(8):
        xt = x[:, t : t + 1]
        if st is None:
            y_t, st = ssm.mamba_block(p, cfg, torch.from_numpy(xt))
            _, ref_st = ref_ssm.mamba_block(ref_p, ref_cfg, jnp.asarray(xt))
        else:
            y_t, st = ssm.mamba_decode_step(p, cfg, torch.from_numpy(xt), st)
            want, ref_st = ref_ssm.mamba_decode_step(ref_p, ref_cfg, jnp.asarray(xt), ref_st)
            _close(y_t.numpy(), want)
        ys.append(y_t)
    _close(torch.cat(ys, 1).numpy(), y_full.numpy())
    _close(st.h.numpy(), ref_st.h)


def test_mamba_scan_and_conv_match_the_reference():
    rng = np.random.default_rng(7)
    for c in (1, 3, 16, 128):
        d_a = rng.uniform(0.5, 1.0, (2, c, 3, 4)).astype(np.float32)
        d_bu = rng.normal(size=(2, c, 3, 4)).astype(np.float32)
        h0 = rng.normal(size=(2, 3, 4)).astype(np.float32)
        want = ref_ssm._scan_chunk(jnp.asarray(h0), jnp.asarray(d_a), jnp.asarray(d_bu))
        got = scan._scan_chunk(torch.from_numpy(h0), torch.from_numpy(d_a), torch.from_numpy(d_bu))
        for g, w in zip(got, want):
            _close(g.numpy(), w, dict(rtol=1e-6, atol=1e-6))
    x = rng.normal(size=(2, 5, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    state = rng.normal(size=(2, 3, 6)).astype(np.float32)
    for st in (None, state):
        want = ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), _j(st))
        got = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), _t(st))
        for g, wt in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wt))  # the same order of sums


# -- xLSTM ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def xl():
    ref_cfg, cfg = ref_get_smoke_config("xlstm_125m"), get_smoke_config("xlstm_125m")
    x = np.random.default_rng(8).normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, x


def test_mlstm_parallel_and_chunked_match_the_reference(xl):
    ref_cfg, cfg, x = xl
    ref_p = ref_xlstm.init_mlstm(jax.random.key(9), ref_cfg)
    p = _block_params(ref_p)
    want = ref_xlstm.mlstm_parallel(ref_p, ref_cfg, jnp.asarray(x))
    par = xlstm.mlstm_parallel(p, cfg, torch.from_numpy(x))
    chunked = xlstm.mlstm_block(p, cfg, torch.from_numpy(x), chunk=16)  # 4 chunks, carried state
    _close(par.numpy(), want)
    _close(chunked.numpy(), par.numpy())
    _close(chunked.numpy(), ref_xlstm.mlstm_block(ref_p, ref_cfg, jnp.asarray(x), chunk=16))


def test_mlstm_prefill_and_decode_match_the_reference(xl):
    ref_cfg, cfg, x = xl
    ref_p = ref_xlstm.init_mlstm(jax.random.key(9), ref_cfg)
    p = _block_params(ref_p)
    ref_st = ref_xlstm.init_mlstm_state(ref_cfg, 2)
    st = xlstm.init_mlstm_state(cfg, 2)
    want, ref_st = ref_xlstm.mlstm_prefill(ref_p, ref_cfg, jnp.asarray(x[:, :32]), ref_st, chunk=16)
    got, st = xlstm.mlstm_prefill(p, cfg, torch.from_numpy(x[:, :32]), st, chunk=16)
    _close(got.numpy(), want)
    for t in range(32, 35):
        want, ref_st = ref_xlstm.mlstm_decode_step(ref_p, ref_cfg, jnp.asarray(x[:, t : t + 1]), ref_st)
        got, st = xlstm.mlstm_decode_step(p, cfg, torch.from_numpy(x[:, t : t + 1]), st)
        _close(got.numpy(), want)
        for g, w in zip(st, ref_st):
            _close(g.numpy(), w, dict(rtol=1e-4, atol=1e-5))
    # decoding token by token equals the parallel form over the whole prefix
    whole = xlstm.mlstm_parallel(p, cfg, torch.from_numpy(x[:, :35]))
    _close(got.numpy(), whole[:, -1:].numpy())


def test_slstm_block_and_decode_match_the_reference(xl):
    ref_cfg, cfg, x = xl
    ref_p = ref_xlstm.init_slstm(jax.random.key(10), ref_cfg)
    p = _block_params(ref_p)
    p["b"] = torch.from_numpy(np.random.default_rng(11).normal(size=p["b"].shape).astype(np.float32))
    ref_p = {**ref_p, "b": jnp.asarray(p["b"].numpy())}
    want, ref_st = ref_xlstm.slstm_block(ref_p, ref_cfg, jnp.asarray(x[:, :16]))
    got, st = xlstm.slstm_block(p, cfg, torch.from_numpy(x[:, :16]))
    _close(got.numpy(), want)
    for g, w in zip(st, ref_st):
        _close(g.numpy(), w)
    want, ref_st = ref_xlstm.slstm_decode_step(ref_p, ref_cfg, jnp.asarray(x[:, 16:17]), ref_st)
    got, st = xlstm.slstm_decode_step(p, cfg, torch.from_numpy(x[:, 16:17]), st)
    _close(got.numpy(), want)


# -- MLA -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def mla():
    ref_cfg = ref_get_smoke_config("deepseek_v2_236b").with_(kv_cache_dtype="float32")
    cfg = get_smoke_config("deepseek_v2_236b").with_(kv_cache_dtype="float32")
    ref_p = ref_attention.init_attention(jax.random.key(1), ref_cfg)
    x = np.random.default_rng(4).normal(size=(2, 17, cfg.d_model)).astype(np.float32)
    return ref_cfg, ref_p, cfg, _block_params(ref_p), x


def test_mla_projection_matches_the_reference(mla):
    ref_cfg, ref_p, cfg, p, x = mla
    pos = np.arange(17)
    want = ref_attention.qkv_project(ref_p, ref_cfg, jnp.asarray(x), jnp.asarray(pos))
    got = attention.qkv_project(p, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    for g, w in zip(got[:3], want[:3]):
        _close(g.numpy(), w)
    for g, w in zip(got[3], want[3]):  # (latent, k_rope)
        _close(g.numpy(), w)
    dh, dr = cfg.head_dim_, cfg.qk_rope_dim
    assert tuple(got[0].shape) == (2, cfg.n_heads, 17, dh + dr) and tuple(got[2].shape)[-1] == dh


def test_mla_decode_matches_the_reference_and_the_materialized_form(mla):
    """The absorbed decode (in latent space) against the reference's, and
    against blockwise attention over the materialized K/V at the last
    position (the reference's own test, at its tolerance: the cache
    rounds k_rope to bf16)."""
    ref_cfg, ref_p, cfg, p, x = mla
    s = 17
    q, k, v, payload = attention.qkv_project(p, cfg, torch.from_numpy(x), torch.arange(s))
    c = cache.make_attn_cache(cfg, 2, 48, device="cpu")
    cache.write_attn_cache(cfg, c, None, None, payload, 0)
    dh = cfg.head_dim_
    q1 = q[:, :, -1:]
    got = attention.mla_decode_attention(p, cfg, q1[..., :dh], q1[..., dh:], c["latent"], c["k_rope"], s)
    ref_c = ref_cache.write_attn_cache(
        ref_cfg, ref_cache.make_attn_cache(ref_cfg, 2, 48), None, None,
        tuple(jnp.asarray(t.numpy()) for t in payload), 0,
    )
    qj = jnp.asarray(q1.numpy())
    want = ref_attention.mla_decode_attention(
        ref_p, ref_cfg, qj[..., :dh], qj[..., dh:], ref_c["latent"], ref_c["k_rope"], jnp.array(s)
    )
    _close(got.numpy(), want)
    dense = attention.blockwise_attention(q, k, v, causal=True, chunk_q=32, chunk_kv=32)
    _close(got.numpy(), dense[:, :, -1:].numpy(), dict(rtol=1e-2, atol=1e-2))


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_mla_cache_write_and_read_match_the_reference(kv_dtype):
    """The latent follows ``kv_cache_dtype`` (bf16 for int8: never
    quantized) and ``k_rope`` is always bf16, as in the reference."""
    cfg = get_smoke_config("deepseek_v2_236b").with_(kv_cache_dtype=kv_dtype)
    ref_cfg = ref_get_smoke_config("deepseek_v2_236b").with_(kv_cache_dtype=kv_dtype)
    c = cache.make_attn_cache(cfg, 2, 12, device="cpu")
    ref_c = ref_cache.make_attn_cache(ref_cfg, 2, 12)
    assert sorted(c) == sorted(ref_c) == ["k_rope", "latent"]
    assert c["k_rope"].dtype == torch.bfloat16
    assert c["latent"].dtype == (torch.bfloat16 if kv_dtype == "int8" else getattr(torch, kv_dtype))
    for name in c:
        assert tuple(c[name].shape) == ref_c[name].shape
        assert str(c[name].dtype).removeprefix("torch.") == str(ref_c[name].dtype)
    rng = np.random.default_rng(5)
    for pos, s in ((0, 5), (5, 1), (6, 6)):
        latent = rng.normal(size=(2, s, cfg.kv_lora_rank)).astype(np.float32)
        k_rope = rng.normal(size=(2, s, cfg.qk_rope_dim)).astype(np.float32)
        ref_c = ref_cache.write_attn_cache(ref_cfg, ref_c, None, None, (jnp.asarray(latent), jnp.asarray(k_rope)), pos)
        assert cache.write_attn_cache(cfg, c, None, None, (torch.from_numpy(latent), torch.from_numpy(k_rope)), pos) is c
    got = cache.read_attn_cache(cfg, c)
    want = ref_cache.read_attn_cache(ref_cfg, ref_c)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
    with pytest.raises(ValueError, match="overflows the 12-row cache"):
        cache.write_attn_cache(cfg, c, None, None, (torch.zeros(2, 1, cfg.kv_lora_rank),
                                                    torch.zeros(2, 1, cfg.qk_rope_dim)), 12)


# -- the scheduled-kernel policy over every block kind ---------------------------

#: (arch, scheduled GEMMs per call at batch 8 and 8 tokens: m = 64 in the
#: layers, m = 8 at a prefill's head and in a decode step)
ROUTED = {
    # 7 Mamba x (in, x, dt, out) + 1 attention x (q, k, v, o) + 4 dense
    # MLPs x 3 + 4 MoE routers (f32) + the head
    "jamba_v0_1_52b": 7 * 4 + 4 + 4 * 3 + 4 + 1,
    # 2 mLSTM x (up, q, k, v, i, f, o gates, down) + 2 sLSTM out + the head
    "xlstm_125m": 2 * 8 + 2 + 1,
    # MLA x (q, kv_down, k_up, v_up, o) per layer, the first-dense MLP x 3,
    # 2 MoE layers x (router + 3 shared-expert GEMMs), the head
    "deepseek_v2_236b": 3 * 5 + 3 + 2 * 4 + 1,
}
#: products the decode step does not make: MLA's k_up and v_up, whose k
#: and v the absorbed decode never reads
DECODE_UNMADE = {"deepseek_v2_236b": 3 * 2}


@pytest.mark.parametrize("arch", sorted(ROUTED))
def test_policy_routes_every_block_kind_like_the_plain_run(arch, monkeypatch):
    """Under ``scheduled_kernels`` each dense of m >= 8 goes through
    ``ops.scheduled_gemm`` (counted by a spy; the router's in f32, the
    rest in the model's dtype), and the routed forward, prefill and decode
    step give the plain run's logits."""
    calls = []
    real = ops.scheduled_gemm

    def spy(x, w, cfg, bias=None):
        calls.append((x.shape[0], x.shape[1], w.shape[1], x.dtype))
        return real(x, w, cfg, bias)

    monkeypatch.setattr(ops, "scheduled_gemm", spy)
    _, _, cfg, params = _models(arch, consistent=True)
    toks = torch.from_numpy(_inputs(cfg, 8, 8)[0])
    backend = build_backend(make_gemmini_description())
    with torch.inference_mode():
        plain = [lm.forward(params, cfg, toks)[0]]
        c = lm.init_cache(cfg, 8, 12, device="cpu")
        plain.append(lm.prefill(params, cfg, toks, c)[0])
        plain.append(lm.decode_step(params, cfg, c, toks[:, :1])[0])
        assert not calls
        routed, counts = [], []
        with policy.scheduled_kernels(backend):
            routed.append(lm.forward(params, cfg, toks)[0])
            counts.append(len(calls))
            c = lm.init_cache(cfg, 8, 12, device="cpu")
            routed.append(lm.prefill(params, cfg, toks, c)[0])
            counts.append(len(calls) - sum(counts))
            routed.append(lm.decode_step(params, cfg, c, toks[:, :1])[0])
            counts.append(len(calls) - sum(counts))
    assert counts == [ROUTED[arch]] * 2 + [ROUTED[arch] - DECODE_UNMADE.get(arch, 0)]
    assert all(dt == torch.float32 for *_, dt in calls)
    routers = [c for c in calls if c[2] == cfg.moe.n_experts] if cfg.moe else []
    assert len(routers) == 3 * sum(m for _, m in lm.layer_kinds(cfg))
    for g, w in zip(routed, plain):
        _close(g.numpy(), w.numpy())
