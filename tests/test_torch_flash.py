"""The port's attention (``repro_torch.models.flash``,
``repro_torch.models.attention``, ``repro_torch.kernels.ref.
flash_attention_ref``) against the reference's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages as
float32.  MHA, GQA (2 query heads per KV head) and MQA, causal and
windowed, with chunk sizes that divide S and that do not (the largest
divisor at most the target is taken).  Both packages sum in float32 in
different orders: outputs within rtol = atol = 1e-5.  A wrong GQA head
order (``Tensor.repeat`` in place of ``repeat_interleave``) is far
outside that.  The chunked forwards meet the reference on a covering set
of cases and the port's dense oracle on the whole grid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_kref
from repro.models import attention as ref_attention
from repro.models import flash as ref_flash
from repro_torch.kernels import ref as kref
from repro_torch.models import attention, flash

TOL = dict(rtol=1e-5, atol=1e-5)
HEADS = {"mha": (4, 4), "gqa": (4, 2), "mqa": (4, 1)}


def _qkv(h, hkv, s, d=16, b=2, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, s, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    return q, k, v


def _both(fn_ref, fn, arrays, **kw):
    want = np.asarray(fn_ref(*(jnp.asarray(a) for a in arrays), **kw))
    got = fn(*(torch.from_numpy(a) for a in arrays), **kw).numpy()
    assert got.shape == want.shape
    return got, want


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ref_matches_the_reference(heads, window, causal):
    got, want = _both(
        ref_kref.flash_attention_ref, kref.flash_attention_ref, _qkv(*HEADS[heads], 12),
        causal=causal, window=window,
    )
    np.testing.assert_allclose(got, want, **TOL)


#: (heads, window, (chunk_q, chunk_kv), skip) over 24 positions: chunks
#: of 8 divide S; targets 5 and 6 fall back to 4 and 6; 24 and 4 mix
FLASH_GRID = [
    (heads, window, chunks, skip)
    for heads in HEADS for window in (0, 7) for chunks in ((8, 8), (5, 6), (24, 4))
    for skip in (False, True)
]
#: the reference's own scans compile per case (about a second each), so
#: it sees a covering subset; the whole grid is held to the dense oracle,
#: which ``test_flash_attention_ref_matches_the_reference`` holds to the
#: reference's
FLASH_VS_REFERENCE = [
    ("mha", 0, (8, 8), False), ("gqa", 7, (5, 6), True), ("mqa", 0, (24, 4), True),
    ("gqa", 7, (8, 8), False), ("mqa", 7, (5, 6), False),
]


def _id(case):
    heads, window, chunks, skip = case
    return f"{heads}-w{window}-c{chunks[0]}x{chunks[1]}{'-skip' if skip else ''}"


@pytest.mark.parametrize("case", FLASH_VS_REFERENCE, ids=_id)
def test_gqa_flash_attention_matches_the_reference(case):
    heads, window, chunks, skip = case
    got, want = _both(
        ref_flash.gqa_flash_attention, flash.gqa_flash_attention, _qkv(*HEADS[heads], 24),
        causal=True, window=window, chunk_q=chunks[0], chunk_kv=chunks[1], skip=skip,
    )
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", FLASH_GRID, ids=_id)
def test_gqa_flash_attention_matches_the_dense_oracle(case):
    heads, window, chunks, skip = case
    q, k, v = (torch.from_numpy(a) for a in _qkv(*HEADS[heads], 24))
    got = flash.gqa_flash_attention(
        q, k, v, causal=True, window=window, chunk_q=chunks[0], chunk_kv=chunks[1], skip=skip
    )
    dense = kref.flash_attention_ref(q, k, v, causal=True, window=window or None)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)


def test_flash_fwd_row_statistics_match_the_reference():
    q, k, v = _qkv(4, 2, 16)
    qg = q.reshape(2, 2, 2, 16, 16)
    want_out, (want_m, want_l) = ref_flash._flash_fwd_impl(
        jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v), True, 0, 8, 4, 0, False
    )
    got_out, (got_m, got_l) = flash._flash_fwd_impl(
        torch.from_numpy(qg), torch.from_numpy(k), torch.from_numpy(v), True, 0, 8, 4, 0, False
    )
    for got, want in ((got_out, want_out), (got_m, want_m), (got_l, want_l)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "args", [(1, 8, 4, 4, True, 0, 0, True), (2, 8, 4, 6, True, 9, 0, True), (0, 4, 4, 6, True, 0, 0, False),
             (3, 4, 8, 4, True, 5, 2, True), (1, 16, 16, 2, False, 7, 0, True)],
)
def test_kv_range_and_chunk_helpers_match_the_reference(args):
    assert flash._kv_range(*args) == ref_flash._kv_range(*args)
    for s, target in ((24, 5), (24, 512), (7, 3), (16, 16)):
        assert flash._div_chunk(s, target) == ref_flash._div_chunk(s, target)
        assert attention._pick_chunk(s, target) == ref_attention._pick_chunk(s, target)


@pytest.mark.parametrize(
    "heads,window,chunks", [("mha", 0, (8, 8)), ("gqa", 6, (5, 7)), ("mqa", 6, (8, 8))],
    ids=["mha", "gqa-window-ragged", "mqa-window"],
)
def test_blockwise_attention_matches_the_reference(heads, window, chunks):
    got, want = _both(
        ref_attention.blockwise_attention, attention.blockwise_attention, _qkv(*HEADS[heads], 24),
        causal=True, window=window, chunk_q=chunks[0], chunk_kv=chunks[1],
    )
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("chunks", [(8, 8), (5, 7), (24, 3)], ids=["divides", "ragged", "mixed"])
def test_blockwise_attention_matches_the_dense_oracle(heads, window, chunks):
    q, k, v = (torch.from_numpy(a) for a in _qkv(*HEADS[heads], 24))
    got = attention.blockwise_attention(
        q, k, v, causal=True, window=window, chunk_q=chunks[0], chunk_kv=chunks[1]
    )
    dense = kref.flash_attention_ref(q, k, v, causal=True, window=window or None)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("window", [0, 6])
def test_causal_block_skip_attention_matches_the_reference(heads, window):
    got, want = _both(
        ref_attention.causal_block_skip_attention, attention.causal_block_skip_attention,
        _qkv(*HEADS[heads], 24), window=window, chunk_q=8, chunk_kv=8,
    )
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_the_reference(heads, window, cache_dtype):
    """One query over a 10-row cache of which 7 rows are valid; a bf16
    cache casts the weights to bf16 for the value product (within one
    bf16 step, 2**-7, of the reference)."""
    h, hkv = HEADS[heads]
    q, k, v = _qkv(h, hkv, 10)
    q = q[:, :, :1]
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[cache_dtype]
    want = ref_attention.decode_attention(
        jnp.asarray(q), jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt), jnp.asarray(7), window=window
    )
    got = attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt), 7, window=window
    )
    tol = TOL if cache_dtype == "float32" else dict(rtol=2**-7, atol=2**-7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_heads_split_and_merge_like_the_reference():
    x = np.random.default_rng(2).normal(size=(2, 5, 12)).astype(np.float32)
    split = attention._split_heads(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(split.numpy(), np.asarray(ref_attention._split_heads(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(attention._merge_heads(split).numpy(), x)
