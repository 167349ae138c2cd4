"""The LM prefill's fused attention (``repro_torch.kernels.attention``):
the rule that admits a call to the kernel, the choice the prefill makes
from its configuration, and the plain version the wrapper takes off the
card.

On the CPU: the rule for every registry configuration with attention
layers, the prefill's choice of design, and the wrapper returning
``blockwise_attention``'s result bit for bit.  Tests marked ``cuda``
hold the kernel to the dense float32 oracle on the card, its walk over
KV tiles included (each causal or windowed case at ragged lengths):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_prefill_attention.py
"""

import math

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import attention as KA
from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import attention as A
from repro_torch.models import lm

# ---------------------------------------------------------------------------
# the admit rule
# ---------------------------------------------------------------------------

#: every registry configuration with attention layers: None where the
#: kernel takes its prefill attention, else words of the refusal
REGISTRY = {
    "codeqwen1_5_7b": None,
    "jamba_v0_1_52b": None,
    "mixtral_8x7b": None,
    "qwen1_5_32b": None,
    "yi_34b": None,
    "granite_34b": None,  # MQA: one KV head
    "paligemma_3b": "head dim 256",
    "musicgen_medium": None,  # head dim 64
    "deepseek_v2_236b": None,  # MLA: q and k 128 + 64, v 128
}


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_the_rule_for_every_registry_configuration(arch):
    cfg = get_config(arch)
    assert "attn" in cfg.pattern
    refusal = A.prefill_kernel_refusal(cfg)
    want = REGISTRY[arch]
    assert (refusal is None) if want is None else (want in refusal), refusal


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if "attn" in get_smoke_config(a).pattern])
def test_the_smoke_configurations_stay_on_the_plain_version(arch):
    """The smoke configurations compute in float32: the card's served
    smoke runs (``chip_smoke.py``) take the plain version, by the rule."""
    assert "torch.float32" in A.prefill_kernel_refusal(get_smoke_config(arch))


def _bf16(*shape, requires_grad=False):
    return torch.zeros(shape, dtype=torch.bfloat16, requires_grad=requires_grad)


@pytest.mark.parametrize(
    "make, reason",
    [
        (lambda: (_bf16(2, 8, 256, 128), _bf16(2, 2, 256, 128), _bf16(2, 2, 256, 128)), "on cpu"),
        (lambda: (torch.zeros(2, 8, 256, 128), torch.zeros(2, 2, 256, 128), torch.zeros(2, 2, 256, 128)),
         "torch.float32"),
        (lambda: (_bf16(2, 8, 256, 128, requires_grad=True), _bf16(2, 2, 256, 128), _bf16(2, 2, 256, 128)),
         "requires grad"),
        (lambda: (_bf16(2, 8, 256, 192), _bf16(2, 8, 256, 192), _bf16(2, 8, 256, 64)), "head dims differ"),
        (lambda: (_bf16(2, 8, 256, 96), _bf16(2, 2, 256, 96), _bf16(2, 2, 256, 96)), "head dim 96"),
        (lambda: (_bf16(2, 8, 1, 128), _bf16(2, 2, 257, 128), _bf16(2, 2, 257, 128)), "position 0"),
        (lambda: (_bf16(2, 6, 256, 64), _bf16(2, 4, 256, 64), _bf16(2, 4, 256, 64)), "6 query heads over 4"),
        (lambda: (_bf16(2, 8, 256, 64), _bf16(2, 2, 256, 64), torch.zeros(2, 2, 256, 64)), "dtypes differ"),
    ],
)
def test_refusals_name_their_reason(make, reason):
    q, k, v = make()
    got = KA.attention_refusal(q, k, v)
    assert got is not None and reason in got, got


@pytest.mark.parametrize(
    "shape, strides, want",
    [
        ((2, 8, 100, 128), None, (8 * 100 * 128, 100 * 128, 128)),  # contiguous
        ((2, 8, 100, 128), "bshd", (100 * 8 * 128, 128, 8 * 128)),  # the heads split off [B, S, H * D]
        ((1, 1, 100, 64), "bshd", (100 * 64, 100 * 64, 64)),  # a dim of one takes the packed stride
        ((2, 8, 100, 128), "sliced", None),  # the head dim not contiguous
    ],
)
def test_tma_strides(shape, strides, want):
    b, h, s, d = shape
    if strides is None:
        t = _bf16(*shape)
    elif strides == "bshd":
        t = _bf16(b, s, h, d).permute(0, 2, 1, 3)
    else:
        t = _bf16(b, h, s, 2 * d)[..., ::2]
    assert KA.tma_strides(t) == want


# ---------------------------------------------------------------------------
# the wrapper on the CPU
# ---------------------------------------------------------------------------


def _qkv(b, h, hkv, s, d, dtype, seed=0, device="cpu", scale=1.0):
    """q, k, v as the LM's projections give them: heads split off a
    [B, S, H * D] product (``models.attention._split_heads``)."""
    gen = torch.Generator().manual_seed(seed)

    def heads(n):
        x = torch.randn(b, s, n * d, generator=gen) * scale
        return x.to(dtype).to(device).reshape(b, s, n, d).permute(0, 2, 1, 3)

    return heads(h), heads(hkv), heads(hkv)


def _spy_plain(monkeypatch) -> list:
    """Record each call of the plain version and the tensor it returned."""
    calls, real = [], KA.blockwise_attention

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    monkeypatch.setattr(KA, "blockwise_attention", spy)
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [0, 48])
def test_cpu_takes_the_plain_version_bit_for_bit(dtype, window, monkeypatch):
    """The wrapper returns the plain version's own result, from the same
    tensors and chunks (two bf16 CPU calls need not give the same bits:
    the result is held to the call the wrapper made)."""
    q, k, v = _qkv(2, 8, 2, 96, 64, dtype)
    calls = _spy_plain(monkeypatch)
    build.reset_launches()
    with tracing.recording() as rec:
        got = KA.prefill_attention(q, k, v, window=window, chunk_q=32, chunk_kv=32)
    [(args, kwargs, out)] = calls
    assert got is out and got.dtype == dtype
    assert all(a is b for a, b in zip(args, (q, k, v), strict=True))
    assert kwargs == {"causal": True, "window": window, "chunk_q": 32, "chunk_kv": 32}
    assert rec.counters == {"attn.plain_calls": 1}
    assert KA.LAUNCHES["prefill_attention"] == 0


def test_meta_tensors_take_the_plain_version(monkeypatch):
    """The dry run's meta tensors (``launch/dryrun.py``) keep the plain
    version's shapes and ops."""
    q, k, v = (torch.empty(2, h, 256, 128, dtype=torch.bfloat16, device="meta") for h in (8, 2, 2))
    calls = _spy_plain(monkeypatch)
    with tracing.recording() as rec:
        got = KA.prefill_attention(q, k, v)
    assert len(calls) == 1 and got.is_meta and got.shape == q.shape
    assert rec.counters == {"attn.plain_calls": 1}


#: (arch, changes to its smoke configuration, design the prefill picks)
CHOICES = [
    ("codeqwen1_5_7b", {"compute_dtype": "bfloat16", "head_dim": 64}, "kernel"),
    ("mixtral_8x7b", {"compute_dtype": "bfloat16", "head_dim": 128}, "kernel"),  # its sliding window
    ("codeqwen1_5_7b", {}, "plain"),  # float32
    ("deepseek_v2_236b", {"compute_dtype": "bfloat16", "head_dim": 64}, "plain"),  # MLA: v 64, q and k 96
    ("paligemma_3b", {"compute_dtype": "bfloat16", "head_dim": 256}, "plain"),
]


@pytest.mark.parametrize("arch, changes, design", CHOICES, ids=[f"{a}-{d}" for a, _, d in CHOICES])
def test_the_prefill_chooses_the_design_from_its_configuration(arch, changes, design, monkeypatch):
    """``lm.prefill`` calls the kernel's wrapper for every attention layer
    of a configuration the rule takes, with its window, and the plain
    version itself for the rest; on the CPU both run the plain version
    and count it, one a layer."""
    cfg = get_smoke_config(arch).with_(**changes)
    assert (A.prefill_kernel_refusal(cfg) is None) == (design == "kernel")
    seen, real = [], KA.prefill_attention

    def spy(q, k, v, **kwargs):
        seen.append(kwargs["window"])
        return real(q, k, v, **kwargs)

    monkeypatch.setattr(KA, "prefill_attention", spy)
    params = lm.init_lm(0, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(0))
    frontend = torch.zeros(2, cfg.n_frontend_tokens, cfg.d_model) if cfg.frontend else None
    cache = lm.init_cache(cfg, 2, 24 + cfg.n_frontend_tokens, device="cpu")
    with torch.inference_mode(), tracing.recording() as rec:
        lm.prefill(params, cfg, tokens, cache, frontend)
    layers = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    window = cfg.window if cfg.attn_kind == "swa" else 0
    assert seen == ([window] * layers if design == "kernel" else [])
    assert rec.counters.get("attn.plain_calls") == layers and "attn.kernel_calls" not in rec.counters


def test_models_attention_keeps_the_plain_version():
    assert A.blockwise_attention is KA.blockwise_attention
    assert A._pick_chunk(4093, 512) == 1  # the prime-length fault lives on the plain path


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the prefill attention kernel runs only there")
    return torch.device("cuda", 0)


def _oracle(q, k, v, window):
    return flash_attention_ref(q.float(), k.float(), v.float(), causal=True, window=window or None)


def _widest(got, want) -> float:
    return (got.float() - want).abs().max().item()


#: (name, batch, heads, KV heads, S, head dim, window): codeqwen's and
#: jamba's layouts (GQA 8 and 4), MQA, mixtral's window, a small window at
#: a ragged length, head dim 64 (musicgen)
CARD_CASES = [
    ("codeqwen", 2, 32, 4, 1024, 128, 0),
    ("jamba", 2, 32, 8, 1024, 128, 0),
    ("mqa", 2, 16, 1, 640, 128, 0),
    ("mixtral window", 1, 8, 2, 4608, 128, 4096),
    ("window 300 ragged", 2, 8, 2, 1000, 128, 300),
    ("head dim 64", 2, 24, 24, 1024, 64, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_kernel_is_no_further_from_the_oracle_than_the_plain_version(card, case):
    _, b, h, hkv, s, d, window = case
    q, k, v = _qkv(b, h, hkv, s, d, torch.bfloat16, seed=s + h, device=card, scale=1.5)
    assert KA.attention_refusal(q, k, v) is None
    got = KA.prefill_attention(q, k, v, window=window)
    plain = A.blockwise_attention(q, k, v, causal=True, window=window)
    want = _oracle(q, k, v, window)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _widest(got, want) <= _widest(plain, want), (_widest(got, want), _widest(plain, want))


@pytest.mark.cuda
def test_kernel_at_a_prime_length(card):
    """S 4093: the plain version would run 4093^2 one-position pairs; the
    kernel masks its ragged last tiles.  Held to the dense oracle, as close
    as the plain version comes at 4096."""
    q, k, v = _qkv(1, 8, 2, 4093, 128, torch.bfloat16, seed=7, device=card, scale=1.5)
    got = KA.prefill_attention(q, k, v)
    q4, k4, v4 = _qkv(1, 8, 2, 4096, 128, torch.bfloat16, seed=7, device=card, scale=1.5)
    plain = _widest(A.blockwise_attention(q4, k4, v4, causal=True), _oracle(q4, k4, v4, 0))
    assert _widest(got, _oracle(q, k, v, 0)) <= plain
    assert torch.isfinite(got.float()).all()


@pytest.mark.cuda
def test_two_launches_are_bit_identical_and_counted(card):
    q, k, v = _qkv(2, 32, 4, 1000, 128, torch.bfloat16, seed=1, device=card)
    build.reset_launches()
    with tracing.recording() as rec:
        first = KA.prefill_attention(q, k, v)
        second = KA.prefill_attention(q, k, v)
    assert torch.equal(first, second)
    assert KA.LAUNCHES["prefill_attention"] == 2 and rec.counters == {"attn.kernel_calls": 2}
    # [B, H, S, D] laid out as [B, S, H, D]: merging the heads is a view
    assert first.permute(0, 2, 1, 3).is_contiguous()


@pytest.mark.cuda
def test_contiguous_and_split_heads_give_the_same_bits(card):
    q, k, v = _qkv(2, 8, 2, 640, 64, torch.bfloat16, seed=2, device=card)
    assert torch.equal(KA.prefill_attention(q, k, v), KA.prefill_attention(q.contiguous(), k.contiguous(),
                                                                            v.contiguous()))


@pytest.mark.cuda
def test_refused_calls_on_the_card_raise(card, monkeypatch):
    """On CUDA the wrapper launches or raises with the rule's reason: a
    configuration the rule refuses takes the plain version in the
    prefill, never here."""
    q, k, v = _qkv(1, 4, 4, 256, 16, torch.float32, seed=3, device=card)
    calls = _spy_plain(monkeypatch)
    build.reset_launches()
    with tracing.recording() as rec, pytest.raises(ValueError, match="torch.float32"):
        KA.prefill_attention(q, k, v, chunk_q=64, chunk_kv=64)
    assert not calls and KA.LAUNCHES["prefill_attention"] == 0 and rec.counters == {}


def _plain_err(q, k, v, window: int, seed: int) -> float:
    """The plain version's widest distance from the oracle on these draws,
    or, at a length its chunks would cut into one-key pairs, on draws of
    that length rounded up to whole 128-key tiles."""
    s = q.shape[2]
    if s % 128:
        q, k, v = _qkv(1, 4, 1, -(-s // 128) * 128, 64, torch.bfloat16, seed=seed, device=q.device, scale=1.5)
    return _widest(A.blockwise_attention(q, k, v, causal=True, window=window), _oracle(q, k, v, window))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 1, 128, 300, 4096])
@pytest.mark.parametrize("s", [128, 640, 2432, 4096, 4093])
def test_kernel_visits_exactly_the_unmasked_tiles(card, s, window):
    """The KV tiles each q tile visits (the diagonal's down to the window's
    edge, the rest skipped unread) and the keys masked inside them, held
    to the dense oracle at the served lengths and a prime one: a tile
    skipped that holds a live key, or a masked key let through, moves the
    rows it touches far beyond bf16 rounding."""
    q, k, v = _qkv(1, 4, 1, s, 64, torch.bfloat16, seed=s + window, device=card, scale=1.5)
    got = KA.prefill_attention(q, k, v, window=window)
    assert _widest(got, _oracle(q, k, v, window)) <= _plain_err(q, k, v, window, seed=s + window)


# ---------------------------------------------------------------------------
# MLA's expanded prefill on the card: q and k 192 (nope 128 + rope 64), v 128
# ---------------------------------------------------------------------------

#: deepseek-v2's softmax scale: 192^-1/2 x YaRN's mscale(40, 0.707)^2
MLA_SCALE = 192**-0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2


def _mla_qkv(b, h, s, seed, device, scale=1.5):
    """q, k, v as ``models.attention.qkv_project`` gives MLA's: q and k
    made whole by ``torch.cat`` (k's 64 rope dims one head shared by every
    head), v split off the [B, S, H * 128] up-projection."""
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return (torch.randn(*shape, generator=gen) * scale).to(torch.bfloat16).to(device)

    q = torch.cat([draw(b, s, h * 128).reshape(b, s, h, 128).permute(0, 2, 1, 3),
                   draw(b, h, s, 64)], dim=-1)
    k_nope = draw(b, s, h * 128).reshape(b, s, h, 128).permute(0, 2, 1, 3)
    k = torch.cat([k_nope, draw(b, 1, s, 64).expand(b, h, s, 64)], dim=-1)
    v = draw(b, s, h * 128).reshape(b, s, h, 128).permute(0, 2, 1, 3)
    return q, k, v


def _mla_plain_err(s: int, window: int, seed: int, device) -> float:
    """The plain version's widest distance from the oracle at MLA's dims,
    on draws of ``s`` rounded up to whole 128-key tiles (a ragged length
    would cut its chunks into one-key pairs)."""
    q, k, v = _mla_qkv(1, 128, -(-s // 128) * 128, seed, device)
    plain = A.blockwise_attention(q, k, v, causal=True, window=window, scale=MLA_SCALE)
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=True, window=window or None, scale=MLA_SCALE)
    return _widest(plain, want)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 1, 128, 300, 4096])
@pytest.mark.parametrize("s", [128, 640, 2432, 4096, 4093, 1000])
def test_mla_kernel_visits_exactly_the_unmasked_tiles(card, s, window):
    """The (192, 128) instantiation at H 128 with the YaRN scale, held to
    the dense float32 oracle as the (64, 64) one is above, at the served
    lengths, a prime one and a ragged one."""
    q, k, v = _mla_qkv(1, 128, s, s + window, card)
    assert KA.attention_refusal(q, k, v) is None
    got = KA.prefill_attention(q, k, v, window=window, scale=MLA_SCALE)
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=True, window=window or None, scale=MLA_SCALE)
    assert got.shape == (1, 128, s, 128) and got.permute(0, 2, 1, 3).is_contiguous()
    assert _widest(got, want) <= _mla_plain_err(s, window, s + window, card)


@pytest.mark.cuda
def test_mla_kernel_at_the_cells_batch_is_bit_stable(card):
    """B 4 at a ragged length: two launches bit-equal, each batch row
    equal to its own launch (the CTAs of one row read only its K and V)."""
    q, k, v = _mla_qkv(4, 128, 1000, 9, card)
    build.reset_launches()
    first = KA.prefill_attention(q, k, v, scale=MLA_SCALE)
    assert torch.equal(first, KA.prefill_attention(q, k, v, scale=MLA_SCALE)) and KA.LAUNCHES["prefill_attention"] == 2
    assert torch.equal(first[2:3], KA.prefill_attention(q[2:3], k[2:3], v[2:3], scale=MLA_SCALE))
