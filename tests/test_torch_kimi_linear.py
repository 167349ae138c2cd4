"""Kimi-Linear as published on the port's serving path, at a small size on
the CPU with seeded random weights, against the benchmark's plain
reference (``bench/reference/kimi-linear-48b-a3b.ep4.py``): KDA linear
attention beside NoPE MLA in the published, not periodic, layer order;
sigmoid routing with a correction bias, renormalised and scaled; one
chip's share of the experts.

The configuration is built from a configuration file with the published
config.json's keys (``bench/configs/kimi-linear-48b-a3b.ep4.*``) at small
widths: d 64, 4 KDA heads of 16, 4 MLA heads (latent 32, nope / rope / v
16 / 8 / 16), 16 experts top-4 with 4 held, one shared expert, layer 0
dense, and 11 layers with MLA at 1-based 4, 8 and 11: two whole repeats
of Kimi-Linear's period after the dense layer and its irregular tail
(KDA, MLA).  Tests marked ``cuda`` hold the recurrence kernel to the plain
version on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kimi_linear.py
"""

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch import tracing
from repro_torch.kernels import kda as KK
from repro_torch.models import attention as A
from repro_torch.models import kda as K
from repro_torch.models import layers as L
from repro_torch.models import lm, moe
from repro_torch.tree import tree_map

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
NAME = "kimi-linear-48b-a3b.ep4"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))


def _load(kind: str):
    spec = importlib.util.spec_from_file_location(f"test_kimi_{kind}", BENCH / kind / f"{NAME}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CONFIG, REFERENCE = _load("configs"), _load("reference")
PUBLISHED = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())


def small_spec(held: int = 4, first: int = 0, cf: float = 1.25, dtype: str = "float32") -> dict:
    spec = dict(PUBLISHED)
    spec.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4, qk_nope_head_dim=16, v_head_dim=16,
                qk_rope_head_dim=8, kv_lora_rank=32, intermediate_size=96, moe_intermediate_size=32,
                router_experts=16, num_experts=held, first_expert=first, num_experts_per_token=4,
                num_hidden_layers=11, vocab_size=256, capacity_factor=cf, attn_chunk=16, param_dtype=dtype,
                compute_dtype=dtype, kv_cache_dtype=dtype,
                linear_attn_config={"full_attn_layers": [4, 8, 11], "head_dim": 16,
                                    "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10], "num_heads": 4,
                                    "short_conv_kernel_size": 4})
    return spec


def _rel(got, want) -> float:
    return float((got.float() - want).abs().max() / want.abs().max())


def _serve(cfg, params, tokens, new: int, cache=None):
    """The prompt through ``lm.prefill``, then ``new`` greedy tokens through
    ``lm.decode_step``: (logits [B, new + 1, V], the whole sequence, the
    cache)."""
    b, s = tokens.shape
    cache = cache if cache is not None else lm.init_cache(cfg, b, s + new, device="cpu")
    got, seq = [], tokens
    with torch.inference_mode():
        logits, cache = lm.prefill(params, cfg, tokens, cache)
        got.append(logits)
        for _ in range(new):
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            seq = torch.cat([seq, nxt], dim=1)
            logits, cache = lm.decode_step(params, cfg, cache, nxt)
            got.append(logits)
    return torch.cat(got, dim=1), seq, cache


# ---------------------------------------------------------------------------
# the layer order
# ---------------------------------------------------------------------------


def test_layer_kinds_by_index_follow_the_published_lists():
    cfg = CONFIG.model_config(PUBLISHED)
    full = set(PUBLISHED["linear_attn_config"]["full_attn_layers"])
    assert [cfg.layer_kind(i) for i in range(27)] == ["attn" if i + 1 in full else "kda" for i in range(27)]
    kinds = lm.layer_kinds(cfg)
    assert [k for k, _ in kinds] == list(cfg.layer_types)
    assert [m for _, m in kinds] == [False] + [True] * 26  # the dense layer 0, then 26 MoE layers
    # 27 = 1 dense + 6 repeats of (KDA, KDA, MLA, KDA) + a tail of (KDA, MLA)
    assert cfg.pattern == ("kda", "kda", "attn", "kda") and lm.n_scan_groups(cfg) == 6
    assert lm.suffix_kinds(cfg) == [("kda", True), ("attn", True)]
    assert sum(k == "kda" for k, _ in kinds) == 20 and lm.graphs_fit(cfg)
    assert cfg.kda.n_heads == 32 and cfg.kda.head_dim == 128 and cfg.kda.conv_size == 4
    assert not cfg.rope and cfg.q_lora_rank == 0 and A.softmax_scale(cfg) == pytest.approx(192**-0.5, rel=1e-15)


def test_an_order_the_layout_cannot_hold_is_refused():
    cfg = CONFIG.model_config(small_spec())
    swapped = cfg.with_(layer_types=cfg.layer_types[:4] + ("attn", "kda") + cfg.layer_types[6:])
    with pytest.raises(ValueError, match="layer order"):
        lm.layer_kinds(swapped)
    # a configuration without a published order keeps the old rule: whole repeats only
    with pytest.raises(ValueError, match="do not divide"):
        lm.n_scan_groups(cfg.with_(layer_types=()))


def test_the_tree_and_the_cache_hold_the_tail():
    cfg = CONFIG.model_config(small_spec())
    params = lm.init_lm(0, cfg, device="cpu")
    assert lm.n_scan_groups(cfg) == 2 and len(params["suffix"]) == 2
    assert set(params["groups"]) == {"pos0", "pos1", "pos2", "pos3"}
    assert params["groups"]["pos0"]["block"]["A_log"].shape == (2, 4)
    kinds = [kind for _, kind, _ in lm.iter_layers(params, cfg)]
    assert kinds == list(cfg.layer_types)
    cache = lm.init_cache(cfg, 3, 20, device="cpu")
    tail_kda, tail_mla = cache["suffix"]
    assert tail_kda["S"].shape == (3, 4, 16, 16) and tail_kda["S"].dtype == torch.float32
    assert tail_kda["conv_q"].shape == (3, 3, 64)
    assert tail_mla["latent"].shape == (3, 20, 32)
    assert cache["groups"]["pos2"]["latent"].shape == (2, 3, 20, 32)  # MLA beside the stacked KDA states
    assert cache["groups"]["pos0"]["S"].shape == (2, 3, 4, 16, 16)
    # a periodic configuration's trees have no tail
    assert "suffix" not in lm.init_cache(cfg.with_(layer_types=(), n_layers=9), 1, 4, device="cpu")


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def test_the_forward_gives_the_references_logits():
    spec = small_spec()
    cfg = CONFIG.model_config(spec)
    params = CONFIG.make_weights(5, cfg, "cpu")
    tokens = torch.randint(0, cfg.vocab, (3, 40), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        got, _ = lm.forward(params, cfg, tokens)
        ref = REFERENCE.logits(params, spec, tokens, torch.arange(40), [(0, 40)])
    assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("held, first", [(4, 0), (4, 8), (16, 0)])
def test_prefill_then_decode_gives_the_references_logits(held, first):
    """The prompt through ``lm.prefill``, then greedy tokens through
    ``lm.decode_step`` (the KDA states and conv tails, the latent cache),
    against one forward pass of the reference over the whole sequence,
    each engine call a capacity segment; in float32 only summation order
    separates them (about 1e-5 of the largest logit over 11 layers: the
    convolutions' fused multiply-adds and the norms' dot products round
    apart from the reference's; one bf16 rounding anywhere is ~4e-3), and
    the router chooses the reference's experts."""
    spec = small_spec(held, first)
    cfg = CONFIG.model_config(spec)
    params = lm.init_lm(3, cfg, device="cpu")
    b, s, new = 3, 24, 5
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(4))
    got, seq, _ = _serve(cfg, params, tokens, new)
    segments = [(0, s)] + [(s + j, s + j + 1) for j in range(new)]
    routes = REFERENCE.plain.Routes()
    with torch.inference_mode():
        ref = REFERENCE.logits(params, spec, seq, torch.arange(s - 1, s + new), segments, routes=routes)
    assert _rel(got, ref) < 4e-5
    assert len(routes.used) == cfg.n_layers - 1


def test_a_prompt_starts_from_zeros_whatever_the_cache_held():
    """The engine keeps one cache for a graphed model and sets its length to
    0 for each wave: a prompt's KDA layers start from zero states and conv
    tails, not from the last wave's."""
    cfg = CONFIG.model_config(small_spec())
    params = lm.init_lm(3, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(9))
    fresh, _, _ = _serve(cfg, params, tokens, 2)
    _, _, used = _serve(cfg, params, tokens.flip(1), 2)
    used["len"] = 0
    again, _, _ = _serve(cfg, params, tokens, 2, cache=used)
    assert torch.equal(again, fresh)


def test_one_recording_counts_a_kda_call_a_layer_and_its_spans():
    cfg = CONFIG.model_config(small_spec())
    params = lm.init_lm(3, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(2))
    with tracing.recording() as rec:
        _serve(cfg, params, tokens, 2)
    n_kda = sum(k == "kda" for k in cfg.layer_types)
    assert rec.counters["kda.plain_calls"] == 3 * n_kda and "kda.kernel_calls" not in rec.counters
    names = {sp.name for sp in rec.spans}
    assert {"layer.kda", "kda.proj", "kda.core", "kda.out", "layer.attn", "layer.moe", "mla.q"} <= names
    assert sum(sp.name == "kda.core" for sp in rec.spans) == 3 * n_kda


# ---------------------------------------------------------------------------
# KDA's recurrence
# ---------------------------------------------------------------------------


def _kda_inputs(b, t, h, dk, seed, strong=False, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    q = K._l2norm(torch.randn(b, t, h, dk, generator=gen)) * dk**-0.5
    k = K._l2norm(torch.randn(b, t, h, dk, generator=gen))
    v = torch.randn(b, t, h, dk, generator=gen)
    g = -torch.rand(b, t, h, dk, generator=gen) * (30.0 if strong else 0.5)
    beta = torch.rand(b, t, h, generator=gen)
    h0 = 0.3 * torch.randn(b, h, dk, dk, generator=gen)
    return q.to(dtype), k.to(dtype), v.to(dtype), g, beta, h0


def _equations(q, k, v, g, beta, h0):
    """The recurrence written out per batch row, head and position."""
    b, t, h, _ = q.shape
    out = torch.zeros(b, t, h, v.shape[-1])
    final = torch.zeros_like(h0)
    for r in range(b):
        for hh in range(h):
            s = h0[r, hh].clone()
            for i in range(t):
                s = torch.diag(torch.exp(g[r, i, hh])) @ s
                kt = k[r, i, hh].float()
                s = s + beta[r, i, hh] * torch.outer(kt, v[r, i, hh].float() - s.T @ kt)
                out[r, i, hh] = s.T @ q[r, i, hh].float()
            final[r, hh] = s
    return out, final


@pytest.mark.parametrize("strong", [False, True])
def test_the_plain_recurrence_is_the_token_loop_of_the_equations(strong):
    args = _kda_inputs(2, 9, 3, 8, seed=1, strong=strong)
    want, want_s = _equations(*args)
    o, s = KK.kda_recurrent_plain(*args)
    assert torch.allclose(o, want, atol=1e-5) and torch.allclose(s, want_s, atol=1e-5)
    # the wrapper on the CPU, into a given state (here the initial one: in place)
    h0 = args[5].clone()
    with tracing.recording() as rec:
        o2, s2 = KK.kda_recurrent(*args[:5], h0, state=h0)
    assert s2 is h0 and torch.equal(o2, o) and torch.equal(h0, s) and rec.counters == {"kda.plain_calls": 1}
    # from zeros
    o0, _ = KK.kda_recurrent_plain(*args[:5])
    want0, _ = _equations(*args[:5], torch.zeros_like(h0))
    assert torch.allclose(o0, want0, atol=1e-5)


@pytest.mark.parametrize("chunk, t, strong", [(4, 37, False), (8, 37, True), (32, 70, True), (16, 16, False)])
def test_the_references_chunked_form_is_the_token_loop(chunk, t, strong):
    """The reference's chunked rewrite (which the on-card check runs) against
    its own token loop and the port's plain recurrence, at ragged lengths
    and at decays down to e^-30 a position (the form never multiplies an
    exp(c) by an exp(-c))."""
    q, k, v, g, beta, _ = _kda_inputs(2, t, 3, 16, seed=t + chunk, strong=strong)
    loop = REFERENCE.recurrence(q, k, v, g, beta)
    got = REFERENCE.chunked(q, k, v, g, beta, chunk=chunk)
    plain, _ = KK.kda_recurrent_plain(q, k, v, g, beta)
    assert torch.allclose(got, loop, atol=2e-6 * float(loop.abs().max()))
    assert torch.allclose(plain, loop, atol=1e-6)


def test_a_decode_step_continues_the_prompts_recurrence():
    """Prefill of the first positions, then one block call a position from
    the returned state (conv tails included), equals one call over all."""
    cfg = CONFIG.model_config(small_spec())
    p = tree_map(lambda t: t[0], lm.init_lm(1, cfg, device="cpu")["groups"]["pos0"]["block"])
    x = torch.randn(2, 10, cfg.d_model, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        whole, st_whole = K.kda_block(p, cfg, x)
        y, st = K.kda_block(p, cfg, x[:, :6])
        parts = [y]
        for i in range(6, 10):
            y, st = K.kda_block(p, cfg, x[:, i : i + 1], st)
            parts.append(y)
    assert torch.allclose(torch.cat(parts, 1), whole, atol=1e-5)
    for a, b in zip(st, st_whole, strict=True):
        assert torch.allclose(a, b, atol=1e-5)


def test_the_wrapper_refuses_with_its_reason():
    q, k, v, g, beta, h0 = _kda_inputs(1, 3, 2, 8, seed=0)
    with pytest.raises(ValueError, match="g is torch.bfloat16"):
        KK.kda_recurrent(q, k, v, g.bfloat16(), beta)
    with pytest.raises(ValueError, match=r"beta is \(1, 3\)"):
        KK.kda_recurrent(q, k, v, g, beta[..., 0])
    with pytest.raises(ValueError, match="not contiguous"):
        KK.kda_recurrent(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, g, beta)
    assert "bfloat16" in KK.kernel_refusal(q, k, v, g, beta, h0, None)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    assert "K = V in (128,)" in KK.kernel_refusal(qb, kb, vb, g, beta, h0, None)
    big = _kda_inputs(1, 2, 1, 128, seed=0, dtype=torch.bfloat16)
    assert "on cpu" in KK.kernel_refusal(*big, None)


def test_a_kda_state_kept_in_bfloat16_is_not_correct(monkeypatch):
    """The recurrence with its state rounded to bfloat16 after each update
    (the rest of the model in float32), served through the benchmark's timed
    path over prompts of 512-1024 positions and checked against the
    reference at the cell's limits: the rounding piles up along the
    sequence and moves the routers' choices past ``route_gap``'s limit,
    where the float32 state reads 0 (``test_prefill_then_decode_...``)."""
    def bf16_state(q, k, v, g, beta, h0=None, *, state=None):
        f32 = torch.float32
        b, t_len, h, dk = q.shape
        s = torch.zeros(b, h, dk, v.shape[-1]) if h0 is None else h0.to(f32)
        outs = []
        for t in range(t_len):
            s = (s * torch.exp(g[:, t])[..., None]).bfloat16().float()
            u = v[:, t].to(f32) - torch.einsum("bhkv,bhk->bhv", s, k[:, t].to(f32))
            s = (s + beta[:, t, :, None, None] * k[:, t].to(f32)[..., None] * u[:, :, None, :]).bfloat16().float()
            outs.append(torch.einsum("bhkv,bhk->bhv", s, q[:, t].to(f32)))
        if state is not None:
            state.copy_(s)
            s = state
        return torch.stack(outs, 1).to(v.dtype), s

    import harness

    monkeypatch.setattr(KK, "kda_recurrent_plain", bf16_state)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell.load(bench, "kimi-linear-longdoc")
    spec = small_spec(4, 4, dtype="float32")
    traffic = dataclasses.replace(cell.traffic, batch=4, new_tokens=8, median=614, min_len=512, max_len=1024,
                                  multiple=8)
    cell = dataclasses.replace(cell, spec=spec, cfg=CONFIG.model_config(spec), traffic=traffic)
    result = harness.execute(cell, 2**31 + 3, 0.0, False, "cpu", time.perf_counter())
    gap = result["checks"]["route_gap"]
    assert not result["correct"] and gap["value"] > gap["limit"]


# ---------------------------------------------------------------------------
# MLA without positions, the router, the share
# ---------------------------------------------------------------------------


def test_mla_without_rope_does_not_see_where_the_tokens_sit():
    cfg = CONFIG.model_config(small_spec())
    p = tree_map(lambda t: t[0], lm.init_lm(2, cfg, device="cpu")["groups"]["pos2"]["block"])
    x = torch.randn(2, 12, cfg.d_model, generator=torch.Generator().manual_seed(6))
    with torch.inference_mode():
        at0 = A.qkv_project(p, cfg, x, torch.arange(12))
        at500 = A.qkv_project(p, cfg, x, torch.arange(500, 512))
        roped = A.qkv_project(p, cfg.with_(rope=True), x, torch.arange(500, 512))
    for a, b in zip(at0[:3], at500[:3], strict=True):
        assert torch.equal(a, b)
    assert not torch.allclose(roped[0], at500[0])  # with RoPE the same tokens elsewhere differ
    # the decode step's projections: no rotation either
    q, latent, k_rope = A.mla_project(p, cfg, x[:, :1], torch.tensor([7]))
    assert torch.allclose(k_rope, at0[3][1][:, :1], atol=1e-6) and torch.allclose(q, at0[0][:, :, :1], atol=1e-6)


def test_the_router_scores_by_sigmoid_and_chooses_by_the_biased_score():
    """``moe.route`` against the published gate written out: sigmoid scores,
    the top-8 of score + e_score_correction_bias, the unbiased scores of
    those renormalised and times ``routed_scaling_factor``."""
    cfg = CONFIG.model_config(PUBLISHED)
    m = cfg.moe
    gen = torch.Generator().manual_seed(5)
    params = {"router": {"w": 0.03 * torch.randn(cfg.d_model, 256, generator=gen)},
              "score_bias": 0.05 * torch.randn(256, generator=gen)}
    x = torch.randn(64, cfg.d_model, generator=gen)
    w, idx, _ = moe.route(params, cfg, x)
    scores = torch.sigmoid(x @ params["router"]["w"])
    want_idx = torch.topk(scores + params["score_bias"], 8, dim=-1).indices
    want_w = scores.gather(-1, want_idx)
    want_w = want_w / want_w.sum(-1, keepdim=True) * 2.446
    assert torch.equal(idx, want_idx) and torch.allclose(w, want_w, rtol=1e-6)
    assert torch.allclose(w.sum(-1), torch.full((64,), 2.446))
    # the bias moves the choice, not the weights' source
    assert not torch.equal(torch.topk(scores, 8, dim=-1).indices, idx)
    assert m.scoring == "sigmoid" and m.renormalize and m.n_routed_experts == 256 and m.n_experts == 64


def _share_params(full: dict, first: int, held: int) -> dict:
    return {k: (v[first : first + held] if k in ("gate", "up", "down") else v) for k, v in full.items()}


def test_the_shares_of_a_layer_add_up_to_the_uncut_layer():
    """Four chips' shares of one MoE layer (4 experts each, the router and
    its bias whole), the shared expert counted once, add up to the uncut
    layer of the port and of the reference, at a capacity that drops
    nothing."""
    uncut_spec = small_spec(16, 0, 1000.0)
    uncut = CONFIG.model_config(uncut_spec)
    params = tree_map(lambda t: t[0], lm.init_lm(7, uncut, device="cpu")["groups"]["pos0"]["ffn"])
    x = torch.randn(2, 24, uncut.d_model, generator=torch.Generator().manual_seed(8))
    shared = L.mlp(params["shared"], x)
    segments = [(0, 24)]
    with torch.inference_mode():
        whole, _ = moe.moe_ffn(params, uncut, x)
        ref_whole = REFERENCE.moe(params, x, uncut_spec, segments, REFERENCE.plain.f32_mm, REFERENCE.plain.Routes())
        total, ref_total = -3 * shared, -3 * shared
        for first in range(0, 16, 4):
            spec = small_spec(4, first, 1000.0)
            part, _ = moe.moe_ffn(_share_params(params, first, 4), CONFIG.model_config(spec), x)
            total = total + part
            ref_total = ref_total + REFERENCE.moe(_share_params(params, first, 4), x, spec, segments,
                                                  REFERENCE.plain.f32_mm, REFERENCE.plain.Routes())
    assert torch.allclose(total, whole, atol=1e-5) and torch.allclose(ref_total, ref_whole, atol=1e-5)
    assert torch.allclose(whole, ref_whole, atol=1e-5)


def test_the_route_gap_reads_the_biased_scores():
    """A forced choice the reference's own: gap 0; an expert whose biased
    score lies 0.3 below the reference's 8th: 0.3."""
    spec = dict(PUBLISHED)
    logits = torch.zeros(1, 256)
    logits[0, :10] = torch.arange(10, 0, -1).float()
    bias = torch.zeros(256)
    bias[9] = 1.0  # expert 9 rises above expert 7 by its bias
    own = REFERENCE.plain.Routes()
    _, ids = REFERENCE.choose(own, logits, bias, spec)
    assert 9 in ids[0].tolist() and 7 not in ids[0].tolist()
    forced = REFERENCE.plain.Routes([ids])
    REFERENCE.choose(forced, logits, bias, spec)
    assert forced.gap <= 0
    swap = ids.clone()
    swap[swap == 9] = 8
    forced = REFERENCE.plain.Routes([swap])
    REFERENCE.choose(forced, logits, bias, spec)
    kth = torch.topk(torch.sigmoid(logits) + bias, 8).values[0, -1]
    assert forced.gap == pytest.approx(float(kth - torch.sigmoid(logits[0, 8])), rel=1e-6)


# ---------------------------------------------------------------------------
# the kernel (the card)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the KDA recurrence kernel runs only there")
    return torch.device("cuda", 0)


def _on(card, args):
    return tuple(None if t is None else t.to(card).contiguous() for t in args)


@pytest.mark.cuda
@pytest.mark.parametrize("b, t, h, state", [(2, 37, 3, False), (1, 1, 2, True), (3, 100, 5, True),
                                              (1, 17, 1, False), (4, 1, 32, True)])
def test_the_kernel_matches_the_plain_version(card, b, t, h, state):
    """Ragged lengths (past a staged chunk of 16 or inside one), a decode
    step from a state, and grids that leave most of the card idle; o within
    one bf16 rounding of the plain version's (both round one f32 value),
    the state within f32 summation order."""
    q, k, v, g, beta, h0 = _on(card, _kda_inputs(b, t, h, 128, seed=b * t + h, dtype=torch.bfloat16))
    h0 = h0 if state else None
    o, s = KK.kda_recurrent(q, k, v, g, beta, h0)
    po, ps = KK.kda_recurrent_plain(q, k, v, g, beta, h0)
    torch.cuda.synchronize()
    scale = float(po.float().abs().max())
    assert float((o.float() - po.float()).abs().max()) <= 2**-7 * scale
    assert torch.allclose(s, ps, rtol=1e-4, atol=1e-5 * float(ps.abs().max()))
    if state:  # in place, as the decode step runs it over the cache
        into = h0.clone()
        o2, s2 = KK.kda_recurrent(q, k, v, g, beta, into, state=into)
        assert s2 is into and torch.equal(o2, o) and torch.equal(into, s)


@pytest.mark.cuda
def test_a_captured_kernel_replays_from_the_state_in_place(card):
    """One decode step captured in a CUDA graph, replayed: each replay
    advances the state in place as an eager call would."""
    q, k, v, g, beta, h0 = _on(card, _kda_inputs(4, 1, 32, 128, seed=2, dtype=torch.bfloat16))
    state, want = h0.clone(), h0.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        KK.kda_recurrent(q, k, v, g, beta, want.clone(), state=want.clone())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, _ = KK.kda_recurrent(q, k, v, g, beta, state, state=state)
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(3):
        graph.replay()
        want_o, want = KK.kda_recurrent(q, k, v, g, beta, want, state=want)
        torch.cuda.synchronize()
        assert torch.equal(out, want_o) and torch.equal(state, want)
