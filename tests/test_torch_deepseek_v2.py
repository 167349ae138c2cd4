"""DeepSeek-V2 as published on the port's serving path, at a small size on
the CPU with seeded random weights, against the benchmark's plain
reference (``bench/reference/deepseek-v2-236b.12l.ep8.py``): MLA with
q-LoRA, the latent norm and YaRN; group-limited routing with the routed
scale; one chip's share of the experts.

The configuration is built from a configuration file with the published
config.json's keys (``bench/configs/deepseek-v2-236b.12l.ep8.*``) at
small widths: d 64, 4 heads of 16 (+ 8 rope dims, YaRN as published),
q-LoRA 32, latent 32, 16 experts in 4 groups keeping 2, top-3, 4 held,
one shared expert, layer 0 dense.
"""

import importlib.util
import json
import math
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.kernels import attention as KA
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import lm, moe
from repro_torch.configs import get_smoke_config
from repro_torch.models.config import GroupedMoEConfig, MoEConfig
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.tree import tree_map

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
NAME = "deepseek-v2-236b.12l.ep8"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))


def _load(kind: str):
    spec = importlib.util.spec_from_file_location(f"test_deepseek_{kind}", BENCH / kind / f"{NAME}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CONFIG, REFERENCE = _load("configs"), _load("reference")
PUBLISHED = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())


def small_spec(held: int = 4, first: int = 0, cf: float = 1.25, dtype: str = "float32") -> dict:
    spec = dict(PUBLISHED)
    spec.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4, qk_nope_head_dim=16, v_head_dim=16,
                qk_rope_head_dim=8, q_lora_rank=32, kv_lora_rank=32, intermediate_size=96, moe_intermediate_size=32,
                n_shared_experts=1, router_experts=16, n_routed_experts=held, first_expert=first, n_group=4,
                topk_group=2, num_experts_per_tok=3, routed_scaling_factor=2.5, num_hidden_layers=3, vocab_size=256,
                capacity_factor=cf, attn_chunk=16, param_dtype=dtype, compute_dtype=dtype, kv_cache_dtype=dtype)
    return spec


def _rel(got, want) -> float:
    return float((got.float() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("held, first", [(4, 0), (4, 8), (16, 0)])
def test_prefill_then_decode_gives_the_references_logits(held, first):
    """The prompt through ``lm.prefill``, then greedy tokens through
    ``lm.decode_step`` over the latent cache, against one forward pass of
    the reference over the whole sequence, each engine call a capacity
    segment; in float32 only summation order separates them, and the
    router chooses the reference's experts."""
    spec = small_spec(held, first)
    cfg = CONFIG.model_config(spec)
    params = lm.init_lm(3, cfg, device="cpu")
    b, s, new = 3, 24, 4
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(4))
    cache = lm.init_cache(cfg, b, s + new, device="cpu")
    got, seq = [], tokens
    with torch.inference_mode():
        logits, cache = lm.prefill(params, cfg, tokens, cache)
        got.append(logits)
        for _ in range(new):
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            seq = torch.cat([seq, nxt], dim=1)
            logits, cache = lm.decode_step(params, cfg, cache, nxt)
            got.append(logits)
        segments = [(0, s)] + [(s + j, s + j + 1) for j in range(new)]
        routes = REFERENCE.plain.Routes()
        ref = REFERENCE.logits(params, spec, seq, torch.arange(s - 1, s + new), segments, routes=routes)
    assert _rel(torch.cat(got, dim=1), ref) < 1e-5
    assert len(routes.used) == (cfg.n_layers - 1)


def test_the_router_is_published_group_limited_greedy():
    """``moe.route`` against the published ``MoEGate.forward``
    (``topk_method == "group_limited_greedy"``, no renormalisation, times
    ``routed_scaling_factor``), written out here."""
    cfg = CONFIG.model_config(small_spec())
    m = cfg.moe
    gen = torch.Generator().manual_seed(5)
    params = {"router": {"w": torch.randn(cfg.d_model, m.n_routed_experts, generator=gen)}}
    x = torch.randn(64, cfg.d_model, generator=gen)
    w, idx, _ = moe.route(params, cfg, x)

    scores = (x @ params["router"]["w"]).softmax(dim=-1, dtype=torch.float32)
    group_scores = scores.view(64, m.n_group, -1).max(dim=-1).values
    group_idx = torch.topk(group_scores, k=m.topk_group, dim=-1, sorted=False)[1]
    group_mask = torch.zeros_like(group_scores).scatter_(1, group_idx, 1)
    score_mask = group_mask.unsqueeze(-1).expand(64, m.n_group, m.n_routed_experts // m.n_group).reshape(64, -1)
    tmp = scores.masked_fill(~score_mask.bool(), 0.0)
    topk_weight, topk_idx = torch.topk(tmp, k=m.top_k, dim=-1, sorted=False)
    topk_weight = topk_weight * m.routed_scaling_factor

    order = topk_idx.argsort(-1)
    assert torch.equal(idx.sort(-1).values, topk_idx.gather(-1, order))
    assert torch.allclose(w.gather(-1, idx.argsort(-1)), topk_weight.gather(-1, order), rtol=1e-6, atol=0)
    # a group left out never gives an expert, however well it scores
    chosen_groups = torch.zeros(64, m.n_group, dtype=torch.bool).scatter_(1, group_idx, True)
    assert bool(chosen_groups.gather(1, idx // (m.n_routed_experts // m.n_group)).all())


def _published_yarn(dim, base, factor, orig, beta_fast, beta_slow, mscale, mscale_all_dim, seq_len):
    """DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding`` cos / sin cache
    ([S, dim], the frequencies repeated for the two halves) and the
    attention's softmax-scale factor, as the published modeling code
    computes them."""
    def find_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(base))

    def get_mscale(scale, m):
        return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

    low, high = max(math.floor(find_dim(beta_fast)), 0), min(math.ceil(find_dim(beta_slow)), dim - 1)
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    hi = high + 0.001 if low == high else high
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (hi - low), 0, 1)
    inv_freq_mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
    freqs = torch.outer(torch.arange(seq_len, dtype=torch.float32), inv_freq)
    m = get_mscale(factor, mscale) / get_mscale(factor, mscale_all_dim)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos() * m, emb.sin() * m, get_mscale(factor, mscale_all_dim) ** 2


@pytest.mark.parametrize("mscale_all_dim", [0.707, 0.0])
def test_yarn_tables_and_scale_are_the_published_formulas(mscale_all_dim):
    rs = PUBLISHED["rope_scaling"]
    cfg = CONFIG.model_config({**PUBLISHED, "rope_scaling": {**rs, "mscale_all_dim": mscale_all_dim}})
    y = cfg.rope_scaling
    cos, sin, factor = _published_yarn(64, 10000.0, rs["factor"], rs["original_max_position_embeddings"],
                                       rs["beta_fast"], rs["beta_slow"], rs["mscale"], mscale_all_dim, 16384)
    got_cos, got_sin = L.rope_tables(torch.arange(16384), 64, cfg.rope_theta, y)
    assert torch.allclose(got_cos, cos[:, :32], atol=1e-6) and torch.allclose(got_sin, sin[:, :32], atol=1e-6)
    assert A.softmax_scale(cfg) == pytest.approx(192**-0.5 * factor, rel=1e-12)
    # the reference's tables (float64, then float32) agree
    ref_cos, ref_sin = REFERENCE.rope_tables(16384, 64, {**PUBLISHED, "rope_scaling": {**rs, "mscale_all_dim": mscale_all_dim}}, "cpu")
    assert torch.allclose(ref_cos, cos[:, :32], atol=2e-3) and torch.allclose(ref_sin, sin[:, :32], atol=2e-3)
    # the published values: the ramp lies between dims 10 and 23, softmax x 1.5896...
    assert A.softmax_scale(CONFIG.model_config(PUBLISHED)) == pytest.approx(192**-0.5 * (0.0707 * math.log(40) + 1) ** 2)


def test_capacity_counts_over_the_routers_width():
    grouped = GroupedMoEConfig(n_experts=20, top_k=6, d_ff_expert=1536, n_routed_experts=160)
    for t in (4, 16, 1000, 65536):
        assert moe.capacity(grouped, t) == max(math.ceil(t * 6 * 1.25 / 160), min(t, 16))
    assert moe.capacity(grouped, 65536) == 3072
    plain = MoEConfig(n_experts=20, top_k=6, d_ff_expert=1536)  # every expert held: the width is 20
    assert moe.capacity(plain, 65536) == math.ceil(65536 * 6 * 1.25 / 20)
    assert moe.share(grouped) == (160, 0) and moe.share(plain) == (20, 0)


def _share_params(full: dict, first: int, held: int) -> dict:
    return {k: (v[first : first + held] if k in ("gate", "up", "down") else v) for k, v in full.items()}


@pytest.mark.parametrize("cf", [1.25, 1000.0])
def test_the_shares_of_a_layer_add_up_to_the_uncut_layer(cf):
    """Four chips' shares of one MoE layer (4 experts each, the router
    whole), the shared expert counted once, add up to the uncut layer of
    the reference and of the port: capacity is counted over the router's
    width, so a pair drops in a share where it drops in the whole (cf
    1.25: 16 slots for 48 tokens, ranked; cf 1000: every expert takes
    every token, ``moe.dispatch``'s slot-per-token form)."""
    spec = small_spec(16, 0, cf)
    uncut = CONFIG.model_config(spec)
    params = tree_map(lambda t: t[0], lm.init_lm(7, uncut, device="cpu")["groups"]["pos0"]["ffn"])
    x = torch.randn(2, 24, uncut.d_model, generator=torch.Generator().manual_seed(8))
    shared = L.mlp(params["shared"], x)
    with torch.inference_mode():
        whole, _ = moe.moe_ffn(params, uncut, x)
        total = -3 * shared
        held = 0
        for first in range(0, 16, 4):
            cfg = CONFIG.model_config(small_spec(4, first, cf))
            with tracing.recording() as rec:
                part, _ = moe.moe_ffn(_share_params(params, first, 4), cfg, x)
            total = total + part
            held += rec.counters["moe.held_pairs"]
            assert rec.counters["moe.pairs"] == 2 * 24 * 3
        ref = REFERENCE.moe(params, x, spec, [(0, 24)], REFERENCE.plain.f32_mm, REFERENCE.plain.Routes())
    assert held == 2 * 24 * 3
    assert _rel(total, ref) < 1e-5 and _rel(whole, ref) < 1e-5


def test_mla_at_the_published_head_dims_takes_the_kernel_with_its_scale(monkeypatch):
    """bf16 MLA at 128 nope + 64 rope dims and v 128 is the kernel's
    (192, 128) instantiation: the prefill calls its wrapper with the
    YaRN softmax scale (on the CPU the wrapper runs the plain version)."""
    spec = small_spec(dtype="bfloat16")
    spec.update(num_attention_heads=2, num_key_value_heads=2, qk_nope_head_dim=128, v_head_dim=128,
                qk_rope_head_dim=64)
    cfg = CONFIG.model_config(spec)
    assert A.prefill_kernel_refusal(cfg) is None
    assert A.prefill_kernel_refusal(CONFIG.model_config(small_spec(dtype="bfloat16"))) is not None  # 24 / 16
    seen, real = [], KA.prefill_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], kw["scale"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(KA, "prefill_attention", spy)
    params = lm.init_lm(0, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 20), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        lm.prefill(params, cfg, tokens, lm.init_cache(cfg, 2, 20, device="cpu"))
    assert seen == [(192, 192, 128, A.softmax_scale(cfg))] * cfg.n_layers
    assert A.softmax_scale(cfg) > 192**-0.5


def test_the_plain_attention_takes_the_scale():
    gen = torch.Generator().manual_seed(2)
    q, k = (torch.randn(1, 2, 40, 24, generator=gen) for _ in range(2))
    v = torch.randn(1, 2, 40, 16, generator=gen)
    got = KA.prefill_attention(q, k, v, scale=0.3, chunk_q=16, chunk_kv=16)
    logits = (q @ k.transpose(-1, -2)) * 0.3
    logits = logits.masked_fill(torch.ones(40, 40, dtype=torch.bool).triu(1), float("-inf"))
    assert torch.allclose(got, logits.softmax(-1) @ v, atol=1e-5)
    assert KA.shape_refusal(q.shape, k.shape, v.shape, torch.bfloat16) is not None
    assert KA.shape_refusal((1, 8, 64, 192), (1, 8, 64, 192), (1, 8, 64, 128), torch.bfloat16) is None


def test_the_captured_steps_arithmetic_is_the_eager_steps():
    """The body ``lm._DecodeGraphs`` captures (the position read from a
    device tensor, the cache row written by index, each router handed in
    by a stand-in) gives the eager step's logits and cache, bit for bit."""
    cfg = CONFIG.model_config(small_spec())
    params = lm.init_lm(3, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (3, 12), generator=torch.Generator().manual_seed(8))
    with torch.inference_mode():
        caches = [lm.init_cache(cfg, 3, 16, device="cpu") for _ in range(2)]
        logits = [lm.prefill(params, cfg, tokens, c)[0] for c in caches]
        token = logits[0][:, -1].argmax(-1, keepdim=True)
        want, _ = lm.decode_step(params, cfg, caches[0], token)
        routed = []

        def router(ffn, rcfg, xt):
            routed.append(xt.shape)
            return moe.route(ffn, rcfg, xt)

        pos = torch.tensor([12])
        got = lm._decode_body(params, cfg, caches[1], token, pos, pos, router)
    assert lm.graphs_fit(cfg) and torch.equal(got, want)
    assert routed == [(3, cfg.d_model)] * (cfg.n_layers - 1)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(caches[0]), _leaves(caches[1]), strict=True))


def _leaves(cache) -> list:
    prefix = [t for lc in cache["prefix"] for t in lc.values()]
    return prefix + [t for g in cache["groups"].values() for t in g.values()]


@pytest.mark.parametrize("arch, fits", [("deepseek_v2_236b", True), ("jamba_v0_1_52b", False),
                                        ("codeqwen1_5_7b", False)])
def test_graphs_fit_mla_attention_everywhere(arch, fits):
    """Only a model with MLA attention in every layer replays its decode
    step (a GQA decode and a Mamba state read their lengths on the host);
    only an engine's cache keeps graphs, and never on the CPU."""
    cfg = get_smoke_config(arch)
    assert lm.graphs_fit(cfg) is fits
    assert "graphs" in lm.init_cache(cfg, 2, 8, device="cpu", graphs=True)
    assert "graphs" not in lm.init_cache(cfg, 2, 8, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        engine = ServingEngine(cfg, lm.init_lm(0, cfg, device="cpu"),
                               ServeConfig(batch=2, max_len=12, max_new_tokens=2))
    engine.generate([np.arange(5, dtype=np.int32), np.arange(7, dtype=np.int32)])
    assert engine._cache is None


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs are captured only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_replayed_graphs_give_the_eager_steps_bits(card, monkeypatch):
    """A cache made with ``graphs=True`` captures the decode step once and
    replays it: the logits and tokens of every step are the eager step's,
    bit for bit, and each replayed step calls ``moe.route`` once per MoE
    layer, as the eager step does."""
    cfg = CONFIG.model_config(small_spec(dtype="bfloat16"))
    params = lm.init_lm(3, cfg, device=card)
    tokens = torch.randint(0, cfg.vocab, (4, 40), generator=torch.Generator().manual_seed(9)).to(card)
    calls, real = [], moe.route

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(moe, "route", counted)
    out = []
    with torch.inference_mode():
        for graphs in (False, True):
            cache = lm.init_cache(cfg, 4, 48, device=card, graphs=graphs)
            logits, cache = lm.prefill(params, cfg, tokens, cache)
            steps = []
            for _ in range(6):
                cur = logits[:, -1:].argmax(-1).to(torch.int32)
                calls.clear()
                logits, cache = lm.decode_step(params, cfg, cache, cur)
                steps.append((logits.clone(), len(calls)))
            out.append(steps)
            assert (cache.get("graphs") is not None) == graphs
    n_moe = cfg.n_layers - 1
    assert [c for _, c in out[0]] == [n_moe] * 6
    assert [c for _, c in out[1]] == [2 * n_moe] + [n_moe] * 5  # the capture's eager step, then replays
    assert all(torch.equal(a, b) for (a, _), (b, _) in zip(out[0], out[1]))


@pytest.mark.cuda
def test_an_engine_serves_the_same_tokens_with_graphs(card, monkeypatch):
    """Two waves through one ``ServingEngine`` (one cache, graphs captured
    in the first) against engines that never replay."""
    cfg = CONFIG.model_config(small_spec(dtype="bfloat16"))
    params = lm.init_lm(4, cfg, device=card)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (30, 17, 40, 25, 12, 33, 8, 40)]

    def serve():
        engine = ServingEngine(cfg, params, ServeConfig(batch=4, max_len=48, max_new_tokens=8))
        return [r.output for r in engine.generate(prompts)], engine

    got, engine = serve()
    assert engine._cache is not None and engine._cache["graphs"] is not None
    monkeypatch.setattr(lm, "graphs_fit", lambda cfg: False)
    want, plain = serve()
    assert plain._cache is None and got == want
