"""The DeepSeek-V2 cell (``deepseek-longdoc``) at small widths on the CPU:
its plain reference against the port (whole forward passes, and the
logits the engine served through the timed path), its weight maker
against ``init_lm``, its FLOPs, and the ``attention_roofline`` reader on
synthetic observations.  The shared tests (``test_bench_reference.py``)
take their small sizes from the registry's smoke configurations, which
have no MLA of this form, so this cell's run here."""

import dataclasses
import json
import math
import time

import pytest
import torch

import correct
import harness
from devtrace import Interval
from helpers import BENCHMARK, ROOT
from repro_torch.models import lm
from test_bench_weights import leaves

CELL = "deepseek-longdoc"
PUBLISHED = json.loads((ROOT / "bench" / "configs" / "deepseek-v2-236b.12l.ep8.json").read_text())


def small(dtype: str = "float32", kv: str | None = None) -> dict:
    """The configuration file at small widths: d 64, 4 heads of 16 + 8
    rope dims, q-LoRA 32, latent 32, 16 experts in 4 groups keeping 2,
    top-3, experts 4-7 held, one shared expert, 3 layers."""
    spec = dict(PUBLISHED)
    spec.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4, qk_nope_head_dim=16, v_head_dim=16,
                qk_rope_head_dim=8, q_lora_rank=32, kv_lora_rank=32, intermediate_size=96, moe_intermediate_size=32,
                n_shared_experts=1, router_experts=16, n_routed_experts=4, first_expert=4, n_group=4, topk_group=2,
                num_experts_per_tok=3, num_hidden_layers=3, vocab_size=512, attn_chunk=16, param_dtype=dtype,
                compute_dtype=dtype, kv_cache_dtype=kv or dtype)
    return spec


def small_cell(dtype="float32", kv=None) -> harness.Cell:
    cell = harness.Cell.load(BENCHMARK, CELL)
    spec = small(dtype, kv)
    t = dataclasses.replace(cell.traffic, batch=4, new_tokens=4, median=24, min_len=8, max_len=40, multiple=8)
    return dataclasses.replace(cell, spec=spec, cfg=cell.config.model_config(spec), traffic=t)


def test_reference_forward_equals_the_ports():
    cell = small_cell()
    weights = cell.config.make_weights(5, cell.cfg, "cpu")
    tokens = torch.randint(0, cell.cfg.vocab, (3, 40), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        got, _ = lm.forward(weights, cell.cfg, tokens)
        ref = cell.reference.logits(weights, cell.spec, tokens, torch.arange(40), [(0, 40)])
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


def test_served_logits_equal_the_reference_in_float32():
    """Through the timed path: padded waves, the latent cache, the absorbed
    decode, the share's capacity per engine call, the grouped router."""
    cell = small_cell("float32", "float32")
    out = harness.run(cell, 2**31 + 3, 0.0, False, "cpu", time.perf_counter(), min_waves=2)
    found = correct.check(cell, out["weights"], out["kept"], "cpu")
    assert found["logit_err"] < 1e-5 and found["token_gap"] == 0.0
    assert found["route_gap"] < 1e-5


def test_a_misrouted_share_is_not_correct(monkeypatch):
    """Each token's experts moved to the next group's: the reference's
    grouped choice finds them below its own sixth, by a router logit."""
    from repro_torch.models import moe

    real = moe.route

    def route(params, cfg, xt):
        w, idx, aux = real(params, cfg, xt)
        return w, (idx + 4) % 16, aux

    monkeypatch.setattr(moe, "route", route)
    result = harness.execute(small_cell("float32", "float32"), 2**31 + 11, 0.0, False, "cpu", time.perf_counter())
    assert not result["correct"] and result["checks"]["route_gap"]["value"] > result["checks"]["route_gap"]["limit"]


def test_weights_are_init_lms_tree():
    cfg = harness.Cell.load(BENCHMARK, CELL).config.model_config(small("bfloat16"))
    config = harness.Cell.load(BENCHMARK, CELL).config
    ours = {p: (tuple(t.shape), t.dtype) for p, t in leaves(config.make_weights(7, cfg, "cpu"))}
    port = {p: (tuple(t.shape), t.dtype) for p, t in leaves(lm.init_lm(0, cfg, device="cpu"))}
    assert ours == port
    assert ours[("groups", "pos0", "ffn", "router", "w")] == ((2, 64, 16), torch.float32)  # every expert scored
    assert ours[("groups", "pos0", "ffn", "gate")][0] == (2, 4, 64, 32)  # the 4 held


def test_flops_of_the_published_sizes():
    cell = harness.Cell.load(BENCHMARK, CELL)
    cfg, c = cell.cfg, cell.config
    assert c.mla_params(cfg) == 149_225_472  # MLA: 149 M of the 215 M weights a token meets in a layer
    moe_layer = c.mla_params(cfg) + 5120 * 160 + 3 * 5120 * 1536 * (2 + 6 * 20 / 160)
    assert moe_layer == pytest.approx(214.9e6, rel=1e-3)
    assert c.active_body_params(cfg) == pytest.approx(12 * c.mla_params(cfg) + 3 * 5120 * 12288 + 11 * (moe_layer - c.mla_params(cfg)))
    one = c.request_flops(cfg, 1, 1)
    assert one == pytest.approx(2 * c.active_body_params(cfg) + 2 * 5120 * 102400 + 2 * 128 * 320 * 12)
    # S 8192 attention: 11.0 TFLOP a layer at B 4
    s = 8192
    assert 4 * 2 * 128 * 320 * s * (s + 1) / 2 == pytest.approx(11.0e12, rel=0.01)


def _obs(lengths, launches, batch=4, ms=80.0):
    """Five waves of ``batch`` requests, waves 3 and 4 traced with
    ``launches`` attention launches of ``ms`` each, one other kernel."""
    requests = [(p, 64, 3.0) for w in range(5) for p in [lengths[w]] + [4096] * (batch - 1)]
    name = "void (anonymous namespace)::prefill_attention_kernel<192, 128>(CUtensorMap_st, CUtensorMap_st, int)"
    step = int(ms * 1e6)
    device = [Interval(name, i * step, (i + 1) * step) for i in range(launches)]
    device.append(Interval("void (anonymous namespace)::wgmma_gemm_kernel<1, 1, 128, __nv_bfloat16>(int)", 0, step))
    return {"device": device, "window_ns": (0, (launches + 1) * step), "requests": requests,
            "prefill_shapes": [(batch, lengths[1]), (batch, lengths[2])]}


def test_attention_roofline_reads_the_traced_waves():
    import attention_bound

    read = harness.load_module(harness.BENCH / "metrics" / "attention_roofline.py", "test_attention_roofline")
    assert read.shapes() == (128, 192, 128, 12)
    lengths = [8192, 6144, 16384, 12288, 9216]
    obs = _obs(lengths, 24)
    least = 12 * (attention_bound.attention_least_s(4, 128, 12288, 192, 128)
                  + attention_bound.attention_least_s(4, 128, 9216, 192, 128))
    assert read.read(obs) == pytest.approx(100 * least / (24 * 0.080))
    # the launches do not match 12 layers x 2 traced prefills, or nothing traced
    assert read.read(_obs(lengths, 23)) is None
    assert read.read({**obs, "device": []}) is None
    assert read.read({**obs, "requests": obs["requests"][:-1]}) is None
    # the least time of a launch: operations at S 16384 (44.5 ms), bytes below ~S 400
    assert attention_bound.attention_least_s(4, 128, 16384, 192, 128) == pytest.approx(0.04448, rel=1e-3)
    flops, nbytes = (attention_bound.attention_flops(1, 1, 128, 192, 128),
                     attention_bound.attention_bytes(1, 1, 128, 192, 128))
    assert attention_bound.attention_least_s(1, 1, 128, 192, 128) == max(flops / 989e12, nbytes / 3.35e12)
    assert math.isclose(nbytes, 2 * 128 * (2 * 192 + 2 * 128))


def test_the_route_gap_reads_each_stage_of_the_grouped_choice():
    """4 groups of 4, 2 kept, top-3: groups 1 and 2 tie for second place.
    Taking group 2's experts where the reference takes group 1's is a
    rounding's choice and reads 0 at both stages; an expert of group 3,
    or group 2's weakest in place of its best, reads its gap."""
    choice_gap = harness.Cell.load(BENCHMARK, CELL).reference.choice_gap
    logits = torch.tensor([[9.0, 1.0, 1.0, 1.0, 5.0, 4.0, 0.0, 0.0, 5.0, 3.0, 0.5, 0.0, 2.0, 0.0, 0.0, 0.0]])
    assert float(choice_gap(logits, torch.tensor([[0, 4, 5]]), 3, 4, 2)) <= 0  # the reference's own
    assert float(choice_gap(logits, torch.tensor([[0, 8, 9]]), 3, 4, 2)) <= 0  # the tied group instead
    assert float(choice_gap(logits, torch.tensor([[0, 8, 12]]), 3, 4, 2)) == pytest.approx(3.0)  # group 3: 5 - 2
    assert float(choice_gap(logits, torch.tensor([[0, 8, 10]]), 3, 4, 2)) == pytest.approx(2.5)  # 3 - 0.5
