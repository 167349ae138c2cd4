"""The Kimi-Linear cell (``kimi-linear-longdoc``) at small widths on the CPU:
its plain reference against the port (the logits the engine served
through the timed path), its weight maker against ``init_lm``, its FLOPs
at the published sizes, the ``kda_roofline`` reader on synthetic
observations, and what the reference imports.  The shared tests
(``test_bench_reference.py``) take their small sizes from the registry's
smoke configurations, which have no such model, so this cell's run here."""

import dataclasses
import json
import math
import subprocess
import sys
import time

import pytest
import torch

import correct
import harness
import lmshapes
from devtrace import Interval
from helpers import BENCHMARK, ROOT
from repro_torch.models import lm
from test_bench_weights import leaves

CELL = "kimi-linear-longdoc"
NAME = "kimi-linear-48b-a3b.ep4"
PUBLISHED = json.loads((ROOT / "bench" / "configs" / f"{NAME}.json").read_text())


def small(dtype: str = "float32", kv: str | None = None) -> dict:
    """The configuration file at small widths: d 64, 4 KDA heads of 16, 4
    MLA heads (latent 32, nope / rope / v 16 / 8 / 16), 16 experts top-4,
    experts 4-7 held, one shared expert, 11 layers (MLA at 4, 8 and 11:
    two whole periods and the published tail)."""
    spec = dict(PUBLISHED)
    spec.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4, qk_nope_head_dim=16, v_head_dim=16,
                qk_rope_head_dim=8, kv_lora_rank=32, intermediate_size=96, moe_intermediate_size=32,
                router_experts=16, num_experts=4, first_expert=4, num_experts_per_token=4, num_hidden_layers=11,
                vocab_size=512, attn_chunk=16, param_dtype=dtype, compute_dtype=dtype, kv_cache_dtype=kv or dtype,
                linear_attn_config={"full_attn_layers": [4, 8, 11], "head_dim": 16,
                                    "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10], "num_heads": 4,
                                    "short_conv_kernel_size": 4})
    return spec


def small_cell(dtype="float32", kv=None) -> harness.Cell:
    cell = harness.Cell.load(BENCHMARK, CELL)
    spec = small(dtype, kv)
    t = dataclasses.replace(cell.traffic, batch=4, new_tokens=4, median=24, min_len=8, max_len=40, multiple=8)
    return dataclasses.replace(cell, spec=spec, cfg=cell.config.model_config(spec), traffic=t)


def test_served_logits_equal_the_reference_in_float32():
    """Through the timed path: padded waves, the KDA states and conv tails,
    the latent cache, the absorbed decode, the share's capacity per engine
    call, the sigmoid router with its bias."""
    cell = small_cell("float32", "float32")
    out = harness.run(cell, 2**31 + 3, 0.0, False, "cpu", time.perf_counter(), min_waves=2)
    found = correct.check(cell, out["weights"], out["kept"], "cpu")
    assert found["logit_err"] < 1e-5 and found["token_gap"] == 0.0
    assert found["route_gap"] < 1e-5


def test_a_misrouted_share_is_not_correct(monkeypatch):
    """Each token's experts moved to the next four: the reference finds them
    below its own eighth biased score."""
    from repro_torch.models import moe

    real = moe.route

    def route(params, cfg, xt):
        w, idx, aux = real(params, cfg, xt)
        return w, (idx + 4) % 16, aux

    monkeypatch.setattr(moe, "route", route)
    result = harness.execute(small_cell("float32", "float32"), 2**31 + 11, 0.0, False, "cpu", time.perf_counter())
    assert not result["correct"] and result["checks"]["route_gap"]["value"] > result["checks"]["route_gap"]["limit"]


def test_weights_are_init_lms_tree():
    config = harness.Cell.load(BENCHMARK, CELL).config
    cfg = config.model_config(small("bfloat16"))
    ours = {p: (tuple(t.shape), t.dtype) for p, t in leaves(config.make_weights(7, cfg, "cpu"))}
    port = {p: (tuple(t.shape), t.dtype) for p, t in leaves(lm.init_lm(0, cfg, device="cpu"))}
    assert ours == port
    assert ours[("groups", "pos0", "ffn", "router", "w")] == ((2, 64, 16), torch.float32)  # every expert scored
    assert ours[("groups", "pos0", "ffn", "score_bias")] == ((2, 16), torch.float32)
    assert ours[("groups", "pos0", "ffn", "gate")][0] == (2, 4, 64, 32)  # the 4 held
    assert ours[("suffix", 1, "block", "kv_norm", "scale")][0] == (32,)  # the tail's MLA
    w = dict(leaves(config.make_weights(7, cfg, "cpu")))
    a = torch.exp(w[("groups", "pos0", "block", "A_log")])
    dt = torch.nn.functional.softplus(w[("groups", "pos0", "block", "dt_bias")])
    assert bool(((a >= 1) & (a <= 16)).all()) and bool(((dt > 0.99e-3) & (dt < 1.01e-1)).all())


def test_flops_of_the_published_sizes():
    cell = harness.Cell.load(BENCHMARK, CELL)
    cfg, c = cell.cfg, cell.config
    assert c.kda_params(cfg) == pytest.approx(39.5e6, rel=2e-3)  # 20 KDA layers
    assert c.mla_params(cfg) == pytest.approx(29.1e6, rel=2e-3)  # 7 MLA layers
    moe_layer = 2304 * 256 + 3 * 2304 * 1024 * (1 + 8 * 64 / 256)
    assert c.active_body_params(cfg) == pytest.approx(20 * c.kda_params(cfg) + 7 * c.mla_params(cfg)
                                                      + 3 * 2304 * 9216 + 26 * moe_layer)
    one = c.request_flops(cfg, 1, 1)
    assert one == pytest.approx(2 * c.active_body_params(cfg) + 2 * 2304 * 163840 + 6 * 128 * 128 * 32 * 20
                                + 2 * 32 * 320 * 7)
    # the weights: 13.8 B here (27.6 GB in bf16)
    count = sum(math.prod(r[1]) for r in lmshapes._recipes(c._leaves(cfg)))
    assert count == pytest.approx(13.8e9, rel=0.01)


def _obs(lengths, prefills, steps, batch=4, new=64, prefill_ms=12.0, step_ms=0.01):
    """Five waves of ``batch`` requests, waves 3 and 4 traced with
    ``prefills`` KDA launches of ``prefill_ms`` and ``steps`` of
    ``step_ms`` each, one other kernel."""
    requests = [(p, new, 3.0) for w in range(5) for p in [lengths[w]] + [8192] * (batch - 1)]
    name = "void (anonymous namespace)::kda_recurrent_kernel(const __nv_bfloat16 *, int, int)"
    device, t = [], 0
    for ms in [prefill_ms] * prefills + [step_ms] * steps:
        device.append(Interval(name, t, t + int(ms * 1e6)))
        t += int(ms * 1e6)
    device.append(Interval("void (anonymous namespace)::wgmma_gemm_kernel<1, 1, 128, __nv_bfloat16>(int)", 0, 10))
    return {"device": device, "window_ns": (0, t), "requests": requests,
            "prefill_shapes": [(batch, lengths[1]), (batch, lengths[2])]}


def test_kda_roofline_reads_the_traced_waves():
    import kda_bound

    read = harness.load_module(harness.BENCH / "metrics" / "kda_roofline.py", "test_kda_roofline")
    assert read.shapes() == (32, 128, 20)
    lengths = [16384, 12288, 49152, 24576, 18432]
    prefills, steps = 20 * 2, 20 * 2 * 64  # 20 layers x 2 traced waves x (a prefill, 64 steps)
    obs = _obs(lengths, prefills, steps)
    step = kda_bound.kda_least_s(4, 1, 32, 128, 128)
    least = 20 * (kda_bound.kda_least_s(4, 24576, 32, 128, 128) + kda_bound.kda_least_s(4, 18432, 32, 128, 128))
    assert read.read(obs) == pytest.approx(100 * (least + steps * step) / (prefills * 0.012 + steps * 0.00001))
    # a few step launches lost by the trace count as found; 2 % lost, a prefill lost or one launch too many read
    # nothing, nor do launches that do not part by ten in time, or nothing traced
    assert read.read(_obs(lengths, prefills, steps - 2)) == pytest.approx(
        100 * (least + (steps - 2) * step) / (prefills * 0.012 + (steps - 2) * 0.00001))
    assert read.read(_obs(lengths, prefills, steps - 52)) is None
    assert read.read(_obs(lengths, prefills - 1, steps)) is None
    assert read.read(_obs(lengths, prefills, steps + 1)) is None
    assert read.read(_obs(lengths, prefills, steps, step_ms=2.0)) is None
    assert read.read({**obs, "device": []}) is None
    assert read.read({**obs, "requests": obs["requests"][:-1]}) is None
    assert read.read({**obs, "prefill_shapes": []}) is None
    # the least time of a launch: bytes at every length (the operations at the bf16 peak are a fifth of them)
    b, t = 4, 32768
    flops, nbytes = kda_bound.kda_flops(b, t, 32, 128, 128), kda_bound.kda_bytes(b, t, 32, 128, 128)
    assert flops == 7 * 128 * 128 * 32 * b * t
    assert nbytes == b * t * 32 * (2 * 4 * 128 + 4 * 128 + 4) + b * 32 * 128 * 128 * 8
    assert kda_bound.kda_least_s(b, t, 32, 128, 128) == max(flops / 989e12, nbytes / 3.35e12) == nbytes / 3.35e12
    assert math.isclose(step, (4 * 32 * (1540 + 128 * 128 * 8)) / 3.35e12)


SCRIPT = r"""
import sys, importlib.util
sys.path[:0] = [sys.argv[1] + "/bench"]
spec = importlib.util.spec_from_file_location("ref", sys.argv[1] + "/bench/reference/kimi-linear-48b-a3b.ep4.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
top = sorted({name.split(".")[0] for name in sys.modules} & {"jax", "jaxlib", "flax", "repro", "repro_torch"})
print(top)
sys.exit(1 if top else 0)
"""


def test_the_reference_imports_no_jax_and_nothing_of_the_program():
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_reference_runs_with_tf32_off(monkeypatch):
    """``correct.reference_logits`` runs the reference under
    ``plain.full_f32``: float32 products in float32, not TF32."""
    cell = small_cell("float32", "float32")
    seen = []

    def logits(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return torch.zeros(1)

    monkeypatch.setattr(cell.reference, "logits", logits)
    wave = harness.Wave(0, [torch.zeros(3, dtype=torch.int32).numpy()] * 4, [[1] * 4] * 4, 0, 0)
    correct.reference_logits(cell, {}, wave, "cpu")
    assert seen == [(False, False, "highest")]

