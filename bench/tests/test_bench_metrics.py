"""The readers' arithmetic on synthetic observations and trace events."""

import pytest

import devtrace
import harness
import hopper
from devtrace import Interval

NAMES = ["tokens_per_s", "request_p90_ms", "setup_s", "pad_share", "prefill_ms", "decode_step_ms",
         "gemm_roofline", "device_idle_share", "mfu"]


def reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py", f"test_metric_{name}").read


def trace_obs():
    ms = 1_000_000
    device = [
        Interval("void (anonymous namespace)::wgmma_gemm_kernel<1, 1, 128, __nv_bfloat16>(CUtensorMap_st, int)", 0, 4 * ms),
        Interval("void (anonymous namespace)::scheduled_gemm_kernel<float, float, 0>(float const*)", 4 * ms, 5 * ms),
        Interval("void at::native::elementwise_kernel<128, 2>(int)", 4 * ms, 8 * ms),
        Interval("Memcpy DtoH (Device -> Pageable)", 9 * ms, 10 * ms),
    ]
    spans = [Interval("engine", 0, 20 * ms), Interval("prefill", 0, 9 * ms), Interval("decode_step", 12 * ms, 20 * ms)]
    return {
        "device": device, "spans": spans, "window_ns": (0, 20 * ms), "trace_window_s": 0.02,
        "busy_s": devtrace.union_s(device, 0, 20 * ms),
        "gemms": [(1024, 4096, 4096, "bfloat16", "bfloat16", None), (8, 4096, 16, "float32", "float32", None)],
    }


def test_end_to_end_readers():
    obs = {"requests": [(100, 16, 1.0)] * 9 + [(50, 16, 3.0)], "window_s": 4.0, "setup_s": 12.5}
    assert reader("tokens_per_s")(obs) == pytest.approx((9 * 116 + 66) / 4.0)
    assert reader("request_p90_ms")(obs) == pytest.approx(1200.0)
    assert reader("setup_s")(obs) == 12.5


def test_model_step_readers():
    obs = {"prefill_shapes": [(8, 100), (8, 100)], "timed_prompt_tokens": 1200,
           "model_call_s": {"prefill": [0.5, 0.7], "decode_step": [0.01] * 4}}
    assert reader("pad_share")(obs) == pytest.approx(25.0)
    assert reader("prefill_ms")(obs) == pytest.approx(600.0)
    assert reader("decode_step_ms")(obs) == pytest.approx(10.0)
    empty = {"prefill_shapes": [], "model_call_s": {"prefill": [], "decode_step": []}}
    assert all(reader(n)(empty) is None for n in ("pad_share", "prefill_ms", "decode_step_ms"))


def test_device_readers():
    obs = trace_obs()
    assert obs["busy_s"] == pytest.approx(0.009)
    assert reader("device_idle_share")(obs) == pytest.approx(55.0)
    assert reader("mfu")({"timed_flops": 0.5 * 2.0 * hopper.MFU_PEAK_FLOPS, "timed_s": 2.0}) == pytest.approx(50.0)
    least = hopper.gemm_least_s(1024, 4096, 4096, "bfloat16", "bfloat16", None) + hopper.gemm_least_s(
        8, 4096, 16, "float32", "float32", None)
    assert reader("gemm_roofline")(obs) == pytest.approx(100 * least / 0.005)
    assert all(reader(n)({}) is None for n in ("gemm_roofline", "device_idle_share", "mfu"))


def test_least_time_is_the_larger_bound():
    # 1024 x 4096 x 4096 bf16: operations bound it
    assert hopper.gemm_least_s(1024, 4096, 4096, "bfloat16", "bfloat16", None) == pytest.approx(
        2 * 1024 * 4096 * 4096 / 989e12)
    # a decode product of 8 rows: its bytes bound it, each byte once
    nbytes = (8 * 4096 + 4096 * 4096) * 2 + 8 * 4096 * 2 + 4096 * 4
    assert hopper.gemm_least_s(8, 4096, 4096, "bfloat16", "bfloat16", "float32") == pytest.approx(nbytes / 3.35e12)


def test_breakdown_sums():
    obs = trace_obs()
    lo, hi = obs["window_ns"]
    ops = dict(devtrace.top(devtrace.by_name(obs["device"], lo, hi)))
    assert ops["wgmma_gemm_kernel<1, 1, 128, __nv_bfloat16>"] == pytest.approx(0.004)
    assert ops["at::native::elementwise_kernel<128, 2>"] == pytest.approx(0.004)
    idle = devtrace.idle_by_span(obs["device"], obs["spans"], lo, hi)
    assert idle == pytest.approx({"prefill": 0.001, "engine": 0.002, "decode_step": 0.008})
    assert sum(idle.values()) == pytest.approx(0.02 - obs["busy_s"])
    assert devtrace.label_at(obs["spans"], 25_000_000) == "harness"


def test_every_metric_has_a_reader():
    for name in NAMES:
        assert callable(reader(name))
