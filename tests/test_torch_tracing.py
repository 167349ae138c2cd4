"""The port's recorder (``repro_torch.tracing``) and the spans and counters
of the LM serving path.

Off, the recorder records nothing, reads no clock and leaves no
allocation behind.  On, spans nest by thread, and a smoke LM served
through ``ServingEngine`` under ``scheduled_kernels`` records the
engine's, the model step's, each block's and the kernel policy's spans
and counters, while serving the same tokens and logits, bit for bit, as
with recording off.  The counters are held to arithmetic done here from
the shapes the model's products were called with.
"""

import dataclasses
import importlib.util
import threading
import tracemalloc
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_smoke_config
from repro_torch.core.configurators import build_backend
from repro_torch.core.deprecation import ReproDeprecationWarning
from repro_torch.core.descriptions import make_gemmini_description
from repro_torch.kernels import gemm, ops
from repro_torch.kernels.policy import scheduled_kernels
from repro_torch.models import layers, lm, moe
from repro_torch.serve import ServeConfig, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
#: dense attention, the hybrid (Mamba, MoE, attention), MLA with shared
#: experts after a dense layer, and the two xLSTM kinds
ARCHS = ["codeqwen1_5_7b", "jamba_v0_1_52b", "deepseek_v2_236b", "xlstm_125m"]
LENGTHS = (5, 9, 3, 7, 6, 2, 8, 4, 6)  # two waves of batch 8, the second one prompt
NEW = 3
ENGINE = {"engine.wave", "engine.pad", "engine.cache_init", "engine.readback", "engine.next_token"}
BLOCK = {
    "attn": {"attn.qkv", "attn.core", "attn.out", "attn.cache_write"},
    "mamba": {"mamba.in_proj", "mamba.scan", "mamba.out_proj"},
    "mlstm": set(),
    "slstm": set(),
}
MOE = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine"}
MLA = {"mla.q", "mla.kv_down", "mla.up"}  # inside attn.qkv (mla.up in the prefill only)


@pytest.fixture(autouse=True)
def _no_launches():
    gemm.reset_launches()
    yield
    assert sum(gemm.LAUNCHES.values()) == 0, "a CPU tensor launched the CUDA kernel"


# ---------------------------------------------------------------------------
# the recorder alone
# ---------------------------------------------------------------------------


class _NoClock:
    @staticmethod
    def time_ns():
        raise AssertionError("the recorder read the clock while off")


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    monkeypatch.setattr(tracing, "time", _NoClock)
    assert tracing.active() is None
    assert tracing.span("a") is tracing.span("b", m=1)  # one shared no-op
    with tracing.span("a") as s:
        tracing.count("c", 5)
    assert s is None
    with tracing.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_off_allocates_nothing_per_span():
    def spans(n):
        for _ in range(n):
            with tracing.span("layer.attn"):
                tracing.count("gemm.routed_flops")

    spans(100)  # warm: interned names, the frame
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        spans(10_000)
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert current - base <= 0 and peak - base < 1024


def test_nesting_gives_parent_ids_and_recording_restores():
    with tracing.recording() as rec:
        with tracing.span("outer", batch=2):
            with tracing.span("inner"):
                tracing.count("n", 2)
            with tracing.span("sibling"):
                pass
        tracing.count("n")
    assert tracing.active() is None
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["inner", "sibling", "outer"]  # in order of ending
    assert by["outer"].parent is None and by["outer"].attrs == {"batch": 2}
    assert by["inner"].parent == by["outer"].id == by["sibling"].parent
    assert by["outer"].start_ns <= by["inner"].start_ns <= by["inner"].end_ns <= by["sibling"].start_ns
    assert by["sibling"].end_ns <= by["outer"].end_ns
    assert len({s.id for s in rec.spans}) == 3 and rec.counters == {"n": 3}
    assert {s.thread for s in rec.spans} == {threading.get_native_id()}


def test_threads_keep_separate_stacks():
    """Two threads open their spans in lockstep, each inside its own
    outer span: each inner span's parent is its own thread's outer one."""
    barrier = threading.Barrier(2, timeout=10)

    def work(tag):
        with tracing.span(f"{tag}.outer"):
            barrier.wait()
            with tracing.span(f"{tag}.inner"):
                barrier.wait()
                tracing.count("both")
            barrier.wait()

    with tracing.recording() as rec:
        threads = [threading.Thread(target=work, args=(tag,)) for tag in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    by = {s.name: s for s in rec.spans}
    for tag in ("a", "b"):
        outer, inner = by[f"{tag}.outer"], by[f"{tag}.inner"]
        assert inner.parent == outer.id and outer.parent is None and inner.thread == outer.thread
    assert by["a.outer"].thread != by["b.outer"].thread
    assert rec.counters == {"both": 2}


def test_the_recorder_never_touches_the_device():
    src = (ROOT / "src" / "repro_torch" / "tracing.py").read_text()
    for call in (".item(", ".tolist(", "synchronize", "Event(", "import torch"):
        assert call not in src


# ---------------------------------------------------------------------------
# the served path
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Served:
    outputs: list
    logits: list
    prefill_shapes: list
    dense: list  # (m, k, n) of each layers.dense product
    routed: list  # (m, k, n) of each product launched through ops.matmul
    experts: int  # operations of the MoE experts' batched products
    policy: object
    rec: tracing.Recording | None


def _serve(arch: str, monkeypatch, record: bool) -> Served:
    cfg = get_smoke_config(arch)
    params = lm.init_lm(0, cfg, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in LENGTHS]
    out = Served([], [], [], [], [], 0, None, None)
    real_prefill, real_decode, real_dense = lm.prefill, lm.decode_step, layers.dense
    real_matmul, real_moe = ops.matmul, moe.moe_ffn

    def prefill(params, cfg, tokens, cache, *a):
        out.prefill_shapes.append(tuple(tokens.shape))
        logits, cache = real_prefill(params, cfg, tokens, cache, *a)
        out.logits.append(logits.clone())
        return logits, cache

    def decode_step(params, cfg, cache, token):
        logits, cache = real_decode(params, cfg, cache, token)
        out.logits.append(logits.clone())
        return logits, cache

    def dense(p, x, **kw):
        out.dense.append((x.numel() // x.shape[-1], x.shape[-1], p["w"].shape[-1]))
        return real_dense(p, x, **kw)

    def matmul(x, w, cfg, bias=None):
        out.routed.append((x.numel() // x.shape[-1], x.shape[-1], w.shape[-1]))
        return real_matmul(x, w, cfg, bias)

    def moe_ffn(p, cfg, x):
        t = x.shape[0] * x.shape[1]
        out.experts += 3 * 2 * cfg.moe.n_experts * moe.capacity(cfg.moe, t) * cfg.d_model * cfg.moe.d_ff_expert
        return real_moe(p, cfg, x)

    for mod, name, fn in [(lm, "prefill", prefill), (lm, "decode_step", decode_step), (layers, "dense", dense),
                          (ops, "matmul", matmul), (moe, "moe_ffn", moe_ffn)]:
        monkeypatch.setattr(mod, name, fn)
    with pytest.warns(ReproDeprecationWarning):
        engine = ServingEngine(cfg, params, ServeConfig(batch=8, max_len=16, max_new_tokens=NEW))
    with scheduled_kernels(build_backend(make_gemmini_description())) as pol:
        if record:
            with tracing.recording() as out.rec:
                reqs = engine.generate(prompts)
        else:
            reqs = engine.generate(prompts)
    out.policy = pol
    out.outputs = [r.output for r in reqs]
    return out


@pytest.fixture(scope="module")
def served():
    runs = {}

    def get(arch, record=True):
        if (arch, record) not in runs:
            with pytest.MonkeyPatch.context() as mp:
                runs[arch, record] = _serve(arch, mp, record)
        return runs[arch, record]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_served_path_records_every_layers_spans(arch, served):
    cfg = get_smoke_config(arch)
    rec = served(arch).rec
    kinds = lm.layer_kinds(cfg)
    want = ENGINE | {"lm.prefill", "lm.decode_step", "lm.embed", "lm.head", "policy.solve"}
    for kind, is_moe in kinds:
        want |= {f"layer.{kind}"} | BLOCK[kind] | (MLA if kind == "attn" and cfg.kv_lora_rank else set())
        if is_moe:
            want |= {"layer.moe"} | MOE
        elif cfg.d_ff:
            want.add("layer.ffn")
    names = Counter(s.name for s in rec.spans)
    assert set(names) == want
    waves = -(-len(LENGTHS) // 8)
    assert names["lm.prefill"] == names["engine.wave"] == waves
    assert names["lm.decode_step"] == names["engine.readback"] == waves * NEW
    # each model call holds each of its layers' block span once, as its child
    by_id = {s.id: s for s in rec.spans}
    calls = [s for s in rec.spans if s.name in ("lm.prefill", "lm.decode_step")]
    per_call = Counter((s.parent, s.name) for s in rec.spans if s.name.startswith("layer.")
                       and by_id[s.parent].name.startswith("lm."))
    for call in calls:
        assert by_id[call.parent].name == "engine.wave"
        for kind, n in Counter(f"layer.{k}" for k, _ in kinds).items():
            assert per_call[call.id, kind] == n
        assert per_call[call.id, "layer.moe"] == sum(m for _, m in kinds)
    # every span ends inside its parent, on one thread
    for s in rec.spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert {s.thread for s in rec.spans} == {threading.get_native_id()}
    wave = [s for s in rec.spans if s.name == "engine.wave"][0]
    assert wave.attrs == {"batch": 8, "padded_len": max(LENGTHS[:8]), "prompt_tokens": sum(LENGTHS[:8])}


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"tracing_test_{name}", ROOT / "bench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_counters_give_the_benchmarks_pad_share(arch, served):
    run = served(arch)
    c = run.rec.counters
    assert c["engine.prompt_tokens"] == sum(LENGTHS)
    assert c["engine.padded_positions"] == sum(b * s for b, s in run.prefill_shapes)
    assert c["engine.decode_steps"] == len(run.prefill_shapes) * NEW
    bench = _reader("pad_share")({"prefill_shapes": run.prefill_shapes, "timed_prompt_tokens": sum(LENGTHS)})
    assert 100.0 * (1 - c["engine.prompt_tokens"] / c["engine.padded_positions"]) == pytest.approx(bench, abs=1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_product_counters_equal_the_shapes_arithmetic(arch, served):
    run = served(arch)
    c = run.rec.counters
    cfg = get_smoke_config(arch)
    calls = len(run.prefill_shapes) * (1 + NEW)  # model calls: a prefill and NEW decode steps a wave
    heads = calls if cfg.tie_embeddings else 0  # the tied head is x @ table.T, outside dense
    unembed = 2 * sum(b for b, _ in run.prefill_shapes) * (1 + NEW) * cfg.d_model * cfg.vocab if heads else 0
    total = sum(2 * m * k * n for m, k, n in run.dense) + run.experts + unembed
    assert c["gemm.routed_flops"] + c.get("gemm.unrouted_flops", 0) == total
    assert c["gemm.routed_flops"] == sum(2 * m * k * n for m, k, n in run.routed) > 0
    # one CoSA solve per product shape the policy first met
    assert c["policy.solves"] == len(run.policy._configs) == Counter(s.name for s in run.rec.spans)["policy.solve"]
    # one prefill attention a prefill and attention layer, on the plain
    # version: CPU tensors
    attn_layers = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    assert c.get("attn.plain_calls", 0) == len(run.prefill_shapes) * attn_layers
    # one scan a Mamba layer and model call, on the plain version: CPU
    # tensors
    mamba_layers = sum(cfg.layer_kind(i) == "mamba" for i in range(cfg.n_layers))
    assert c.get("mamba.plain_calls", 0) == calls * mamba_layers
    # one MLA decode attention an MLA layer and decode step, on the plain
    # version: CPU tensors
    mla_layers = attn_layers if cfg.kv_lora_rank else 0
    assert c.get("mla.plain_calls", 0) == len(run.prefill_shapes) * NEW * mla_layers
    # every (token, choice) pair of every MoE layer routed, all held here
    # (the smoke configurations hold every expert)
    moe_pairs = {"moe.pairs", "moe.held_pairs", "moe.dropped_pairs"} if cfg.moe else set()
    if cfg.moe:
        moe_layers = sum(m for _, m in lm.layer_kinds(cfg))
        positions = sum(b * s for b, s in run.prefill_shapes) + sum(b for b, _ in run.prefill_shapes) * NEW
        assert c["moe.pairs"] == c["moe.held_pairs"] == positions * cfg.moe.top_k * moe_layers
        assert 0 <= c["moe.dropped_pairs"] <= c["moe.held_pairs"]
    # and no counter beyond those the benchmark and these tests read
    unrouted = {"gemm.unrouted_flops"} if len(run.routed) < len(run.dense) or heads or run.experts else set()
    attn = {"attn.plain_calls"} if attn_layers else set()
    mamba = {"mamba.plain_calls"} if mamba_layers else set()
    mla = {"mla.plain_calls"} if mla_layers else set()
    assert set(c) == {"engine.prompt_tokens", "engine.padded_positions", "engine.decode_steps", "gemm.routed_flops",
                      "policy.solves"} | unrouted | attn | mamba | mla | moe_pairs


@pytest.mark.parametrize("arch", ARCHS)
def test_a_recorded_prefill_counts_one_scan_a_mamba_layer(arch):
    """``mamba.kernel_calls`` or ``mamba.plain_calls`` once per Mamba layer
    of a prefill (the plain version here: CPU tensors), and neither where
    the model has no Mamba layer."""
    cfg = get_smoke_config(arch)
    params = lm.init_lm(0, cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, size=(2, 6)).astype(np.int64))
    with torch.inference_mode(), tracing.recording() as rec:
        lm.prefill(params, cfg, tokens, lm.init_cache(cfg, 2, 8, device="cpu"))
    mamba_layers = sum(cfg.layer_kind(i) == "mamba" for i in range(cfg.n_layers))
    counts = {k: v for k, v in rec.counters.items() if k.startswith("mamba.")}
    assert counts == ({"mamba.plain_calls": mamba_layers} if mamba_layers else {})
    assert sum(s.name == "mamba.scan" for s in rec.spans) == mamba_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_recording_changes_no_token_and_no_logit(arch, served):
    on, off = served(arch, True), served(arch, False)
    assert off.rec is None and on.outputs == off.outputs
    assert len(on.logits) == len(off.logits) == 2 * (1 + NEW)
    for a, b in zip(on.logits, off.logits, strict=True):
        assert torch.equal(a, b)
