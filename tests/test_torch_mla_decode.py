"""MLA's absorbed decode attention (``repro_torch.kernels.mla``): the rule
that picks the kernel, the plain version the rule takes elsewhere, and the
kernel.

On the CPU: ``models.attention.mla_decode_kernel_refusal``'s answer and
reason for an f32 cache, f32 compute, a CPU tensor, a DTensor latent and
an unsupported (r, dr); the decode step of the registry's deepseek-v2 (its
smoke config) giving the same bits as the arithmetic it ran before the
kernel, with ``mla.plain_calls`` counted once a layer; the plain version
against a dense softmax; and the launch counts a CUDA graph's replays add.
Tests marked ``cuda`` hold the kernel to the plain version on the card at
deepseek-longdoc's layer, check that positions past the length are never
read into the result, replay one captured graph at several lengths, and
count the launches of a captured decode step on each replay:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mla_decode.py

This file imports no JAX, so the card collects it.
"""

import functools
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import build
from repro_torch.kernels import mla as KM
from repro_torch.models import attention as A
from repro_torch.models import lm
from repro_torch.parallel.policy import gather_fsdp

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
#: the benchmark's DeepSeek-V2 configuration (deepseek-longdoc's)
NAME = "deepseek-v2-236b.12l.ep8"
#: deepseek-longdoc's layer: batch, heads, latent width, rope dims, the cache's rows
LONGDOC = (4, 128, 512, 64, 16384 + 64)
#: the lengths held to the plain version: one position, around a tile's
#: edge, past half the cache, the whole cache
LENGTHS = (1, 63, 64, 65, 8193, 16448)


def _deepseek(**over):
    return get_smoke_config("deepseek_v2_236b").with_(**over)


def _latent(cfg, b=2, s=8, device="cpu", dtype=None):
    dtype = dtype or (torch.bfloat16 if cfg.kv_cache_dtype != "float32" else torch.float32)
    return torch.zeros(b, s, cfg.kv_lora_rank, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# the rule and the plain version (the CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "over, device, reason",
    [
        (dict(kv_cache_dtype="float32", compute_dtype="bfloat16"), "cpu", "torch.float32 cache"),
        (dict(compute_dtype="float32"), "cpu", "compute in torch.float32"),
        (dict(compute_dtype="bfloat16", kv_lora_rank=512, qk_rope_dim=64), "cpu", "on cpu"),
        (dict(compute_dtype="bfloat16", kv_lora_rank=512, qk_rope_dim=64), "meta", "on meta"),
        (dict(compute_dtype="bfloat16", kv_lora_rank=512, qk_rope_dim=32), "cpu", r"\(r, dr\) = \(512, 32\)"),
        (dict(compute_dtype="bfloat16", kv_lora_rank=256, qk_rope_dim=64), "cpu", r"\(r, dr\) = \(256, 64\)"),
    ],
)
def test_the_rule_refuses_with_its_reason(over, device, reason):
    cfg = _deepseek(**over)
    refusal = A.mla_decode_kernel_refusal(cfg, _latent(cfg, device=device))
    assert refusal is not None and re.search(reason, refusal)


def test_the_rule_takes_a_bf16_cache_at_deepseeks_widths_only_on_cuda():
    cfg = _deepseek(compute_dtype="bfloat16", kv_lora_rank=512, qk_rope_dim=64)
    assert A.mla_decode_kernel_refusal(cfg, _latent(cfg)) == "on cpu: the kernel runs on CUDA tensors"
    # the cache alone decides the rest: the same rule the wrapper asks
    assert KM.cache_refusal(_latent(cfg, dtype=torch.bfloat16), 64) == "on cpu: the kernel runs on CUDA tensors"


_DTENSOR_RULE = """
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as A
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
cfg = get_smoke_config("deepseek_v2_236b").with_(compute_dtype="bfloat16", kv_lora_rank=512, qk_rope_dim=64)
latent = distribute_tensor(torch.zeros(2, 8, 512, dtype=torch.bfloat16), mesh, [Replicate(), Shard(1)])
print(A.mla_decode_kernel_refusal(cfg, latent))
"""


def test_the_rule_refuses_a_dtensor_latent():
    """A sequence-parallel latent (a DTensor, on a fake two-rank group in a
    fresh process) keeps the plain split arithmetic and its all-reduces."""
    out = subprocess.run([sys.executable, "-c", _DTENSOR_RULE], capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().startswith("a DTensor latent")


def _decode_before(params, cfg, q_nope, q_rope, latent_cache, k_rope_cache, cur_len: int):
    """``mla_decode_attention`` as the decode step ran it before the
    kernel (an unsplit cache): everything in f32 over every position, the
    length a host int."""
    b, h, _, dh = q_nope.shape
    r = cfg.kv_lora_rank
    f32 = torch.float32
    w_ku = gather_fsdp(params["k_up"]["w"]).reshape(r, h, dh).to(f32)
    w_vu = gather_fsdp(params["v_up"]["w"]).reshape(r, h, dh).to(f32)
    scale = A.softmax_scale(cfg)
    latent = latent_cache.to(f32)
    q_lat = torch.einsum("bhqd,rhd->bhqr", q_nope.to(f32).contiguous(), w_ku.contiguous())
    latent, q_lat = latent.to(f32).contiguous(), q_lat.contiguous()
    logits = torch.einsum("bhqr,bsr->bhqs", q_lat, latent)
    logits = logits + torch.einsum("bhqd,bsd->bhqs", q_rope.to(f32).contiguous(), k_rope_cache.to(f32).contiguous())
    logits = logits * scale
    pos = torch.arange(latent.shape[1])
    logits = torch.where(pos[None, None, None, :] < cur_len, logits, -1e30)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    ctx_lat = torch.einsum("bhqs,bsr->bhqr", p, latent) / p.sum(-1, keepdim=True)
    return torch.einsum("bhqr,rhd->bhqd", ctx_lat.contiguous(), w_vu.contiguous()).to(q_nope.dtype)


def _greedy_steps(cfg, params, tokens, steps: int):
    cache = lm.init_cache(cfg, tokens.shape[0], tokens.shape[1] + steps, device="cpu")
    with torch.inference_mode():
        logits, cache = lm.prefill(params, cfg, tokens, cache)
        out = []
        for _ in range(steps):
            logits, cache = lm.decode_step(params, cfg, cache, logits[:, -1:].argmax(-1))
            out.append(logits)
    return out


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float32"])
def test_the_plain_path_gives_the_bits_it_gave_before(monkeypatch, kv_dtype):
    """The registry's deepseek-v2 (smoke widths, f32 compute) on the CPU:
    every decode step's logits bit-equal to the arithmetic before the
    kernel, and one ``mla.plain_calls`` a layer and step."""
    cfg = _deepseek(kv_cache_dtype=kv_dtype)
    params = lm.init_lm(5, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (3, 11), generator=torch.Generator().manual_seed(6))
    with tracing.recording() as rec:
        got = _greedy_steps(cfg, params, tokens, 4)
    assert rec.counters.get("mla.plain_calls") == 4 * cfg.n_layers
    assert not rec.counters.get("mla.kernel_calls")

    def before(params, cfg, q_nope, q_rope, latent, k_rope, length):
        return _decode_before(params, cfg, q_nope, q_rope, latent, k_rope, int(length))

    monkeypatch.setattr(A, "mla_decode_attention", before)
    want = _greedy_steps(cfg, params, tokens, 4)
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))


def _dense(q_lat, q_rope, latent, k_rope, length: int, scale: float):
    """The softmax-weighted latent in float64, over the first ``length``
    positions only, and each output's sum of weights times |latent|."""
    q, qr, c, kr = (t.double() for t in (q_lat[:, :, 0], q_rope[:, :, 0], latent[:, :length], k_rope[:, :length]))
    p = torch.softmax(scale * (torch.einsum("bhr,bsr->bhs", q, c) + torch.einsum("bhd,bsd->bhs", qr, kr)), -1)
    return torch.einsum("bhs,bsr->bhr", p, c)[:, :, None], torch.einsum("bhs,bsr->bhr", p, c.abs())[:, :, None]


def _inputs(b, h, r, dr, s_max, *, seed=0, device="cpu"):
    """q_lat, q_rope [B, H, 1, d] and the latent [B, S_max, r], k_rope
    [B, S_max, dr] caches in bf16, drawn as the step makes them: the
    latent after its RMSNorm (unit scale), q_lat through k_up."""
    gen = torch.Generator().manual_seed(seed)
    q_lat = 0.05 * torch.randn(b, h, 1, r, generator=gen)
    q_rope = torch.randn(b, h, 1, dr, generator=gen)
    latent = torch.randn(b, s_max, r, generator=gen)
    k_rope = torch.randn(b, s_max, dr, generator=gen)
    return tuple(t.to(torch.bfloat16).to(device) for t in (q_lat, q_rope, latent, k_rope))


@pytest.mark.parametrize("length", [1, 5, 13, 16])
def test_the_plain_version_is_the_softmax_over_the_length(length):
    args = _inputs(2, 3, 32, 8, 16, seed=length)
    got = KM.mla_decode(*args, torch.tensor([length]), scale=0.2)
    want, _ = _dense(*args, length, 0.2)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 1, 32)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6)


def test_a_replay_adds_what_its_capture_counted():
    build.reset_launches()
    counted = {"mla_decode": 3, "mla_decode_combine": 3}
    build.add_launches(counted)
    build.add_launches(counted, 2)
    assert {k: build.launches()[k] for k in counted} == {"mla_decode": 9, "mla_decode_combine": 9}
    build.add_launches(counted, -3)
    assert not any(build.launches().values())


# ---------------------------------------------------------------------------
# the kernel (the card)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the MLA decode kernel runs only there")
    return torch.device("cuda", 0)


@functools.cache
def _longdoc(device):
    return _inputs(*LONGDOC, seed=1, device=device)


@functools.cache
def _bench_config():
    """(the configuration module, the published spec) of ``NAME``."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    spec = importlib.util.spec_from_file_location("test_mla_bench_config", BENCH / "configs" / f"{NAME}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, json.loads((BENCH / "configs" / f"{NAME}.json").read_text())


def _scale():
    """deepseek-longdoc's softmax scale (YaRN's mscale squared over 192^1/2)."""
    mod, published = _bench_config()
    return A.softmax_scale(mod.model_config(published))


def _length(n, device):
    return torch.tensor([n], dtype=torch.int64, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("length", LENGTHS)
def test_the_kernel_matches_the_plain_version_at_longdocs_layer(card, length):
    """The kernel against the plain version on the same bf16 tensors, both
    against a float64 softmax over the first ``length`` positions.  The
    kernel rounds each weight to bf16 for the value product (at most
    2^-9 of it), so each output may move by 2^-9 of its weights times
    |latent|; the tolerance is twice that, for the f32 sums' order and
    the exp2 on the multi-function unit."""
    args = _longdoc(card)
    scale = _scale()
    before = KM.LAUNCHES["mla_decode"]
    got = KM.mla_decode(*args, _length(length, card), scale=scale)
    torch.cuda.synchronize()
    assert KM.LAUNCHES["mla_decode"] == before + 1
    want, weight = _dense(*args, length, scale)
    plain = KM.mla_decode_plain(*args, length, scale=scale)
    tol = 2.0**-8 * weight + 1e-6
    assert ((got.double() - want).abs() <= tol).all()
    assert ((plain.double() - want).abs() <= 1e-4 * weight + 1e-6).all()


@pytest.mark.cuda
def test_positions_past_the_length_are_never_read(card):
    args = _longdoc(card)
    scale = _scale()
    for length in (65, 8193):
        want = KM.mla_decode(*args, _length(length, card), scale=scale)
        q_lat, q_rope, latent, k_rope = (t.clone() for t in args)
        latent[:, length:] = float("nan")
        k_rope[:, length:] = float("nan")
        got = KM.mla_decode(q_lat, q_rope, latent, k_rope, _length(length, card), scale=scale)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_one_captured_graph_replays_at_any_length(card):
    args = _longdoc(card)
    scale = _scale()
    length = _length(1, card)
    KM.mla_decode(*args, length, scale=scale)  # the build and the first launch outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = KM.mla_decode(*args, length, scale=scale)
    for n in (16448, 777, 64):
        length.fill_(n)
        graph.replay()
        assert torch.equal(out, KM.mla_decode(*args, _length(n, card), scale=scale))


def _mla_spec_cfg():
    """The benchmark's DeepSeek-V2 at small widths in bf16, its latent the
    kernel's (r 512, dr 64): d 64, 4 heads of 16, 3 layers (the first
    dense), 8 of 16 experts in 4 groups, top-3."""
    mod, published = _bench_config()
    spec = dict(published)
    spec.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4, qk_nope_head_dim=16, v_head_dim=16,
                qk_rope_head_dim=64, q_lora_rank=32, kv_lora_rank=512, intermediate_size=96, moe_intermediate_size=32,
                n_shared_experts=1, router_experts=16, n_routed_experts=8, first_expert=0, n_group=4, topk_group=2,
                num_experts_per_tok=3, num_hidden_layers=3, vocab_size=256, attn_chunk=16, param_dtype="bfloat16",
                compute_dtype="bfloat16", kv_cache_dtype="bfloat16")
    return mod.model_config(spec)


@pytest.mark.cuda
def test_a_captured_step_counts_its_launches_on_each_replay(card):
    """A cache made with ``graphs=True``: the first step runs once eagerly
    (its launches counted) and captures, which counts nothing; each
    replay counts one launch of the kernel and its combine a layer.  The
    replayed steps give the eager steps' bits, and an eager step records
    one ``mla.kernel_calls`` a layer and no plain call."""
    cfg = _mla_spec_cfg()
    params = lm.init_lm(3, cfg, device=card)
    tokens = torch.randint(0, cfg.vocab, (4, 40), generator=torch.Generator().manual_seed(9)).to(card)
    steps = {}
    with torch.inference_mode():
        for graphs in (False, True):
            cache = lm.init_cache(cfg, 4, 48, device=card, graphs=graphs)
            logits, cache = lm.prefill(params, cfg, tokens, cache)
            out, counts = [], []
            for _ in range(4):
                build.reset_launches()
                if graphs:
                    logits, cache = lm.decode_step(params, cfg, cache, logits[:, -1:].argmax(-1))
                else:
                    with tracing.recording() as rec:
                        logits, cache = lm.decode_step(params, cfg, cache, logits[:, -1:].argmax(-1))
                    assert rec.counters.get("mla.kernel_calls") == cfg.n_layers
                    assert not rec.counters.get("mla.plain_calls")
                torch.cuda.synchronize()
                out.append(logits.clone())
                counts.append((build.launches()["mla_decode"], build.launches()["mla_decode_combine"]))
            steps[graphs] = (out, counts)
            assert (cache.get("graphs") is not None) == graphs
    n = cfg.n_layers
    assert steps[False][1] == [(n, n)] * 4
    assert steps[True][1] == [(2 * n, 2 * n)] + [(n, n)] * 3  # the capture's eager step, then replays
    assert cache["graphs"].launches == {"mla_decode": n, "mla_decode_combine": n}
    assert all(torch.equal(a, b) for a, b in zip(steps[False][0], steps[True][0], strict=True))
