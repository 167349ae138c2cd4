"""The port's wave-based LM server (``repro_torch.serve.ServingEngine`` and
``python -m repro_torch.launch.serve --arch``) against the reference's.

Both engines serve the same prompts (drawn with numpy from a seed, of
different lengths, so waves are left-padded) with the same parameters
(the reference's ``init_lm``, converted).  Greedy tokens must be equal.
The two packages' logits agree to 1e-4 (``tests/test_torch_models.py``),
so equal tokens are only guaranteed where the top two logits of a step
are further apart than that: the test records every step's logits and
asserts that each compared step's margin exceeds the tolerance.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core.deprecation import ReproDeprecationWarning as RefDeprecationWarning
from repro.models import lm as ref_lm
from repro.serve import engine as ref_engine
from repro_torch.configs import get_smoke_config
from repro_torch.core.deprecation import ReproDeprecationWarning
from repro_torch.kernels import gemm
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.serve import ServeConfig, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_launches():
    gemm.reset_launches()
    yield
    assert sum(gemm.LAUNCHES.values()) == 0, "a CPU tensor launched the CUDA kernel"


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("arch", ["yi_34b", "granite_34b"])
def test_greedy_tokens_match_the_reference_engine(arch, monkeypatch):
    """Two waves of batch 2 (the second holds one prompt and one padding
    row), prompts of 5, 8 and 3 tokens, 4 new tokens each."""
    ref_cfg, cfg = ref_get_smoke_config(arch), get_smoke_config(arch)
    ref_params = ref_lm.init_lm(jax.random.key(0), ref_cfg)
    params = lm.params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    scfg = dict(batch=2, max_len=16, max_new_tokens=4)
    prompts = _prompts(cfg, (5, 8, 3))

    with pytest.warns(RefDeprecationWarning):
        ref = ref_engine.ServingEngine(ref_cfg, ref_params, ref_engine.ServeConfig(**scfg))
    want = ref.generate(prompts)

    steps = []  # every prefill / decode step's logits, in order
    for name in ("prefill", "decode_step"):
        real = getattr(lm, name)

        def recording(*a, _real=real, **kw):
            logits, c = _real(*a, **kw)
            steps.append(logits[:, -1].clone())
            return logits, c

        monkeypatch.setattr(lm, name, recording)
    with pytest.warns(ReproDeprecationWarning):
        engine = ServingEngine(cfg, params, ServeConfig(**scfg))
    got = engine.generate(prompts)

    assert [r.rid for r in got] == [r.rid for r in want] == [0, 1, 2]
    assert all(r.done for r in got)
    for g, w in zip(got, want):
        assert g.output == w.output and len(g.output) == 4
    # per wave: the prefill and 4 decode steps; the last step's logits
    # pick no output token
    assert len(steps) == 2 * 5
    for wave, rows in ((0, (0, 1)), (1, (0,))):
        for logits in steps[wave * 5 : wave * 5 + 4]:
            top2 = torch.topk(logits[list(rows)], 2, dim=-1).values
            assert bool(((top2[:, 0] - top2[:, 1]) > TOL).all())


def test_temperature_sampling_is_seeded_by_the_step():
    cfg = get_smoke_config("codeqwen1_5_7b")
    params = lm.init_lm(0, cfg, device="cpu")
    prompts = _prompts(cfg, (6, 6))
    runs = []
    for _ in range(2):
        with pytest.warns(ReproDeprecationWarning):
            engine = ServingEngine(cfg, params, ServeConfig(batch=2, max_len=12, max_new_tokens=5, temperature=1.0))
        runs.append([r.output for r in engine.generate(prompts)])
    assert runs[0] == runs[1]
    assert all(0 <= t < cfg.vocab for out in runs[0] for t in out)
    with pytest.warns(ReproDeprecationWarning):
        greedy = ServingEngine(cfg, params, ServeConfig(batch=2, max_len=12, max_new_tokens=5))
    assert [r.output for r in greedy.generate(prompts)] != runs[0]


def test_engine_serves_on_the_params_device_and_refuses_other_families():
    cfg = get_smoke_config("qwen1_5_32b")
    with pytest.warns(ReproDeprecationWarning):
        engine = ServingEngine(cfg, lm.init_lm(0, cfg, device="cpu"), ServeConfig(batch=1, max_len=8))
    assert engine.device == torch.device("cpu")
    with pytest.warns(ReproDeprecationWarning), pytest.raises(NotImplementedError, match="Queue A item 5"):
        ServingEngine(get_smoke_config("mixtral_8x7b"), {}, ServeConfig())


def test_serve_lm_returns_what_it_served(capsys):
    args = serve.build_parser().parse_args(
        ["--arch", "granite-34b", "--smoke", "--device", "cpu", "--requests", "3",
         "--batch", "2", "--prompt-len", "6", "--new-tokens", "3"]
    )
    with pytest.warns(ReproDeprecationWarning):
        result = serve.serve_lm(args)
    assert result.cfg.name == "granite-34b" and result.cfg.n_layers == 2
    assert [len(r.output) for r in result.requests] == [3, 3, 3]
    assert result.tokens_per_s > 0
    out = capsys.readouterr().out
    assert "[serve] granite-34b on cpu: 3 requests, 9 tokens" in out


def test_serve_cli_arch_smoke_runs_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "codeqwen1_5_7b",
         "--smoke", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "[serve] codeqwen1.5-7b on cpu: 16 requests, 256 tokens" in proc.stdout


def test_serve_cli_arch_defaults_to_the_card():
    assert serve.build_parser().parse_args(["--arch", "yi_34b"]).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        serve.main(["--arch", "yi_34b", "--smoke", "--requests", "1"])
