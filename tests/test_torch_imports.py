"""The port stands alone and runs where its target says.

``repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor ``repro``;
``Target()`` defaults to the card and a CUDA target without one fails at
compile time instead of running on the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = [
        m for m in _imported_modules(path)
        if m.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert not bad, f"{path.name} imports {bad}"


def test_port_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "m = repro_torch.compile('mlp_tiny', repro_torch.Target('gemmini', device='cpu'))\n"
        "from repro_torch.core import zoo\n"
        "out = m.run(zoo.get_model('mlp_tiny').feeds(0))[0]\n"
        "assert out.shape == (1, 16) and str(out.dtype) == 'int8'\n"
        "print('ok', m.modeled_cycles()['total'])\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok 2624.0")


def test_target_defaults_to_the_card():
    target = repro_torch.Target("gemmini")
    assert target.device == "cuda"
    assert target.mode == "optimized" and target.use_mip is True


def test_mip_request_is_refused_where_the_reference_would_solve_it(monkeypatch):
    """With pulp importable the reference solves the MIP; the port has none,
    so it refuses ``use_mip=True`` instead of answering with the heuristic."""
    import importlib.util

    real_find_spec = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: object() if name == "pulp" else real_find_spec(name, *a),
    )
    with pytest.raises(NotImplementedError, match="use_mip=False"):
        repro_torch.compile("mlp_tiny", repro_torch.Target("gemmini", device="cpu"))
    module = repro_torch.compile(
        "mlp_tiny", repro_torch.Target("gemmini", use_mip=False, device="cpu")
    )
    assert module.modeled_cycles()["total"] == 2624.0


def test_cuda_target_without_a_card_raises_at_compile_time():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default target compiles")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        repro_torch.compile("mlp_tiny", repro_torch.Target("gemmini"))


def test_target_lists_every_problem():
    with pytest.raises(repro_torch.TargetError) as e:
        repro_torch.Target("nope", mode="fastest", device="tpu")
    assert len(e.value.problems) == 3
    msg = str(e.value)
    assert "unknown accelerator 'nope'" in msg and "unknown mode 'fastest'" in msg
    assert "device" in msg
    with pytest.raises(TypeError, match="Target"):
        repro_torch.compile("mlp_tiny", "gemmini:optimized")


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """The smoke script fails, and prints no result, without a card — and
    in a directory that holds nothing else of the repo."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    scripts = [lone] if torch.cuda.is_available() else [ROOT / "chip_smoke.py", lone]
    for script in scripts:
        proc = subprocess.run(
            [sys.executable, str(script)], capture_output=True, text=True,
            env=env, cwd=script.parent, timeout=120,
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
