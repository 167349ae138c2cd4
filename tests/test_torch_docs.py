"""The port's docs stay runnable: every Python block of
``docs/torch/integration_guide.md`` and ``docs/torch/architecture.md`` runs,
in order, in one namespace, with the guide's one device line set to the
CPU.  (``chip_smoke.py`` runs the same blocks on the card.)
"""

import re
from pathlib import Path

import pytest

from repro_torch.kernels import gemm

ROOT = Path(__file__).resolve().parents[1]
DOCS = ROOT / "docs" / "torch"
BLOCK = re.compile(r"^```python\n(.*?)^```", re.MULTILINE | re.DOTALL)
DEVICE_LINE = 'device = "cuda"\n'


def python_blocks(path: Path) -> list[str]:
    return BLOCK.findall(path.read_text())


def test_the_guide_names_its_device_once_at_the_top():
    blocks = python_blocks(DOCS / "integration_guide.md")
    assert blocks[0] == DEVICE_LINE
    assert not any("device = " in b for b in blocks[1:])
    assert not any(re.search(r"^\s*(import|from)\s+(repro|jax)\b", b, re.MULTILINE) for b in blocks)
    assert len(blocks) >= 17  # one for each of the reference guide's Python blocks


@pytest.mark.parametrize("doc", ["integration_guide.md", "architecture.md"])
def test_doc_python_blocks_run_on_the_cpu(doc, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.chdir(tmp_path)
    blocks = python_blocks(DOCS / doc)
    if blocks and blocks[0] == DEVICE_LINE:
        blocks = blocks[1:]
    namespace = {"__name__": f"docs_{doc}", "device": "cpu"}
    gemm.reset_launches()
    for i, block in enumerate(blocks):
        code = compile(block, f"{doc} block {i + 1}", "exec")
        exec(code, namespace)
    assert sum(gemm.LAUNCHES.values()) == 0
