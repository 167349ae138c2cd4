"""The harness loads neither JAX nor the JAX package (``repro``), and reads
nothing under ``benchmarks/``.  Checked in a fresh interpreter: pytest's
settings of the package tests import ``repro`` into the test process."""

import subprocess
import sys

from helpers import ROOT

SCRIPT = r"""
import sys
root = sys.argv[1]
read = []

def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes)):
        path = args[0].decode() if isinstance(args[0], bytes) else args[0]
        if path.startswith(root + "/benchmarks"):
            read.append(path)

sys.addaudithook(hook)
sys.path[:0] = [root + "/bench", root + "/src"]
import pathlib
import run, harness, correct, control, devtrace, hopper, lmshapes, traffic
from reference import plain
import repro_torch.serve, repro_torch.kernels.policy, repro_torch.core.configurators
import repro_torch.core.descriptions, repro_torch.models.lm, repro_torch.kernels.ops
bench = pathlib.Path(root, "bench")
for kind in ("configs", "reference", "metrics"):
    for path in sorted((bench / kind).glob("*.py")):
        harness.load_module(path, "check_" + kind + "_" + path.stem.replace(".", "_").replace("-", "_"))
top = {name.split(".")[0] for name in sys.modules}
bad = sorted(top & {"jax", "jaxlib", "flax", "repro"})
files = [m.__file__ for m in list(sys.modules.values()) if getattr(m, "__file__", None)]
under = [f for f in files if f.startswith(root + "/benchmarks")]
print("loaded:", bad, "read:", read + under)
sys.exit(1 if bad or read or under else 0)
"""


def test_harness_imports_no_jax_and_reads_no_benchmarks():
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr



def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    import run

    for name in ("repro_torch", "repro_torch.models", "reproducible", "jax_extra"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(run.forbidden_modules()) & {"repro", "jax"}
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()
