"""The port's five example scripts (``examples/torch/``) held to the
reference's (``examples/``).

Each port script computes its results in a ``run(device=...)`` function,
called here with ``device="cpu"``:

* quickstart: its traced ``qdense`` compiles to the same post-pass ops,
  outputs and modeled cycles as ``repro.compile`` of the equal golden
  graph in every mode (the reference's own script traces a jnp function,
  which the installed jax cannot import);
* integrate_accelerator: EdgeMM's modeled cycles equal the reference
  example's in every mode, its outputs are bit-equal to the reference's
  graph interpreter on both routes, and on the emulated route its ``mma``
  intrinsic is called as often per run as the reference's;
* serve_zoo: the planned run is bit-equal to the interpreter and to the
  reference's golden graph;
* serve_lm: greedy tokens equal the reference engine's on the same
  weights;
* train_lm: a run killed part-way resumes from its checkpoint to the same
  losses, bit for bit, as a run never killed, and leaves no process group
  behind.

Each script also runs as ``python examples/torch/<x>.py --device cpu`` in
a process where ``jax`` and ``repro`` cannot be imported.
"""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core import ir as ref_ir
from repro.core import zoo as ref_zoo
from repro.core.deprecation import ReproDeprecationWarning as RefDeprecationWarning
from repro.models import lm as ref_lm
from repro.serve import engine as ref_engine
from repro_torch.core.deprecation import ReproDeprecationWarning
from repro_torch.kernels import gemm
from repro_torch.models import lm

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "torch"
MODES = ("optimized", "baseline", "naive")


def _load(path: Path, name: str):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def example(name: str):
    return _load(EXAMPLES / f"{name}.py", f"torch_example_{name}")


def reference_example(name: str):
    return _load(ROOT / "examples" / f"{name}.py", f"reference_example_{name}")


@pytest.fixture(autouse=True)
def _no_launches():
    gemm.reset_launches()
    yield
    assert sum(gemm.LAUNCHES.values()) == 0, "a CPU tensor launched the CUDA kernel"


def assert_bit_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- quickstart ---------------------------------------------------------------------


def quickstart_golden(params):
    """The reference IR of the quickstart's ``qdense``."""
    x = ref_ir.input_((8, 256), "int8", name="x")
    w_q = ref_ir.quantize(ref_ir.transpose(ref_ir.const(params["w"]), (1, 0)), scale=0.03125)
    d = ref_ir.bias_add(ref_ir.dense(x, w_q), ref_ir.const(params["b"]))
    return ref_ir.Graph([ref_ir.clip(ref_ir.requantize(d, scale=0.125), lo=-128, hi=127)], name="qdense")


def test_quickstart_matches_the_reference_golden_graph():
    qs = example("quickstart")
    result = qs.run("cpu")
    params, x = qs.make_params(), qs.make_input()
    want_ref = ref_ir.execute_graph(quickstart_golden(params), {"x": x})[0]
    assert_bit_equal(result["reference"], want_ref)
    for spec in qs.SPECS:
        mode = spec.split(":")[1]
        want = repro.compile(quickstart_golden(params), repro.Target("gemmini", mode=mode, cache=False))
        assert_bit_equal(result["outputs"][spec], want.run({"x": x})[0])
        assert_bit_equal(result["outputs"][spec], want_ref)
        assert result["cycles"][spec] == want.modeled_cycles()
        assert result["ops"][spec] == [n.op for n in want.graph.toposort()]
    assert result["modules"]["gemmini:optimized"].input_signature() == (("x", (8, 256), "int8"),)


def test_quickstart_prints_the_reference_lines(capsys):
    example("quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("exact=True") == 3 and "device=cpu" in out
    assert "optimization report for 'qdense'" in out and "schedule for generalized_dense" in out


# -- integrate_accelerator (EdgeMM) -------------------------------------------------


def _count_mma(desc, fn_name="edgemm.mma"):
    calls = [0]
    intr = desc.intrinsics[fn_name]

    def counted(a, b, acc, _fn=intr.fn):
        calls[0] += 1
        return _fn(a, b, acc)

    intr.fn = counted
    return desc, calls


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel", "emulated"])
def test_edgemm_matches_the_reference_example(use_pallas):
    ref_ex = reference_example("integrate_accelerator")
    ex = example("integrate_accelerator")
    x = ex.make_input()
    ref_desc, ref_calls = _count_mma(ref_ex.make_edgemm())
    port_desc, port_calls = _count_mma(ex.make_edgemm())
    result = ex.run("cpu", use_pallas=use_pallas, accelerator=port_desc)
    want_out = ref_ir.execute_graph(ref_ex.build_graph(np.random.default_rng(0)), {"x": x})[0]
    assert_bit_equal(result["reference"], want_out)
    assert result["warm"] == (0, 1)
    for mode in MODES:
        want = repro.compile(
            ref_ex.build_graph(np.random.default_rng(0)), repro.Target(ref_desc, mode=mode, cache=False),
            options=repro.CompileOptions(fresh_backend=True),
        )
        assert result["cycles"][mode] == want.modeled_cycles()["total"]
        assert_bit_equal(result["outputs"][mode], want_out)
        module = result["modules"][mode]
        assert module.backend.use_pallas is use_pallas
        ref_calls[0] = port_calls[0] = 0
        assert_bit_equal(module.run({"x": x})[0], want.run({"x": x})[0])
        if not use_pallas:
            assert port_calls[0] == ref_calls[0] > 0
        else:
            assert port_calls[0] == 0
    assert result["schedules"].keys() and all(
        s["dataflow"] == "WS" for s in result["schedules"].values()
    )


def test_edgemm_registers_once_and_is_a_target_by_name(capsys):
    """Loading the example twice keeps one registration (``exist_ok``);
    the name compiles like any in-tree accelerator."""
    import repro_torch

    ex = example("integrate_accelerator")
    again = _load(EXAMPLES / "integrate_accelerator.py", "torch_example_integrate_accelerator_again")
    assert "edgemm" in repro_torch.REGISTRY.names()
    assert repro_torch.REGISTRY.get("edgemm").fingerprint() == again.make_edgemm().fingerprint()
    ex.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("match vs reference: True") == 6
    assert out.count("warm recompile: scheduler sweeps=0, cache hits=1") == 2


# -- serve_zoo ----------------------------------------------------------------------


@pytest.mark.parametrize("name,target", [("mlp_tiny", "gemmini:optimized"), ("qcnn", "edge_npu:baseline")])
def test_serve_zoo_planned_equals_the_interpreter_and_the_reference(name, target):
    r = example("serve_zoo").run(name, target, device="cpu", requests=8)
    acc, mode = target.split(":")
    want = repro.compile(ref_zoo.get_model(name).build(), repro.Target(acc, mode=mode, cache=False))
    assert r["module"].modeled_cycles() == want.modeled_cycles()
    for seed, (p, i) in enumerate(zip(r["planned"], r["interpreted"])):
        assert_bit_equal(p[0], i[0])
        assert_bit_equal(p[0], want.run(ref_zoo.get_model(name).feeds(seed=seed))[0])


def test_serve_zoo_prints_the_plan(capsys):
    example("serve_zoo").main(["mlp_tiny", "--device", "cpu", "--requests", "4"])
    out = capsys.readouterr().out
    assert "model=mlp_tiny" in out and "plan: 8 steps" in out and "4 requests: planned" in out
    assert "'total': 2624.0" in out


# -- serve_lm -----------------------------------------------------------------------


def test_serve_lm_greedy_tokens_equal_the_reference_engine():
    ex = example("serve_lm")
    cfg = ex.config()
    ref_cfg = ref_get_smoke_config("musicgen_medium").with_(frontend=None, n_frontend_tokens=0)
    ref_params = ref_lm.init_lm(jax.random.key(0), ref_cfg)
    params = lm.params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    kw = dict(requests=4, batch=2, prompt_len=8, new_tokens=4)
    with pytest.warns(ReproDeprecationWarning):
        got = ex.run("cpu", params=params, **kw)
    with pytest.warns(RefDeprecationWarning):
        engine = ref_engine.ServingEngine(ref_cfg, ref_params, ref_engine.ServeConfig(
            batch=2, max_len=8 + 4 + 1, max_new_tokens=4))
    want = engine.generate(ex.prompts(cfg, 4, 8))
    assert [r.output for r in got["done"]] == [r.output for r in want]
    assert all(len(r.output) == 4 and r.done for r in got["done"])
    assert got["again"][0].output == got["done"][0].output


# -- train_lm -----------------------------------------------------------------------


class Killed(Exception):
    """Ends a training run part-way, as a kill would."""


def killing(build_trainer, kill_at: int, built: list):
    """``build_trainer`` whose trainer stops before its step ``kill_at``:
    the trainer fetches each step's batch outside its retry block, so the
    exception ends the run.  Each trainer built is appended to ``built``."""

    def build(*args, **kwargs):
        trainer, state, cfg = build_trainer(*args, **kwargs)
        batch_at = trainer.pipeline.batch_at

        def batch_or_kill(step):
            if step == kill_at:
                raise Killed(f"killed before step {step}")
            return batch_at(step)

        trainer.pipeline.batch_at = batch_or_kill
        built.append(trainer)
        return trainer, state, cfg

    return build


def test_train_lm_resume_is_bit_equal_and_leaves_the_process_group_as_found(tmp_path, monkeypatch):
    """14 steps, checkpoint every 10: a run killed before step 12 resumes
    at 10 and reproduces steps 10-13 bit for bit.  Each run leaves the
    process group as it found it: none stays none (a group an earlier test
    of this worker left running stays running); the script test below
    runs it in a fresh process."""
    ex = example("train_lm")
    before = dist.is_initialized()
    kw = dict(arch="xlstm_125m", steps=14, batch=2, seq=16, log_every=1)
    whole = ex.run("cpu", ckpt=str(tmp_path / "whole"), **kw)
    assert dist.is_initialized() == before
    killed = []
    with monkeypatch.context() as m:
        m.setattr(ex, "build_trainer", killing(ex.build_trainer, 12, killed))
        with pytest.raises(Killed):
            ex.run("cpu", ckpt=str(tmp_path / "killed"), **kw)
    assert dist.is_initialized() == before
    assert [h["step"] for h in killed[0].history] == list(range(12))
    resumed = ex.run("cpu", ckpt=str(tmp_path / "killed"), **kw)
    assert dist.is_initialized() == before
    assert [h["step"] for h in resumed["trainer"].history] == [10, 11, 12, 13]
    want = {h["step"]: h["loss"] for h in whole["trainer"].history}
    assert [h["loss"] for h in resumed["trainer"].history] == [want[s] for s in (10, 11, 12, 13)]
    assert [h["loss"] for h in killed[0].history] == [want[s] for s in range(12)]
    from repro_torch.tree import flatten

    assert all(torch.equal(torch.as_tensor(a.full_tensor() if hasattr(a, "full_tensor") else a),
                           torch.as_tensor(b.full_tensor() if hasattr(b, "full_tensor") else b))
               for a, b in zip(flatten(resumed["state"]), flatten(whole["state"]), strict=True))


def test_train_lm_reuses_a_running_process_group(tmp_path):
    """In a process whose group already runs, the example trains on it and
    leaves it running."""
    from repro_torch.launch.mesh import make_elastic_mesh

    ex = example("train_lm")
    started = not dist.is_initialized()
    make_elastic_mesh(device_type="cpu")
    try:
        r = ex.run("cpu", steps=2, batch=2, seq=8, ckpt=str(tmp_path), log_every=1)
        assert dist.is_initialized() and len(r["trainer"].history) == 2
    finally:
        if started:
            dist.destroy_process_group()


# -- the scripts stand alone --------------------------------------------------------

#: each script with small arguments, and a line its output must hold
SCRIPTS = {
    "quickstart": ([], "gemmini:naive        exact=True"),
    "integrate_accelerator": ([], "warm recompile: scheduler sweeps=0"),
    "serve_zoo": (["qcnn", "edge_npu:optimized", "--requests", "4"], "model=qcnn"),
    "serve_lm": (["--requests", "2", "--batch", "2", "--prompt-len", "6", "--new-tokens", "3"],
                 "deterministic decode: OK"),
    "train_lm": (["--steps", "3", "--batch", "2", "--seq", "8"], "training xlstm-125m"),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_example_runs_with_jax_and_the_reference_blocked(name, tmp_path):
    args, expect = SCRIPTS[name]
    if name == "train_lm":
        args = [*args, "--ckpt", str(tmp_path / "ckpt")]
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.argv = [{str(EXAMPLES / (name + '.py'))!r}, *{args!r}, '--device', 'cpu']\n"
        f"runpy.run_path(sys.argv[0], run_name='__main__')\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'the script left a process group running'\n"
        "print('ok', [k for k in sys.modules if k.split('.')[0] in ('jax', 'repro')])\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "REPRO_TORCH_CACHE_DIR": str(tmp_path / "cache")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert expect in proc.stdout
    assert "ok ['jax', 'repro']" in proc.stdout  # only the blocking entries


IMPORT_LINE = re.compile(r"^\s*(import|from)\s+(repro|jax)\b", re.MULTILINE)


def test_no_port_file_imports_jax_or_the_reference():
    """``grep -rE '^\\s*(import|from)\\s+(repro|jax)\\b'`` over the port's
    package, its examples and ``chip_smoke.py`` finds nothing."""
    files = [*sorted((ROOT / "src" / "repro_torch").rglob("*.py")), *sorted(EXAMPLES.glob("*.py")),
             ROOT / "chip_smoke.py"]
    assert len(list(EXAMPLES.glob("*.py"))) == 5
    hits = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}" for p in files
            for m in IMPORT_LINE.finditer(p.read_text())]
    assert not hits, hits
