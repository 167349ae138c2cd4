"""The port stands alone and runs where its target says.

``repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor ``repro``;
``Target()``, ``Target.parse()`` and the serve CLI default to the card, and
a CUDA target without one fails at compile time instead of running on the
CPU.
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
#: modules whose reference counterparts sit beside the JAX package's
#: traced frontend and serving engines
SERVING_MODULES = (
    "repro_torch.core.batching",
    "repro_torch.serve",
    "repro_torch.serve.microbatch",
    "repro_torch.launch.serve",
    "repro_torch.core.descriptions.edge_npu",
    "repro_torch.core.descriptions.tpu_v5e",
)


#: the compile service's modules (schedule cache, measured DSE, artifacts)
COMPILE_SERVICE_MODULES = (
    "repro_torch.core.schedule_cache",
    "repro_torch.core.measure",
    "repro_torch.core.artifact",
)

#: the decode path's modules and the static verifier
DECODE_MODULES = (
    "repro_torch.core.verify",
    "repro_torch.serve.continuous",
)

#: the LM substrate, its configs, the kernel policy and the LM server
LM_MODULES = (
    "repro_torch.models",
    "repro_torch.models.config",
    "repro_torch.models.layers",
    "repro_torch.models.cache",
    "repro_torch.models.flash",
    "repro_torch.models.attention",
    "repro_torch.models.lm",
    "repro_torch.models.moe",
    "repro_torch.models.ssm",
    "repro_torch.models.xlstm",
    "repro_torch.configs",
    *(f"repro_torch.configs.{arch}" for arch in (
        "paligemma_3b", "mixtral_8x7b", "deepseek_v2_236b", "qwen1_5_32b", "granite_34b",
        "codeqwen1_5_7b", "yi_34b", "musicgen_medium", "xlstm_125m", "jamba_v0_1_52b",
    )),
    "repro_torch.kernels.policy",
    "repro_torch.serve.engine",
    "repro_torch.core.deprecation",
)


#: the traced frontend and the sharded plans' modules
FRONTEND_SHARDED_MODULES = (
    "repro_torch.frontend",
    "repro_torch.frontend.nn",
    "repro_torch.frontend.importer",
    "repro_torch.core.collective",
    "repro_torch.core.sharded",
    "repro_torch.launch.mesh",
)


#: the training path: the policy and its dp axes, the tree utilities,
#: optimizer, data, checkpoints, the step and trainer, and the launcher
TRAIN_MODULES = (
    "repro_torch.parallel",
    "repro_torch.parallel.policy",
    "repro_torch.parallel.sharding",
    "repro_torch.tree",
    "repro_torch.optim",
    "repro_torch.optim.adamw",
    "repro_torch.data",
    "repro_torch.data.pipeline",
    "repro_torch.checkpoint",
    "repro_torch.checkpoint.store",
    "repro_torch.train",
    "repro_torch.train.step",
    "repro_torch.train.trainer",
    "repro_torch.launch.train",
)


#: the emulated-intrinsic route, the legacy integration surface and the MIP
EMULATED_MODULES = (
    "repro_torch.core",
    "repro_torch.core.intrinsics",
    "repro_torch.core.mapping",
    "repro_torch.core.lowering",
    "repro_torch.core.configurators",
    "repro_torch.core.registry",
    "repro_torch.core.passes",
    "repro_torch.core.example_graphs",
    "repro_torch.core.cosa",
    "repro_torch.core.cosa.mip",
)


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


def test_serving_modules_are_checked_files():
    checked = {str(p.relative_to(ROOT / "src")) for p in PORT_FILES if p.is_relative_to(ROOT / "src")}
    for module in SERVING_MODULES:
        path = module.replace(".", "/")
        assert f"{path}.py" in checked or f"{path}/__init__.py" in checked, module


def test_serving_modules_run_with_jax_blocked(tmp_path):
    code = (
        "import sys, argparse\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for name in {SERVING_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from repro_torch.launch.serve import serve_zoo\n"
        "r = serve_zoo(argparse.Namespace(zoo='qcnn', target='edge_npu:optimized', batch=4,\n"
        "    requests=6, deadline_ms=1.0, device='cpu'))\n"
        "assert r.module.bucket_sizes() == (1, 4) and len(r.outputs) == 6\n"
        "print('ok', [k for k in sys.modules if k.split('.')[0] in ('jax', 'repro')])\n"
    )
    # serve_zoo compiles with the default schedule cache: keep it in tmp_path
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "REPRO_TORCH_CACHE_DIR": str(tmp_path)}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert "ok ['jax', 'repro']" in proc.stdout  # only the blocking entries


def test_compile_service_modules_are_checked_files():
    checked = {str(p.relative_to(ROOT / "src")) for p in PORT_FILES if p.is_relative_to(ROOT / "src")}
    for module in COMPILE_SERVICE_MODULES:
        assert f"{module.replace('.', '/')}.py" in checked, module


def test_compile_service_runs_with_jax_blocked(tmp_path):
    """A measured compile through the schedule cache, a save and a load,
    in a process where importing jax or repro fails."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for name in {COMPILE_SERVICE_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import repro_torch\n"
        "from repro_torch.core import zoo\n"
        f"t = repro_torch.Target('edge_npu', device='cpu', cache_dir={str(tmp_path / 'cache')!r})\n"
        "m = repro_torch.compile('qcnn', t, options=repro_torch.CompileOptions(measure_top_k=2))\n"
        f"repro_torch.save(m, {str(tmp_path / 'art')!r})\n"
        f"r = repro_torch.load({str(tmp_path / 'art')!r}, device='cpu')\n"
        "f = zoo.get_model('qcnn').feeds(0)\n"
        "assert (r.run(f)[0] == m.run(f)[0]).all() and m.backend.n_measurements > 0\n"
        "print('ok', [k for k in sys.modules if k.split('.')[0] in ('jax', 'repro')])\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert "ok ['jax', 'repro']" in proc.stdout


def test_emulated_modules_are_checked_files():
    checked = {str(p.relative_to(ROOT / "src")) for p in PORT_FILES if p.is_relative_to(ROOT / "src")}
    for module in EMULATED_MODULES:
        path = module.replace(".", "/")
        assert f"{path}.py" in checked or f"{path}/__init__.py" in checked, module


def test_emulated_route_and_legacy_surface_run_with_jax_blocked():
    """The emulated route, its interpreter and the deprecated two-step flow,
    in a process where importing jax or repro fails."""
    code = (
        "import sys, warnings\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for name in {EMULATED_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import repro_torch\n"
        "from repro_torch.core import zoo\n"
        "from repro_torch.core.example_graphs import quantized_conv_dense_graph\n"
        "t = repro_torch.Target('gemmini', device='cpu', cache=False, use_pallas=False)\n"
        "m = repro_torch.compile('qcnn', t)\n"
        "f = zoo.get_model('qcnn').feeds(0)\n"
        "assert (m.run(f)[0] == m.run(f, use_plan=False)[0]).all()\n"
        "with warnings.catch_warnings(record=True) as w:\n"
        "    warnings.simplefilter('always')\n"
        "    b = repro_torch.integrate('gemmini', cache=False, use_pallas=False)\n"
        "    b.compile(quantized_conv_dense_graph(), device='cpu')\n"
        "assert [x.category for x in w] == [repro_torch.ReproDeprecationWarning] * 2\n"
        "print('ok', [k for k in sys.modules if k.split('.')[0] in ('jax', 'repro')])\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert "ok ['jax', 'repro']" in proc.stdout


def test_decode_modules_are_checked_files():
    checked = {str(p.relative_to(ROOT / "src")) for p in PORT_FILES if p.is_relative_to(ROOT / "src")}
    for module in DECODE_MODULES:
        assert f"{module.replace('.', '/')}.py" in checked, module


def test_decode_path_and_verifier_run_with_jax_blocked(tmp_path):
    """The decode engine, a decode artifact's save and verified load, and
    the verifier's sweep, in a process where importing jax or repro fails."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for name in {DECODE_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import repro_torch\n"
        "from repro_torch.core import verify\n"
        "from repro_torch.serve import ContinuousBatchingEngine, EngineConfig, random_requests\n"
        "model = repro_torch.get_decode_model('attn_decode')\n"
        "t = repro_torch.Target('gemmini', device='cpu', cache=False)\n"
        "eng = ContinuousBatchingEngine(model, t, EngineConfig(batch=2, prompt_len=4, max_new_tokens=3))\n"
        "rep = eng.run(random_requests(model, 3, 4, seed=0))\n"
        "assert rep.total_new_tokens == 9\n"
        f"repro_torch.save(eng.decode_mod, {str(tmp_path / 'art')!r})\n"
        f"m = repro_torch.load({str(tmp_path / 'art')!r}, device='cpu')\n"
        "assert m.graph.cache_spec == eng.decode_mod.graph.cache_spec\n"
        "assert verify.main(['--sweep', '--device', 'cpu', '--accelerators', 'edge_npu',\n"
        "                    '--modes', 'naive']) == 0\n"
        "print('ok', [k for k in sys.modules if k.split('.')[0] in ('jax', 'repro')])\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "REPRO_TORCH_CACHE_DIR": str(tmp_path)}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert "ok ['jax', 'repro']" in proc.stdout


def test_lm_modules_are_checked_files():
    checked = {str(p.relative_to(ROOT / "src")) for p in PORT_FILES if p.is_relative_to(ROOT / "src")}
    for module in LM_MODULES:
        path = module.replace(".", "/")
        assert f"{path}.py" in checked or f"{path}/__init__.py" in checked, module


def test_lm_path_runs_with_jax_blocked():
    """Every config, a forward of each new block kind's smoke arch, and the
    smoke LM served with its GEMMs routed through
    the scheduled kernel's policy, in a process where importing jax or
    repro fails."""
    code = (
        "import sys, argparse\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for name in {LM_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from repro_torch.configs import all_configs\n"
        "assert len(all_configs()) == 10\n"
        "import torch\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.models import lm\n"
        "for arch in ('jamba_v0_1_52b', 'xlstm_125m', 'deepseek_v2_236b'):\n"
        "    cfg = get_smoke_config(arch)\n"
        "    logits, _ = lm.forward(lm.init_lm(0, cfg, device='cpu'), cfg,\n"
        "                           torch.zeros((1, 4), dtype=torch.int32))\n"
        "    assert logits.shape == (1, 4, cfg.vocab)\n"
        "from repro_torch.core.configurators import build_backend\n"
        "from repro_torch.core.descriptions import make_gemmini_description\n"
        "from repro_torch.kernels.policy import scheduled_kernels\n"
        "from repro_torch.launch.serve import serve_lm\n"
        "with scheduled_kernels(build_backend(make_gemmini_description())):\n"
        "    r = serve_lm(argparse.Namespace(arch='yi_34b', smoke=True, device='cpu', batch=4,\n"
        "        requests=4, prompt_len=8, new_tokens=3))\n"
        "assert [len(q.output) for q in r.requests] == [3, 3, 3, 3]\n"
        "print('ok', [k for k in sys.modules if k.split('.')[0] in ('jax', 'repro')])\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-W", "ignore", "-c", code], capture_output=True, text=True, env=env,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "ok ['jax', 'repro']" in proc.stdout


def test_train_modules_are_checked_files():
    checked = {str(p.relative_to(ROOT / "src")) for p in PORT_FILES if p.is_relative_to(ROOT / "src")}
    for module in TRAIN_MODULES:
        path = module.replace(".", "/")
        assert f"{path}.py" in checked or f"{path}/__init__.py" in checked, module


def test_train_path_runs_with_jax_blocked(tmp_path):
    """A train step, a checkpoint round trip and ``build_trainer(smoke=True,
    device="cpu")`` run for a few steps, in a process where importing jax
    or repro fails."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for name in {TRAIN_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import torch\n"
        "from repro_torch.checkpoint import restore_checkpoint, save_checkpoint\n"
        "from repro_torch.launch.train import build_trainer\n"
        "from repro_torch.train import TrainState\n"
        f"trainer, state, cfg = build_trainer('deepseek_v2_236b', smoke=True, steps=3, global_batch=2,\n"
        f"    seq_len=8, checkpoint_dir={str(tmp_path / 'run')!r}, checkpoint_every=2, device='cpu')\n"
        "batch = trainer.shard_batch(trainer.pipeline.batch_at(0))\n"
        "new, metrics = trainer.train_step(state, batch)\n"
        "assert torch.isfinite(metrics['loss']) and int(new.opt_state['step']) == 1\n"
        f"save_checkpoint({str(tmp_path / 'one')!r}, 1, tuple(new))\n"
        f"got, step, _ = restore_checkpoint({str(tmp_path / 'one')!r}, tuple(state))\n"
        "assert step == 1 and torch.equal(got[0]['embed']['table'], new.params['embed']['table'])\n"
        "trainer.run(state)\n"
        "assert [h['step'] for h in trainer.history] == [0]\n"
        "print('ok', [k for k in sys.modules if k.split('.')[0] in ('jax', 'repro')])\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert "ok ['jax', 'repro']" in proc.stdout


def test_frontend_and_sharded_modules_are_checked_files():
    checked = {str(p.relative_to(ROOT / "src")) for p in PORT_FILES if p.is_relative_to(ROOT / "src")}
    for module in FRONTEND_SHARDED_MODULES:
        path = module.replace(".", "/")
        assert f"{path}.py" in checked or f"{path}/__init__.py" in checked, module


def test_frontend_and_sharded_paths_run_with_jax_blocked(tmp_path):
    """A torch callable traced and compiled, a zoo model sharded on a
    (1, 2) mesh, saved and loaded, in a process where importing jax or
    repro fails."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for name in {FRONTEND_SHARDED_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import repro_torch\n"
        "from repro_torch.core import zoo\n"
        "model = zoo.get_model('mlp_tiny')\n"
        "t = repro_torch.Target('gemmini', device='cpu', cache=False)\n"
        "m = repro_torch.compile(model.torch_fn, t, example_inputs=model.example_inputs(),\n"
        "                        params=model.params())\n"
        "s = repro_torch.compile('mlp_tiny', repro_torch.Target('gemmini', device='cpu', cache=False,\n"
        "                        mesh=(1, 2)))\n"
        f"repro_torch.save(s, {str(tmp_path / 'art')!r})\n"
        f"r = repro_torch.load({str(tmp_path / 'art')!r}, device='cpu')\n"
        "f = model.feeds(0)\n"
        "assert (r.run(f)[0] == m.run(f)[0]).all() and (s.run(f)[0] == m.run(f)[0]).all()\n"
        "print('ok', [k for k in sys.modules if k.split('.')[0] in ('jax', 'repro')])\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert "ok ['jax', 'repro']" in proc.stdout


def test_port_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "m = repro_torch.compile('mlp_tiny', repro_torch.Target('gemmini', device='cpu', cache=False))\n"
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
    parsed = repro_torch.Target.parse("edge_npu:naive", batch_size=16)
    assert (parsed.accelerator, parsed.mode, parsed.device, parsed.batch_size) == (
        "edge_npu", "naive", "cuda", 16
    )


def test_target_parse_lists_bad_specs():
    for spec in ("a:b:c", ":optimized"):
        with pytest.raises(repro_torch.TargetError, match="'accelerator:mode'"):
            repro_torch.Target.parse(spec)
    with pytest.raises(repro_torch.TargetError, match="mode='naive' was also passed"):
        repro_torch.Target.parse("gemmini:optimized", mode="naive")
    assert repro_torch.Target.parse("gemmini", mode="naive", device="cpu").describe() == "gemmini:naive@cpu"


def test_serve_cli_defaults_to_the_card():
    from repro_torch.launch import serve

    assert serve.build_parser().parse_args(["--zoo", "mlp_tiny"]).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        serve.main(["--zoo", "mlp_tiny", "--requests", "1"])


def test_mip_request_is_refused_where_the_reference_would_solve_it(monkeypatch):
    """With pulp importable the port, like the reference, asks the MIP for
    ``use_mip=True`` (solver id ``mip``) instead of refusing; a MIP that
    cannot solve (here pulp is only pretended) falls back to the greedy
    heuristic's schedules, as the reference's does."""
    import importlib.util

    real_find_spec = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: object() if name == "pulp" else real_find_spec(name, *a),
    )
    module = repro_torch.compile("mlp_tiny", repro_torch.Target("gemmini", device="cpu", cache=False))
    assert module.backend.scheduler.solver_id() == "mip"
    heuristic = repro_torch.compile(
        "mlp_tiny", repro_torch.Target("gemmini", use_mip=False, device="cpu", cache=False)
    )
    assert heuristic.backend.scheduler.solver_id() == "heuristic"
    levels = [[s["levels"] for s in m.schedules().values()] for m in (module, heuristic)]
    assert levels[0] == levels[1]
    assert module.modeled_cycles()["total"] == heuristic.modeled_cycles()["total"] == 2624.0


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
