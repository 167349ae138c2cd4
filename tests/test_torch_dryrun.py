"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's, on the CPU.

- ``cell_config`` equals the reference's config field for field, and
  ``input_specs`` its inputs in shape and dtype, for every arch x shape
  cell.
- One subprocess starts a fake 8-rank process group, builds a (2, 4)
  ("data", "model") mesh and runs ``run_cell`` of the yi-34b,
  jamba-v0.1-52b and deepseek-v2 smoke configs for a train, a prefill
  and a decode cell (sequence 64).  Each cell's ``argument_bytes``
  equals, exactly, the sum of the local shard bytes that the reference's
  own specs give its arguments (``jax.eval_shape`` shapes, the
  reference's ``param_specs`` / ``opt_state_specs`` / ``cache_specs`` and
  batch specs on the same mesh shape).  The dense (yi) train cell's
  counted FLOPs per rank lie within 10 % of 6·N·T (N the parameters of
  the products, the embedding lookup apart; T the tokens) plus the
  attention's products (forward 4·B·H·S²·dh, the flash backward 2.5
  times that), over the 8 ranks.
- The CLI prints a cell's line and writes its report, in a process
  where importing ``jax`` or ``repro`` fails.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as RefP

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import lm as ref_lm
from repro.models.config import shapes_for as ref_shapes_for
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeCell, shapes_for
from repro_torch.configs import get_config

ROOT = Path(__file__).resolve().parents[1]
MESH = {"data": 2, "model": 4}
CELLS = {
    "train": ShapeCell("train_t", 64, 8, "train"),
    "prefill": ShapeCell("prefill_t", 64, 4, "prefill"),
    "decode": ShapeCell("decode_t", 64, 4, "decode"),
}
RUN_ARCHS = ("yi_34b", "jamba_v0_1_52b", "deepseek_v2_236b")


def _ref_dryrun():
    """The reference's dry-run module; importing it sets ``XLA_FLAGS``
    for a 512-device host, so the variable is put back at once."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref_dryrun


def _cells():
    return [(a, c) for a in ARCH_IDS for c in shapes_for(get_config(a))]


@pytest.mark.parametrize("arch,cell", _cells(), ids=lambda x: getattr(x, "name", x))
def test_cell_config_and_input_specs_equal_the_reference(arch, cell):
    ref_dryrun = _ref_dryrun()
    assert ARCH_IDS == REF_ARCH_IDS
    ref_cell = next(c for c in ref_shapes_for(ref_dryrun.get_config(arch)) if c.name == cell.name)
    assert dataclasses.asdict(ref_cell) == dataclasses.asdict(cell)
    ref_cfg = ref_dryrun.cell_config(arch, ref_cell)
    cfg = dryrun.cell_config(arch, cell)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    want = ref_dryrun.input_specs(ref_cfg, ref_cell)
    got = dryrun.input_specs(cfg, cell)
    assert got.keys() == want.keys()
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    flat_got = [(k, v) for k, v in _sds_leaves(got)]
    assert [jax.tree_util.keystr(p) for p, _ in flat_want] == [k for k, _ in flat_got]
    for (_, w), (_, g) in zip(flat_want, flat_got):
        assert tuple(w.shape) == g.shape and str(w.dtype) == str(g.dtype).removeprefix("torch.")


def _sds_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sds_leaves(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


# -- argument bytes and FLOPs on a fake 8-rank mesh --------------------------------

_RUN = r'''
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeCell
dryrun.start_fake_group(8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
out = {}
for arch in sys.argv[1].split(","):
    for kind, (name, s, b) in json.loads(sys.argv[2]).items():
        rep = dryrun.run_cell(arch, ShapeCell(name, s, b, kind), False, None, mesh=mesh,
                              base=get_smoke_config(arch))
        out[f"{arch}:{kind}"] = rep
print("REPORTS" + json.dumps(out))
'''


@pytest.fixture(scope="module")
def reports():
    cells = {k: (c.name, c.seq_len, c.global_batch) for k, c in CELLS.items()}
    proc = subprocess.run(
        [sys.executable, "-c", _RUN, ",".join(RUN_ARCHS), json.dumps(cells)],
        capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("REPORTS"))
    return json.loads(line[len("REPORTS"):])


def _local_bytes(sds, spec, shape) -> int:
    n = 1
    spec = tuple(spec) + (None,) * (len(sds.shape) - len(tuple(spec)))
    for dim, entry in zip(sds.shape, spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        split = math.prod(shape.get(a, 1) for a in names if a is not None)
        assert dim % split == 0
        n *= dim // split
    return n * np.dtype(sds.dtype).itemsize


def _tree_bytes(tree, specs, shape) -> int:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, RefP))
    assert len(leaves) == len(spec_leaves)
    return sum(_local_bytes(x, s, shape) for x, s in zip(leaves, spec_leaves))


def _ref_argument_bytes(arch, kind) -> int:
    """The local bytes of the reference's arguments on one rank of the
    (2, 4) mesh, by the reference's specs."""
    ref_dryrun = _ref_dryrun()
    cell = CELLS[kind]
    mesh = SimpleNamespace(shape=MESH)
    cfg = ref_get_smoke_config(arch)
    if kind == "decode" and not cfg.kv_lora_rank:  # the reference's cell_config, on the smoke config
        cfg = cfg.with_(kv_cache_dtype="int8")
    params = jax.eval_shape(lambda: ref_lm.init_lm(jax.random.key(0), cfg))
    pspecs = ref_sharding.param_specs(cfg, params, mesh)
    dp = tuple(ref_sharding.dp_axes(mesh))
    total = _tree_bytes(params, pspecs, MESH)
    specs = ref_dryrun.input_specs(cfg, cell)
    if kind == "train":
        opt = jax.eval_shape(lambda: ref_adamw_init(RefAdamWConfig(moment_dtype="float32"), params))
        total += _tree_bytes(opt, ref_sharding.opt_state_specs(cfg, opt, pspecs), MESH)
        return total + sum(_local_bytes(v, RefP(dp), MESH) for v in specs["batch"].values())
    cache = jax.eval_shape(lambda: ref_lm.init_cache(cfg, cell.global_batch, cell.seq_len))
    total += _tree_bytes(cache, ref_sharding.cache_specs(cfg, cache, mesh), MESH)
    if kind == "prefill":
        return total + sum(_local_bytes(v, RefP(dp), MESH) for v in specs["batch"].values())
    return total + _local_bytes(specs["token"], RefP(dp, None), MESH)


@pytest.mark.parametrize("kind", CELLS)
@pytest.mark.parametrize("arch", RUN_ARCHS)
def test_argument_bytes_equal_those_of_the_reference_specs(arch, kind, reports):
    rep = reports[f"{arch}:{kind}"]
    assert rep["status"] == "ok" and rep["n_chips"] == 8 and rep["mesh"] == "2x4"
    assert rep["memory"]["argument_bytes"] == _ref_argument_bytes(arch, kind)
    assert rep["memory"]["peak_bytes"] >= rep["memory"]["argument_bytes"]
    assert rep["constants"]["source"].startswith("NVIDIA H100 SXM5 datasheet")


def test_dense_train_flops_match_the_model_count(reports):
    cfg = ref_get_smoke_config("yi_34b")
    cell = CELLS["train"]
    b, s = cell.global_batch, cell.seq_len
    tokens = b * s
    n = cfg.param_count() - cfg.vocab * cfg.d_model  # the embedding is a lookup
    attn_fwd = 4 * b * cfg.n_heads * s * s * cfg.head_dim_ * cfg.n_layers
    want = (6 * n * tokens + 3.5 * attn_fwd) / 8
    got = reports["yi_34b:train"]["flops_per_device"]
    assert abs(got - want) <= 0.1 * want, (got, want)
    rep = reports["yi_34b:train"]
    assert rep["collectives"].get("all_gather_into_tensor", 0) > 0  # the FSDP gathers
    assert rep["dominant"] in ("compute", "memory", "collective")


def test_cli_writes_a_cell_report(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"  # the dry run and the sharding layer stand alone
        "sys.modules['repro'] = None\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.models.config import ShapeCell\n"
        "dryrun.get_config = get_smoke_config\n"
        "dryrun.shapes_for = lambda cfg: (ShapeCell('decode_t', 64, 32, 'decode'),)\n"
        f"dryrun.main(['--arch', 'yi_34b', '--mesh', 'single', '--out', {str(tmp_path)!r}])\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[dryrun] yi_34b x decode_t x 16x16: OK" in proc.stdout
    assert "NVIDIA H100 SXM5 datasheet" in proc.stdout
    rep = json.loads((tmp_path / "yi_34b__decode_t__16_16.json").read_text())
    assert rep["n_chips"] == 256 and rep["memory"]["argument_bytes"] > 0
    assert "jax" not in proc.stderr
