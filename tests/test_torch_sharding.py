"""The port's sharding rules (``repro_torch.parallel.sharding``) and
activation policy (``repro_torch.parallel.policy``) against the
reference's, on the CPU.

Spec parity: for every one of the ten configs at its published widths,
every leaf of ``param_specs``, ``opt_state_specs`` and ``cache_specs``
(a decode cache of batch 128 and of batch 1, 32,768 positions, int8 KV
where the reference's dry run uses it), plus ``batch_spec`` and
``logits_spec``, equals the reference's entry for entry, on the meshes
(1, 1), (2, 4), (16, 16) and (2, 16, 16) given to both packages as a
shape mapping, with the ``REPRO_REPLICATE_SMALL_RECURRENT`` knob unset
and set to 1.  The reference's shapes come from ``jax.eval_shape``, the
port's from ``init_lm`` / ``init_cache`` under ``FakeTensorMode`` (no
storage).  Equality is exact: specs are tuples of axis names.

Also: ``constrain`` is the identity on a plain tensor and with no policy
installed, and ``placements`` turns every kind of spec entry into the
DTensor placement of each mesh dim (on a fake 8-rank group, in a
subprocess, which keeps it out of this process).
"""

import functools
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefP
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.parallel import policy as ref_policy
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import policy, sharding

ROOT = Path(__file__).resolve().parents[1]

MESHES = {
    "1x1": {"data": 1, "model": 1},
    "2x4": {"data": 2, "model": 4},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
CACHE_BATCHES = (128, 1)
CACHE_LEN = 32768


@pytest.fixture(autouse=True)
def _clean():
    yield
    policy.set_policy(None)
    ref_policy.set_policy(None)


def _decode_cfg(cfg):
    """The dry run's decode config: int8 KV unless the cache is MLA's."""
    return cfg if cfg.kv_lora_rank else cfg.with_(kv_cache_dtype="int8")


@functools.cache
def _ref_shapes(arch):
    cfg = ref_get_config(arch)
    params = jax.eval_shape(lambda: ref_lm.init_lm(jax.random.key(0), cfg))
    opt = jax.eval_shape(lambda: ref_adamw_init(RefAdamWConfig(moment_dtype="float32"), params))
    caches = {b: jax.eval_shape(lambda b=b: ref_lm.init_cache(_decode_cfg(cfg), b, CACHE_LEN)) for b in CACHE_BATCHES}
    return cfg, params, opt, caches


@functools.cache
def _port_shapes(arch):
    cfg = get_config(arch)
    with FakeTensorMode():
        params = lm.init_lm(0, cfg, device="cpu")
        opt = adamw_init(AdamWConfig(moment_dtype="float32"), params)
        caches = {b: lm.init_cache(_decode_cfg(cfg), b, CACHE_LEN, device="cpu") for b in CACHE_BATCHES}
    return cfg, params, opt, caches


def _ref_leaves(tree):
    """(path, spec as a tuple) of each leaf of a reference spec tree."""
    leaves = jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, RefP))
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in leaves]


def _port_leaves(tree, prefix=""):
    """(path, spec) of each leaf of a port spec tree, in the reference's
    order (dict keys sorted); a spec is a tuple, so tuples are leaves."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _port_leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, list):
        return [leaf for i, t in enumerate(tree) for leaf in _port_leaves(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _assert_same(port_specs, ref_specs):
    got, want = _port_leaves(port_specs), _ref_leaves(ref_specs)
    assert [p for p, _ in got] == [p for p, _ in want]
    bad = [(p, g, w) for (p, g), (_, w) in zip(got, want) if g != w]
    assert not bad, bad[:5]
    return len(got)


@pytest.fixture(params=["unset", "1"])
def knob(request, monkeypatch):
    if request.param == "1":
        monkeypatch.setenv("REPRO_REPLICATE_SMALL_RECURRENT", "1")
    else:
        monkeypatch.delenv("REPRO_REPLICATE_SMALL_RECURRENT", raising=False)
    return request.param


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_state_specs_equal_the_reference(arch, mesh, knob):
    ref_cfg, ref_params, ref_opt, _ = _ref_shapes(arch)
    cfg, params, opt, _ = _port_shapes(arch)
    shape = MESHES[mesh]
    ref_ps = ref_sharding.param_specs(ref_cfg, ref_params, SimpleNamespace(shape=shape))
    ps = sharding.param_specs(cfg, params, shape)
    n = _assert_same(ps, ref_ps)
    assert n == len(jax.tree.leaves(ref_params))
    _assert_same(sharding.opt_state_specs(cfg, opt, ps), ref_sharding.opt_state_specs(ref_cfg, ref_opt, ref_ps))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, mesh, knob):
    ref_cfg, _, _, ref_caches = _ref_shapes(arch)
    cfg, _, _, caches = _port_shapes(arch)
    shape = MESHES[mesh]
    for b in CACHE_BATCHES:
        want = ref_sharding.cache_specs(_decode_cfg(ref_cfg), ref_caches[b], SimpleNamespace(shape=shape))
        got = sharding.cache_specs(_decode_cfg(cfg), caches[b], shape)
        _assert_same(got, want)


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_and_logits_specs_equal_the_reference(mesh):
    stand_in = SimpleNamespace(shape=MESHES[mesh])
    for given in (MESHES[mesh], tuple(MESHES[mesh].values()), stand_in):
        assert sharding.batch_spec(given) == tuple(ref_sharding.batch_spec(stand_in))
        assert sharding.logits_spec(given) == tuple(ref_sharding.logits_spec(stand_in))


@pytest.mark.parametrize("mesh", MESHES)
def test_constrain_is_the_identity_without_a_policy_or_a_dtensor(mesh):
    x = torch.arange(2 * 64 * 4, dtype=torch.float32).reshape(2, 64, 4)
    assert policy.get_policy() is None
    assert policy.constrain(x, "dp", "boundary", None) is x
    assert policy.spec_for(x.shape, "dp", "tp") is None
    pol = policy.install(MESHES[mesh])
    assert policy.constrain(x, "dp", "boundary", None) is x  # a plain tensor has no mesh to lay out on
    # the spec it would name is the reference's with_sharding_constraint's
    ref_policy.install(SimpleNamespace(shape=MESHES[mesh]))
    for dims in (("dp", "boundary", None), ("dp", None, "tp"), ("tp", "dp")):
        spec = policy.spec_for(x.shape, *dims)
        want = [pol.dp if d == "dp" and n % pol.dp_size == 0 else
                pol.tp if d in ("tp", "boundary") and n % pol.tp_size == 0 else None
                for n, d in zip(x.shape, dims)]
        want += [None] * (x.dim() - len(want))
        assert spec == tuple(w[0] if isinstance(w, tuple) and len(w) == 1 else w for w in want)
    assert pol.tp == "model" and pol.tp_size == MESHES[mesh]["model"] and pol.boundary == "seq"
    assert policy.install(MESHES[mesh], boundary="none").boundary == "none"
    assert policy.spec_for((4, 64, 8), "dp", "boundary", None)[1] is None
    with pytest.raises(ValueError, match="boundary"):
        policy.install(MESHES[mesh], boundary="rows")


_PLACEMENTS = r'''
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from repro_torch.parallel import sharding
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
m2 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
m3 = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
R = Replicate()
cases = [
    (sharding.P(), m2, (R, R)),
    (sharding.P(None, None), m2, (R, R)),
    (sharding.P("data", None), m2, (Shard(0), R)),
    (sharding.P(None, "model"), m2, (R, Shard(1))),
    (sharding.P("model", "data"), m2, (Shard(1), Shard(0))),
    (sharding.P(("data",), None, "model"), m2, (Shard(0), Shard(2))),
    (sharding.batch_spec(m3), m3, (Shard(0), Shard(0), R)),
    (sharding.logits_spec(m3), m3, (Shard(0), Shard(0), Shard(2))),
    (sharding.P(None, ("pod", "data"), "model"), m3, (Shard(1), Shard(1), Shard(2))),
]
for spec, mesh, want in cases:
    got = sharding.placements(spec, mesh)
    assert got == want, (spec, got, want)
for bad in (sharding.P("data", "data"), sharding.P("pod", None)):
    try:
        sharding.placements(bad, m2)
    except ValueError:
        continue
    raise AssertionError(bad)
t = sharding.shard_tree({"w": torch.zeros(8, 16), "len": 3}, {"w": sharding.P("data", "model"), "len": ()}, m2)
assert t["len"] == 3 and t["w"].placements == (Shard(0), Shard(1)) and t["w"].to_local().shape == (4, 4)
print("placements ok", len(cases))
'''


def test_placements_of_every_spec_kind():
    proc = subprocess.run(
        [sys.executable, "-c", _PLACEMENTS],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "placements ok 9" in proc.stdout
