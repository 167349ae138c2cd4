"""The port's sharded plans against the reference's, on the CPU.

``Target(devices=N)`` / ``Target(mesh=(d, m))`` compiles one plan per mesh
shard; a ``ShardedModule`` runs every shard on the target's one device, one
thread per shard, meeting at each collective through a
``CollectiveSession``.  Mirrors ``tests/test_sharded.py`` (bit-exact against
devices = 1 across the zoo x {gemmini, edge_npu} x mode matrix, batched
buckets and data-parallel meshes, artifacts, concurrency, the ring cost
formulas, the rendezvous) and ``tests/test_mesh.py`` (the elastic
factorization), plus what holds the port to the reference: outputs and
``modeled_cycles()`` key by key equal to the reference's ``ShardedModule``
compiled from the same golden graph, sharded artifacts loading across the
two packages both ways, the verifier's collective checks and its device
sweep.

The reference is compiled from its golden graphs (``build()``), never from
zoo names: its traced frontend fails under jax 0.9.
"""

import os
import subprocess
import sys
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro
from repro.core import collective as ref_collective
from repro.core import ir as ref_ir
from repro.core import zoo as ref_zoo
from repro.core.registry import REGISTRY as REF_REGISTRY
from repro.core.verify import verify_collectives as ref_verify_collectives
from repro.launch import mesh as ref_mesh
import repro_torch
from repro_torch import CompileOptions, ShardedModule, Target, TargetError
from repro_torch.core import ir, verify, zoo
from repro_torch.core.collective import (
    CollectiveError,
    CollectiveSession,
    ShardSpec,
    _combine_for,
    collective_cycles,
    session_scope,
)
from repro_torch.core.ir import COLLECTIVE_OPS
from repro_torch.core.registry import REGISTRY
from repro_torch.core.verify import verify_collectives
from repro_torch.launch import serve
from repro_torch.launch.mesh import mesh_factorization

ROOT = Path(__file__).resolve().parents[1]
MODES = ("naive", "baseline", "optimized")
ACCELERATORS = ("gemmini", "edge_npu")
MATRIX = [(m.name, a) for m in zoo.ZOO.values() for a in m.accelerators if a in ACCELERATORS]


def _target(acc="gemmini", mode="optimized", **kw) -> Target:
    return Target(acc, mode=mode, device="cpu", cache=False, use_mip=False, **kw)


def _ref_sharded(name, acc, mode, mesh):
    return repro.compile(
        ref_zoo.get_model(name).build(),
        repro.Target(acc, mode=mode, cache=False, use_mip=False, mesh=mesh),
    )


def _assert_outputs_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


def _codes(diags) -> set[str]:
    return {d.code for d in diags}


# -- the acceptance matrix: sharded == single-device == the reference ---------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model_name,acc", MATRIX)
def test_sharded_bit_exact_vs_single_device(model_name, acc, mode):
    model = zoo.get_model(model_name)
    feeds = model.feeds(seed=0)
    single = repro_torch.compile(model_name, _target(acc, mode))
    sharded = repro_torch.compile(model_name, _target(acc, mode, devices=2))
    assert isinstance(sharded, ShardedModule)
    assert sharded.devices == 2 and sharded.device == torch.device("cpu")
    got = sharded.run(feeds)
    _assert_outputs_equal(single.run(feeds), got)
    ref = _ref_sharded(model_name, acc, mode, (1, 2))
    _assert_outputs_equal(ref.run(feeds), got)
    assert sharded.modeled_cycles() == ref.modeled_cycles()
    for key, shard in sharded.shards.items():
        assert [n.op for n in shard.graph.toposort()] == [n.op for n in ref.shards[key].graph.toposort()]


def test_sharded_devices_4_bit_exact():
    model = zoo.get_model("toycar_mlp")
    feeds = model.feeds(seed=3)
    single = repro_torch.compile("toycar_mlp", _target("gemmini"))
    sharded = repro_torch.compile("toycar_mlp", _target("gemmini", devices=4, mesh=(1, 4)))
    assert sharded.mesh == (1, 4)
    _assert_outputs_equal(single.run(feeds), sharded.run(feeds))
    ref = _ref_sharded("toycar_mlp", "gemmini", "optimized", (1, 4))
    assert sharded.modeled_cycles() == ref.modeled_cycles() == {
        "accel": 15728.0, "host": 0.0, "comm": 1410.0, "total": 17138.0,
    }
    two = repro_torch.compile("toycar_mlp", _target("gemmini", devices=2))
    assert two.modeled_cycles() == {"accel": 27984.0, "host": 0.0, "comm": 556.25, "total": 28540.25}


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2)])
def test_sharded_batched_buckets_bit_exact(mesh):
    """Batched sharding: every bucket becomes a ShardedModule; the data
    axis splits buckets it divides (bucket 1 falls back to tensor-parallel
    only) and outputs still match the unsharded batched module and the
    golden graph."""
    model = zoo.get_model("toycar_mlp")
    opts = CompileOptions(batch_buckets=(1, 4))
    single = repro_torch.compile("toycar_mlp", _target("gemmini"), options=opts)
    sharded = repro_torch.compile("toycar_mlp", _target("gemmini", mesh=mesh), options=opts)
    dp = mesh[0]
    for b, sub in sharded.modules.items():
        assert isinstance(sub, ShardedModule)
        want_dp = dp if dp > 1 and b % dp == 0 else 1
        assert sub.mesh == (want_dp, mesh[1])
        assert sub.input_signature() == (("x", (b, 640), "int8"),)
    feeds_list = [model.feeds(seed=s) for s in range(6)]
    got = sharded.run_many(feeds_list)
    _assert_outputs_equal(
        [o for r in single.run_many(feeds_list) for o in r], [o for r in got for o in r]
    )
    golden = ref_zoo.get_model("toycar_mlp").build()
    for f, g in zip(feeds_list, got):
        _assert_outputs_equal(ref_ir.execute_graph(golden, f), g)


def test_sharded_verify_gate_and_kernel_route():
    """The verify gate runs on every shard and on the mesh; each shard's
    accelerator steps are kernel executors (on the CPU their plain
    version) at the shard's narrower shapes."""
    sharded = repro_torch.compile(
        "toycar_mlp", _target("gemmini", devices=2), options=CompileOptions(verify="each")
    )
    assert repro_torch.verify(sharded) == []
    widths = sorted({n.inputs[1].shape[-1] for n in sharded.shard_module(0, 1).ops})
    assert widths == [4, 64, 320]  # 8 -> 4 columns, 128 -> 64, 640 -> 320
    assert all(hasattr(op.executor, "kernel_config") for op in sharded.shard_module(0, 1).ops.values())


def test_sharded_artifact_round_trip(tmp_path):
    model = zoo.get_model("toycar_mlp")
    feeds = model.feeds(seed=0)
    sharded = repro_torch.compile("toycar_mlp", _target("edge_npu", devices=2))
    repro_torch.save(sharded, tmp_path / "art")
    loaded = repro_torch.load(tmp_path / "art", device="cpu")
    assert isinstance(loaded, ShardedModule)
    assert loaded.mesh == sharded.mesh
    assert loaded.signature == sharded.signature
    _assert_outputs_equal(sharded.run(feeds), loaded.run(feeds))
    assert loaded.modeled_cycles() == sharded.modeled_cycles()


@pytest.mark.parametrize("name", ["toycar_mlp", "transformer_block"])
def test_sharded_artifact_cross_loads_both_ways(name, tmp_path):
    feeds = zoo.get_model(name).feeds(seed=4)
    port = repro_torch.compile(name, _target("gemmini", devices=2))
    repro_torch.save(port, tmp_path / "port")
    ref_loaded = repro.load(tmp_path / "port")
    assert isinstance(ref_loaded, repro.ShardedModule) and ref_loaded.mesh == (1, 2)
    _assert_outputs_equal(ref_loaded.run(feeds), port.run(feeds))
    assert ref_loaded.modeled_cycles() == port.modeled_cycles()

    ref = _ref_sharded(name, "gemmini", "optimized", (1, 2))
    repro.save(ref, tmp_path / "ref")
    port_loaded = repro_torch.load(tmp_path / "ref", device="cpu")
    assert isinstance(port_loaded, ShardedModule) and port_loaded.signature == ref.signature
    _assert_outputs_equal(port_loaded.run(feeds), ref.run(feeds))
    assert port_loaded.modeled_cycles() == ref.modeled_cycles()


def test_sharded_batched_artifact_cross_loads(tmp_path):
    model = zoo.get_model("mlp_tiny")
    module = repro_torch.compile(
        "mlp_tiny", _target("gemmini", mesh=(2, 2)), options=CompileOptions(batch_buckets=(1, 4))
    )
    repro_torch.save(module, tmp_path / "art")
    restored = repro_torch.load(tmp_path / "art", device="cpu")
    ref_restored = repro.load(tmp_path / "art")
    assert [restored.bucket_module(b).mesh for b in (1, 4)] == [(1, 2), (2, 2)]
    assert [ref_restored.bucket_module(b).mesh for b in (1, 4)] == [(1, 2), (2, 2)]
    traffic = [model.feeds(seed=s) for s in range(5)]
    want = module.run_many(traffic)
    for got in (restored.run_many(traffic), ref_restored.run_many(traffic)):
        _assert_outputs_equal([o for r in want for o in r], [o for r in got for o in r])


def test_run_many_and_concurrent_runs():
    """The sharded executor must survive concurrent callers: each run gets
    its own CollectiveSession + fresh shard threads."""
    model = zoo.get_model("toycar_mlp")
    sharded = repro_torch.compile("toycar_mlp", _target("gemmini", devices=2))
    single = repro_torch.compile("toycar_mlp", _target("gemmini"))
    feeds_list = [model.feeds(seed=s) for s in range(4)]
    want = [single.run(f) for f in feeds_list]
    got = sharded.run_many(feeds_list)
    for w, g in zip(want, got):
        _assert_outputs_equal(w, g)

    results: dict[int, list] = {}

    def call(i):
        results[i] = sharded.run(feeds_list[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, w in enumerate(want):
        _assert_outputs_equal(w, results[i])


# -- devices=1 identity ---------------------------------------------------------


def test_devices_1_compiles_zero_collectives():
    """A devices=1 target compiles exactly as before: no collective nodes
    in any plan, and zero modeled comm cycles."""
    for model_name in ("mlp_tiny", "toycar_mlp"):
        module = repro_torch.compile(model_name, _target("gemmini"))
        ops = {n.op for n in module.graph.toposort()}
        assert not (ops & COLLECTIVE_OPS)
        assert "shard_slice" not in ops
        cycles = module.modeled_cycles()
        assert cycles["comm"] == 0.0
        assert cycles["total"] == cycles["accel"] + cycles["host"]


def test_sharded_module_devices_1_is_plain_dispatch():
    module = repro_torch.compile("mlp_tiny", _target("gemmini"))
    wrapped = ShardedModule(shards={(0, 0): module}, mesh=(1, 1), signature=module.input_signature())
    feeds = zoo.get_model("mlp_tiny").feeds(seed=0)
    _assert_outputs_equal(module.run(feeds), wrapped.run(feeds))
    with pytest.raises(ValueError, match="do not cover mesh"):
        ShardedModule(shards={(0, 0): module}, mesh=(1, 2), signature=module.input_signature())


# -- golden interconnect cost formulas ----------------------------------------


@pytest.mark.parametrize("acc", ("gemmini", "edge_npu", "tpu_v5e"))
def test_all_reduce_cost_formula_golden(acc):
    """Pin the modeled ring all-reduce cost: 2 * (K-1) * (B/K / link_bw +
    hop latency), parameterized on the accelerator's interconnect (the
    port has no tpu_v5e description: its arch is the reference's, held to
    the same formula)."""
    arch = REGISTRY.get(acc).arch if acc in REGISTRY else REF_REGISTRY.get(acc).arch
    B, K = 4096, 4
    want = 2.0 * (K - 1) * ((B / K) / arch.link_bytes_per_cycle + arch.link_hop_cycles)
    assert collective_cycles("all_reduce", B, K, arch) == pytest.approx(want)
    assert collective_cycles("all_gather", B, K, arch) == pytest.approx(want / 2)
    assert collective_cycles("reduce_scatter", B, K, arch) == pytest.approx(want / 2)
    assert collective_cycles("all_reduce", B, 1, arch) == 0.0
    for op in ("all_reduce", "all_gather", "reduce_scatter"):
        assert collective_cycles(op, B, K, arch) == ref_collective.collective_cycles(op, B, K, arch)


def test_interconnects_differ_across_accelerators():
    costs = {
        acc: collective_cycles("all_reduce", 1 << 16, 4, REGISTRY.get(acc).arch)
        for acc in ("gemmini", "edge_npu")
    }
    costs["tpu_v5e"] = collective_cycles("all_reduce", 1 << 16, 4, REF_REGISTRY.get("tpu_v5e").arch)
    assert costs["tpu_v5e"] < costs["gemmini"] < costs["edge_npu"]


def test_modeled_comm_charged_on_sharded_plans():
    sharded = repro_torch.compile("toycar_mlp", _target("edge_npu", devices=2))
    cycles = sharded.modeled_cycles()
    assert cycles["comm"] > 0.0
    assert cycles["total"] == pytest.approx(cycles["accel"] + cycles["host"] + cycles["comm"])


# -- collective runtime unit tests ---------------------------------------------


def test_collective_session_exchange_and_reuse():
    session = CollectiveSession()
    combine = lambda vals: torch.cat(vals)  # noqa: E731
    results = {}

    def rank(r):
        with session_scope(session):
            a = session.exchange("g", r, 2, torch.full((2,), r), combine)
            b = session.exchange("g", r, 2, torch.full((2,), 10 + r), combine)
            results[r] = (a, b)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in range(2):
        # the group id is reusable across sequential calls on one session
        assert results[r][0].tolist() == [0, 0, 1, 1]
        assert results[r][1].tolist() == [10, 10, 11, 11]
    assert results[0][0] is results[1][0]  # one combine, every shard sees it


def test_collective_abort_unblocks_waiters():
    session = CollectiveSession()
    errors = []

    def waiter():
        try:
            session.exchange("g", 0, 2, torch.zeros(1), lambda v: v[0])
        except CollectiveError as e:
            errors.append(e)

    t = threading.Thread(target=waiter)
    t.start()
    session.abort(RuntimeError("peer died"))
    t.join(timeout=5)
    assert not t.is_alive()
    assert len(errors) == 1
    with pytest.raises(CollectiveError, match="peer shard failed before"):
        session.exchange("h", 1, 2, torch.zeros(1), lambda v: v[0])


@pytest.mark.parametrize("dtype", ["int8", "int32", "float32"])
@pytest.mark.parametrize("op", ["all_gather", "all_reduce", "reduce_scatter"])
def test_combine_equals_the_reference(op, dtype):
    """The combine on the tensors' device equals the reference's numpy
    combine: rank-order concatenation, an int64-accumulated integer sum
    cast back (wrapping like the reference), a rank-order float sum."""
    rng = np.random.default_rng(5)
    if dtype == "float32":
        vals = [rng.normal(size=(4, 6)).astype(dtype) * 1e3 for _ in range(3)]
    else:
        info = np.iinfo(dtype)
        vals = [rng.integers(info.min // 2, info.max // 2, (4, 6)).astype(dtype) for _ in range(3)]
    want = ref_collective._combine_for(op, 1, dtype)(vals)
    got = _combine_for(op, 1, dtype)([torch.from_numpy(v) for v in vals])
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_shard_failure_propagates_not_deadlocks():
    """A failing shard aborts the session and surfaces ONE real error to
    the caller instead of hanging its peers."""
    sharded = repro_torch.compile("toycar_mlp", _target("edge_npu", devices=2))
    feeds = zoo.get_model("toycar_mlp").feeds(seed=0)
    shard = sharded.shards[(0, 1)]

    def explode(_feeds):
        raise RuntimeError("injected shard failure")

    shard._check_feeds = explode
    try:
        with pytest.raises(RuntimeError, match="injected shard failure"):
            sharded.run(feeds)
    finally:
        del shard._check_feeds
    _assert_outputs_equal(sharded.run(feeds), repro_torch.compile("toycar_mlp", _target("edge_npu")).run(feeds))


def test_collective_outside_session_raises():
    sharded = repro_torch.compile("toycar_mlp", _target("edge_npu", devices=2))
    feeds = zoo.get_model("toycar_mlp").feeds(seed=0)
    with pytest.raises(CollectiveError, match="outside a ShardedModule"):
        sharded.shards[(0, 0)].run(feeds)


def test_shard_spec_validation():
    assert ShardSpec(data=2, model=4).devices == 8
    with pytest.raises(ValueError):
        ShardSpec(data=0)
    with pytest.raises(ValueError):
        ShardSpec(data=2, model=2, data_rank=2)


def test_feed_errors_list_every_problem():
    sharded = repro_torch.compile("mlp_tiny", _target("gemmini", devices=2))
    with pytest.raises(repro_torch.FeedError) as e:
        sharded.run({"y": np.zeros((1, 16), np.int8)})
    assert "missing feed for input 'x'" in str(e.value) and "unknown feed 'y'" in str(e.value)


# -- Target surface ---------------------------------------------------------------


def test_target_mesh_validation():
    assert Target("gemmini", devices=4).resolved_mesh == (1, 4)
    assert Target("gemmini", mesh=(2, 2)).devices == 4
    assert Target("gemmini", mesh=[1, 2]).mesh == (1, 2)
    assert Target("gemmini", devices=1).resolved_mesh == (1, 1)
    assert Target("gemmini", devices=12).resolved_mesh == (3, 4)
    assert Target("gemmini", mesh=(1, 4), device="cpu").describe() == "gemmini:optimized@cpu@4dev(data=1,model=4)"
    with pytest.raises(TargetError, match="mesh"):
        Target("gemmini", devices=4, mesh=(2, 4))
    with pytest.raises(TargetError, match="devices"):
        Target("gemmini", devices=0)
    with pytest.raises(TargetError, match="mesh"):
        Target("gemmini", mesh=(2,))


def test_unbatched_data_parallel_mesh_rejected():
    with pytest.raises(ValueError, match="batch buckets"):
        repro_torch.compile("mlp_tiny", _target("gemmini", mesh=(2, 1)))


def test_sharded_rejects_custom_pass_list():
    with pytest.raises(ValueError, match="passes"):
        repro_torch.compile("mlp_tiny", _target("gemmini", devices=2), options=CompileOptions(passes=[]))


def test_shard_pass_refuses_decode_graphs():
    with pytest.raises(ValueError, match="stateful decode graphs cannot be shard-partitioned"):
        repro_torch.compile("attn_decode", _target("gemmini", devices=2))


def test_shard_slice_and_collective_ir_builders():
    x = ir.input_((4, 8), "int32", name="x")
    s = ir.shard_slice(x, 1, 0, 2)
    assert s.shape == (4, 4)
    g = ir.all_gather(s, 1, group="g", rank=0, parts=2)
    assert g.shape == (4, 8)
    r = ir.all_reduce(x, group="r", rank=1, parts=2)
    assert r.shape == x.shape
    rs = ir.reduce_scatter(x, 0, group="rs", rank=0, parts=2)
    assert rs.shape == (2, 8)
    with pytest.raises(ValueError):
        ir.shard_slice(x, 1, 0, 3)  # 8 % 3 != 0
    # the reference semantics of one participant, as the reference's
    value = np.arange(32, dtype=np.int32).reshape(4, 8)
    for port, ref in (
        (ir.shard_slice(x, 1, 1, 2), ref_ir.shard_slice(ref_ir.input_((4, 8), "int32"), 1, 1, 2)),
        (ir.all_gather(x, 0, group="g", rank=0, parts=1), ref_ir.all_gather(ref_ir.input_((4, 8), "int32"), 0, group="g", rank=0, parts=1)),
    ):
        np.testing.assert_array_equal(ir.execute_node(port, [value]), ref_ir.execute_node(ref, [value]))
    with pytest.raises(NotImplementedError, match="CollectiveSession"):
        ir.execute_node(g, [value[:, :4]])


def test_clone_graph_preserves_structure():
    model = zoo.get_model("mlp_tiny")
    g = model.build()
    clone = ir.clone_graph(g)
    order_a, order_b = g.toposort(), clone.toposort()
    assert len(order_a) == len(order_b)
    for a, b in zip(order_a, order_b):
        assert a is not b
        assert (a.op, a.name, a.shape, a.dtype) == (b.op, b.name, b.shape, b.dtype)
    feeds = model.feeds(seed=0)
    _assert_outputs_equal(ir.execute_graph(g, feeds), ir.execute_graph(clone, feeds))


# -- the verifier's collective checks --------------------------------------------


def _coll(group, rank, *, op="all_gather", parts=2, axis=1, dtype="int8", shape=(4, 4)):
    return {"group": group, "op": op, "rank": rank, "parts": parts, "axis": axis,
            "dtype": dtype, "shape": shape, "node": f"{group}_r{rank}"}


@pytest.mark.parametrize(
    "seqs,codes",
    [
        ({0: [_coll("g0", 0), _coll("g1", 0)], 1: [_coll("g0", 1), _coll("g1", 1)]}, set()),
        ({0: [_coll("g0", 0), _coll("g1", 0)], 1: [_coll("g1", 1), _coll("g0", 1)]}, {"C_ORDER"}),
        ({0: [_coll("g0", 0, shape=(4, 4))], 1: [_coll("g0", 1, shape=(2, 4))]}, {"C_MISMATCH"}),
        ({0: [_coll("g0", 0)], 1: []}, {"C_MISMATCH"}),
        # issued twice by shard 0: the duplicate, and the order it implies
        ({0: [_coll("g0", 0), _coll("g0", 0)], 1: [_coll("g0", 1)]}, {"C_MISMATCH", "C_ORDER"}),
    ],
    ids=["clean", "order", "shape", "absent-rank", "twice"],
)
def test_collective_sequences_are_checked_as_the_reference_checks_them(seqs, codes):
    got = verify_collectives(seqs)
    assert [str(d) for d in got] == [str(d) for d in ref_verify_collectives(seqs)]
    assert _codes(got) == codes


def test_real_sharded_compile_is_clean_and_exposes_sequences():
    module = repro_torch.compile(
        "transformer_block", _target("gemmini", mesh=(1, 2)), options=CompileOptions(verify="each")
    )
    seqs = module.collective_sequences()
    assert set(seqs) == {(0, 0), (0, 1)}
    assert all(len(s) > 0 for s in seqs.values())
    assert verify_collectives(module.shards) == []
    ref = _ref_sharded("transformer_block", "gemmini", "optimized", (1, 2))
    assert [[{k: v for k, v in r.items() if k != "node"} for r in s] for s in seqs.values()] == [
        [{k: v for k, v in r.items() if k != "node"} for r in s] for s in ref.collective_sequences().values()
    ]
    broken = {k: list(v) for k, v in seqs.items()}
    broken[(0, 1)] = [broken[(0, 1)][1], broken[(0, 1)][0]] + broken[(0, 1)][2:]
    assert "C_ORDER" in _codes(verify_collectives(broken))
    x = ir.input_((4, 8), "int8", name="x")
    ag = ir.all_gather(x, 1, group="g0", rank=0, parts=2)
    ag.attrs["rank"] = 5
    assert "G_ATTRS" in _codes(verify.verify_graph(ir.Graph([ag], name="coll")))


def test_verify_sweep_cli_over_device_counts():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.verify", "--sweep", "--devices", "1,4",
         "--device", "cpu", "--accelerators", "gemmini", "--modes", "optimized"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "verified 9 compile(s), 0 with diagnostics" in out.stdout
    assert "ok   qcnn x gemmini:optimized@cpu@4dev(data=1,model=4)" in out.stdout


# -- serving -----------------------------------------------------------------------


def test_serve_zoo_with_devices(tmp_path, monkeypatch, capsys):
    """``serve --zoo ... --devices N`` serves through sharded bucket
    modules; every response equals a per-request single-device run."""
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    args = serve.build_parser().parse_args(
        ["--zoo", "mlp_tiny", "--target", "gemmini:optimized", "--batch", "4",
         "--requests", "24", "--devices", "4", "--device", "cpu"]
    )
    result = serve.serve_zoo(args)
    assert "on a (data=1, model=4) mesh" in capsys.readouterr().out
    assert all(isinstance(result.module.bucket_module(b), ShardedModule) for b in result.module.bucket_sizes())
    single = repro_torch.compile(zoo.get_model("mlp_tiny").build(), _target("gemmini"))
    assert len(result.outputs) == 24
    for feeds, got in zip(result.traffic, result.outputs):
        _assert_outputs_equal(single.run(feeds), got)
    repro_torch.save(result.module, tmp_path / "served")
    args.artifact = str(tmp_path / "served")
    booted = serve.serve_zoo(args)
    assert booted.boot_how == "loaded artifact"
    for feeds, got in zip(booted.traffic, booted.outputs):
        _assert_outputs_equal(single.run(feeds), got)


# -- the elastic factorization (tests/test_mesh.py) -------------------------------


@pytest.mark.parametrize("n,want", [(2, (1, 2)), (4, (1, 4)), (8, (1, 8)), (64, (4, 16)), (12, (3, 4))])
def test_even_counts_take_the_largest_pow2_model_axis(n, want):
    assert mesh_factorization(n) == want == ref_mesh.mesh_factorization(n)


def test_one_device_is_the_trivial_mesh():
    assert mesh_factorization(1) == (1, 1)
    assert mesh_factorization(1, model_parallel=1) == (1, 1)


@pytest.mark.parametrize("n", [3, 5, 7, 11, 13])
def test_odd_and_prime_counts_collapse_to_data_only(n):
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # implicit default must NOT warn
        assert mesh_factorization(n) == (n, 1)


@pytest.mark.parametrize("n", [3, 5, 7])
def test_explicit_model_parallel_on_odd_count_warns(n):
    with pytest.warns(UserWarning, match="does not divide"):
        data, model = mesh_factorization(n, model_parallel=2)
    assert (data, model) == (n, 1)


def test_honored_explicit_request_does_not_warn():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert mesh_factorization(8, model_parallel=2) == (4, 2)
        assert mesh_factorization(8, model_parallel=8) == (1, 8)


def test_oversized_request_clamps_then_warns():
    with pytest.warns(UserWarning):
        assert mesh_factorization(4, model_parallel=8) == (1, 4)


def test_invalid_count_raises():
    with pytest.raises(ValueError, match="n_devices"):
        mesh_factorization(0)
    with pytest.raises(ValueError, match="n_devices"):
        mesh_factorization(-2)
