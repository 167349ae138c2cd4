"""AOT compile artifacts in the port, against the reference.

Mirrors the reference's ``tests/test_artifact.py``: ``repro_torch.save`` /
``repro_torch.load`` round-trip every zoo model, accelerator and mode
bit-exactly with zero work (no DSE sweep, no measurement, no pass-manager
run), batched modules round-trip with their buckets, the content-addressed
store writes through and treats a corrupt entry as a miss, and schema,
architecture, content and graph mismatches are refused.  On top of that
the two packages' artifacts are interchangeable: the manifest schema is
the reference's, field by field, and an artifact saved by either package
loads in the other bit-equal with zero sweeps.

Both packages compile golden graphs (``get_model(n).build(batch=b)``); the
reference's zoo-name compile goes through its traced frontend, which fails
under jax 0.9.
"""

import itertools
import json

import numpy as np
import pytest

import repro
import repro.core.pass_manager as ref_pass_manager
from repro.core import zoo as ref_zoo
from repro.core.artifact import ArtifactStore as RefArtifactStore
from repro.core.artifact import graph_fingerprint as ref_graph_fingerprint
import repro_torch
import repro_torch.core.pass_manager as pass_manager
from repro_torch.core import zoo
from repro_torch.core.artifact import SCHEMA_VERSION, ArtifactStore, graph_fingerprint
from repro_torch.kernels import gemm

MATRIX = [
    (name, acc, mode)
    for name in sorted(zoo.ZOO)
    for acc in zoo.get_model(name).accelerators
    if acc in ("gemmini", "edge_npu")
    for mode in ("naive", "baseline", "optimized")
]


def _port(name, acc="gemmini", mode="optimized", batch=None, **options):
    return repro_torch.compile(
        zoo.get_model(name).build(batch=batch),
        repro_torch.Target(acc, mode=mode, device="cpu", cache=False),
        options=repro_torch.CompileOptions(**options) if options else None,
    )


def _ref(name, acc="gemmini", mode="optimized", batch=None, **target):
    return repro.compile(
        ref_zoo.get_model(name).build(batch=batch),
        repro.Target(acc, mode=mode, cache=False, **target),
    )


def _assert_bit_equal(got_outs, want_outs):
    assert len(got_outs) == len(want_outs)
    for g, w in zip(got_outs, want_outs):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


class _NoPasses:
    """Asserts that the pass manager of both packages never runs inside —
    the load path must perform zero rewrite-rule fires by construction."""

    def __enter__(self):
        self._orig = pass_manager.PassManager.run, ref_pass_manager.PassManager.run

        def forbidden(self_pm, graph, ctx=None):
            raise AssertionError("PassManager.run fired during artifact load")

        pass_manager.PassManager.run = forbidden
        ref_pass_manager.PassManager.run = forbidden
        return self

    def __exit__(self, *exc):
        pass_manager.PassManager.run, ref_pass_manager.PassManager.run = self._orig
        return False


def _assert_zero_work(module):
    assert module.backend.scheduler.n_solver_calls == 0
    assert module.backend.n_measurements == 0


# -- round trips ------------------------------------------------------------


@pytest.mark.parametrize("name,acc,mode", MATRIX)
def test_roundtrip_bit_exact_with_zero_work(name, acc, mode, tmp_path):
    module = _port(name, acc, mode)
    repro_torch.save(module, tmp_path / "art")
    with _NoPasses():
        restored = repro_torch.load(tmp_path / "art", device="cpu")
    _assert_zero_work(restored)
    assert restored.device.type == "cpu"
    feeds = zoo.get_model(name).feeds(seed=7)
    _assert_bit_equal(restored.run(feeds), module.run(feeds))
    assert restored.pass_report.rewrites_by_pass() == module.pass_report.rewrites_by_pass()
    assert restored.modeled_cycles() == module.modeled_cycles()
    assert restored.plan.stage_assignment() == module.plan.stage_assignment()


@pytest.mark.parametrize("name,acc,mode", MATRIX)
def test_reference_artifact_loads_in_the_port(name, acc, mode, tmp_path):
    """The reference's artifact (its default numpy-emulation route)
    restores onto the port's kernel: bit-equal, zero sweeps, zero passes."""
    want = _ref(name, acc, mode)
    repro.save(want, tmp_path / "art")
    with _NoPasses():
        got = repro_torch.load(tmp_path / "art", device="cpu")
    _assert_zero_work(got)
    feeds = zoo.get_model(name).feeds(seed=9)
    _assert_bit_equal(got.run(feeds), want.run(feeds))
    assert got.modeled_cycles() == want.modeled_cycles()


@pytest.mark.parametrize("name", ["mlp_tiny", "qcnn", "transformer_block"])
def test_port_artifact_loads_in_the_reference(name, tmp_path):
    got = _port(name, "gemmini", "optimized", batch=4)
    repro_torch.save(got, tmp_path / "art")
    with _NoPasses():
        want = repro.load(tmp_path / "art")
    assert want.backend.scheduler.n_solver_calls == 0
    assert want.backend.use_pallas  # the port's manifest names the kernel route
    feeds = zoo.get_model(name).feeds(seed=2, batch=4)
    _assert_bit_equal(want.run(feeds), got.run(feeds))


def test_batched_roundtrip_and_cross_load(tmp_path):
    module = repro_torch.compile(
        "mlp_tiny",
        repro_torch.Target("gemmini", device="cpu", cache=False),
        options=repro_torch.CompileOptions(batch_buckets=(1, 4)),
    )
    repro_torch.save(module, tmp_path / "art")
    with _NoPasses():
        restored = repro_torch.load(tmp_path / "art", device="cpu")
        ref_restored = repro.load(tmp_path / "art")
    assert isinstance(restored, repro_torch.BatchedModule)
    assert isinstance(ref_restored, repro.BatchedModule)
    assert restored.bucket_sizes() == ref_restored.bucket_sizes() == (1, 4)
    assert restored.sample_module is not None and restored.inputs == module.inputs
    for b in restored.bucket_sizes():
        _assert_zero_work(restored.bucket_module(b))
    traffic = [zoo.get_model("mlp_tiny").feeds(seed=s) for s in range(7)]
    for a, b, c in zip(module.run_many(traffic), restored.run_many(traffic), ref_restored.run_many(traffic)):
        _assert_bit_equal(b, a)
        _assert_bit_equal(c, a)


def test_measured_winner_persists(tmp_path, monkeypatch):
    import repro_torch.core.measure as measure

    timings = iter([3e-6, 1e-6] * 64)
    monkeypatch.setattr(measure, "time_executor", lambda ex, args, **kw: next(timings))
    module = _port("mlp_tiny", measure_top_k=2, fresh_backend=True)
    assert module.backend.n_measurements > 0
    repro_torch.save(module, tmp_path / "art")
    restored = repro_torch.load(tmp_path / "art", device="cpu")
    _assert_zero_work(restored)
    for op, orig in zip(restored.ops.values(), module.ops.values()):
        assert op.strategy.schedule_result.measured == orig.strategy.schedule_result.measured
        assert op.strategy.schedule == orig.strategy.schedule
    feeds = zoo.get_model("mlp_tiny").feeds(seed=0)
    _assert_bit_equal(restored.run(feeds), module.run(feeds))


def test_load_needs_a_reachable_device(tmp_path):
    repro_torch.save(_port("mlp_tiny"), tmp_path / "art")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default load target exists")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        repro_torch.load(tmp_path / "art")


# -- manifests ------------------------------------------------------------------


def _normalized(manifest: dict) -> dict:
    """A manifest without what legitimately differs between two saves of
    one model: auto-generated node names (process-global counters, also in
    each schedule's workload name), pass timings, and the documented port
    fields (``use_pallas``, and the reference-only ``interpret`` flag of
    its kernel configs)."""
    m = json.loads(json.dumps(manifest))
    for sd in m["schedules"].values():
        sd["best"]["workload"]["name"] = None
    for nd in m["graph"]["nodes"]:
        if nd["op"] != "input":
            nd["name"] = None
    for step in m["plan"]["steps"]:
        step[3] = None
    for stage in m["stage_assignment"]:
        stage["name"] = None
    for p in m["pass_report"]["passes"]:
        p["duration_ms"] = None
    for cfg in m["kernel_configs"].values():
        cfg.pop("interpret", None)
    m.pop("use_pallas")
    return m


@pytest.mark.parametrize("name,acc", [("qcnn", "gemmini"), ("transformer_block", "edge_npu"), ("toycar_mlp", "gemmini")])
def test_manifest_equals_the_references_field_by_field(name, acc, tmp_path):
    got = _port(name, acc, batch=4)
    want = _ref(name, acc, batch=4, use_pallas=True)  # its route with kernel configs
    repro_torch.save(got, tmp_path / "port")
    repro.save(want, tmp_path / "ref")
    port_man = json.loads((tmp_path / "port" / "manifest.json").read_text())
    ref_man = json.loads((tmp_path / "ref" / "manifest.json").read_text())
    assert sorted(port_man) == sorted(ref_man)
    assert port_man["use_pallas"] is True and port_man["schema_version"] == SCHEMA_VERSION
    assert len(port_man["kernel_configs"]) == len(got.ops)
    got_n, want_n = _normalized(port_man), _normalized(ref_man)
    for key in ref_man:
        if key != "use_pallas":
            assert got_n[key] == want_n[key], key
    assert (tmp_path / "port" / "arrays.npz").read_bytes() == (tmp_path / "ref" / "arrays.npz").read_bytes()


@pytest.mark.parametrize("name", sorted(zoo.ZOO))
def test_graph_fingerprint_equals_the_reference(name):
    for batch in (None, 16):
        assert graph_fingerprint(zoo.get_model(name).build(batch=batch)) == ref_graph_fingerprint(
            ref_zoo.get_model(name).build(batch=batch)
        )
    assert graph_fingerprint(zoo.get_model(name).build()) == graph_fingerprint(zoo.get_model(name).build())


def test_graph_fingerprint_covers_const_bytes():
    g1, g2 = zoo.get_model("mlp_tiny").build(), zoo.get_model("mlp_tiny").build()
    for n in g2.toposort():
        if n.op == "const" and n.value.size:
            n.value = n.value.copy()
            n.value.flat[0] += 1
            break
    assert graph_fingerprint(g1) != graph_fingerprint(g2)


# -- refusals ---------------------------------------------------------------------


@pytest.fixture
def saved(tmp_path):
    path = repro_torch.save(_port("mlp_tiny"), tmp_path / "art")
    return path, json.loads((path / "manifest.json").read_text())


def _rewrite(path, manifest):
    (path / "manifest.json").write_text(json.dumps(manifest))


def test_missing_path_is_a_clear_error(tmp_path):
    with pytest.raises(repro_torch.ArtifactError, match="no compile artifact"):
        repro_torch.load(tmp_path / "nope", device="cpu")


def test_schema_version_mismatch_is_refused(saved):
    path, man = saved
    man["schema_version"] = SCHEMA_VERSION + 1
    _rewrite(path, man)
    with pytest.raises(repro_torch.ArtifactError, match="schema version"):
        repro_torch.load(path, device="cpu")


def test_arch_fingerprint_mismatch_is_refused(saved):
    path, man = saved
    man["arch_fingerprint"] = "0" * 16
    _rewrite(path, man)
    with pytest.raises(repro_torch.ArtifactError, match="architecture fingerprint"):
        repro_torch.load(path, device="cpu")


def test_torn_arrays_are_refused(saved):
    path, _ = saved
    data = (path / "arrays.npz").read_bytes()
    (path / "arrays.npz").write_bytes(data[: len(data) // 2])
    with pytest.raises(repro_torch.ArtifactError, match="content verification"):
        repro_torch.load(path, device="cpu")


def test_tampered_graph_is_refused(saved):
    path, man = saved
    for nd in man["graph"]["nodes"]:
        if nd["op"] not in ("input", "const"):
            nd["dtype"] = "float64"
            break
    _rewrite(path, man)
    with pytest.raises(repro_torch.ArtifactError, match="graph verification"):
        repro_torch.load(path, device="cpu")


def test_tampered_plan_skeleton_is_refused(saved):
    path, man = saved
    man["plan"]["n_slots"] += 1
    _rewrite(path, man)
    with pytest.raises(repro_torch.ArtifactError, match="plan verification"):
        repro_torch.load(path, device="cpu")


def test_missing_schedule_is_refused(saved):
    path, man = saved
    man["schedules"].pop(next(iter(man["schedules"])))
    _rewrite(path, man)
    with pytest.raises(repro_torch.ArtifactError, match="no schedule"):
        repro_torch.load(path, device="cpu")


def test_unregistered_accelerator_is_a_clear_error(saved):
    path, man = saved
    man["accelerator"] = "ghost_npu"
    _rewrite(path, man)
    with pytest.raises(repro_torch.ArtifactError, match="not registered"):
        repro_torch.load(path, device="cpu")


def test_sharded_manifest_is_refused(tmp_path):
    path = tmp_path / "sharded"
    path.mkdir()
    _rewrite(path, {"schema_version": SCHEMA_VERSION, "kind": "sharded", "mesh": [1, 2], "signature": []})
    with pytest.raises(repro_torch.ArtifactError, match="sharded slice"):
        repro_torch.load(path, device="cpu")


def test_cache_spec_graph_is_refused(saved):
    path, man = saved
    man["graph"]["cache_spec"] = {"max_len": 8, "dtype": "int8", "layout": "bshd", "state": [],
                                  "pos_input": "pos", "mask_input": None}
    _rewrite(path, man)
    with pytest.raises(repro_torch.ArtifactError, match="decode slice"):
        repro_torch.load(path, device="cpu")


def test_save_refuses_what_is_not_a_module(tmp_path):
    with pytest.raises(repro_torch.ArtifactError, match="CompiledModule"):
        repro_torch.save({"not": "a module"}, tmp_path / "art")


# -- the content-addressed store ------------------------------------------------------


def _store_compile(tmp_path, mode="optimized", **opts):
    return repro_torch.compile(
        "mlp_tiny",
        repro_torch.Target("edge_npu", mode=mode, device="cpu", cache=False),
        options=repro_torch.CompileOptions(artifact_dir=tmp_path / "store", fresh_backend=True, **opts),
    )


def test_write_through_hits_with_zero_work(tmp_path):
    first = _store_compile(tmp_path)
    with _NoPasses():
        second = _store_compile(tmp_path)
    _assert_zero_work(second)
    feeds = zoo.get_model("mlp_tiny").feeds(seed=2)
    _assert_bit_equal(second.run(feeds), first.run(feeds))


def test_write_through_keys_separate_modes_and_buckets(tmp_path):
    _store_compile(tmp_path)
    _store_compile(tmp_path, mode="naive")
    assert len(list((tmp_path / "store").rglob("manifest.json"))) == 2
    batched = _store_compile(tmp_path, batch_buckets=(1, 4))
    # buckets 1 and 4, plus the per-sample plan (same key as the plain compile)
    assert len(list((tmp_path / "store").rglob("manifest.json"))) == 4
    with _NoPasses():
        again = _store_compile(tmp_path, batch_buckets=(1, 4))
    for b in again.bucket_sizes():
        _assert_zero_work(again.bucket_module(b))
    traffic = [zoo.get_model("mlp_tiny").feeds(seed=s) for s in range(5)]
    for a, b in zip(again.run_many(traffic), batched.run_many(traffic)):
        _assert_bit_equal(a, b)


def test_corrupt_store_entry_is_a_miss_not_an_error(tmp_path):
    _store_compile(tmp_path)
    for npz in (tmp_path / "store").rglob("arrays.npz"):
        npz.write_bytes(b"torn")
    with pytest.warns(RuntimeWarning, match="unusable compile artifact"):
        module = _store_compile(tmp_path)
    assert module.backend.scheduler.n_solver_calls > 0  # recompiled
    rewritten = _store_compile(tmp_path)
    _assert_zero_work(rewritten)
    feeds = zoo.get_model("mlp_tiny").feeds(seed=4)
    _assert_bit_equal(rewritten.run(feeds), module.run(feeds))


def test_passes_override_bypasses_the_store(tmp_path):
    _store_compile(tmp_path, passes=[])
    assert not (tmp_path / "store").exists()


def test_store_key_equals_the_references_and_covers_every_knob():
    base = dict(source_fingerprint="f" * 64, arch_fingerprint="a" * 16, mode="proposed",
                use_pallas=True, bucket=None, measure_top_k=None)
    k0 = ArtifactStore.key_for(**base)
    assert k0 == RefArtifactStore.key_for(**base)
    for change in (dict(mode="naive"), dict(use_pallas=False), dict(bucket=4), dict(measure_top_k=3),
                   dict(arch_fingerprint="b" * 16), dict(source_fingerprint="0" * 64)):
        assert ArtifactStore.key_for(**{**base, **change}) != k0


def test_a_cpu_measured_entry_never_answers_for_another_device(tmp_path, monkeypatch):
    import repro_torch.core.measure as measure
    from repro_torch.core import pipeline

    timings = itertools.cycle([3e-6, 1e-6])
    monkeypatch.setattr(measure, "time_executor", lambda ex, args, **kw: next(timings))
    cpu = _store_compile(tmp_path, measure_top_k=2)
    assert cpu.backend.n_measurements > 0
    with _NoPasses():
        again = _store_compile(tmp_path, measure_top_k=2)
    _assert_zero_work(again)  # the CPU's own entry answers for the CPU
    # the same compile as timed on another device misses the CPU's entry
    monkeypatch.setattr(pipeline, "device_tag", lambda device: "cuda:NVIDIA H100 80GB HBM3")
    other = _store_compile(tmp_path, measure_top_k=2)
    assert other.backend.n_measurements == cpu.backend.n_measurements
    assert len(list((tmp_path / "store").rglob("manifest.json"))) == 2
    base = dict(source_fingerprint="f" * 64, arch_fingerprint="a" * 16, mode="proposed",
                use_pallas=True, bucket=None, measure_top_k=2)
    assert (ArtifactStore.key_for(**base, measure_device="cpu")
            != ArtifactStore.key_for(**base, measure_device="cuda:NVIDIA H100 80GB HBM3"))


def test_roundtrip_makes_no_launch_on_the_cpu(tmp_path):
    gemm.reset_launches()
    module = _port("qcnn", "edge_npu")
    repro_torch.save(module, tmp_path / "art")
    restored = repro_torch.load(tmp_path / "art", device="cpu")
    restored.run(zoo.get_model("qcnn").feeds(seed=0))
    assert sum(gemm.LAUNCHES.values()) == 0
