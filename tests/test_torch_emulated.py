"""The port's emulated-intrinsic route (``Target(use_pallas=False)``) and
its per-node interpreter, held to the reference's default route on the CPU.

The reference's default for ``gemmini`` and ``edge_npu`` is its numpy
emulation: a tiled loop nest that calls the description's registered
compute intrinsic once per PE tile.  The port runs the same loop on torch
tensors.  Every zoo model x both accelerators x every mode must give
bit-equal outputs, equal modeled cycles and the same number of intrinsic
calls per run as the reference, and a user's intrinsic (saturating,
in-place, or with smaller tile limits) must change what the route does
as it does in the reference.
"""

import re

import numpy as np
import pytest
import torch

import repro
from repro.core import build_backend as ref_build_backend
from repro.core import ir as ref_ir
from repro.core import zoo as ref_zoo
from repro.core.descriptions import make_edge_npu_description as ref_edge_npu
from repro.core.descriptions import make_gemmini_description as ref_gemmini
from repro.core.mapping import MappingGenerator as RefMappingGenerator
from repro.core.zoo import mlp_graph as ref_mlp_graph
import repro_torch
from repro_torch.core import ir, zoo
from repro_torch.core.configurators import build_backend
from repro_torch.core.descriptions import make_edge_npu_description, make_gemmini_description
from repro_torch.core.executor import CompiledModule, ExecutionPlan
from repro_torch.core.intrinsics import HardwareIntrinsicGenerator, int32_tile_product
from repro_torch.core.mapping import MappingGenerator
from repro_torch.core.zoo import mlp_graph
from repro_torch.kernels import gemm

MODELS = ("qcnn", "toycar_mlp", "mlp_tiny", "transformer_block")
MODES = ("optimized", "baseline", "naive")
MAKERS = {"gemmini": (ref_gemmini, make_gemmini_description),
          "edge_npu": (ref_edge_npu, make_edge_npu_description)}
#: intrinsic calls per run of each zoo model at batch 1, the same in every
#: mode: (gemmini, edge_npu), as the reference's emulated route makes them
CALLS = {"qcnn": (64, 386), "toycar_mlp": (912, 3616), "mlp_tiny": (8, 32),
         "transformer_block": (136, 1088)}


def counted(desc):
    """``desc`` with each compute intrinsic wrapped to count its calls."""
    calls = [0]
    for intr in desc.intrinsics.values():
        if intr.kind == "compute":
            def wrapped(a, b, acc, _fn=intr.fn):
                calls[0] += 1
                return _fn(a, b, acc)

            intr.fn = wrapped
    return desc, calls


def assert_bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


#: the reference's backend memo keys by the description's fingerprint, which
#: does not read the intrinsic functions: its counted descriptions compile
#: on fresh backends
REF_FRESH = repro.CompileOptions(fresh_backend=True)


def _target(acc, mode, **kw):
    return repro_torch.Target(acc, mode=mode, device="cpu", cache=False, use_pallas=False, **kw)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("acc", ("gemmini", "edge_npu"))
@pytest.mark.parametrize("name", MODELS)
def test_emulated_route_matches_the_reference(name, acc, mode):
    """The 24 modules: bit-equal outputs, equal modeled cycles and equal
    intrinsic calls per run, planned and interpreted; no kernel launch."""
    ref_make, port_make = MAKERS[acc]
    ref_desc, ref_calls = counted(ref_make())
    port_desc, port_calls = counted(port_make())
    want_m = repro.compile(
        ref_zoo.get_model(name).build(), repro.Target(ref_desc, mode=mode, cache=False), options=REF_FRESH
    )
    got_m = repro_torch.compile(zoo.get_model(name).build(), _target(port_desc, mode))
    assert not got_m.backend.use_pallas and not want_m.backend.use_pallas
    assert got_m.modeled_cycles() == want_m.modeled_cycles()
    gemm.reset_launches()
    feeds = [ref_zoo.get_model(name).feeds(seed) for seed in range(2)]
    for f in feeds:
        ref_calls[0] = port_calls[0] = 0
        want = want_m.run(f)
        got = got_m.run(f)
        assert port_calls[0] == ref_calls[0] == CALLS[name][acc == "edge_npu"]
        assert_bit_equal(got, want)
        port_calls[0] = 0
        assert_bit_equal(got_m.run(f, use_plan=False), want)
        assert port_calls[0] == CALLS[name][acc == "edge_npu"]
    for got, want in zip(got_m.run_many(feeds, use_plan=False), want_m.run_many(feeds)):
        assert_bit_equal(got, want)
    assert_bit_equal(got_m.run_many(feeds)[1], want_m.run(feeds[1]))
    assert sum(gemm.LAUNCHES.values()) == 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("acc", ("gemmini", "edge_npu"))
def test_routes_agree_and_the_interpreter_matches_the_kernel_route(acc, mode):
    """The zoo's emulated modules equal the kernel route's on the CPU, whose
    interpreter (the unspecialised executors) equals its plan too."""
    for name in ("qcnn", "transformer_block"):
        model = zoo.get_model(name)
        feeds = model.feeds(3)
        emulated = repro_torch.compile(model.build(), _target(acc, mode))
        kernel = repro_torch.compile(model.build(), repro_torch.Target(acc, mode=mode, device="cpu", cache=False))
        assert kernel.backend.use_pallas
        planned = kernel.run(feeds)
        assert_bit_equal(kernel.run(feeds, use_plan=False), planned)
        assert_bit_equal(emulated.run(feeds), planned)


def test_plan_specializes_const_weight_executors():
    mod = build_backend(make_gemmini_description(), use_pallas=False).compile_graph(
        mlp_graph((16,) * 3), "proposed", device="cpu"
    )
    raw = {op.executor for op in mod.ops.values()}
    steps = [s for s in mod.plan.steps if s.op.startswith("generalized")]
    assert steps and all(s.fn not in raw for s in steps)
    kernel = build_backend(make_gemmini_description()).compile_graph(
        mlp_graph((16,) * 3), "proposed", device="cpu"
    )
    assert {s.fn for s in kernel.plan.steps} >= {op.executor for op in kernel.ops.values()}


def test_run_many_results_stay_independent_and_match_the_interpreter():
    """The counterpart of the reference's run_many test: results of one
    call survive the next, and the interpreter gives the same."""
    mod = build_backend(make_gemmini_description(), use_pallas=False).compile_graph(
        mlp_graph((16,) * 3), "proposed", device="cpu"
    )
    feeds = [{"x": np.full((1, 16), i, dtype=np.int8)} for i in range(4)]
    outs = mod.run_many(feeds)
    snapshots = [o[0].copy() for o in outs]
    mod.run_many([{"x": np.full((1, 16), 9, dtype=np.int8)}] * 4)
    for out, snap in zip(outs, snapshots):
        np.testing.assert_array_equal(out[0], snap)
    for p, leg in zip(outs, mod.run_many(feeds, use_plan=False)):
        np.testing.assert_array_equal(p[0], leg[0])
    with pytest.raises(ValueError, match="requires use_plan=True"):
        mod.run(feeds[0], use_plan=False, pipelined=True)
    with pytest.raises(ValueError, match="requires use_plan=True"):
        mod.run_many(feeds, use_plan=False, pipelined=True)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_plan_and_interpreter_handle_none_operands(use_pallas):
    def graph(ir_):
        x = ir_.input_((4, 8), "int8", name="x")
        w = ir_.const(np.ones((8, 8), dtype=np.int8))
        node = ir_.Node("generalized_dense", [x, w, None], {"quantized": False}, shape=(4, 8), dtype="int32")
        return ir_.Graph([node])

    mod = build_backend(make_gemmini_description(), use_pallas=use_pallas).compile_graph(
        graph(ir), "proposed", device="cpu"
    )
    ref = ref_build_backend(ref_gemmini()).compile_graph(graph(ref_ir), mode="proposed")
    feeds = {"x": np.ones((4, 8), dtype=np.int8)}
    expected = np.full((4, 8), 8, dtype=np.int32)
    for got in (mod.run(feeds), mod.run(feeds, use_plan=False), ref.run(feeds, use_plan=False)):
        np.testing.assert_array_equal(got[0], expected)
        assert got[0].dtype == np.int32


def test_inplace_accumulating_intrinsic_stays_correct():
    """An in-place-accumulating intrinsic (legal for the generic tile loop)
    must not corrupt the fast path's shared initial accumulator: the
    build-time probe sees the write and falls back to the tile loop, as the
    reference's read-only init makes it do."""

    def inplace_mma(a_tile, b_tile, acc_tile):
        acc_tile.add_(int32_tile_product(a_tile, b_tile))
        return acc_tile

    def ref_inplace_mma(a_tile, b_tile, acc_tile):
        np.add(acc_tile, a_tile.astype(np.int32) @ b_tile.astype(np.int32), out=acc_tile)
        return acc_tile

    desc, ref_desc = make_edge_npu_description(), ref_edge_npu()
    for d, fn in ((desc, inplace_mma), (ref_desc, ref_inplace_mma)):
        for intr in d.intrinsics.values():
            if intr.kind == "compute":
                intr.fn = fn
    desc, calls = counted(desc)
    ref_desc, ref_calls = counted(ref_desc)
    mod = build_backend(desc, use_pallas=False).compile_graph(mlp_graph((8, 8, 8)), "proposed", device="cpu")
    ref = ref_build_backend(ref_desc).compile_graph(ref_mlp_graph((8, 8, 8)), mode="proposed")
    feeds = {"x": np.full((1, 8), 3, dtype=np.int8)}
    calls[0] = ref_calls[0] = 0
    r1 = mod.run(feeds)[0].copy()
    np.testing.assert_array_equal(r1, ref.run(feeds)[0])
    assert calls[0] == ref_calls[0]  # both took the tile loop
    for _ in range(3):
        np.testing.assert_array_equal(mod.run(feeds)[0], r1)
    np.testing.assert_array_equal(mod.run(feeds, use_plan=False)[0], r1)


def test_smaller_intrinsic_tile_limits_are_refused_at_compile_time():
    def shrink(desc):
        for intr in desc.intrinsics.values():
            if intr.kind == "compute":
                intr.tile_limits = {"N": 4, "C": 4, "K": 4}
        return desc

    with pytest.raises(ValueError) as ref_err:
        ref_build_backend(shrink(ref_gemmini())).compile_graph(ref_mlp_graph((16,) * 3), mode="proposed")
    with pytest.raises(ValueError) as err:
        build_backend(shrink(make_gemmini_description()), use_pallas=False).compile_graph(
            mlp_graph((16,) * 3), "proposed", device="cpu"
        )
    assert str(err.value) == str(ref_err.value)
    assert "Eq.(1) violated upstream" in str(err.value)
    # the kernel route runs no intrinsic and does not check it
    build_backend(shrink(make_gemmini_description())).compile_graph(
        mlp_graph((16,) * 3), "proposed", device="cpu"
    )


def _saturating(desc, lo, hi, numpy_tiles: bool):
    def sat(a_tile, b_tile, acc_tile):
        if numpy_tiles:
            return acc_tile + np.clip(a_tile.astype(np.int32) @ b_tile.astype(np.int32), lo, hi)
        return acc_tile + torch.clamp(int32_tile_product(a_tile, b_tile), lo, hi)

    for intr in desc.intrinsics.values():
        if intr.kind == "compute":
            intr.fn = sat
    return desc


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ("transformer_block", "qcnn"))
def test_saturating_intrinsic_changes_the_output_as_in_the_reference(name, mode):
    """A user's saturating intrinsic is executed by the emulated route: the
    output equals the reference's with the same numpy intrinsic, differs
    from the multiply-add's, and the batched fast path's probe falls back
    to the per-instance loop."""
    lo, hi = -300, 300
    ref_desc, ref_calls = counted(_saturating(ref_gemmini(), lo, hi, True))
    desc, calls = counted(_saturating(make_gemmini_description(), lo, hi, False))
    ref = repro.compile(
        ref_zoo.get_model(name).build(batch=2), repro.Target(ref_desc, mode=mode, cache=False), options=REF_FRESH
    )
    got_m = repro_torch.compile(zoo.get_model(name).build(batch=2), _target(desc, mode))
    plain_desc, plain_calls = counted(make_gemmini_description())
    plain = repro_torch.compile(zoo.get_model(name).build(batch=2), _target(plain_desc, mode))
    feeds = zoo.get_model(name).feeds(0, batch=2)
    calls[0] = ref_calls[0] = plain_calls[0] = 0
    want = ref.run(feeds)
    got = got_m.run(feeds)
    assert_bit_equal(got, want)
    assert calls[0] == ref_calls[0] > 0
    assert not np.array_equal(got[0], plain.run(feeds)[0])
    bmm = [n for n in got_m.ops if len(n.inputs[1].shape) == 3]
    assert bool(bmm) == (name == "transformer_block")
    # the multiply-add passes the batched probe and skips the intrinsic on
    # the attention GEMMs; the saturating one replays them tile by tile
    assert (calls[0] > plain_calls[0]) == bool(bmm)
    assert_bit_equal(got_m.run(feeds, use_plan=False), want)


#: int8 operands whose accumulators pass 2^24, and a requantize scale that
#: is not float32-exact, chosen so that rounding in float32 moves one code
BIG_K = 1536
BIG_SCALE = 1.0 / 171550.0


def _big_acc_operands():
    rng = np.random.default_rng(7)
    return (rng.integers(110, 128, (4, BIG_K)).astype(np.int8),
            rng.integers(110, 128, (BIG_K, 16)).astype(np.int8))


def _big_acc_graph(ir_):
    _, w = _big_acc_operands()
    x = ir_.input_((4, BIG_K), "int8", name="x")
    node = ir_.Node(
        "generalized_dense", [x, ir_.const(w, name="w"), None],
        {"quantized": True, "requant_scale": BIG_SCALE, "clip_lo": -128, "clip_hi": 127},
        shape=(4, 16), dtype="int8",
    )
    return ir_.Graph([node], name="big_acc")


def test_requantize_in_float64_where_the_kernel_route_rounds_in_float32():
    """The emulated route requantizes in float64, as the reference's
    emulation does; the kernel route requantizes in float32, which here
    lands one code off.  Each route gives what its reference gives."""
    x, w = _big_acc_operands()
    feeds = {"x": x}
    acc = x.astype(np.int64) @ w.astype(np.int64)
    assert acc.min() > 2**24
    want = ref_build_backend(ref_gemmini()).compile_graph(_big_acc_graph(ref_ir), mode="proposed").run(feeds)
    emulated = build_backend(make_gemmini_description(), use_pallas=False).compile_graph(
        _big_acc_graph(ir), "proposed", device="cpu"
    )
    assert_bit_equal(emulated.run(feeds), want)
    assert_bit_equal(emulated.run(feeds, use_plan=False), want)
    f64 = np.clip(np.rint(acc * BIG_SCALE), -128, 127).astype(np.int8)
    np.testing.assert_array_equal(want[0], f64)
    kernel = build_backend(make_gemmini_description()).compile_graph(_big_acc_graph(ir), "proposed", device="cpu")
    f32 = np.clip(np.rint(acc.astype(np.float32) * np.float32(BIG_SCALE)), -128, 127).astype(np.int8)
    np.testing.assert_array_equal(kernel.run(feeds)[0], f32)
    assert (f32 != f64).sum() == 1 and np.abs(f32.astype(int) - f64).max() == 1


@pytest.mark.parametrize("seed", range(4))
def test_tiled_executor_matches_the_reference(seed):
    """``to_tiled_executor`` on random padded shapes, through the tile loop
    and through ``pad_w`` + ``prepadded``, against the reference's."""
    rng = np.random.default_rng(seed)
    port_backend = build_backend(make_gemmini_description(), use_pallas=False)
    ref_backend = ref_build_backend(ref_gemmini())
    # none a multiple of the 16-wide PE tile: every operand is padded
    m, k, n = (16 * int(q) + int(r) for q, r in zip(rng.integers(0, 4, 3), rng.integers(1, 16, 3)))
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    from repro.core.arch_spec import GemmWorkload as RefWorkload
    from repro_torch.core.arch_spec import GemmWorkload

    ref_sched = ref_backend.scheduler.schedule(RefWorkload(N=m, C=k, K=n, name="g")).best
    sched = port_backend.scheduler.schedule(GemmWorkload(N=m, C=k, K=n, name="g")).best
    assert sched.to_dict() == ref_sched.to_dict()
    assert all(sched.padded(j) > d for j, d in zip("NCK", (m, k, n)))
    ref_run = RefMappingGenerator(ref_gemmini()).to_tiled_executor(
        ref_sched, ref_gemmini().compute_intrinsic_for_tag("gemmini_qgemm")
    )
    run = MappingGenerator(make_gemmini_description()).to_tiled_executor(
        sched, make_gemmini_description().compute_intrinsic_for_tag("gemmini_qgemm")
    )
    want = ref_run(x, w)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for got in (run(xt, wt), run.prepadded(xt, run.pad_w(wt), n)):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(run.pad_w(wt).numpy(), ref_run.pad_w(w))


@pytest.mark.parametrize("acc", ("gemmini", "edge_npu"))
def test_mapping_describe_matches_the_reference(acc):
    ref_make, port_make = MAKERS[acc]
    want = repro.compile(ref_zoo.get_model("qcnn").build(), repro.Target(acc, cache=False))
    got = repro_torch.compile(zoo.get_model("qcnn").build(), _target(acc, "optimized"))
    ref_texts = [RefMappingGenerator(ref_make()).describe(op.strategy.schedule) for op in want.ops.values()]
    texts = [MappingGenerator(port_make()).describe(op.strategy.schedule) for op in got.ops.values()]
    unnamed = [[re.sub(r"\[[^\]]*\]", "[]", t, count=1) for t in ts] for ts in (texts, ref_texts)]
    assert unnamed[0] == unnamed[1] and "outer tiles" in texts[0]


def test_intrinsic_generator_matches_the_reference():
    from repro.core.intrinsics import HardwareIntrinsicGenerator as RefGenerator

    for acc, (ref_make, port_make) in MAKERS.items():
        ref_gen, gen = RefGenerator(ref_make()), HardwareIntrinsicGenerator(port_make())
        assert [(i.name, i.tag, i.tile_limits, i.quantized) for i in gen.all()] == [
            (i.name, i.tag, i.tile_limits, i.quantized) for i in ref_gen.all()
        ]
        with pytest.raises(KeyError, match="no compute intrinsic generated"):
            gen.for_tag("nope")


@pytest.mark.parametrize("dtypes", [("int8", "int8"), ("uint8", "int8"), ("int32", "int32"), ("float32", "int16")])
def test_tile_product_wraps_as_numpy_int32(dtypes):
    rng = np.random.default_rng(3)
    info = [np.iinfo(d) if d.startswith(("int", "uint")) else None for d in dtypes]
    a, b = (
        (rng.integers(i.min, i.max, (16, 16), endpoint=True) if i else rng.normal(size=(16, 16)) * 1e4).astype(d)
        for i, d in zip(info, dtypes)
    )
    acc = rng.integers(-(2**40), 2**40, (16, 16))
    want = acc + a.astype(np.int32) @ b.astype(np.int32)
    got = make_gemmini_description().compute_intrinsic_for_tag("gemmini_qgemm").fn(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(acc)
    )
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_hand_assembled_module_interprets_host_only_graphs():
    x = ir.input_((16, 16), "int32", name="x")
    g = ir.Graph([ir.softmax(ir.dequantize(x, scale=0.1))])
    mod = CompiledModule(graph=g, desc=make_gemmini_description(), mode="proposed", device=torch.device("cpu"))
    feeds = {"x": np.arange(256, dtype=np.int32).reshape(16, 16)}
    assert isinstance(mod.finalize(), ExecutionPlan)
    assert_bit_equal(mod.run(feeds, use_plan=False), mod.run(feeds))
