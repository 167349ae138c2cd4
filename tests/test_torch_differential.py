"""The differential oracle: seeded random graphs through the port, held to
the reference (``tests/test_differential.py``, the reference's standing
oracle for every pass and executor change).

Small random IR graphs — int8 dense chains, f32 dense chains, int8 convs
with and without a fused max-pool, batched ``x·yᵀ`` products, f32
elementwise chains, decode steps over an int8 KV cache — are built with
each package's ``ir`` from the same numpy seed, and compiled on gemmini
and edge_npu in every mode.  These must all agree:

* the port's planned run and its interpreter (``use_plan=False``), on the
  kernel route (the port's default) and on the emulated route
  (``use_pallas=False``);
* ``repro.compile`` of the reference's graph (the reference's default
  route);
* ``repro.core.ir.execute_graph``, the reference's graph interpreter;

with equal modeled cycles and equal post-pass op sequences.  Integer
outputs are bit-exact; float outputs agree within rtol 1e-6 and atol 5e-7,
the order of float32 summation (the port's host GEMMs sum in torch's
order, the reference's in numpy's).  A sharded arm runs the same graphs on
a random ``(data, model)`` mesh against the reference's sharded module and
the port's single-device one (modeled ``comm`` included).

The generators keep the reference's invariants that make the int8 paths
bit-exact by construction: requantize scales are powers of two (float32
exact) and accumulators stay far inside 2^24, so the kernel route's
float32 requantization equals the emulated route's float64.  A seeded
sweep always runs; the hypothesis exploration is derandomized, so every
run draws the same examples and counts the same passes.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro
from repro.core import ir as ref_ir
from repro.core import zoo as ref_zoo
import repro_torch
from repro_torch.core import ir
from repro_torch.kernels import gemm

ACCELERATORS = ("gemmini", "edge_npu")
MODES = ("optimized", "baseline", "naive")
ROUTES = (True, False)  # use_pallas: the kernel route, the emulated route
FLOAT_TOL = dict(rtol=1e-6, atol=5e-7)
#: tensor-parallel meshes: a data axis splits the batch, which a prebuilt
#: graph cannot be rebuilt for (both packages refuse it the same way)
MESHES = ((1, 2), (1, 4))


@pytest.fixture(autouse=True)
def _no_launches():
    gemm.reset_launches()
    yield
    assert sum(gemm.LAUNCHES.values()) == 0, "a CPU tensor launched the CUDA kernel"


def _ref_target(acc, mode, **kw):
    # cache=False: random workloads never reach a persistent schedule
    # cache; use_mip=False keeps the sweeps fast (no MIP solves here anyway)
    return repro.Target(acc, mode=mode, cache=False, use_mip=False, **kw)


def _target(acc, mode, use_pallas, **kw):
    return repro_torch.Target(acc, mode=mode, cache=False, use_mip=False, use_pallas=use_pallas,
                              device="cpu", **kw)


# ---------------------------------------------------------------------------
# specs: the reference's four generators, plus a conv with a fused pool and
# a batched x·yᵀ product
# ---------------------------------------------------------------------------


def _qdense_chain_spec(rng: np.random.Generator) -> dict:
    depth = int(rng.integers(1, 4))
    dims = [int(d) for d in rng.choice([3, 5, 8, 13, 16, 24], size=depth + 1)]
    return {
        "kind": "qdense_chain",
        "m": int(rng.integers(1, 6)),
        "dims": dims,
        "scales": [2.0 ** -int(rng.integers(3, 8)) for _ in range(depth)],
        "bias": [bool(rng.integers(0, 2)) for _ in range(depth)],
        "transpose_b": [bool(rng.integers(0, 2)) for _ in range(depth)],
        "relu_clip": [bool(rng.integers(0, 2)) for _ in range(depth)],
    }


def _fdense_chain_spec(rng: np.random.Generator) -> dict:
    depth = int(rng.integers(1, 3))
    dims = [int(d) for d in rng.choice([4, 7, 16, 20], size=depth + 1)]
    return {
        "kind": "fdense_chain",
        "m": int(rng.integers(1, 5)),
        "dims": dims,
        "bias": [bool(rng.integers(0, 2)) for _ in range(depth)],
        "act": [str(rng.choice(["none", "relu", "gelu"])) for _ in range(depth)],
    }


def _qconv_spec(rng: np.random.Generator, pool: bool = False) -> dict:
    return {
        "kind": "qconv",
        "hw": int(rng.integers(5, 9)),
        "ci": int(rng.choice([3, 4, 8])),
        "co": int(rng.choice([4, 8])),
        "k": int(rng.choice([2, 3])),
        "stride": int(rng.integers(1, 3)),
        "padding": int(rng.integers(0, 2)),
        "bias": bool(rng.integers(0, 2)),
        "scale": 2.0 ** -int(rng.integers(4, 8)),
        "pool": pool,
    }


def _qconv_pool_spec(rng: np.random.Generator) -> dict:
    return _qconv_spec(rng, pool=True)


def _bmm_spec(rng: np.random.Generator) -> dict:
    """The attention scores' shape: x[B, M, C] · y[B, N, C]ᵀ, both
    activations, optionally requantized."""
    return {
        "kind": "bmm",
        "b": int(rng.integers(1, 4)),
        "m": int(rng.choice([1, 4, 8, 16])),
        "n": int(rng.choice([4, 8, 16])),
        "c": int(rng.choice([8, 16, 24])),
        "requant": bool(rng.integers(0, 2)),
        "scale": 2.0 ** -int(rng.integers(4, 9)),
    }


def _ew_chain_spec(rng: np.random.Generator) -> dict:
    return {
        "kind": "ew_chain",
        "shape": (int(rng.integers(1, 4)), int(rng.choice([5, 9, 16]))),
        "ops": [str(rng.choice(["add", "mul", "relu", "gelu"])) for _ in range(int(rng.integers(2, 5)))],
    }


SPEC_MAKERS = (_qdense_chain_spec, _fdense_chain_spec, _qconv_spec, _qconv_pool_spec, _bmm_spec,
               _ew_chain_spec)


def _materialize(spec: dict, seed: int):
    """(build, feeds): ``build(m)`` makes a fresh graph with the IR module
    ``m`` (the pass pipeline mutates graphs, so every consumer gets its
    own); constants come from ``seed``."""
    rng = np.random.default_rng(seed)
    kind = spec["kind"]

    if kind == "qdense_chain":
        dims, m = spec["dims"], spec["m"]
        x = rng.integers(-16, 16, size=(m, dims[0])).astype(np.int8)
        ws = [rng.integers(-8, 8, size=(dims[i], dims[i + 1])).astype(np.int8) for i in range(len(dims) - 1)]
        bs = [rng.integers(-64, 64, size=(d,)).astype(np.int32) for d in dims[1:]]

        def build(ir_):
            h = ir_.input_((m, dims[0]), "int8", name="x")
            for i, w in enumerate(ws):
                wn = ir_.transpose(ir_.const(w.T), (1, 0)) if spec["transpose_b"][i] else ir_.const(w)
                h = ir_.dense(h, wn)
                if spec["bias"][i]:
                    h = ir_.bias_add(h, ir_.const(bs[i]))
                h = ir_.requantize(h, scale=spec["scales"][i])
                h = ir_.clip(h, lo=0 if spec["relu_clip"][i] else -128, hi=127)
            return ir_.Graph([h], name="fuzz_qdense")

        return build, {"x": x}

    if kind == "fdense_chain":
        dims, m = spec["dims"], spec["m"]
        x = rng.standard_normal((m, dims[0])).astype(np.float32)
        ws = [(rng.standard_normal((dims[i], dims[i + 1])) * 0.3).astype(np.float32)
              for i in range(len(dims) - 1)]
        bs = [rng.standard_normal((d,)).astype(np.float32) for d in dims[1:]]

        def build(ir_):
            h = ir_.input_((m, dims[0]), "float32", name="x")
            for i, w in enumerate(ws):
                h = ir_.dense(h, ir_.const(w))
                if spec["bias"][i]:
                    h = ir_.bias_add(h, ir_.const(bs[i]))
                if spec["act"][i] == "relu":
                    h = ir_.relu(h)
                elif spec["act"][i] == "gelu":
                    h = ir_.gelu(h)
            return ir_.Graph([h], name="fuzz_fdense")

        return build, {"x": x}

    if kind == "qconv":
        hw, ci, co, k = spec["hw"], spec["ci"], spec["co"], spec["k"]
        x = rng.integers(-16, 16, size=(1, hw, hw, ci)).astype(np.int8)
        w = rng.integers(-8, 8, size=(k, k, ci, co)).astype(np.int8)
        b = rng.integers(-64, 64, size=(co,)).astype(np.int32)

        def build(ir_):
            h = ir_.input_((1, hw, hw, ci), "int8", name="x")
            h = ir_.conv2d(h, ir_.const(w), stride=spec["stride"], padding=spec["padding"])
            if spec["bias"]:
                h = ir_.bias_add(h, ir_.const(b))
            h = ir_.clip(ir_.requantize(h, scale=spec["scale"]), lo=-128, hi=127)
            if spec["pool"] and min(h.shape[1:3]) >= 2:
                h = ir_.max_pool2d(h, size=2, stride=2)
            return ir_.Graph([h], name="fuzz_qconv")

        return build, {"x": x}

    if kind == "bmm":
        b, m, n, c = spec["b"], spec["m"], spec["n"], spec["c"]
        x = rng.integers(-128, 128, size=(b, m, c)).astype(np.int8)
        y = rng.integers(-128, 128, size=(b, n, c)).astype(np.int8)

        def build(ir_):
            xs = ir_.input_((b, m, c), "int8", name="x")
            ys = ir_.input_((b, n, c), "int8", name="y")
            h = ir_.dense(xs, ir_.transpose(ys, (0, 2, 1)))
            if spec["requant"]:
                h = ir_.clip(ir_.requantize(h, scale=spec["scale"]), lo=-128, hi=127)
            return ir_.Graph([h], name="fuzz_bmm")

        return build, {"x": x, "y": y}

    if kind == "ew_chain":
        shape = spec["shape"]
        x = rng.standard_normal(shape).astype(np.float32)
        consts = [rng.standard_normal(shape).astype(np.float32) for _ in spec["ops"]]

        def build(ir_):
            h = ir_.input_(shape, "float32", name="x")
            for op, c in zip(spec["ops"], consts):
                if op == "add":
                    h = ir_.add(h, ir_.const(c))
                elif op == "mul":
                    h = ir_.mul(h, ir_.const(c))
                elif op == "relu":
                    h = ir_.relu(h)
                else:
                    h = ir_.gelu(h)
            return ir_.Graph([h], name="fuzz_ew")

        return build, {"x": x}

    raise AssertionError(kind)


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------


def _assert_same(got, want, what: str, spec: dict):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, spec, got.shape, got.dtype,
                                                                 want.shape, want.dtype)
    if np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=f"{what}: {spec}")
    else:
        np.testing.assert_allclose(got, want, err_msg=f"{what}: {spec}", **FLOAT_TOL)


def _assert_all_same(got: list, want: list, what: str, spec: dict):
    assert len(got) == len(want), (what, spec)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same(g, w, f"{what}[out{i}]", spec)


def _ops(module) -> list[str]:
    return [n.op for n in module.graph.toposort()]


def check_conformance(build, feeds, spec: dict):
    interpreted = ref_ir.execute_graph(build(ref_ir), feeds)
    _assert_all_same(ir.execute_graph(build(ir), feeds), interpreted, "port graph interpreter", spec)
    for acc in ACCELERATORS:
        for mode in MODES:
            want = repro.compile(build(ref_ir), _ref_target(acc, mode))
            want_out = want.run(feeds)
            _assert_all_same(want_out, interpreted, f"reference[{acc}:{mode}]-vs-interpreter", spec)
            for use_pallas in ROUTES:
                where = f"{acc}:{mode}:{'kernel' if use_pallas else 'emulated'}"
                module = repro_torch.compile(build(ir), _target(acc, mode, use_pallas))
                assert _ops(module) == _ops(want), (where, spec)
                assert module.modeled_cycles() == want.modeled_cycles(), (where, spec)
                _assert_all_same(module.run(feeds), want_out, f"planned[{where}]", spec)
                _assert_all_same(module.run(feeds, use_plan=False), want_out, f"interpreted[{where}]", spec)


# -- the seeded sweep: every generator, always run ----------------------------------


@pytest.mark.parametrize("seed", range(8 * len(SPEC_MAKERS)))
def test_seeded_differential_sweep(seed):
    rng = np.random.default_rng(1000 + seed)
    spec = SPEC_MAKERS[seed % len(SPEC_MAKERS)](rng)
    check_conformance(*_materialize(spec, seed=2000 + seed), spec)


# -- decode steps: KV-cache graphs, every output compared ---------------------------


def _decode_step_spec(rng: np.random.Generator) -> dict:
    d = int(rng.choice([8, 16]))
    max_len = int(rng.choice([16, 32]))
    return {"kind": "decode_step", "d": d, "max_len": max_len, "pos": int(rng.integers(1, max_len - 1))}


def _materialize_decode(spec: dict, seed: int):
    """A single-sample decode step: quantized attention over an int8 KV
    cache; every scale dyadic."""
    d, ml, pos = spec["d"], spec["max_len"], spec["pos"]
    rng = np.random.default_rng(seed)
    ws = {t: (rng.normal(size=(d, d)) * 0.05).astype(np.float32) for t in ("q", "k", "v", "attn")}
    bs = {t: rng.integers(-64, 64, size=(d,)).astype(np.int32) for t in ("q", "k", "v", "attn")}
    z = ref_zoo

    def build(ir_):
        x = ir_.input_((1, d), "int8", name="x")
        k_cache = ir_.input_((ml, d), "int8", name="k_cache")
        v_cache = ir_.input_((ml, d), "int8", name="v_cache")
        p = ir_.input_((), "int32", name="pos")
        mask = ir_.input_((1, ml), "float32", name="mask")

        def proj(h, tag):
            w_q = ir_.quantize(ir_.transpose(ir_.const(ws[tag]), (1, 0)), scale=z.TF_W_SCALE)
            dn = ir_.bias_add(ir_.dense(h, w_q), ir_.const(bs[tag]))
            return ir_.clip(ir_.requantize(dn, scale=z.TF_RQ_SCALE), lo=-128, hi=127)

        q = proj(x, "q")
        kc = ir_.kv_cache_append(k_cache, proj(x, "k"), p)
        vc = ir_.kv_cache_append(v_cache, proj(x, "v"), p)
        scores = ir_.dense(q, ir_.transpose(ir_.kv_cache_read(kc), (1, 0)))
        masked = ir_.add(ir_.dequantize(scores, scale=1.0 / (64.0 * d)), mask)
        probs = ir_.quantize(ir_.softmax(masked), scale=z.TF_PROBS_SCALE)
        ctx = ir_.requantize(ir_.dense(probs, ir_.kv_cache_read(vc)), scale=z.TF_RQ_SCALE)
        return ir_.Graph([ir_.add(proj(ctx, "attn"), x), kc, vc], name="fuzz_decode")

    kc = np.zeros((ml, d), np.int8)
    vc = np.zeros((ml, d), np.int8)
    kc[:pos] = rng.integers(-128, 128, (pos, d))
    vc[:pos] = rng.integers(-128, 128, (pos, d))
    feeds = {"x": rng.integers(-128, 128, (1, d)).astype(np.int8), "k_cache": kc, "v_cache": vc,
             "pos": np.asarray(pos, np.int32), "mask": z.decode_mask(np.asarray(pos), ml)}
    return build, feeds


@pytest.mark.parametrize("seed", range(8))
def test_seeded_decode_differential_sweep(seed):
    """The oracle over a stateful decode step: the token row and both
    cache planes, which the serve engine threads from step to step."""
    spec = _decode_step_spec(np.random.default_rng(7000 + seed))
    build, feeds = _materialize_decode(spec, seed=8000 + seed)
    assert len(ref_ir.execute_graph(build(ref_ir), feeds)) == 3
    check_conformance(build, feeds, spec)


# -- the sharded arm: a random mesh -------------------------------------------------


@pytest.mark.parametrize("seed", range(12))
def test_seeded_sharded_differential_sweep(seed):
    """Random graphs on a random ``(data, model)`` mesh: the port's sharded
    module (both routes) equals the reference's sharded module and the
    port's single-device one, with the reference's modeled cycles (the
    ``comm`` term included)."""
    rng = np.random.default_rng(5000 + seed)
    spec = SPEC_MAKERS[seed % len(SPEC_MAKERS)](rng)
    mesh = MESHES[int(rng.integers(0, len(MESHES)))]
    build, feeds = _materialize(spec, seed=6000 + seed)
    spec = {**spec, "mesh": mesh}
    for acc in ACCELERATORS:
        want = repro.compile(build(ref_ir), _ref_target(acc, "optimized", mesh=mesh))
        want_out = want.run(feeds)
        for use_pallas in ROUTES:
            single = repro_torch.compile(build(ir), _target(acc, "optimized", use_pallas)).run(feeds)
            sharded = repro_torch.compile(build(ir), _target(acc, "optimized", use_pallas, mesh=mesh))
            assert sharded.modeled_cycles() == want.modeled_cycles(), (acc, spec)
            got = sharded.run(feeds)
            _assert_all_same(got, want_out, f"sharded[{acc}@{mesh}]-vs-reference", spec)
            _assert_all_same(got, single, f"sharded[{acc}@{mesh}]-vs-single", spec)


@pytest.mark.parametrize("mesh", [(2, 2), (2, 1)])
def test_data_parallel_mesh_of_a_prebuilt_graph_is_refused_as_in_the_reference(mesh):
    build, _ = _materialize(_qdense_chain_spec(np.random.default_rng(0)), seed=0)
    with pytest.raises(ValueError) as want:
        repro.compile(build(ref_ir), _ref_target("gemmini", "optimized", mesh=mesh))
    with pytest.raises(ValueError, match="is data-parallel") as got:
        repro_torch.compile(build(ir), _target("gemmini", "optimized", True, mesh=mesh))
    assert str(got.value) == str(want.value)


# -- hypothesis exploration, derandomized --------------------------------------------


@settings(max_examples=24, deadline=None, derandomize=True)
@given(spec_seed=st.integers(0, 2**20), value_seed=st.integers(0, 2**20),
       kind=st.integers(0, len(SPEC_MAKERS) - 1))
def test_hypothesis_differential(spec_seed, value_seed, kind):
    spec = SPEC_MAKERS[kind](np.random.default_rng(spec_seed))
    check_conformance(*_materialize(spec, seed=value_seed), spec)
