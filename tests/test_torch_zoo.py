"""The port's zoo on both registered descriptions, against the reference.

``qcnn`` and ``transformer_block`` on gemmini, and all four models on
edge_npu, x {naive, baseline, optimized} x batch {None, 4},
``device="cpu"``: the post-pass op sequence in plan order, the per-rule
rewrite counts, the schedules, the kernel configs (against the
reference's ``kernel_config_for`` in interpret mode, which keeps the
schedule's exact tiles), ``modeled_cycles()`` and the outputs of ``run``
and ``run_many`` (bit-equal) match ``repro.compile(model.build(batch=b),
repro.Target(acc, mode=m, cache=False))``.  On the CPU every accelerator
step runs the kernel's plain version, so the launch counter stays at 0.

The reference is compiled from its golden graphs (``build()``), never from
zoo names or ``trace()``: its traced frontend fails under jax 0.9.
"""

import dataclasses

import numpy as np
import pytest

import repro
from repro.core import zoo as ref_zoo
from repro.core.descriptions import make_edge_npu_description as ref_edge_npu
from repro.core.lowering import kernel_config_for as ref_kernel_config_for
import repro_torch
from repro_torch.core import zoo
from repro_torch.core.descriptions import make_edge_npu_description
from repro_torch.core.lowering import kernel_config_for
from repro_torch.kernels import gemm

MODES = ("naive", "baseline", "optimized")
BATCHES = (None, 4)
CASES = [("gemmini", "qcnn"), ("gemmini", "transformer_block")] + [
    ("edge_npu", name) for name in ("qcnn", "toycar_mlp", "mlp_tiny", "transformer_block")
]


def _ref_module(acc, name, mode, batch, graph=None):
    graph = graph or ref_zoo.get_model(name).build(batch=batch)
    return repro.compile(graph, repro.Target(acc, mode=mode, cache=False))


def _port_module(acc, name, mode, batch, **build_kw):
    graph = zoo.get_model(name).build(batch=batch, **build_kw)
    return repro_torch.compile(graph, repro_torch.Target(acc, mode=mode, device="cpu", cache=False))


def _schedule_dicts(module):
    """Schedules in plan order, without the workload's node name (names
    carry each package's own process-global counter)."""
    return [
        {**d, "workload": {k: v for k, v in d["workload"].items() if k != "name"}}
        for d in module.schedules().values()
    ]


def _assert_bit_equal(got, want, context):
    assert len(got) == len(want), context
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray), context
        assert g.dtype == w.dtype and g.shape == w.shape, context
        np.testing.assert_array_equal(g, w, err_msg=context)


@pytest.mark.parametrize("batch", BATCHES, ids=lambda b: f"batch{b}")
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("acc,name", CASES)
def test_zoo_matches_reference(acc, name, mode, batch):
    gemm.reset_launches()
    ref = _ref_module(acc, name, mode, batch)
    got = _port_module(acc, name, mode, batch)

    assert [n.op for n in got.graph.toposort()] == [n.op for n in ref.graph.toposort()]
    assert [n.target for n in got.graph.toposort()] == [n.target for n in ref.graph.toposort()]
    assert [(p.name, p.rewrites, p.detail, p.nodes_before, p.nodes_after) for p in got.pass_report.passes] == [
        (p.name, p.rewrites, p.detail, p.nodes_before, p.nodes_after) for p in ref.pass_report.passes
    ]
    assert got.input_signature() == ref.input_signature()
    assert _schedule_dicts(got) == _schedule_dicts(ref)
    assert got.modeled_cycles() == ref.modeled_cycles()

    ref_cfgs = []
    for n, op in ref.ops.items():
        cfg = dataclasses.asdict(ref_kernel_config_for(ref.desc, ref.backend.mapping_gen, n, op.strategy))
        assert cfg.pop("interpret") is True  # no TPU here: the exact-tile config
        ref_cfgs.append(cfg)
    got_cfgs = [dataclasses.asdict(op.executor.kernel_config) for op in got.ops.values()]
    assert got_cfgs == ref_cfgs
    assert got_cfgs == [
        dataclasses.asdict(kernel_config_for(got.desc, got.backend.mapping_gen, n, op.strategy))
        for n, op in got.ops.items()
    ]

    model = zoo.get_model(name)
    feeds = [model.feeds(seed, batch=batch) for seed in range(3)]
    context = f"{acc}/{name}/{mode}/batch{batch}"
    _assert_bit_equal(got.run(feeds[0]), ref.run(feeds[0]), context)
    for g, w in zip(got.run_many(feeds), ref.run_many(feeds)):
        _assert_bit_equal(g, w, context)
    assert sum(gemm.LAUNCHES.values()) == 0


@pytest.mark.parametrize("name", sorted(ref_zoo.ZOO))
def test_zoo_entries_match_reference(name):
    ref, got = ref_zoo.get_model(name), zoo.get_model(name)
    for field in ("name", "input_name", "input_shape", "input_dtype", "accelerators", "n_gemms"):
        assert getattr(got, field) == getattr(ref, field), field
    for batch in (1, 4, 16):
        assert got.batched_input_shape(batch) == ref.batched_input_shape(batch)
    want, have = ref.params(), got.params()
    assert have.keys() == want.keys()
    for key in want:
        assert have[key].dtype == want[key].dtype
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)
    np.testing.assert_array_equal(got.feeds(7)["x"], ref.feeds(7)["x"])


@pytest.mark.parametrize(
    "name,ref_params,ref_graph",
    [
        ("qcnn", lambda: ref_zoo.qcnn_params(seed=3), lambda: ref_zoo.qcnn_graph(seed=3, batch=4)),
        (
            "transformer_block",
            lambda: ref_zoo.transformer_params(seed=3),
            lambda: ref_zoo.transformer_block_graph(seed=3, batch=4),
        ),
    ],
)
def test_reference_parameters_carry_across(name, ref_params, ref_graph):
    """``build(params=...)`` takes the reference's parameter dict (numpy),
    so other weights flow into both packages identically."""
    ref = _ref_module("gemmini", name, "optimized", 4, graph=ref_graph())
    got = _port_module("gemmini", name, "optimized", 4, params=ref_params())
    feeds = zoo.get_model(name).feeds(2, batch=4)
    _assert_bit_equal(got.run(feeds), ref.run(feeds), f"{name} seed-3 weights")
    default = _port_module("gemmini", name, "optimized", 4)
    assert not np.array_equal(default.run(feeds)[0], got.run(feeds)[0])


@pytest.mark.parametrize("name", ["qcnn", "transformer_block"])
def test_bad_parameter_dict_is_refused(name):
    model = zoo.get_model(name)
    params = model.params()
    first, second = sorted(params)[:2]
    params.pop(first)
    params[second] = params[second].astype(np.float64)
    params["extra"] = np.zeros(3)
    with pytest.raises(ValueError) as e:
        model.build(params=params)
    msg = str(e.value)
    assert f"missing parameter {first!r}" in msg
    assert "unknown parameter 'extra'" in msg
    assert f"{second!r} is float64" in msg


def test_registry_holds_gemmini_and_edge_npu():
    assert repro_torch.REGISTRY.names() == ["edge_npu", "gemmini"]
    assert make_edge_npu_description().fingerprint() == ref_edge_npu().fingerprint()
    assert repro_torch.validate_description(make_edge_npu_description()) == []
    with pytest.raises(KeyError, match="unknown accelerator 'tpu_v5e'; registered: edge_npu, gemmini"):
        repro_torch.REGISTRY.get("tpu_v5e")
    with pytest.raises(repro_torch.TargetError, match="registered: edge_npu, gemmini"):
        repro_torch.Target("tpu_v5e", device="cpu", cache=False)


def test_edge_npu_schedules_are_weight_stationary_and_8_wide():
    """edge_npu's array is 8x8 and weight-stationary only: every compiled
    step's kernel config says WS, and its blocks stay multiples of the
    8-wide array where the GEMM allows."""
    module = _port_module("edge_npu", "transformer_block", "optimized", 4)
    cfgs = [op.executor.kernel_config for op in module.ops.values()]
    assert cfgs and all(c.dataflow == "WS" for c in cfgs)
    assert all(c.block_n % 8 == 0 and c.block_k % 8 == 0 for c in cfgs)
