"""The port's kernel executor on the branches the slice's MLPs never take.

``lowering._make_kernel_executor`` is ported whole: im2col for convs, the
fused pool and residual epilogues, and the per-instance batched matmul
(with the folded ``transpose_b`` layout).  The reference's ``qcnn`` and
``transformer_block`` golden graphs exercise all of them, plus the
softmax / dequantize / quantize host ops.  Here each reference graph is
translated node for node into the port's IR (same ops, attrs, shapes,
dtypes and constants), independent of the port's own zoo builders
(``tests/test_torch_zoo.py`` holds those), and both are compiled on
gemmini.  Outputs must be bit-equal on the CPU.
"""

import numpy as np
import pytest

import repro
from repro.core import zoo as ref_zoo
from repro.core.batching import batched_shape
import repro_torch
from repro_torch.core import ir
from repro_torch.kernels import gemm


def _to_port(graph) -> ir.Graph:
    nodes = {}
    for n in graph.toposort():
        nodes[n] = ir.Node(
            n.op,
            [nodes[i] if i is not None else None for i in n.inputs],
            dict(n.attrs),
            shape=tuple(n.shape),
            dtype=n.dtype,
            name=n.name,
            value=n.value,
        )
    return ir.Graph([nodes[o] for o in graph.outputs], name=graph.name)


def _build(name, batch):
    model = ref_zoo.get_model(name)
    return model.build(batch=batch) if batch else model.build()


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("mode", ["naive", "baseline", "optimized"])
@pytest.mark.parametrize("name", ["qcnn", "transformer_block"])
def test_conv_pool_bmm_residual_match_reference(name, mode, batch):
    gemm.reset_launches()
    ref = repro.compile(_build(name, batch), repro.Target("gemmini", mode=mode, cache=False))
    got = repro_torch.compile(
        _to_port(_build(name, batch)), repro_torch.Target("gemmini", mode=mode, device="cpu", cache=False)
    )
    assert [n.op for n in got.graph.toposort()] == [n.op for n in ref.graph.toposort()]
    assert got.modeled_cycles() == ref.modeled_cycles()

    accel = [n for n in got.graph.toposort() if n.target == "accel"]
    if name == "qcnn":
        assert any(n.op.endswith("conv2d") for n in accel)
        if mode != "naive":
            assert any(n.attrs.get("pool") for n in accel)
    else:
        assert any(len(n.inputs[1].shape) == 3 for n in accel) == (batch is not None)
        if mode != "naive":
            assert any(n.attrs.get("residual") for n in accel)
            assert any(n.attrs.get("transpose_b") for n in accel)

    shape = ref_zoo.get_model(name).input_shape
    if batch:
        shape = batched_shape(shape, batch)
    for seed in range(2):
        feeds = {"x": np.random.default_rng(seed).integers(-128, 128, shape).astype(np.int8)}
        for g, w in zip(got.run(feeds), ref.run(feeds)):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert sum(gemm.LAUNCHES.values()) == 0
