"""Canonical demo graphs shared by tests, benchmarks, and docs.

The acceptance workload for the integration registry is a quantized
conv2d feeding a quantized dense (conv + matmul); keeping a single builder
here means the cache tests and the integration benchmark are guaranteed to
measure the same graph.

Port of ``repro.core.example_graphs``: the same graph with the same
constants (drawn from ``np.random.default_rng(seed)``, as there).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import ir


def quantized_conv_dense_graph(seed: int = 0) -> ir.Graph:
    """int8 conv2d -> requantize/clip -> int8 dense -> requantize/clip.

    Compiles through the backend as two accelerator GEMMs (the conv via its
    im2col lowering).  Graphs are mutated by ``compile``; call this again
    for every compile.
    """
    rng = np.random.default_rng(seed)
    x = ir.input_((1, 10, 10, 8), "int8", name="x")
    wc = ir.const(rng.integers(-8, 8, (3, 3, 8, 16)).astype(np.int8), name="wc")
    bc = ir.const(rng.integers(-50, 50, (16,)).astype(np.int32), name="bc")
    conv = ir.clip(
        ir.requantize(ir.bias_add(ir.conv2d(x, wc, stride=1), bc), scale=0.05)
    )
    wd = ir.quantize(
        ir.transpose(
            ir.const(rng.normal(size=(24, 16)).astype(np.float32) * 0.02), (1, 0)
        ),
        scale=0.02,
    )
    bd = ir.const(rng.integers(-50, 50, (24,)).astype(np.int32), name="bd")
    out = ir.clip(ir.requantize(ir.bias_add(ir.dense(conv, wd), bd), scale=0.1))
    return ir.Graph([out], name="qconv_dense")
