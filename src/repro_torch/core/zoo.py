"""Model zoo: the multi-layer workloads of the Table-2 benchmark.

  * ``qcnn``        — int8 conv+pool+conv+dense CNN (quantized TFLite-style
                      op chains, conv via its im2col GEMM lowering);
  * ``toycar_mlp``  — the MLPerf-Tiny ToyCar autoencoder of the paper's
                      Table 2 (640 -> 128x3 -> 8 -> 128x3 -> 640, int8);
  * ``mlp_tiny``    — a serving-size MLP whose layers each fit one PE tile;
  * ``transformer_block`` — a quantized single-head transformer encoder
                      block (QKV/attention/output-projection/FFN GEMMs,
                      host softmax).

``build()`` returns the hand-built ``ir.Graph`` (the golden form); graphs
are mutated by compilation, so it returns a fresh graph per call.  Every
model feeds float weights through the registered constant preprocessing
chain (transpose + quantize), so the ``naive`` mode pays for weight
preparation at run time exactly as the paper's naive BYOC baseline does.
Quantization scales are float32-exact (powers of two).

Port of ``repro.core.zoo``: ``ZooModel`` and the four models' parameter
and graph builders, with the same numpy generators and draw orders, so
the weights are the reference's.  ``build(batch, params)`` also takes the
reference's parameter dict — numpy arrays as ``repro.core.zoo.mlp_params``,
``qcnn_params`` or ``transformer_params`` return them — after checking
every name, shape and dtype.  The traced-frontend twins
(``jnp_fn``/``trace``) and the decode zoo wait for their slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from repro_torch.core import ir
from repro_torch.core.batching import batched_shape

ACCELERATORS = ("gemmini", "edge_npu", "tpu_v5e")

# the paper's ToyCar autoencoder layer widths (MLPerf-Tiny anomaly det.)
TOYCAR_LAYERS = (640, 128, 128, 128, 8, 128, 128, 128, 640)
MLP_TINY_LAYERS = (16,) * 9

# float32-exact quantization scales (see module docstring)
MLP_W_SCALE = 0.0625
MLP_RQ_SCALE = 1.0 / 64.0
QCNN_CONV_RQ = (0.0625, 0.046875)
QCNN_DENSE_W = (0.03125, 0.0625)
QCNN_DENSE_RQ = (0.125, 0.25)
TF_W_SCALE = 0.0625
TF_RQ_SCALE = 1.0 / 64.0
TF_PROBS_SCALE = 1.0 / 128.0

# transformer_block widths: d_model and d_ff of the musicgen smoke config
# (``repro.configs.musicgen_medium.smoke_config``), which the reference
# reads at build time; the port keeps them as constants
TF_D_MODEL = 64
TF_D_FF = 128
TF_SEQ = 16


def check_params(expected: dict[str, np.ndarray], params: dict) -> dict[str, np.ndarray]:
    """``params`` as numpy arrays, after holding every name, shape and
    dtype to ``expected``; raises ONE ``ValueError`` listing every
    mismatch."""
    problems = [f"missing parameter {k!r}" for k in sorted(expected.keys() - params.keys())]
    problems += [f"unknown parameter {k!r}" for k in sorted(params.keys() - expected.keys())]
    out = {}
    for name in sorted(expected.keys() & params.keys()):
        want, got = expected[name], np.asarray(params[name])
        if got.shape != want.shape or got.dtype != want.dtype:
            problems.append(
                f"parameter {name!r} is {got.dtype}{list(got.shape)}, "
                f"expected {want.dtype}{list(want.shape)}"
            )
        out[name] = got
    if problems:
        bullet = "\n  - ".join(problems)
        raise ValueError(f"parameters do not match the model:\n  - {bullet}")
    return out


@dataclass(frozen=True)
class ZooModel:
    name: str
    description: str
    #: golden graph builder: ``graph(batch, params)``
    graph: Callable[[int | None, dict], ir.Graph]
    #: parameter builder (numpy, seeded as in the reference)
    params: Callable[[], dict]
    input_name: str
    input_shape: tuple[int, ...]
    input_dtype: str
    #: accelerators this model lowers to (conv has no TPU kernel lowering)
    accelerators: tuple[str, ...]
    n_gemms: int

    def build(self, batch: int | None = None, params: dict | None = None) -> ir.Graph:
        """The golden graph, with a leading batch dim of ``batch``
        (``None`` is the per-sample form) and the model's own parameters
        unless ``params`` supplies them (checked by ``check_params``)."""
        expected = self.params()
        p = expected if params is None else check_params(expected, params)
        return self.graph(batch, p)

    def feeds(self, seed: int = 0, batch: int | None = None) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(seed)
        shape = self.input_shape if batch is None else self.batched_input_shape(batch)
        x = rng.integers(-128, 128, size=shape)
        return {self.input_name: x.astype(self.input_dtype)}

    def batched_input_shape(self, batch: int) -> tuple[int, ...]:
        """The input shape at serving batch ``batch``: a leading unit dim
        is widened in place (MLP/CNN style), otherwise a new leading batch
        dim is prepended (the 2-D transformer block becomes rank 3) — the
        one convention in ``repro_torch.core.batching.batched_shape``."""
        return batched_shape(self.input_shape, batch)


def _qdense(h: ir.Node, w_fp: np.ndarray, b: np.ndarray, *, w_scale: float,
            rq_scale: float, clip_lo: int = -128) -> ir.Node:
    """One quantized dense layer as the full TFLite-style op sequence.

    Float weights enter through the registered constant preprocessing
    (transpose to (C, K), quantize to int8); ``clip_lo=0`` turns the
    saturating clip into a fused quantized ReLU.
    """
    w_q = ir.quantize(ir.transpose(ir.const(w_fp), (1, 0)), scale=w_scale)
    bias = ir.const(b)
    d = ir.dense(h, w_q)
    return ir.clip(ir.requantize(ir.bias_add(d, bias), scale=rq_scale),
                   lo=clip_lo, hi=127)


def _qconv(h: ir.Node, w_q: np.ndarray, b: np.ndarray, *, stride: int = 1,
           rq_scale: float = QCNN_CONV_RQ[0]) -> ir.Node:
    conv = ir.conv2d(h, ir.const(w_q), stride=stride)
    return ir.clip(ir.requantize(ir.bias_add(conv, ir.const(b)), scale=rq_scale))


def mlp_params(layers=TOYCAR_LAYERS, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    params: dict[str, np.ndarray] = {}
    for i in range(len(layers) - 1):
        d_in, d_out = layers[i], layers[i + 1]
        params[f"w{i}"] = (rng.normal(size=(d_out, d_in)) * 0.05).astype(np.float32)
        params[f"b{i}"] = rng.integers(-64, 64, size=(d_out,)).astype(np.int32)
    return params


def mlp_graph(
    layers=TOYCAR_LAYERS, seed: int = 0, name: str = "mlp",
    batch: int | None = None, params: dict[str, np.ndarray] | None = None,
) -> ir.Graph:
    """Quantized MLP: each layer dense -> bias_add -> requantize -> clip.
    ``batch`` widens the leading input dim (the GEMMs fold it into M)."""
    params = mlp_params(layers, seed) if params is None else params
    x = ir.input_((batch or 1, layers[0]), "int8", name="x")
    h = x
    for i in range(len(layers) - 1):
        h = _qdense(h, params[f"w{i}"], params[f"b{i}"],
                    w_scale=MLP_W_SCALE, rq_scale=MLP_RQ_SCALE)
    return ir.Graph([h], name=name)


def qcnn_params(seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "conv0_w": rng.integers(-8, 8, (3, 3, 8, 16)).astype(np.int8),
        "conv0_b": rng.integers(-50, 50, (16,)).astype(np.int32),
        "conv1_w": rng.integers(-8, 8, (3, 3, 16, 16)).astype(np.int8),
        "conv1_b": rng.integers(-50, 50, (16,)).astype(np.int32),
        "dense0_w": (rng.normal(size=(32, 144)) * 0.02).astype(np.float32),
        "dense0_b": rng.integers(-50, 50, (32,)).astype(np.int32),
        "dense1_w": (rng.normal(size=(10, 32)) * 0.05).astype(np.float32),
        "dense1_b": rng.integers(-50, 50, (10,)).astype(np.int32),
    }


def qcnn_graph(
    seed: int = 0, batch: int | None = None, params: dict[str, np.ndarray] | None = None
) -> ir.Graph:
    """int8 CNN: conv(3x3, 8->16) -> max_pool(2x2) -> conv(3x3, 16->16) ->
    flatten -> dense(144->32) -> dense(32->10); quantized op chains
    throughout.  The pool rides directly on the first conv's quantized
    chain, so the ``fuse_conv_pool`` pass folds it into the generalized
    conv's epilogue (the naive BYOC mode pays for it on the host).
    ``batch`` widens the leading NHWC dim (im2col folds it into GEMM M)."""
    p = qcnn_params(seed) if params is None else params
    x = ir.input_((batch or 1, 12, 12, 8), "int8", name="x")
    h = _qconv(x, p["conv0_w"], p["conv0_b"], rq_scale=QCNN_CONV_RQ[0])
    h = ir.max_pool2d(h, size=2, stride=2)  # (1, 5, 5, 16)
    h = _qconv(h, p["conv1_w"], p["conv1_b"], rq_scale=QCNN_CONV_RQ[1])
    h = ir.flatten(h)  # (1, 3*3*16) zero-copy view
    h = _qdense(h, p["dense0_w"], p["dense0_b"],
                w_scale=QCNN_DENSE_W[0], rq_scale=QCNN_DENSE_RQ[0])
    h = _qdense(h, p["dense1_w"], p["dense1_b"],
                w_scale=QCNN_DENSE_W[1], rq_scale=QCNN_DENSE_RQ[1])
    return ir.Graph([h], name="qcnn")


def transformer_params(seed: int = 0) -> dict[str, np.ndarray]:
    d_model, d_ff = TF_D_MODEL, TF_D_FF
    rng = np.random.default_rng(seed)
    params: dict[str, np.ndarray] = {}
    # draw order is part of the golden parameterization: q, k, v, attn, f1, f2
    for tag, (d_in, d_out) in (
        ("q", (d_model, d_model)),
        ("k", (d_model, d_model)),
        ("v", (d_model, d_model)),
        ("attn", (d_model, d_model)),
        ("f1", (d_model, d_ff)),
        ("f2", (d_ff, d_model)),
    ):
        params[f"w_{tag}"] = (rng.normal(size=(d_out, d_in)) * 0.05).astype(np.float32)
        params[f"b_{tag}"] = rng.integers(-64, 64, size=(d_out,)).astype(np.int32)
    return params


def transformer_block_graph(
    seed: int = 0, seq: int = TF_SEQ, batch: int | None = None,
    params: dict[str, np.ndarray] | None = None,
) -> ir.Graph:
    """Quantized single-head transformer encoder block (d_model 64, d_ff
    128).

    Activation-activation GEMMs (scores = q @ k^T, context = probs @ v) are
    raw int8 dense ops — scheduled on the accelerator but with their
    epilogues (dequantize/softmax/quantize) on the host, which is exactly
    the structure BYOC partitioning produces for attention.

    ``batch`` prepends a leading batch dim: the weight-operand projections
    fold it into the GEMM M dimension, while the attention GEMMs become
    batched matmuls (one per-sample GEMM instance per request).
    """
    d_model = TF_D_MODEL
    p = transformer_params(seed) if params is None else params
    shape = (seq, d_model) if batch is None else (batch, seq, d_model)
    x = ir.input_(shape, "int8", name="x")

    def proj(h, tag, clip_lo=-128):
        return _qdense(h, p[f"w_{tag}"], p[f"b_{tag}"],
                       w_scale=TF_W_SCALE, rq_scale=TF_RQ_SCALE,
                       clip_lo=clip_lo)

    q = proj(x, "q")
    k = proj(x, "k")
    v = proj(x, "v")
    # attention: int8 scores GEMM, softmax on the host in float
    swap_last_two = (1, 0) if batch is None else (0, 2, 1)
    scores = ir.dense(q, ir.transpose(k, swap_last_two))  # (.., seq, seq) int32
    probs = ir.quantize(
        ir.softmax(ir.dequantize(scores, scale=1.0 / (64.0 * d_model))),
        scale=TF_PROBS_SCALE,
    )
    ctx = ir.requantize(ir.dense(probs, v), scale=TF_RQ_SCALE)  # (seq, d) int8
    attn = proj(ctx, "attn")
    h = ir.add(attn, x)
    # FFN with fused quantized ReLU (clip_lo=0) on the expansion layer
    f = proj(h, "f1", clip_lo=0)
    f = proj(f, "f2")
    out = ir.add(f, h)
    return ir.Graph([out], name="transformer_block")


def _mlp_model(name: str, description: str, layers: tuple[int, ...]) -> ZooModel:
    return ZooModel(
        name=name,
        description=description,
        graph=lambda batch, params: mlp_graph(layers, name=name, batch=batch, params=params),
        params=lambda: mlp_params(layers),
        input_name="x",
        input_shape=(1, layers[0]),
        input_dtype="int8",
        accelerators=ACCELERATORS,
        n_gemms=len(layers) - 1,
    )


ZOO: dict[str, ZooModel] = {
    m.name: m
    for m in (
        ZooModel(
            name="qcnn",
            description="int8 conv+pool+conv+dense CNN (conv via im2col GEMM)",
            graph=lambda batch, params: qcnn_graph(batch=batch, params=params),
            params=qcnn_params,
            input_name="x",
            input_shape=(1, 12, 12, 8),
            input_dtype="int8",
            accelerators=("gemmini", "edge_npu"),
            n_gemms=4,
        ),
        _mlp_model(
            "toycar_mlp", "MLPerf-Tiny ToyCar autoencoder (paper Table 2)", TOYCAR_LAYERS
        ),
        _mlp_model(
            "mlp_tiny", "serving-size MLP; every layer fits one PE tile", MLP_TINY_LAYERS
        ),
        ZooModel(
            name="transformer_block",
            description="quantized single-head transformer encoder block",
            graph=lambda batch, params: transformer_block_graph(batch=batch, params=params),
            params=transformer_params,
            input_name="x",
            input_shape=(TF_SEQ, TF_D_MODEL),
            input_dtype="int8",
            accelerators=("gemmini", "edge_npu"),
            n_gemms=8,
        ),
    )
}


def model_names() -> list[str]:
    return sorted(ZOO)


def get_model(name: str) -> ZooModel:
    try:
        return ZOO[name]
    except KeyError:
        known = ", ".join(model_names())
        raise KeyError(f"unknown zoo model {name!r}; available: {known}") from None
