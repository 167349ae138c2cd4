"""Model zoo: the multi-layer workloads of the Table-2 benchmark.

  * ``qcnn``        — int8 conv+pool+conv+dense CNN (quantized TFLite-style
                      op chains, conv via its im2col GEMM lowering);
  * ``toycar_mlp``  — the MLPerf-Tiny ToyCar autoencoder of the paper's
                      Table 2 (640 -> 128x3 -> 8 -> 128x3 -> 640, int8);
  * ``mlp_tiny``    — a serving-size MLP whose layers each fit one PE tile;
  * ``transformer_block`` — a quantized single-head transformer encoder
                      block (QKV/attention/output-projection/FFN GEMMs,
                      host softmax).

Every model exists in TWO equivalent forms sharing one set of parameters:

  * ``build()`` — the hand-built ``ir.Graph`` (the golden reference);
  * ``torch_fn`` — a plain PyTorch callable routed through the traced
    frontend by ``trace()`` (what ``repro_torch.compile("<name>", ...)``
    uses); the counterpart of the reference's ``jnp_fn``.

Graphs are mutated by compilation, so ``build()`` and ``trace()`` return a
fresh graph per call.  Every model feeds float weights through the
registered constant preprocessing chain (transpose + quantize), so the
``naive`` mode pays for weight preparation at run time exactly as the
paper's naive BYOC baseline does.  Quantization scales are float32-exact
(powers of two), so the scale literals the tracer reads equal the
hand-built attributes bit for bit.

Port of ``repro.core.zoo``: ``ZooModel`` and the four models' parameter
and graph builders and their twins, with the same numpy generators and
draw orders, so the weights are the reference's (and ``trace()`` feeds the
same numpy dict to the tracer).  ``build(batch, params)`` also takes the
reference's parameter dict — numpy arrays as ``repro.core.zoo.mlp_params``,
``qcnn_params`` or ``transformer_params`` return them — after checking
every name, shape and dtype.

The decode zoo (``DECODE_ZOO``, ``attn_decode``) is the stateful form: a
quantized attention step over an int8 KV cache, whose ``build(seq, batch,
params)`` and ``trace(seq, batch)`` give the decode step (``seq=1``,
optionally batched) or the prefill (``seq=P``), all carrying the same
``CacheSpec``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core import ir
from repro_torch.core.batching import batched_shape
from repro_torch.frontend import nn as fnn

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

# attn_decode width: d_model of the xlstm_125m smoke config
# (``repro.configs.xlstm_125m.smoke_config``), which the reference reads
# at build time; the port keeps it as a constant
DECODE_D_MODEL = 64

#: default KV capacity of the decode zoo entry (rows per request)
DECODE_MAX_LEN = 64

#: additive attention-mask values: masking keeps every plan shape static
#: (decode always attends the full ``max_len`` cache); exp(-1e9) underflows
#: to exactly 0.0 in the float64 host softmax, so masked rows never perturb
#: bit-exactness.
MASK_BLOCKED = -1e9


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
    #: plain PyTorch twin of ``build`` — ``fn(x, params)``, batch-agnostic;
    #: the counterpart of the reference's ``jnp_fn``
    torch_fn: Callable
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

    def example_inputs(self, batch: int | None = None) -> dict[str, np.ndarray]:
        shape = self.input_shape if batch is None else self.batched_input_shape(batch)
        return {self.input_name: np.zeros(shape, dtype=self.input_dtype)}

    def trace(self, batch: int | None = None) -> ir.Graph:
        """Build the model through the traced-torch frontend (the path
        ``repro_torch.compile("<name>", ...)`` takes); ``batch`` traces the
        batched form for one serving bucket."""
        from repro_torch.frontend import trace_model

        return trace_model(
            self.torch_fn, self.example_inputs(batch), self.params(), name=self.name
        )

    def trace_batched(self) -> tuple[ir.Graph, Callable[[int], ir.Graph]]:
        """The per-sample traced graph and ``build(batch)`` for the serving
        buckets, from one export with a symbolic batch dim
        (``frontend.trace_batched``); ``build(b)`` equals ``trace(b)``."""
        from repro_torch.frontend import trace_batched

        return trace_batched(
            self.torch_fn, self.example_inputs(), self.params(), name=self.name
        )


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


def _qdense_torch(h, w_fp, b, *, w_scale: float, rq_scale: float,
                  clip_lo: int = -128):
    w_q = fnn.quantize(w_fp.t(), w_scale)
    d = fnn.dense(h, w_q) + b
    return torch.clamp(fnn.requantize(d, rq_scale), clip_lo, 127)


def _qconv(h: ir.Node, w_q: np.ndarray, b: np.ndarray, *, stride: int = 1,
           rq_scale: float = QCNN_CONV_RQ[0]) -> ir.Node:
    conv = ir.conv2d(h, ir.const(w_q), stride=stride)
    return ir.clip(ir.requantize(ir.bias_add(conv, ir.const(b)), scale=rq_scale))


def _qconv_torch(h, w_q, b, *, stride: int = 1, rq_scale: float = QCNN_CONV_RQ[0]):
    conv = fnn.conv2d(h, w_q, stride=stride) + b
    return torch.clamp(fnn.requantize(conv, rq_scale), -128, 127)


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


def make_mlp_fn(layers=TOYCAR_LAYERS):
    def mlp_fn(x, params):
        h = x
        for i in range(len(layers) - 1):
            h = _qdense_torch(h, params[f"w{i}"], params[f"b{i}"],
                              w_scale=MLP_W_SCALE, rq_scale=MLP_RQ_SCALE)
        return h

    return mlp_fn


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


def qcnn_fn(x, params):
    h = _qconv_torch(x, params["conv0_w"], params["conv0_b"],
                     rq_scale=QCNN_CONV_RQ[0])
    h = fnn.max_pool2d(h, size=2, stride=2)
    h = _qconv_torch(h, params["conv1_w"], params["conv1_b"],
                     rq_scale=QCNN_CONV_RQ[1])
    h = h.reshape(h.shape[0], -1)
    h = _qdense_torch(h, params["dense0_w"], params["dense0_b"],
                      w_scale=QCNN_DENSE_W[0], rq_scale=QCNN_DENSE_RQ[0])
    h = _qdense_torch(h, params["dense1_w"], params["dense1_b"],
                      w_scale=QCNN_DENSE_W[1], rq_scale=QCNN_DENSE_RQ[1])
    return h


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


def transformer_block_fn(x, params):
    d_model = x.shape[-1]

    def proj(h, tag, clip_lo=-128):
        return _qdense_torch(h, params[f"w_{tag}"], params[f"b_{tag}"],
                             w_scale=TF_W_SCALE, rq_scale=TF_RQ_SCALE,
                             clip_lo=clip_lo)

    q = proj(x, "q")
    k = proj(x, "k")
    v = proj(x, "v")
    # batch-agnostic K^T: swap the last two dims whatever the rank
    kt = k.t() if x.dim() == 2 else k.transpose(1, 2)
    scores = fnn.dense(q, kt)
    probs = fnn.quantize(
        torch.softmax(fnn.dequantize(scores, 1.0 / (64.0 * d_model)), dim=-1),
        TF_PROBS_SCALE,
    )
    ctx = fnn.requantize(fnn.dense(probs, v), TF_RQ_SCALE)
    attn = proj(ctx, "attn")
    h = attn + x
    f = proj(h, "f1", clip_lo=0)
    f = proj(f, "f2")
    return f + h


def decode_mask(pos, max_len: int) -> np.ndarray:
    """Decode-step mask: the new token (just appended at ``pos``) attends
    cache rows ``[0, pos]``.  Scalar ``pos`` -> ``(1, L)``; a ``[B]`` vector
    of per-request positions -> ``(B, 1, L)``."""
    pos = np.asarray(pos)
    j = np.arange(max_len)
    if pos.ndim == 0:
        valid = j <= int(pos)
        return np.where(valid, 0.0, MASK_BLOCKED).astype(np.float32)[None, :]
    valid = j[None, :] <= pos.astype(np.int64)[:, None]
    return np.where(valid, 0.0, MASK_BLOCKED).astype(np.float32)[:, None, :]


def prefill_mask(seq: int, max_len: int) -> np.ndarray:
    """Causal prefill mask ``(seq, L)``: row ``i`` attends rows ``[0, i]``.
    Padding rows beyond the true prompt get the same causal treatment —
    their outputs are ignored and their cache rows are overwritten by later
    decode appends, so no validity column is needed."""
    i = np.arange(seq)[:, None]
    j = np.arange(max_len)[None, :]
    return np.where(j <= i, 0.0, MASK_BLOCKED).astype(np.float32)


def decode_params(seed: int = 0) -> dict[str, np.ndarray]:
    d_model = DECODE_D_MODEL
    rng = np.random.default_rng(seed)
    params: dict[str, np.ndarray] = {}
    # draw order is part of the golden parameterization: q, k, v, attn
    for tag in ("q", "k", "v", "attn"):
        params[f"w_{tag}"] = (
            rng.normal(size=(d_model, d_model)) * 0.05
        ).astype(np.float32)
        params[f"b_{tag}"] = rng.integers(-64, 64, size=(d_model,)).astype(np.int32)
    return params


def attn_decode_graph(
    seed: int = 0,
    seq: int = 1,
    max_len: int = DECODE_MAX_LEN,
    batch: int | None = None,
    params: dict[str, np.ndarray] | None = None,
) -> ir.Graph:
    """Quantized single-head attention step against an int8 KV cache.

    ``seq=1`` is the decode step; ``seq=P`` is prefill — the SAME structure
    (project, append to the cache at ``pos``, attend the full cache under an
    additive mask), so prefill and decode compile to distinct
    ``ExecutionPlan``s sharing one weight set.  The cache stores the
    post-requantize int8 K/V activations directly, appended via the
    stateful ``kv_cache_append`` op and threaded out as graph outputs 1 and
    2 per the graph's ``CacheSpec``.

    ``batch`` (decode only) prepends a batch dim: projections fold it into
    GEMM M, the attention GEMMs become batched matmuls, and ``pos`` becomes
    a ``[B]`` vector of per-request lengths — the continuous-batching shape.
    """
    if batch is not None and seq != 1:
        raise ValueError("batched attn_decode supports seq=1 (decode) only")
    d_model = DECODE_D_MODEL
    p = decode_params(seed) if params is None else params
    if batch is None:
        x = ir.input_((seq, d_model), "int8", name="x")
        k_cache = ir.input_((max_len, d_model), "int8", name="k_cache")
        v_cache = ir.input_((max_len, d_model), "int8", name="v_cache")
        pos = ir.input_((), "int32", name="pos")
        mask = ir.input_((seq, max_len), "float32", name="mask")
    else:
        x = ir.input_((batch, 1, d_model), "int8", name="x")
        k_cache = ir.input_((batch, max_len, d_model), "int8", name="k_cache")
        v_cache = ir.input_((batch, max_len, d_model), "int8", name="v_cache")
        pos = ir.input_((batch,), "int32", name="pos")
        mask = ir.input_((batch, 1, max_len), "float32", name="mask")

    def proj(h, tag):
        return _qdense(h, p[f"w_{tag}"], p[f"b_{tag}"],
                       w_scale=TF_W_SCALE, rq_scale=TF_RQ_SCALE)

    q = proj(x, "q")
    kc = ir.kv_cache_append(k_cache, proj(x, "k"), pos)
    vc = ir.kv_cache_append(v_cache, proj(x, "v"), pos)
    k_all = ir.kv_cache_read(kc)
    v_all = ir.kv_cache_read(vc)
    swap_last_two = (1, 0) if batch is None else (0, 2, 1)
    scores = ir.dense(q, ir.transpose(k_all, swap_last_two))  # (.., seq, L) int32
    masked = ir.add(ir.dequantize(scores, scale=1.0 / (64.0 * d_model)), mask)
    probs = ir.quantize(ir.softmax(masked), scale=TF_PROBS_SCALE)
    ctx = ir.requantize(ir.dense(probs, v_all), scale=TF_RQ_SCALE)
    out = ir.add(proj(ctx, "attn"), x)
    name = "attn_decode" if seq == 1 else "attn_prefill"
    return ir.Graph(
        [out, kc, vc],
        name=name,
        cache_spec=decode_cache_spec(max_len, batch),
    )


def decode_cache_spec(max_len: int, batch: int | None) -> ir.CacheSpec:
    """The decode-state contract of ``attn_decode_graph``: the two caches
    fed back from outputs 1 and 2."""
    return ir.CacheSpec(
        max_len=max_len,
        dtype="int8",
        layout="LD" if batch is None else "BLD",
        state=(("k_cache", 1), ("v_cache", 2)),
        pos_input="pos",
        mask_input="mask",
    )


def attn_decode_fn(x, k_cache, v_cache, pos, mask, params):
    """Plain-torch twin of ``attn_decode_graph`` (batch- and seq-agnostic)."""
    d_model = x.shape[-1]

    def proj(h, tag):
        return _qdense_torch(h, params[f"w_{tag}"], params[f"b_{tag}"],
                             w_scale=TF_W_SCALE, rq_scale=TF_RQ_SCALE)

    q = proj(x, "q")
    kc = fnn.kv_cache_append(k_cache, proj(x, "k"), pos)
    vc = fnn.kv_cache_append(v_cache, proj(x, "v"), pos)
    k_all = fnn.kv_cache_read(kc)
    v_all = fnn.kv_cache_read(vc)
    kt = k_all.t() if k_all.dim() == 2 else k_all.transpose(1, 2)
    scores = fnn.dense(q, kt)
    masked = fnn.dequantize(scores, 1.0 / (64.0 * d_model)) + mask
    probs = fnn.quantize(torch.softmax(masked, dim=-1), TF_PROBS_SCALE)
    ctx = fnn.requantize(fnn.dense(probs, v_all), TF_RQ_SCALE)
    return proj(ctx, "attn") + x, kc, vc


@dataclass(frozen=True)
class DecodeModel:
    """A stateful decode workload: two graph forms (prefill at ``seq=P``,
    decode at ``seq=1``, optionally batched) sharing one parameter set,
    plus the traced-torch twin — the zoo contract extended with KV-cache
    state."""

    name: str
    description: str
    d_model: int
    max_len: int
    #: golden graph builder: ``graph(seq, batch, params)``
    graph: Callable[[int, int | None, dict], ir.Graph]
    #: torch twin ``fn(x, k_cache, v_cache, pos, mask, params)``; the
    #: counterpart of the reference's ``jnp_fn``
    torch_fn: Callable
    params: Callable[[], dict]
    accelerators: tuple[str, ...]
    n_gemms: int

    def build(
        self, seq: int = 1, batch: int | None = None, params: dict | None = None
    ) -> ir.Graph:
        """The golden graph: the decode step (``seq=1``; ``batch`` slots
        with a ``[B]`` pos, or one request without) or the prefill of
        ``seq`` rows, with the model's own parameters unless ``params``
        supplies them (checked by ``check_params``)."""
        expected = self.params()
        p = expected if params is None else check_params(expected, params)
        return self.graph(seq, batch, p)

    def example_inputs(
        self, seq: int = 1, batch: int | None = None
    ) -> dict[str, np.ndarray]:
        d, ml = self.d_model, self.max_len
        if batch is None:
            return {
                "x": np.zeros((seq, d), np.int8),
                "k_cache": np.zeros((ml, d), np.int8),
                "v_cache": np.zeros((ml, d), np.int8),
                "pos": np.zeros((), np.int32),
                "mask": np.zeros((seq, ml), np.float32),
            }
        if seq != 1:
            raise ValueError("batched attn_decode supports seq=1 (decode) only")
        return {
            "x": np.zeros((batch, 1, d), np.int8),
            "k_cache": np.zeros((batch, ml, d), np.int8),
            "v_cache": np.zeros((batch, ml, d), np.int8),
            "pos": np.zeros((batch,), np.int32),
            "mask": np.zeros((batch, 1, ml), np.float32),
        }

    def trace(self, seq: int = 1, batch: int | None = None) -> ir.Graph:
        """The traced-frontend form (what ``repro_torch.compile("<name>")``
        uses); carries the same ``CacheSpec`` as the golden graph."""
        from repro_torch.frontend import trace_model

        name = self.name if seq == 1 else f"{self.name.split('_')[0]}_prefill"
        g = trace_model(
            self.torch_fn, self.example_inputs(seq, batch), self.params(), name=name
        )
        g.cache_spec = decode_cache_spec(self.max_len, batch)
        return g

    def feeds(
        self, seed: int = 0, pos=None, batch: int | None = None
    ) -> dict[str, np.ndarray]:
        """Decode-step feeds with a PRE-FILLED cache: rows ``[0, pos)`` hold
        random int8 K/V (as if written by a prior prefill), the rest zeros.
        Same generator and draw order as the reference."""
        d, ml = self.d_model, self.max_len
        rng = np.random.default_rng(seed)
        if batch is None:
            pos = np.asarray(ml // 2 if pos is None else pos, np.int32)
            kc = np.zeros((ml, d), np.int8)
            vc = np.zeros((ml, d), np.int8)
            kc[: int(pos)] = rng.integers(-128, 128, (int(pos), d))
            vc[: int(pos)] = rng.integers(-128, 128, (int(pos), d))
            x = rng.integers(-128, 128, (1, d)).astype(np.int8)
        else:
            pos = (
                rng.integers(0, ml - 1, (batch,)).astype(np.int32)
                if pos is None
                else np.asarray(pos, np.int32)
            )
            kc = np.zeros((batch, ml, d), np.int8)
            vc = np.zeros((batch, ml, d), np.int8)
            for b in range(batch):
                kc[b, : int(pos[b])] = rng.integers(-128, 128, (int(pos[b]), d))
                vc[b, : int(pos[b])] = rng.integers(-128, 128, (int(pos[b]), d))
            x = rng.integers(-128, 128, (batch, 1, d)).astype(np.int8)
        mask = decode_mask(pos, ml)
        return {"x": x, "k_cache": kc, "v_cache": vc, "pos": pos, "mask": mask}


DECODE_ZOO: dict[str, DecodeModel] = {
    m.name: m
    for m in (
        DecodeModel(
            name="attn_decode",
            description=(
                "stateful single-head decode step over an int8 KV cache "
                "(xlstm_125m smoke shapes)"
            ),
            d_model=DECODE_D_MODEL,
            max_len=DECODE_MAX_LEN,
            graph=lambda seq, batch, params: attn_decode_graph(
                seq=seq, batch=batch, params=params
            ),
            torch_fn=attn_decode_fn,
            params=decode_params,
            accelerators=("gemmini", "edge_npu"),
            n_gemms=6,
        ),
    )
}


def decode_model_names() -> list[str]:
    return sorted(DECODE_ZOO)


def get_decode_model(name: str) -> DecodeModel:
    try:
        return DECODE_ZOO[name]
    except KeyError:
        known = ", ".join(decode_model_names())
        raise KeyError(
            f"unknown decode zoo model {name!r}; available: {known}"
        ) from None


def _mlp_model(name: str, description: str, layers: tuple[int, ...]) -> ZooModel:
    return ZooModel(
        name=name,
        description=description,
        graph=lambda batch, params: mlp_graph(layers, name=name, batch=batch, params=params),
        torch_fn=make_mlp_fn(layers),
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
            torch_fn=qcnn_fn,
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
            torch_fn=transformer_block_fn,
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
