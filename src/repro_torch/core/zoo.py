"""Model zoo: the multi-layer workloads of the Table-2 benchmark.

  * ``toycar_mlp``  — the MLPerf-Tiny ToyCar autoencoder of the paper's
                      Table 2 (640 -> 128x3 -> 8 -> 128x3 -> 640, int8);
  * ``mlp_tiny``    — a serving-size MLP whose layers each fit one PE tile.

``build()`` returns the hand-built ``ir.Graph`` (the golden form); graphs
are mutated by compilation, so it returns a fresh graph per call.  Every
model feeds float weights through the registered constant preprocessing
chain (transpose + quantize), so the ``naive`` mode pays for weight
preparation at run time exactly as the paper's naive BYOC baseline does.
Quantization scales are float32-exact (powers of two).

Port of ``repro.core.zoo``: ``ZooModel``, ``mlp_params``, ``mlp_graph`` and
``TOYCAR_LAYERS`` for these two models, with the same numpy generator, so
the weights are the reference's.  ``build(batch, params)`` also takes the
reference's parameter dict — numpy arrays as ``repro.core.zoo.mlp_params``
returns them — after checking every name, shape and dtype.  The
traced-frontend twins (``jnp_fn``/``trace``) and the other models wait for
their slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from repro_torch.core import ir

# the paper's ToyCar autoencoder layer widths (MLPerf-Tiny anomaly det.)
TOYCAR_LAYERS = (640, 128, 128, 128, 8, 128, 128, 128, 640)
MLP_TINY_LAYERS = (16,) * 9

# float32-exact quantization scales (see module docstring)
MLP_W_SCALE = 0.0625
MLP_RQ_SCALE = 1.0 / 64.0


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
        """The input shape at serving batch ``batch``: the leading unit dim
        widens in place (the MLPs' GEMMs fold it into M)."""
        return (batch, *self.input_shape[1:])


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


def _mlp_model(name: str, description: str, layers: tuple[int, ...]) -> ZooModel:
    return ZooModel(
        name=name,
        description=description,
        graph=lambda batch, params: mlp_graph(layers, name=name, batch=batch, params=params),
        params=lambda: mlp_params(layers),
        input_name="x",
        input_shape=(1, layers[0]),
        input_dtype="int8",
    )


ZOO: dict[str, ZooModel] = {
    m.name: m
    for m in (
        _mlp_model(
            "toycar_mlp", "MLPerf-Tiny ToyCar autoencoder (paper Table 2)", TOYCAR_LAYERS
        ),
        _mlp_model(
            "mlp_tiny", "serving-size MLP; every layer fits one PE tile", MLP_TINY_LAYERS
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
