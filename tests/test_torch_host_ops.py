"""Every host op the port lowers, in every integer and float dtype, against
the reference's ``compile_host_op`` (numpy) on the same inputs.

The port's ``compile_host_op`` runs torch on the CPU here.  Integer
outputs must be bit-equal.  Float outputs must be bit-equal too, except
for two ops whose last bits the reference's numpy and torch compute
differently in float64, held to units in the last place (ulp) of the
output dtype:

* ``gelu`` (``torch.tanh`` against ``np.tanh``): within 1 ulp of
  ``0.5 * |x|``, the scale of ``0.5 * x * (1 + tanh(...))``: where
  ``1 + tanh`` cancels (x well below 0) the output is tiny and a
  one-ulp tanh difference is large against the output itself;
* ``softmax`` (a float64 sum whose order differs): within 2 ulp of the
  output.

Measured here: gelu 0.50 ulp of ``0.5 * |x|``, softmax 1.3 ulp, both in
float64 only; float16 and float32 outputs round the float64 value and
came out bit-equal.

``chip_smoke.py`` runs the same cases on the card against the port's CPU
run, with the same rule.
"""

import numpy as np
import pytest
import torch

from repro.core import executor as ref_executor
from repro.core import ir as ref_ir
from repro_torch.core import executor, ir

DTYPES = ("int8", "int16", "int32", "int64", "uint8", "float16", "float32", "float64")
#: ops the port's compile_host_op lowers (im2col is a preprocessing name,
#: lowered inside the conv executor, with no graph node of its own)
OPS = tuple(sorted(ir.HOST_OPS - {"im2col"}))
#: float ops whose last bits differ, and their bound in ulp of the output
#: dtype (gelu's at 0.5 * |x|, softmax's at the output)
ULP_BOUND = {"gelu": 1, "softmax": 2}


def _data(dtype: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype.startswith(("int", "uint")):
        info = np.iinfo(dtype)
        lo, hi = max(int(info.min), -300), min(int(info.max), 300)
        return rng.integers(lo, hi + 1, shape).astype(dtype)
    return (rng.normal(size=shape) * 3).astype(dtype)


def build_case(op: str, dtype: str, irmod):
    """(root node, feeds) of one op at one dtype, built with ``irmod``
    (the port's ``ir`` or the reference's)."""
    x = irmod.input_((3, 8), dtype, name="x")
    feeds = {"x": _data(dtype, (3, 8), 0)}
    if op in ("add", "sub", "mul"):
        node = getattr(irmod, op)(x, irmod.input_((3, 8), dtype, name="y"))
        feeds["y"] = _data(dtype, (3, 8), 1)
    elif op in ("relu", "gelu"):
        node = getattr(irmod, op)(x)
    elif op == "clip":
        node = irmod.clip(x, lo=3, hi=100)
    elif op == "requantize":
        node = irmod.requantize(x, scale=0.37)
    elif op == "quantize":
        node = irmod.quantize(x, scale=0.05)
    elif op == "dequantize":
        node = irmod.dequantize(x, scale=0.05)
    elif op == "bias_add":
        node = irmod.bias_add(x, irmod.input_((8,), dtype, name="b"))
        feeds["b"] = _data(dtype, (8,), 2)
    elif op == "transpose":
        node = irmod.transpose(irmod.input_((2, 3, 4), dtype, name="x"), (2, 0, 1))
        feeds["x"] = _data(dtype, (2, 3, 4), 0)
    elif op == "reshape":
        node = irmod.reshape(irmod.input_((2, 3, 4), dtype, name="x"), (4, 6))
        feeds["x"] = _data(dtype, (2, 3, 4), 0)
    elif op == "flatten":
        node = irmod.Node("flatten", [irmod.input_((2, 3, 4), dtype, name="x")], {},
                          shape=(2, 12), dtype=dtype)
        feeds["x"] = _data(dtype, (2, 3, 4), 0)
    elif op == "softmax":
        node = irmod.softmax(x)
    elif op == "max_pool2d":
        node = irmod.max_pool2d(irmod.input_((2, 6, 6, 3), dtype, name="x"), 2, 2)
        feeds["x"] = _data(dtype, (2, 6, 6, 3), 0)
    elif op == "kv_cache_read":
        node = irmod.kv_cache_read(irmod.input_((16, 8), dtype, name="x"))
        feeds["x"] = _data(dtype, (16, 8), 0)
    elif op == "kv_cache_append":
        node = irmod.kv_cache_append(
            irmod.input_((16, 8), dtype, name="x"),
            irmod.input_((2, 8), dtype, name="u"),
            irmod.input_((), "int32", name="pos"),
        )
        feeds["x"] = _data(dtype, (16, 8), 0)
        feeds["u"] = _data(dtype, (2, 8), 3)
        feeds["pos"] = np.asarray(5, np.int32)
    else:
        raise AssertionError(f"no case for host op {op!r}")
    return node, feeds


def _args(node, feeds):
    return [feeds[i.name] for i in node.inputs]


def ulp_error(got: np.ndarray, want: np.ndarray, at: np.ndarray) -> float:
    """Largest |got - want| in units of the output dtype's last place at |at|."""
    eps = np.finfo(want.dtype).eps
    tiny = np.finfo(want.dtype).tiny
    scale = np.maximum(np.abs(at.astype(np.float64)), tiny) * eps
    return float(np.max(np.abs(got.astype(np.float64) - want.astype(np.float64)) / scale))


def check(op: str, got: np.ndarray, want: np.ndarray, x: np.ndarray) -> None:
    """``got`` against the reference's ``want`` for input ``x``: bit-equal,
    or within ``ULP_BOUND`` for the float outputs of gelu and softmax."""
    assert got.dtype == want.dtype and got.shape == want.shape, (op, got.dtype, want.dtype)
    if want.dtype.kind == "f" and op in ULP_BOUND:
        at = 0.5 * x.astype(np.float64) if op == "gelu" else want
        err = ulp_error(got, want, at)
        assert err <= ULP_BOUND[op], (op, want.dtype, err)
    else:
        np.testing.assert_array_equal(got, want, err_msg=f"{op} {want.dtype}")


def test_every_lowered_host_op_has_a_case():
    assert set(OPS) == ir.HOST_OPS - {"im2col"}
    assert ir.HOST_OPS <= ref_ir.HOST_OPS
    for op in OPS:
        node, _ = build_case(op, "int32", ir)
        assert node.op == op


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_host_op_matches_the_reference(op, dtype):
    ref_node, feeds = build_case(op, dtype, ref_ir)
    node, _ = build_case(op, dtype, ir)
    want = np.asarray(ref_executor.compile_host_op(ref_node)(*_args(ref_node, feeds)))
    fn = executor.compile_host_op(node, torch.device("cpu"))
    got = fn(*(executor.to_tensor(a, torch.device("cpu")) for a in _args(node, feeds)))
    got = executor.to_numpy(got)
    assert str(got.dtype) == node.dtype == ref_node.dtype
    check(op, got, want, feeds["x"])


def test_gelu_and_softmax_round_to_equal_bits_below_float64():
    """The last-bit differences of gelu and softmax are float64's: on these
    inputs the float16 and float32 outputs, rounded from float64, are
    bit-equal to the reference's."""
    for op in ULP_BOUND:
        for dtype in ("float16", "float32"):
            ref_node, feeds = build_case(op, dtype, ref_ir)
            node, _ = build_case(op, dtype, ir)
            want = np.asarray(ref_executor.compile_host_op(ref_node)(*_args(ref_node, feeds)))
            fn = executor.compile_host_op(node, torch.device("cpu"))
            got = executor.to_numpy(fn(*(torch.from_numpy(a) for a in _args(node, feeds))))
            np.testing.assert_array_equal(got, want, err_msg=f"{op} {dtype}")
