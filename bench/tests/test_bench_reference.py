"""Each configuration's plain reference against the port on the CPU, at
the port's smoke sizes: whole forward passes, and the logits the engine
served through prefill and decode steps under the kernel policy."""

import time

import pytest
import torch

import correct
import harness
import lmshapes
from helpers import BENCHMARK, smoke_cell
from repro_torch.models import lm

CELLS = [w["name"] for w in BENCHMARK["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_reference_forward_equals_the_ports(name):
    cell = smoke_cell(name, "float32")
    weights = lmshapes.make_weights(5, cell.cfg, "cpu")
    tokens = torch.randint(0, cell.cfg.vocab, (3, 40), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        got, _ = lm.forward(weights, cell.cfg, tokens)
        ref = cell.reference.logits(weights, cell.spec, tokens, torch.arange(40), [(0, 40)])
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


@pytest.mark.parametrize("name", CELLS)
def test_served_logits_equal_the_reference_in_float32(name):
    """Through the timed path: padded waves, the KV cache, the Mamba state
    and the MoE capacity per engine call (an f32 KV cache, so that only
    summation order separates the two)."""
    cell = smoke_cell(name, "float32", kv="float32")
    out = harness.run(cell, 2**31 + 3, 0.0, False, "cpu", time.perf_counter(), min_waves=2)
    found = correct.check(cell, out["weights"], out["kept"], "cpu")
    assert found["logit_err"] < 1e-5 and found["token_gap"] == 0.0
    # the router by itself: in float32 the program chooses the reference's experts
    assert found.get("route_gap", 0.0) < 1e-5 and ("route_gap" in found) == (cell.cfg.moe is not None)


def test_moe_capacity_follows_each_engine_call():
    """The same tokens routed as one call drop other pairs than as two:
    the reference's segments decide the groups."""
    cell = smoke_cell("jamba-summarize", "float32")
    cell.spec["moe"]["capacity_factor"] = 0.5
    weights = lmshapes.make_weights(5, cell.cfg, "cpu")
    tokens = torch.randint(0, cell.cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        one = cell.reference.logits(weights, cell.spec, tokens, torch.arange(32), [(0, 32)])
        two = cell.reference.logits(weights, cell.spec, tokens, torch.arange(32), [(0, 16), (16, 32)])
    assert not torch.allclose(one, two)


def test_wave_inputs_rebuild_the_engines_padding():
    from harness import Wave
    import numpy as np

    w = Wave(0, [np.array([5, 6, 7], np.int32), np.array([9], np.int32)], [[1, 2], [3, 4]], 0, 0)
    tokens, read, segments = correct.wave_inputs(w, 2, "cpu")
    assert tokens.tolist() == [[5, 6, 7, 1, 2], [0, 0, 9, 3, 4]]
    assert read.tolist() == [2, 3, 4] and segments == [(0, 3), (3, 4), (4, 5)]
