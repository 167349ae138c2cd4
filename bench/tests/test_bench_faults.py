"""A run whose timed path is broken underneath comes out not correct.

Each fault is planted below the harness, in the program, for one run of
a cell at the port's smoke sizes on the CPU (float32, so that the
unbroken run reads only summation order; the limits are the cell's own):
a served token altered where it is produced, a decode step that returns
its cache unchanged, half of a wave's requests never answered, and (in
the MoE model) a router that hands its tokens to other experts.  The
exchange between chips has no fault to plant: every cell runs on one
chip."""

import copy

import pytest

from helpers import execute_cpu, smoke_cell
from repro_torch.models import lm, moe
from repro_torch.serve import ServingEngine

CELLS = ["codeqwen-completion", "jamba-summarize"]


def altered_token(monkeypatch):
    real = ServingEngine._next_tokens

    def next_tokens(self, logits, step):
        tok = real(self, logits, step)
        tok[0] = (tok[0] + 1) % self.cfg.vocab
        return tok

    monkeypatch.setattr(ServingEngine, "_next_tokens", next_tokens)


def state_unchanged(monkeypatch):
    real = lm.decode_step

    def decode_step(params, cfg, cache, token):
        logits, _ = real(params, cfg, copy.deepcopy(cache), token)
        return logits, cache

    monkeypatch.setattr(lm, "decode_step", decode_step)


def half_the_wave(monkeypatch):
    real = ServingEngine.generate

    def generate(self, prompts):
        return real(self, prompts)[: len(prompts) // 2]

    monkeypatch.setattr(ServingEngine, "generate", generate)


def misrouted(monkeypatch):
    real = moe.route

    def route(params, cfg, xt):
        weights, idx, aux = real(params, cfg, xt)
        return weights, (idx + 1) % cfg.moe.n_experts, aux

    monkeypatch.setattr(moe, "route", route)


@pytest.mark.parametrize("name", CELLS)
def test_the_unbroken_run_is_correct(name):
    result = execute_cpu(smoke_cell(name, "float32", kv="float32"))
    assert result["correct"] and result["failed"] == 0


@pytest.mark.parametrize("fault", [altered_token, state_unchanged, half_the_wave], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result = execute_cpu(smoke_cell(name, "float32", kv="float32"))
    assert not result["correct"], result["checks"]


def test_a_router_that_chooses_other_experts_is_not_correct(monkeypatch):
    """Each token's experts shifted by one where the router chose them."""
    misrouted(monkeypatch)
    result = execute_cpu(smoke_cell("jamba-summarize", "float32", kv="float32"))
    assert not result["correct"] and result["checks"]["route_gap"]["value"] > result["checks"]["route_gap"]["limit"]
