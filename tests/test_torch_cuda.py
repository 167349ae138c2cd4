"""Tests of the port that need an NVIDIA card.

They import only ``repro_torch`` (the card's machine has no JAX), are
marked ``cuda``, and skip where ``torch.cuda.is_available()`` is false.
On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import ShardedModule, Target
from repro_torch.core import zoo


@pytest.fixture
def cuda_card() -> str:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the scheduled GEMM kernels run only there")
    return "cuda"


def _assert_outputs_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


@pytest.mark.cuda
def test_sharded_run_under_a_side_stream(cuda_card, monkeypatch):
    """Every shard, and every combine, joins the caller's current stream:
    each shard's thread issues on it, and a call made under a side stream
    equals devices = 1."""
    model = zoo.get_model("toycar_mlp")
    streams = []
    real_execute = ShardedModule._execute

    def execute(self, key, feeds):
        streams.append((key, torch.cuda.current_stream()))
        return real_execute(self, key, feeds)

    monkeypatch.setattr(ShardedModule, "_execute", execute)

    def target(**kw) -> Target:
        return Target("gemmini", mode="optimized", device=cuda_card, cache=False, use_mip=False, **kw)

    single = repro_torch.compile("toycar_mlp", target())
    sharded = repro_torch.compile("toycar_mlp", target(devices=4, mesh=(1, 4)))
    side = torch.cuda.Stream()
    for seed in range(8):
        feeds = model.feeds(seed=seed)
        want = single.run(feeds)
        streams.clear()
        with torch.cuda.stream(side):
            got = sharded.run(feeds)
        assert sorted(key for key, _ in streams) == sorted(sharded.shards)
        assert all(stream == side for _, stream in streams)
        _assert_outputs_equal(want, got)
