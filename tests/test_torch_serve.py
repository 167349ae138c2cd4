"""The port's serving layer on the CPU: the micro-batching request queue and
the ``repro_torch.launch.serve`` zoo server.

The six ``test_microbatcher_*`` behaviours of the reference's
``tests/test_serving.py`` (results equal per-request execution, bursts
batch, the deadline flushes a partial batch, a bad request fails only its
own future, cancelled futures do not kill the dispatcher, failures
propagate and the queue keeps serving), run against the port.  The
reference's own versions fail under jax 0.9: their fixtures compile
``"mlp_tiny"`` by name, which goes through the traced frontend, and its
importer rejects the ``jit`` primitive that jax 0.9 emits
(``frontend/importer.py:541``).  Here the per-request reference is the
reference's golden-graph compile (``get_model("mlp_tiny").build()``).
"""

import argparse
import os
import sys
import threading
import time

import numpy as np
import pytest

import repro
from repro.core import zoo as ref_zoo
import repro_torch
from repro_torch.core import zoo
from repro_torch.kernels import gemm
from repro_torch.kernels.gemm import GemmKernelConfig
from repro_torch.launch import serve
from repro_torch.serve import MicroBatcher


@pytest.fixture(autouse=True)
def _schedule_cache_in_tmp(tmp_path, monkeypatch):
    """``serve_zoo`` compiles with the default schedule cache, as the CLI
    does; keep that cache out of the home directory."""
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "schedule_cache"))


@pytest.fixture(scope="module")
def batched_mlp():
    return repro_torch.compile(
        "mlp_tiny",
        repro_torch.Target("gemmini", device="cpu", cache=False),
        options=repro_torch.CompileOptions(batch_buckets=(1, 4)),
    )


@pytest.fixture(scope="module")
def mlp_reference():
    return repro.compile(ref_zoo.get_model("mlp_tiny").build(), repro.Target("gemmini", cache=False))


# -- MicroBatcher --------------------------------------------------------------


def test_microbatcher_results_match_per_request_execution(batched_mlp, mlp_reference):
    model = zoo.get_model("mlp_tiny")
    traffic = [model.feeds(seed=s) for s in range(11)]
    with MicroBatcher(batched_mlp, max_batch=4, max_delay_s=0.05) as mb:
        futures = [mb.submit(f) for f in traffic]
        outs = [f.result(timeout=10) for f in futures]
    for feeds, out in zip(traffic, outs):
        assert np.array_equal(out[0], mlp_reference.run(feeds)[0])


def test_microbatcher_batches_bursts(batched_mlp):
    """A burst submitted before the deadline must dispatch in few batches,
    each capped at max_batch."""
    model = zoo.get_model("mlp_tiny")
    with MicroBatcher(batched_mlp, max_batch=4, max_delay_s=0.25) as mb:
        futures = [mb.submit(model.feeds(seed=s)) for s in range(8)]
        for f in futures:
            f.result(timeout=10)
        stats = mb.stats
    assert stats.requests == 8
    assert all(size <= 4 for size in stats.batch_sizes)
    assert stats.batches <= 4  # batching actually happened (not 8 singles)
    assert stats.mean_batch() >= 2.0


def test_microbatcher_deadline_flushes_partial_batch(batched_mlp):
    """One lone request must not wait for a full batch: the deadline
    dispatches a partial batch."""
    model = zoo.get_model("mlp_tiny")
    with MicroBatcher(batched_mlp, max_batch=64, max_delay_s=0.01) as mb:
        t0 = time.perf_counter()
        out = mb.submit(model.feeds(seed=0)).result(timeout=10)
        dt = time.perf_counter() - t0
    assert out[0].shape == (1, 16)
    assert dt < 5.0  # resolved by deadline, not by a full batch


def test_microbatcher_isolates_bad_request_from_neighbors(batched_mlp, mlp_reference):
    """One request with invalid feeds must fail ONLY its own future; the
    co-batched healthy requests still get their results."""
    model = zoo.get_model("mlp_tiny")
    good_feeds = [model.feeds(seed=s) for s in range(3)]
    with MicroBatcher(batched_mlp, max_batch=4, max_delay_s=0.25) as mb:
        futures = [mb.submit(f) for f in good_feeds[:1]]
        bad = mb.submit({"x": np.zeros((2, 2), dtype=np.float32)})
        futures += [mb.submit(f) for f in good_feeds[1:]]
        for feeds, fut in zip(good_feeds, futures):
            assert np.array_equal(fut.result(timeout=10)[0], mlp_reference.run(feeds)[0])
        with pytest.raises(repro_torch.FeedError):
            bad.result(timeout=10)


def test_microbatcher_survives_cancelled_futures(batched_mlp):
    """A client cancelling a queued future must not kill the dispatcher:
    subsequent requests still resolve."""
    model = zoo.get_model("mlp_tiny")
    with MicroBatcher(batched_mlp, max_batch=4, max_delay_s=0.3) as mb:
        doomed = mb.submit(model.feeds(seed=0))
        cancelled = doomed.cancel()  # races the dispatcher; both paths OK
        later = mb.submit(model.feeds(seed=1))
        assert later.result(timeout=10)[0].shape == (1, 16)
        if not cancelled:  # dispatcher won the race and ran it
            assert doomed.result(timeout=10)[0].shape == (1, 16)


def test_microbatcher_propagates_failures_and_keeps_serving(batched_mlp):
    model = zoo.get_model("mlp_tiny")
    with MicroBatcher(batched_mlp, max_batch=2, max_delay_s=0.01) as mb:
        bad = mb.submit({"x": np.zeros((3, 3), dtype=np.float32)})
        with pytest.raises(repro_torch.FeedError):
            bad.result(timeout=10)
        good = mb.submit(model.feeds(seed=1))
        assert good.result(timeout=10)[0].shape == (1, 16)
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(model.feeds(seed=2))


# -- serve_zoo -----------------------------------------------------------------


def _serve_args(**overrides):
    base = dict(
        zoo="transformer_block",
        target="gemmini:optimized",
        requests=24,
        batch=16,
        deadline_ms=1.0,
        device="cpu",
    )
    base.update(overrides)
    return argparse.Namespace(**base)


@pytest.mark.parametrize(
    "name,target,batch,buckets",
    [
        ("transformer_block", "gemmini:optimized", 16, [1, 4, 16]),
        ("qcnn", "edge_npu:naive", 1, [1]),
        ("toycar_mlp", "gemmini:baseline", 64, [1, 4, 16, 64]),
    ],
)
def test_serve_zoo_prints_its_lines_and_serves_per_request_results(capsys, name, target, batch, buckets):
    gemm.reset_launches()
    result = serve.serve_zoo(_serve_args(zoo=name, target=target, batch=batch, requests=70))
    out = capsys.readouterr().out
    assert f"[serve] {name} on {target}@cpu: compiled {len(buckets)} bucket plans {buckets}" in out
    assert "(cold start)" in out
    assert "70 requests in" in out and "req/s" in out and "p50" in out and "p99" in out
    assert "dispatches, mean batch" in out
    assert f"modeled cycles/request at batch {buckets[-1]}" in out
    assert "[serve] sample output:" in out

    assert result.module.bucket_sizes() == tuple(buckets)
    assert result.stats.requests == 70 and len(result.latencies_s) == 70
    assert all(size <= batch for size in result.stats.batch_sizes)
    acc, mode = target.split(":")
    single = repro_torch.compile(zoo.get_model(name).build(), repro_torch.Target(acc, mode=mode, device="cpu", cache=False))
    for feeds, got in zip(result.traffic, result.outputs):
        want = single.run(feeds)
        assert got[0].dtype == want[0].dtype
        np.testing.assert_array_equal(got[0], want[0])
    assert sum(gemm.LAUNCHES.values()) == 0


@pytest.mark.parametrize(
    "argv,what",
    [
        (["--zoo", "toycar_mlp", "--devices", "2"], "--devices"),
        (["--arch", "musicgen_medium", "--device", "cpu"], "needs frontend embeddings"),
        (["--zoo", "attn_decode", "--artifact", "dec.art"], "decode zoo"),
        ([], "pass --zoo"),
    ],
)
def test_serve_cli_refuses_what_is_not_ported(argv, what):
    with pytest.raises(SystemExit) as e:
        serve.main(argv)
    assert what in str(e.value.code)


def test_serve_zoo_boots_from_artifact_without_compiling(capsys, tmp_path, monkeypatch):
    """``--save-artifact`` writes the served batched module; ``--artifact``
    boots the next server from it with no compile, no DSE and no pass
    pipeline, serving the same responses.  The reference's version of this
    test fails only because its first compile goes through the traced
    frontend."""
    path = tmp_path / "toycar.art"
    first = serve.serve_zoo(_serve_args(zoo="toycar_mlp", batch=4, requests=9, save_artifact=str(path)))
    assert f"[serve] saved compile artifact to {path}" in capsys.readouterr().out

    def no_compile(*args, **kwargs):
        raise AssertionError("serve_zoo compiled despite --artifact")

    monkeypatch.setattr(repro_torch, "compile", no_compile)
    booted = serve.serve_zoo(_serve_args(zoo="toycar_mlp", batch=4, requests=9, artifact=str(path)))
    out = capsys.readouterr().out
    assert "[serve] toycar_mlp on gemmini:optimized@cpu: loaded artifact 2 bucket plans [1, 4]" in out
    assert booted.boot_how == "loaded artifact" and first.boot_how == "compiled"
    assert booted.module.bucket_sizes() == (1, 4)
    for b in booted.module.bucket_sizes():
        backend = booted.module.bucket_module(b).backend
        assert backend.scheduler.n_solver_calls == 0 and backend.n_measurements == 0
    for got, want in zip(booted.outputs, first.outputs):
        np.testing.assert_array_equal(got[0], want[0])


def test_serve_zoo_rejects_single_shape_artifact(tmp_path):
    path = tmp_path / "single.art"
    repro_torch.save(
        repro_torch.compile("mlp_tiny", repro_torch.Target("gemmini", device="cpu", cache=False)), path
    )
    with pytest.raises(SystemExit, match="single-shape module"):
        serve.serve_zoo(_serve_args(zoo="mlp_tiny", batch=4, requests=2, artifact=str(path)))


def test_serve_cli_saves_and_boots_artifacts(capsys, tmp_path):
    path = tmp_path / "qcnn.art"
    common = ["--zoo", "qcnn", "--target", "edge_npu:naive", "--requests", "3", "--batch", "4",
              "--device", "cpu"]
    serve.main(common + ["--save-artifact", str(path)])
    assert (path / "manifest.json").exists()
    serve.main(common + ["--artifact", str(path)])
    assert "[serve] qcnn on edge_npu:naive@cpu: loaded artifact 2 bucket plans [1, 4]" in (
        capsys.readouterr().out
    )


def test_serve_cli_serves_on_the_cpu_when_asked(capsys):
    serve.main(["--zoo", "mlp_tiny", "--target", "edge_npu:optimized", "--requests", "5",
                "--batch", "4", "--device", "cpu"])
    assert "[serve] mlp_tiny on edge_npu:optimized@cpu" in capsys.readouterr().out


def test_launch_count_survives_concurrent_dispatchers():
    """A dispatcher thread counts launches beside the caller's threads: no
    count may be lost."""
    cfg = GemmKernelConfig(16, 32, 16, acc_dtype="int32", out_dtype="int32")
    workers, per_worker = (os.cpu_count() or 1) + 4, 2000
    gemm.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=lambda: [gemm.record_launch(cfg) for _ in range(per_worker)])
            for _ in range(workers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert gemm.LAUNCHES["gemm_int32"] == workers * per_worker
    finally:
        sys.setswitchinterval(old)
        gemm.reset_launches()
