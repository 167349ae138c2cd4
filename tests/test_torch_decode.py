"""The port's decode path against the reference: the KV-cache IR ops, the
decode zoo, compiled decode steps and prefills, the continuous-batching
engine, decode artifacts and the decode serve CLI.

Every compile is ``device="cpu"``, where each accelerator step runs the
kernel's plain version.  The reference is compiled from its golden graphs
(``get_decode_model(name).build(...)``): its traced frontend fails under
jax 0.9, so its engine runs here with ``DecodeModel.trace`` replaced, in
the test only, by the golden builder (which carries the same
``CacheSpec``; ``tests/test_decode.py`` pins trace == golden where the
frontend works).
"""

import json

import numpy as np
import pytest
import torch

import repro
from repro.core import ir as ref_ir
from repro.core import zoo as ref_zoo
from repro.serve import continuous as ref_continuous
import repro_torch
from repro_torch.core import ir, zoo
from repro_torch.core.artifact import graph_fingerprint
from repro_torch.core.executor import compile_host_op, kv_append
from repro_torch.kernels import gemm
from repro_torch.launch import serve
from repro_torch.serve import (
    BlockPool,
    ContinuousBatchingEngine,
    EngineConfig,
    PoolExhausted,
    random_requests,
    sequential_generate,
)

MODEL = zoo.get_decode_model("attn_decode")
REF_MODEL = ref_zoo.get_decode_model("attn_decode")
MODES = ("naive", "baseline", "optimized")
#: form -> (seq, batch): the decode step unbatched and at B = 3 and 8, and
#: a prefill of 8 rows
FORMS = {"decode": (1, None), "batched3": (1, 3), "batched8": (1, 8), "prefill8": (8, None)}


def _target(acc="gemmini", mode="optimized"):
    return repro_torch.Target(acc, mode=mode, device="cpu", cache=False)


def _ref_target(acc="gemmini", mode="optimized"):
    return repro.Target(acc, mode=mode, cache=False)


def _feeds(seq, batch, seed=5):
    if seq == 1:
        return REF_MODEL.feeds(seed=seed, batch=batch)
    return {
        **REF_MODEL.example_inputs(seq=seq),
        "x": np.random.default_rng(seed).integers(-128, 128, (seq, REF_MODEL.d_model)).astype(np.int8),
        "mask": ref_zoo.prefill_mask(seq, REF_MODEL.max_len),
    }


def _assert_bit_equal(got, want, context=""):
    assert len(got) == len(want), context
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray), context
        assert g.dtype == w.dtype and g.shape == w.shape, context
        np.testing.assert_array_equal(g, w, err_msg=context)


# -- the KV-cache IR ops -----------------------------------------------------------


@pytest.mark.parametrize("pos", [np.asarray(3), np.asarray([1, 5], np.int32)], ids=["scalar", "vector"])
def test_kv_append_ref_matches_the_reference(pos):
    rng = np.random.default_rng(0)
    cache = rng.integers(-128, 128, (2, 8, 4)).astype(np.int8)
    upd = rng.integers(-128, 128, (2, 2, 4)).astype(np.int8)
    before = cache.copy()
    want = ref_ir.kv_append_ref(cache, upd, pos)
    _assert_bit_equal([ir.kv_append_ref(cache, upd, pos)], [want])
    # the plan's host closure, on tensors, is the same write
    got = kv_append(torch.from_numpy(cache), torch.from_numpy(upd), torch.from_numpy(pos))
    _assert_bit_equal([got.numpy()], [want])
    np.testing.assert_array_equal(cache, before)  # functional: the input is untouched


@pytest.mark.parametrize(
    "cache_shape,upd_shape,pos",
    [((8, 4), (2, 4), 7), ((8, 4), (1, 4), -1), ((2, 8, 4), (2, 1, 4), [3, 8])],
    ids=["past-the-end", "negative", "one-slot"],
)
def test_out_of_bounds_append_raises_the_reference_error(cache_shape, upd_shape, pos):
    cache, upd = np.zeros(cache_shape, np.int8), np.ones(upd_shape, np.int8)
    pos = np.asarray(pos, np.int32)
    with pytest.raises(ValueError) as want:
        ref_ir.kv_append_ref(cache, upd, pos)
    with pytest.raises(ValueError) as got:
        ir.kv_append_ref(cache, upd, pos)
    assert str(got.value) == str(want.value)
    # the host closure checks a pos computed in the plan when it runs
    node = ir.kv_cache_append(
        ir.input_(cache_shape, "int8", name="c"), ir.input_(upd_shape, "int8", name="u"),
        ir.input_(pos.shape, "int32", name="p"),
    )
    fn = compile_host_op(node, torch.device("cpu"))
    with pytest.raises(ValueError) as closure:
        fn(torch.from_numpy(cache), torch.from_numpy(upd), torch.from_numpy(pos))
    assert str(closure.value) == str(want.value)


def test_cache_builders_validate_as_the_reference_does():
    for pkg in (ir, ref_ir):
        cache = pkg.input_((8, 4), "int8", name="c")
        upd = pkg.input_((1, 4), "int8", name="u")
        pos = pkg.input_((), "int32", name="p")
        node = pkg.kv_cache_append(cache, upd, pos)
        assert (node.shape, node.dtype) == ((8, 4), "int8")
        assert pkg.kv_cache_read(cache).shape == (8, 4)
    cases = [
        ((8, 4), "int8", (1, 5), "int8", ()),  # feature dim
        ((8, 4), "int8", (1, 4), "int32", ()),  # dtype
        ((8, 4), "int8", (9, 4), "int8", ()),  # more rows than the cache
        ((2, 8, 4), "int8", (2, 1, 4), "int8", (3,)),  # pos shape
    ]
    for cshape, cdt, ushape, udt, pshape in cases:
        msgs = []
        for pkg in (ir, ref_ir):
            with pytest.raises(ValueError) as e:
                pkg.kv_cache_append(
                    pkg.input_(cshape, cdt, name="c"), pkg.input_(ushape, udt, name="u"),
                    pkg.input_(pshape, "int32", name="p"),
                )
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert ir.CACHE_OPS == ref_ir.CACHE_OPS and ir.CACHE_OPS <= ir.HOST_OPS


def test_cache_ops_are_host_ops_with_the_reference_cycles():
    """kv_cache_read/append stay on the host and are costed like the
    reference's (the append as its update-row write)."""
    cycles = {}
    for pkg, compile_, target in (
        (ir, repro_torch.compile, _target(mode="baseline")),
        (ref_ir, repro.compile, _ref_target(mode="baseline")),
    ):
        read = pkg.Graph([pkg.kv_cache_read(pkg.input_((64, 64), "int8", name="c"))])
        app = pkg.Graph([pkg.kv_cache_append(
            pkg.input_((64, 64), "int8", name="c"), pkg.input_((1, 64), "int8", name="u"),
            pkg.input_((), "int32", name="p"),
        )])
        cycles[pkg] = [compile_(g, target=target).modeled_cycles() for g in (read, app)]
    assert cycles[ir] == cycles[ref_ir]
    read_c, app_c = cycles[ir]
    assert read_c["host"] > 0 and read_c["accel"] == 0
    assert 0 < app_c["host"] < read_c["host"]


# -- the decode zoo ----------------------------------------------------------------


def test_decode_zoo_matches_the_reference():
    assert zoo.decode_model_names() == ref_zoo.decode_model_names() == ["attn_decode"]
    for field in ("name", "d_model", "max_len", "accelerators", "n_gemms"):
        assert getattr(MODEL, field) == getattr(REF_MODEL, field), field
    assert zoo.DECODE_MAX_LEN == ref_zoo.DECODE_MAX_LEN and zoo.MASK_BLOCKED == ref_zoo.MASK_BLOCKED
    want, have = REF_MODEL.params(), MODEL.params()
    assert have.keys() == want.keys()
    for key in want:
        assert have[key].dtype == want[key].dtype
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)
    for batch in (None, 3):
        for seed in (0, 7):
            got, ref = MODEL.feeds(seed=seed, batch=batch), REF_MODEL.feeds(seed=seed, batch=batch)
            assert got.keys() == ref.keys()
            _assert_bit_equal(list(got.values()), list(ref.values()), f"feeds {seed} {batch}")
        got, ref = MODEL.example_inputs(batch=batch), REF_MODEL.example_inputs(batch=batch)
        _assert_bit_equal(list(got.values()), list(ref.values()))
    _assert_bit_equal([zoo.decode_mask(np.asarray([0, 5, 63]), 64), zoo.decode_mask(9, 64),
                       zoo.prefill_mask(8, 64)],
                      [ref_zoo.decode_mask(np.asarray([0, 5, 63]), 64), ref_zoo.decode_mask(9, 64),
                       ref_zoo.prefill_mask(8, 64)])
    with pytest.raises(KeyError, match="unknown decode zoo model 'nope'; available: attn_decode"):
        zoo.get_decode_model("nope")
    with pytest.raises(ValueError, match="seq=1"):
        MODEL.build(seq=8, batch=2)


@pytest.mark.parametrize("form", FORMS)
def test_golden_graph_matches_the_reference(form):
    seq, batch = FORMS[form]
    got, want = MODEL.build(seq=seq, batch=batch), REF_MODEL.build(seq=seq, batch=batch)
    assert got.name == want.name
    assert [(n.op, n.shape, n.dtype) for n in got.toposort()] == [
        (n.op, n.shape, n.dtype) for n in want.toposort()
    ]
    assert got.cache_spec.__dict__ == want.cache_spec.__dict__
    feeds = _feeds(seq, batch)
    _assert_bit_equal(ir.execute_graph(got, feeds), ref_ir.execute_graph(want, feeds), form)


def test_reference_parameters_carry_across():
    """``build(params=...)`` takes the reference's parameter dict."""
    feeds = _feeds(1, 3)
    want = ref_ir.execute_graph(ref_zoo.attn_decode_graph(seed=3, batch=3), feeds)
    got = ir.execute_graph(MODEL.build(batch=3, params=ref_zoo.decode_params(3)), feeds)
    _assert_bit_equal(got, want)
    assert not np.array_equal(ir.execute_graph(MODEL.build(batch=3), feeds)[0], got[0])
    with pytest.raises(ValueError, match="missing parameter 'w_q'"):
        MODEL.build(params={k: v for k, v in MODEL.params().items() if k != "w_q"})


# -- compiled decode steps and prefills -----------------------------------------


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("acc", MODEL.accelerators)
def test_compiled_decode_matches_the_reference(acc, mode, form):
    gemm.reset_launches()
    seq, batch = FORMS[form]
    ref = repro.compile(REF_MODEL.build(seq=seq, batch=batch), _ref_target(acc, mode))
    got = repro_torch.compile(
        MODEL.build(seq=seq, batch=batch, params=ref_zoo.decode_params(0)), _target(acc, mode)
    )
    context = f"{acc}/{mode}/{form}"
    # the post-pass op sequence, compared in plan order (names differ)
    assert [(n.op, n.target) for n in got.graph.toposort()] == [
        (n.op, n.target) for n in ref.graph.toposort()
    ], context
    assert len(got.ops) == len(ref.ops) == MODEL.n_gemms
    assert all(n.target == "host" for n in got.graph.toposort() if n.op in ir.CACHE_OPS)
    assert got.graph.cache_spec == zoo.decode_cache_spec(MODEL.max_len, batch)
    assert got.modeled_cycles() == ref.modeled_cycles(), context
    feeds = _feeds(seq, batch)
    out = got.run(feeds)
    _assert_bit_equal(out, ref.run(feeds), context)
    _assert_bit_equal(out, ref_ir.execute_graph(REF_MODEL.build(seq=seq, batch=batch), feeds), context)
    assert sum(gemm.LAUNCHES.values()) == 0  # the CPU runs the plain versions


def test_front_door_compiles_the_decode_step():
    module = repro_torch.compile("attn_decode", _target())
    assert module.graph.name == "attn_decode"
    assert [s for s, _ in module.graph.cache_spec.state] == ["k_cache", "v_cache"]
    feeds = MODEL.feeds(seed=9)
    _assert_bit_equal(module.run(feeds), ref_ir.execute_graph(REF_MODEL.build(), feeds))


def test_decode_names_refuse_batch_buckets():
    with pytest.raises(ValueError) as want:
        repro.compile("attn_decode", target=_ref_target(),
                      options=repro.CompileOptions(batch_buckets=(1, 4)))
    for options, target in (
        (repro_torch.CompileOptions(batch_buckets=(1, 4)), _target()),
        (None, repro_torch.Target("gemmini", device="cpu", cache=False, batch_size=4)),
    ):
        with pytest.raises(ValueError) as got:
            repro_torch.compile("attn_decode", target, options=options)
        msg = str(got.value)
        assert msg.startswith(str(want.value).split(" — ")[0])
        assert "get_decode_model(name).trace(batch=B)" in msg
        assert "repro_torch.serve.ContinuousBatchingEngine" in msg


def test_out_of_bounds_pos_raises_before_any_step_runs():
    module = repro_torch.compile(MODEL.build(batch=2), _target())
    feeds = MODEL.feeds(seed=1, batch=2)
    feeds["pos"] = np.asarray([3, MODEL.max_len], np.int32)
    with pytest.raises(ValueError) as want:
        ref_ir.execute_graph(REF_MODEL.build(batch=2), feeds)
    plan = module.finalize()
    assert plan.append_checks == (("pos", 1, MODEL.max_len),) * 2
    with pytest.raises(ValueError) as got:
        module.run(feeds)
    assert str(got.value) == str(want.value)


def test_prefill_and_decode_are_distinct_plans_sharing_weights():
    dec = repro_torch.compile(MODEL.build(), _target())
    pre = repro_torch.compile(MODEL.build(seq=8), _target())
    assert (dec.graph.name, pre.graph.name) == ("attn_decode", "attn_prefill")

    def weights(m):
        return sorted(n.value.tobytes() for n in m.graph.toposort()
                      if n.op == "const" and n.value is not None and n.value.ndim >= 1)

    assert weights(dec) == weights(pre)
    assert dec.graph.outputs[0].shape[0] == 1 and pre.graph.outputs[0].shape[0] == 8


def test_batched_decode_matches_per_sample():
    batched = repro_torch.compile(MODEL.build(batch=3), _target())
    single = repro_torch.compile(MODEL.build(), _target())
    feeds = MODEL.feeds(seed=2, batch=3)
    outs = batched.run(feeds)
    for b in range(3):
        per = single.run({k: v[b] for k, v in feeds.items()})
        for j, o in enumerate(per):
            np.testing.assert_array_equal(o, outs[j][b])


# -- BlockPool ---------------------------------------------------------------------


def test_block_pool_alloc_free_and_occupancy():
    pool = BlockPool(n_blocks=4, block_size=8, width=16)
    blocks = [pool.alloc() for _ in range(3)]
    assert pool.n_used == 3 and pool.n_free == 1
    assert pool.occupancy() == 0.75 and pool.peak_used == 3
    pool.free(blocks)
    assert pool.n_used == 0 and pool.peak_used == 3
    assert sorted({pool.alloc() for _ in range(4)}) == [0, 1, 2, 3]
    with pytest.raises(PoolExhausted):
        pool.alloc()
    with pytest.raises(ValueError, match="n_blocks >= 1"):
        BlockPool(n_blocks=0, block_size=8, width=4)


def test_block_pool_write_gather_round_trip_across_blocks():
    pool = BlockPool(n_blocks=4, block_size=4, width=8)
    table = [pool.alloc(), pool.alloc()]
    rows_k = np.arange(8 * 8, dtype=np.int8).reshape(8, 8)
    rows_v = -rows_k
    for r in range(6):
        pool.write_row(table, r, rows_k[r], rows_v[r])
    k, v = pool.gather(table, 6)
    np.testing.assert_array_equal(k, rows_k[:6])
    np.testing.assert_array_equal(v, rows_v[:6])
    assert pool.gather(table, 0)[0].shape == (0, 8)


def test_block_pool_free_scrubs_blocks():
    pool = BlockPool(n_blocks=2, block_size=2, width=4)
    blk = pool.alloc()
    pool.write_row([blk], 0, np.ones(4, np.int8), np.ones(4, np.int8))
    pool.free([blk])
    again = pool.alloc()
    assert np.all(pool.k[again] == 0) and np.all(pool.v[again] == 0)


def test_block_pool_blocks_for_rounds_up():
    pool = BlockPool(n_blocks=1, block_size=8, width=4)
    assert (pool.blocks_for(1), pool.blocks_for(8), pool.blocks_for(9)) == (1, 1, 2)


# -- the continuous-batching engine ---------------------------------------------


CFG = EngineConfig(batch=4, prompt_len=8, max_new_tokens=6, block_size=8)


@pytest.fixture(scope="module")
def engine():
    return ContinuousBatchingEngine(MODEL, _target(), CFG)


def _golden_trace(monkeypatch):
    """The reference's engine compiles ``model.trace(...)``, which goes
    through its traced frontend; use the golden graph instead."""
    monkeypatch.setattr(
        ref_zoo.DecodeModel, "trace",
        lambda self, seq=1, batch=None: self.build(seq=seq, batch=batch),
    )


def _streams(requests):
    return [(r.rid, r.tokens, [v.tobytes() for v in r.vectors], r.done) for r in requests]


@pytest.mark.parametrize("acc,mode", [("gemmini", "optimized"), ("edge_npu", "naive")])
def test_engine_matches_the_reference_engine(monkeypatch, acc, mode):
    _golden_trace(monkeypatch)
    cfg = EngineConfig(batch=3, prompt_len=8, max_new_tokens=5, block_size=4)
    want = ref_continuous.random_requests(REF_MODEL, 7, cfg.prompt_len, seed=0)
    got = random_requests(MODEL, 7, cfg.prompt_len, seed=0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.prompt, b.prompt)
    ref_cfg = ref_continuous.EngineConfig(**cfg.__dict__)
    ref_rep = ref_continuous.ContinuousBatchingEngine(REF_MODEL, _ref_target(acc, mode), ref_cfg).run(want)
    rep = ContinuousBatchingEngine(MODEL, _target(acc, mode), cfg).run(got)
    assert _streams(got) == _streams(want)
    for field in ("total_new_tokens", "decode_steps", "prefills", "peak_occupancy", "n_blocks",
                  "block_size"):
        assert getattr(rep, field) == getattr(ref_rep, field), field


def test_sequential_generate_matches_the_reference(monkeypatch):
    _golden_trace(monkeypatch)
    want = ref_continuous.random_requests(REF_MODEL, 3, CFG.prompt_len, seed=4)
    got = random_requests(MODEL, 3, CFG.prompt_len, seed=4)
    ref_rep = ref_continuous.sequential_generate(
        REF_MODEL, _ref_target(), want, ref_continuous.EngineConfig(**CFG.__dict__))
    rep = sequential_generate(MODEL, _target(), got, CFG)
    assert _streams(got) == _streams(want)
    assert (rep.decode_steps, rep.prefills) == (ref_rep.decode_steps, ref_rep.prefills)


def test_continuous_matches_sequential_token_for_token(engine):
    a = random_requests(MODEL, 10, CFG.prompt_len, seed=7)
    b = random_requests(MODEL, 10, CFG.prompt_len, seed=7)
    rep = engine.run(a)
    sequential_generate(MODEL, _target(), b, CFG)
    assert _streams(a) == _streams(b)
    assert rep.total_new_tokens == 10 * CFG.max_new_tokens


def test_engine_backfills_finished_slots(engine):
    n = CFG.batch * 3 + 1
    reqs = random_requests(MODEL, n, CFG.prompt_len, seed=1)
    rep = engine.run(reqs)
    assert all(r.done for r in reqs)
    assert rep.prefills == n
    assert 0 < rep.peak_occupancy <= 1.0
    assert engine.pool.n_used == 0
    assert rep.decode_steps < n * CFG.max_new_tokens


def test_engine_pool_rows_match_staging_state_after_every_step(engine):
    """The block pool is row-for-row consistent with the dense staging
    cache the compiled plan consumes, after every step."""
    queue = random_requests(MODEL, 6, CFG.prompt_len, seed=3)
    steps = 0
    while queue or any(r is not None for r in engine._slots):
        engine._admit(queue)
        engine._step()
        steps += 1
        for slot, req in enumerate(engine._slots):
            if req is None:
                continue
            n_rows = int(engine._pos[slot])
            k, v = engine.pool.gather(engine._tables[slot], n_rows)
            np.testing.assert_array_equal(k, engine._state["k_cache"][slot, :n_rows])
            np.testing.assert_array_equal(v, engine._state["v_cache"][slot, :n_rows])
    assert steps > 1 and engine.pool.n_used == 0


def test_engine_rejects_overflowing_budget():
    with pytest.raises(ValueError, match="max_len"):
        ContinuousBatchingEngine(
            MODEL, _target(), EngineConfig(prompt_len=32, max_new_tokens=MODEL.max_len)
        )


def test_engine_raises_when_pool_cannot_fit_one_request():
    eng = ContinuousBatchingEngine(
        MODEL, _target(),
        EngineConfig(batch=2, prompt_len=8, max_new_tokens=6, block_size=4, n_blocks=1),
    )
    with pytest.raises(PoolExhausted, match="smaller than one request"):
        eng.run(random_requests(MODEL, 1, 8, seed=0))


# -- decode artifacts --------------------------------------------------------------


@pytest.mark.parametrize("batch", [None, 4], ids=["step", "batched4"])
def test_decode_artifacts_cross_load_both_ways(tmp_path, batch):
    feeds = MODEL.feeds(seed=3, batch=batch)
    port = repro_torch.compile(MODEL.build(batch=batch), _target("edge_npu"))
    repro_torch.save(port, tmp_path / "port")
    ref_loaded = repro.load(tmp_path / "port")
    assert ref_loaded.graph.cache_spec.__dict__ == port.graph.cache_spec.__dict__
    _assert_bit_equal(ref_loaded.run(feeds), port.run(feeds))

    ref = repro.compile(REF_MODEL.build(batch=batch), _ref_target("edge_npu"))
    repro.save(ref, tmp_path / "ref")
    loaded = repro_torch.load(tmp_path / "ref", device="cpu")
    assert loaded.graph.cache_spec == port.graph.cache_spec
    _assert_bit_equal(loaded.run(feeds), ref.run(feeds))
    # the restored module threads its cache outputs back as the next step's
    # cache inputs, as the spec says
    outs = loaded.run(feeds)
    signature = {name: (shape, dtype) for name, shape, dtype in loaded.input_signature()}
    for name, idx in loaded.graph.cache_spec.state:
        assert (outs[idx].shape, str(outs[idx].dtype)) == signature[name]


def test_cache_spec_is_part_of_the_fingerprint():
    g = MODEL.build()
    bare = ir.Graph(outputs=g.outputs, name=g.name)
    assert graph_fingerprint(g) != graph_fingerprint(bare)
    from repro.core.artifact import graph_fingerprint as ref_fingerprint

    assert graph_fingerprint(g) == ref_fingerprint(REF_MODEL.build())
    assert ir.clone_graph(g).cache_spec == g.cache_spec


def test_decode_manifest_holds_the_cache_spec(tmp_path):
    path = repro_torch.save(repro_torch.compile("attn_decode", _target()), tmp_path / "art")
    spec = json.loads((path / "manifest.json").read_text())["graph"]["cache_spec"]
    assert spec == {"max_len": 64, "dtype": "int8", "layout": "LD",
                    "state": [["k_cache", 1], ["v_cache", 2]], "pos_input": "pos",
                    "mask_input": "mask"}


# -- the serve CLI -----------------------------------------------------------------


def test_serve_cli_serves_the_decode_zoo(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    serve.main(["--zoo", "attn_decode", "--device", "cpu", "--batch", "4", "--requests", "8"])
    out = capsys.readouterr().out
    assert "attn_decode on gemmini:optimized@cpu: continuous batching, 4 decode slots" in out
    assert "8 requests, 128 tokens" in out and "8 prefills" in out


def test_serve_decode_returns_what_it_served(tmp_path, monkeypatch):
    import argparse

    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    args = argparse.Namespace(zoo="attn_decode", target="edge_npu:baseline", batch=3, requests=5,
                              prompt_len=40, new_tokens=30, device="cpu")
    result = serve.serve_decode(args)
    assert result.engine.cfg.prompt_len == MODEL.max_len - 30  # clipped to fit the cache
    assert [len(r.tokens) for r in result.report.requests] == [30] * 5
    want = random_requests(MODEL, 5, result.engine.cfg.prompt_len, seed=0)
    sequential_generate(MODEL, _target("edge_npu", "baseline"), want, result.engine.cfg)
    assert _streams(result.report.requests) == _streams(want)
    args.new_tokens = MODEL.max_len
    with pytest.raises(SystemExit, match="leaves no room for a prompt"):
        serve.serve_decode(args)


def test_serve_cli_lists_both_zoos_for_an_unknown_name():
    with pytest.raises(SystemExit, match="available: mlp_tiny, qcnn, toycar_mlp, transformer_block, "
                                         "attn_decode"):
        serve.main(["--zoo", "nope", "--device", "cpu"])
