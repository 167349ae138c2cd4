"""The port's sharded LM on four gloo ranks, on the CPU: DTensor
parameters, optimizer state, caches and batches on a (2, 2) ("data",
"model") mesh, against the unsharded port and the reference.

One subprocess spawns the four ranks (``torch.multiprocessing``, a
``file://`` store) and runs every job; this process builds the jobs and
the two unsharded runs.  Parameters are the reference's
(``init_lm(jax.random.key(0), cfg)`` of the smoke configs, f32), carried
across with ``params_from_numpy`` / ``opt_state_from_numpy``; the
reference's policy and the port's are installed for the same (2, 2)
shape, so the MoE layers group their tokens alike (G = 2).

- Training: the reference takes one step from init; from that state
  (its moments non-zero) the sharded port, the unsharded port and the
  reference each take two more steps on the same batches.  The loss of
  each step within 1e-6 relative, and each parameter leaf within 1e-5 of
  its largest |value| plus 1e-4 of the learning rate (the sums are split
  across ranks, so they round differently; a leaf that starts at 0 is
  learning-rate sized after AdamW's steps, which carry the rounding of
  its gradient at that size).  Observed: at most 0.25 of that tolerance
  (jamba), 0.06 or less for yi and mixtral.  The four ranks' checkpoint
  (each rank gathers, rank 0 writes) restores unsharded bit-equal to
  their final parameters.
- Decoding: a prefill of 8 tokens and 4 greedy decode steps give the
  same tokens sharded, unsharded and in the reference.  deepseek-v2's
  MLA latent cache is sequence-parallel (positions over ``model``);
  jamba's KV heads shard over ``model``, its Mamba states beside them.
"""

import os
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
MESH = {"data": 2, "model": 2}
TRAIN_ARCHS = ("yi_34b", "mixtral_8x7b", "jamba_v0_1_52b")
DECODE_ARCHS = ("jamba_v0_1_52b", "deepseek_v2_236b")
BATCH, SEQ = 4, 16
PROMPT, MAX_LEN, STEPS = 8, 16, 4


# -- the four ranks (run in the subprocess) ---------------------------------------


def _worker(rank: int, tmp: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import policy
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.tree import flatten

    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=4)
    mesh = make_elastic_mesh(model_parallel=MESH["model"], device_type="cpu")
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == MESH
    policy.install(mesh)
    rows = shd.placements(shd.batch_spec(mesh), mesh)
    jobs = torch.load(os.path.join(tmp, "jobs.pt"), weights_only=False)
    results = {}
    for name, job in jobs.items():
        cfg = get_smoke_config(job["arch"])
        params = shd.shard_tree(job["params"], shd.param_specs(cfg, job["params"], mesh), mesh)
        if job["kind"] == "train":
            opt = job["opt_state"]
            ospecs = shd.opt_state_specs(cfg, opt, shd.param_specs(cfg, job["params"], mesh))
            state = TrainState(params, shd.shard_tree(opt, ospecs, mesh))
            step = make_train_step(cfg, AdamWConfig(**job["opt_cfg"]))
            losses = []
            for batch in job["batches"]:
                state, metrics = step(state, {k: distribute_tensor(v, mesh, rows) for k, v in batch.items()})
                losses.append(float(metrics["loss"]))
            assert all(isinstance(t, DTensor) for t in flatten(state.params))
            # every rank gathers its shards, rank 0 writes
            save_checkpoint(os.path.join(tmp, name.replace(":", "_")), len(losses), tuple(state))
            results[name] = {"losses": losses, "params": [t.full_tensor() for t in flatten(state.params)]}
        else:
            cache = lm.init_cache(cfg, BATCH, MAX_LEN, device="cpu")
            cache = shd.shard_tree(cache, shd.cache_specs(cfg, cache, mesh), mesh)
            logits, cache = lm.prefill(params, cfg, distribute_tensor(job["prompt"], mesh, rows), cache)
            tokens = []
            for _ in range(STEPS):
                tok = logits.full_tensor().argmax(-1).to(torch.int32)
                tokens.append(tok)
                logits, cache = lm.decode_step(params, cfg, cache, distribute_tensor(tok, mesh, rows))
            attn = _attention_cache(cache)
            results[name] = {"tokens": torch.cat(tokens, 1),
                             "layout": {k: (v.dim(), v.placements) for k, v in attn.items()}}
    if rank == 0:
        torch.save(results, os.path.join(tmp, "results.pt"))
    dist.destroy_process_group()


def _attention_cache(cache):
    """The first attention layer's cache (KV or MLA latent)."""
    for layer in [*cache["prefix"], *cache["groups"].values()]:
        if "k" in layer or "latent" in layer:
            return layer
    raise AssertionError("no attention layer")


# -- this process: the jobs, the unsharded port and the reference ---------------------


def _ref_train_start(arch, ref_policy):
    import jax

    from repro.configs import get_smoke_config as ref_get_smoke_config
    from repro.models import lm as ref_lm
    from repro.optim import AdamWConfig as RefAdamWConfig
    from repro.optim import adamw_init as ref_adamw_init
    from repro.train import step as ref_step

    ref_policy.install(SimpleNamespace(shape=MESH))
    cfg = ref_get_smoke_config(arch)
    opt_cfg = dict(lr=1e-3, warmup_steps=5, total_steps=20)
    ref_fn = jax.jit(ref_step.make_train_step(cfg, RefAdamWConfig(**opt_cfg)))
    params = ref_lm.init_lm(jax.random.key(0), cfg)
    state, _ = ref_fn(ref_step.TrainState(params, ref_adamw_init(RefAdamWConfig(**opt_cfg), params)),
                      _batch(cfg, 0))
    return cfg, opt_cfg, ref_fn, state


def _batch(cfg, step):
    from repro.data import DataConfig as RefDataConfig
    from repro.data import SyntheticTokenPipeline as RefPipeline

    pipe = RefPipeline(RefDataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH, seed=5))
    return pipe.batch_at(step)


@pytest.fixture(scope="module")
def runs():
    """(jobs, the four ranks' results, the unsharded port's, the reference's)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as ref_get_smoke_config
    from repro.models import lm as ref_lm
    from repro.parallel import policy as ref_policy
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import policy
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.tree import flatten

    jobs, unsharded, ref = {}, {}, {}
    try:
        policy.install(MESH)
        for arch in TRAIN_ARCHS:
            cfg = get_smoke_config(arch)
            ref_cfg, opt_cfg, ref_fn, state = _ref_train_start(arch, ref_policy)
            host = jax.tree.map(np.asarray, state)
            batches = [_batch(ref_cfg, s) for s in (1, 2)]
            ref_losses = []
            for b in batches:
                state, m = ref_fn(state, b)
                ref_losses.append(float(m["loss"]))
            ref[f"train:{arch}"] = {"losses": ref_losses, "params": [np.asarray(a) for a in jax.tree.leaves(state.params)]}

            params = lm.params_from_numpy(host.params, cfg, device="cpu")
            opt = lm.opt_state_from_numpy(host.opt_state, cfg, device="cpu")
            torch_batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
            jobs[f"train:{arch}"] = {"kind": "train", "arch": arch, "params": params, "opt_state": opt,
                                     "opt_cfg": opt_cfg, "batches": torch_batches}
            st, losses = TrainState(params, opt), []
            step = make_train_step(cfg, AdamWConfig(**opt_cfg))
            for b in torch_batches:
                st, m = step(st, b)
                losses.append(float(m["loss"]))
            unsharded[f"train:{arch}"] = {"losses": losses, "params": flatten(st.params)}

        rng = np.random.default_rng(7)
        for arch in DECODE_ARCHS:
            ref_cfg, cfg = ref_get_smoke_config(arch), get_smoke_config(arch)
            ref_policy.install(SimpleNamespace(shape=MESH))
            ref_params = ref_lm.init_lm(jax.random.key(0), ref_cfg)
            prompt = rng.integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
            cache = ref_lm.init_cache(ref_cfg, BATCH, MAX_LEN)
            logits, cache = ref_lm.prefill(ref_params, ref_cfg, jnp.asarray(prompt), cache)
            toks = []
            for _ in range(STEPS):
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                toks.append(np.asarray(tok))
                logits, cache = ref_lm.decode_step(ref_params, ref_cfg, cache, tok)
            ref[f"decode:{arch}"] = {"tokens": np.concatenate(toks, 1)}

            params = lm.params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
            jobs[f"decode:{arch}"] = {"kind": "decode", "arch": arch, "params": params,
                                      "prompt": torch.from_numpy(prompt)}
            c = lm.init_cache(cfg, BATCH, MAX_LEN, device="cpu")
            with torch.inference_mode():
                logits, c = lm.prefill(params, cfg, torch.from_numpy(prompt), c)
                toks = []
                for _ in range(STEPS):
                    tok = logits.argmax(-1).to(torch.int32)
                    toks.append(tok)
                    logits, c = lm.decode_step(params, cfg, c, tok)
            unsharded[f"decode:{arch}"] = {"tokens": torch.cat(toks, 1).numpy()}
    finally:
        policy.set_policy(None)
        ref_policy.set_policy(None)

    with tempfile.TemporaryDirectory() as tmp:
        torch.save(jobs, os.path.join(tmp, "jobs.pt"))
        proc = subprocess.run(
            [sys.executable, __file__, tmp], capture_output=True, text=True, timeout=900,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src") + os.pathsep + str(ROOT / "tests")},
        )
        assert proc.returncode == 0, proc.stderr[-4000:]
        sharded = torch.load(os.path.join(tmp, "results.pt"), weights_only=False)
        for name, job in jobs.items():
            if job["kind"] == "train":  # the four ranks' checkpoint, as an unsharded restore reads it
                template = (job["params"], job["opt_state"])
                tree, step, _ = restore_checkpoint(os.path.join(tmp, name.replace(":", "_")), template)
                sharded[name]["restored"] = (step, flatten(tree[0]))
    return jobs, sharded, unsharded, ref


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_steps_equal_the_unsharded_port_and_the_reference(arch, runs):
    jobs, sharded, unsharded, ref = runs
    name = f"train:{arch}"
    got = sharded[name]
    step, restored = got["restored"]
    assert step == len(got["losses"])
    assert all(torch.equal(a, b) for a, b in zip(restored, got["params"], strict=True))
    lr = jobs[name]["opt_cfg"]["lr"]
    for other in (unsharded[name], ref[name]):
        np.testing.assert_allclose(got["losses"], other["losses"], rtol=1e-6)
        assert len(got["params"]) == len(other["params"])
        worst = 0.0
        for a, b in zip(got["params"], other["params"]):
            b = np.asarray(b)
            assert a.shape == b.shape and a.dtype == torch.float32
            err = float(np.abs(a.numpy() - b).max())
            worst = max(worst, err / (1e-5 * float(np.abs(b).max()) + 1e-4 * lr))
        assert worst <= 1.0, worst


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sharded_prefill_and_decode_give_the_unsharded_tokens(arch, runs):
    _, sharded, unsharded, ref = runs
    name = f"decode:{arch}"
    got = sharded[name]
    np.testing.assert_array_equal(got["tokens"].numpy(), unsharded[name]["tokens"])
    np.testing.assert_array_equal(got["tokens"].numpy(), ref[name]["tokens"])
    from torch.distributed.tensor import Shard

    layout = got["layout"]
    model = list(MESH).index("model")
    if arch == "deepseek_v2_236b":  # the sequence-parallel latent: positions over model
        ndim, placements = layout["latent"]
        assert placements[model] == Shard(ndim - 2), layout
    else:  # KV heads over model
        ndim, placements = layout["k"]
        assert placements[model] == Shard(ndim - 3), layout


if __name__ == "__main__":
    torch.multiprocessing.spawn(_worker, args=(sys.argv[1],), nprocs=4)
