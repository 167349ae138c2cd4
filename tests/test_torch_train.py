"""The port's training path (``repro_torch.{parallel,optim,data,train}``,
``repro_torch.launch.train``, the flash backward, the differentiable
``lm.forward`` and the MoE groups) against the reference's, on the CPU.

Parameters come from the reference's ``init_lm(jax.random.key(0), cfg)``
and optimizer states from its own train step, converted with
``params_from_numpy`` / ``opt_state_from_numpy``; every other input is
drawn with numpy from a seed.  Tolerances, each stated where it is used:

- data batches, host slices, pipeline states, the learning rate and the
  data-parallel axes are bit-equal;
- ``adamw_update`` within 2 f32 ulp of the reference per element (1 bf16
  ulp where the result is stored in bf16: 2 f32 ulp apart can round to
  neighbouring bf16 values), and the global norm within 2 f32 ulp;
- the flash gradients within 1e-5 of the largest |grad| (both sum in f32,
  in different orders; observed about 4e-7);
- one train step of each smoke arch: the loss and ``grad_norm`` within
  1e-5 relative, each gradient leaf within 1e-4 of its largest |value|
  (observed 1e-5 at most, jamba's ``A_log``), compared before the
  optimizer, whose first step is about sign(g); the step's change to each
  parameter within 2e-2 of the step's learning rate (observed 7.3e-3,
  xlstm, where the gradient is within its tolerance of 0);
- remat on and off: bit-equal gradients.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticTokenPipeline as RefPipeline
from repro.models import flash as ref_flash
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw as ref_adamw_mod
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import cosine_lr as ref_cosine_lr
from repro.parallel import policy as ref_policy
from repro.parallel import sharding as ref_sharding
from repro.train import step as ref_step
from repro_torch.checkpoint import latest_step
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core.configurators import build_backend
from repro_torch.core.descriptions import make_gemmini_description
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.kernels import gemm, ops
from repro_torch.kernels.policy import scheduled_kernels
from repro_torch.launch import train as launch_train
from repro_torch.models import flash, lm, moe
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_lr
from repro_torch.optim import adamw as adamw_mod
from repro_torch.parallel import policy, sharding
from repro_torch.train import TrainState, make_train_step
from repro_torch.train import step as train_step_mod
from repro_torch.tree import flatten

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean():
    gemm.reset_launches()
    yield
    policy.set_policy(None)
    ref_policy.set_policy(None)
    assert sum(gemm.LAUNCHES.values()) == 0, "a CPU tensor launched the CUDA kernel"


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


# -- data ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "cfg",
    [
        dict(vocab=256, seq_len=32, global_batch=8, seed=7),
        dict(vocab=50304, seq_len=16, global_batch=4, seed=0),
        dict(vocab=1000, seq_len=12, global_batch=6, seed=3, n_frontend_tokens=4, d_model=8),
    ],
    ids=["small-vocab", "xlstm-vocab", "frontend"],
)
def test_pipeline_batches_slices_and_state_equal_the_reference(cfg):
    ref, port = RefPipeline(RefDataConfig(**cfg)), SyntheticTokenPipeline(DataConfig(**cfg))
    for step in (0, 1, 13, 1000):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert want.keys() == got.keys()
        for k in want:
            assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), (step, k)
        hosts = 2 if cfg["global_batch"] % 4 else 4
        for i in range(hosts):
            a, b = ref.host_slice(step, i, hosts), port.host_slice(step, i, hosts)
            assert all(np.array_equal(a[k], b[k]) for k in a)
        assert ref.state(step) == port.state(step)


# -- optimizer -----------------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(10, 100), (5, 12), (100, 10000), (0, 1)])
def test_cosine_lr_is_bit_equal_to_the_reference(warmup, total):
    ref_cfg = RefAdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    cfg = AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    for step in sorted({0, 1, warmup, total, total + 3, *range(0, total + 1, max(total // 97, 1))}):
        want = np.asarray(ref_cosine_lr(ref_cfg, jnp.int32(step)))
        got = cosine_lr(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes(), (step, got.item(), float(want))


def _opt_tree(rng, dtype):
    """A small parameter-shaped tree: a dict with a nested list, mixed ranks."""
    def draw(*shape):
        return rng.normal(size=shape).astype(np.float32)

    tree = {"b": draw(7), "a": {"w": draw(5, 3), "layers": [draw(4), draw(2, 2, 3)]}, "s": draw()}
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _to_port(tree):
    return jax.tree.map(lambda a: lm._to_tensor(np.asarray(a), "cpu", None), tree)


def _within_ulps(got: torch.Tensor, want, n_f32: int = 2):
    """Elementwise: within ``n_f32`` f32 ulp of ``want``, or within 1 bf16
    ulp where ``got`` is stored in bf16."""
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        w = want.astype(np.float32)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0**-126))) - 7)
        return np.abs(_np(got) - w) <= ulp
    return np.abs(_np(got) - want) <= n_f32 * np.spacing(np.abs(want).astype(np.float32))


@pytest.mark.parametrize("clipped", [False, True], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(param_dtype, moment_dtype, clipped, monkeypatch):
    """Three updates from one state: every new parameter and moment within
    2 f32 ulp (1 bf16 ulp where stored in bf16), grad_norm and lr likewise.
    Clipped (global norm above grad_clip), the norm's sum runs in another
    order than XLA's and lands 1 ulp away, which the clip scale carries
    into every moment; so the norm is held to 2 ulp on its own, and the
    update is then given the reference's norm."""
    rng = np.random.default_rng(11)
    ref_cfg = RefAdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5, moment_dtype=moment_dtype)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5, moment_dtype=moment_dtype)
    dt = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    ref_params = _opt_tree(rng, dt)
    ref_state = ref_adamw_init(ref_cfg, ref_params)
    params, state = _to_port(ref_params), _to_port(ref_state)
    for i in range(3):
        grads_np = jax.tree.map(lambda g: g * (10.0 if clipped else 0.1), _opt_tree(rng, dt))
        grads = _to_port(grads_np)
        ref_norm = ref_adamw_mod._global_norm(grads_np)
        assert _within_ulps(adamw_mod._global_norm(grads), ref_norm).all()
        if clipped:
            monkeypatch.setattr(adamw_mod, "_global_norm", lambda tree: torch.from_numpy(np.array(ref_norm)))
        ref_params, ref_state, ref_metrics = ref_adamw_update(ref_cfg, ref_params, grads_np, ref_state)
        params, state, metrics = adamw_update(cfg, params, grads, state)
        monkeypatch.undo()
        assert (float(ref_metrics["grad_norm"]) > ref_cfg.grad_clip) == clipped
        for want, got in zip(
            jax.tree.leaves((ref_params, ref_state["m"], ref_state["v"])),
            flatten((params, state["m"], state["v"])),
            strict=True,
        ):
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            assert _within_ulps(got, want).all(), (i, np.abs(_np(got) - np.asarray(want, np.float32)).max())
        assert int(state["step"]) == int(ref_state["step"]) == i + 1
        assert state["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            assert _within_ulps(metrics[k], ref_metrics[k]).all(), k


def test_adamw_init_mirrors_the_parameters():
    params = {"w": torch.zeros(3, 2, dtype=torch.bfloat16), "l": [torch.zeros(4)]}
    state = adamw_init(AdamWConfig(moment_dtype="bfloat16"), params)
    assert state["m"]["w"].dtype == state["v"]["l"][0].dtype == torch.bfloat16
    assert state["m"]["l"][0].shape == (4,) and state["step"].dtype == torch.int32 and int(state["step"]) == 0
    assert state["step"].device.type == "cpu"


def test_adamw_update_reads_no_value_of_the_device():
    """The schedule and bias corrections come from the host's step counter:
    on the meta device, which holds no values (reading one raises), the
    update still runs, and the lr follows the host's step."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=4, total_steps=10)
    params = {"w": torch.empty(5, 3, device="meta"), "l": [torch.empty(4, device="meta", dtype=torch.bfloat16)]}
    state = adamw_init(cfg, params)
    for i in range(1, 4):
        params, state, metrics = adamw_update(cfg, params, params, state)
        assert params["w"].device.type == "meta" and params["l"][0].dtype == torch.bfloat16
        assert state["step"].device.type == "cpu" and int(state["step"]) == i
        assert torch.equal(metrics["lr"], cosine_lr(cfg, torch.tensor(i, dtype=torch.int32)))


# -- flash backward -------------------------------------------------------------

#: (B, Hkv, G, S, D, chunk_q, chunk_kv, causal, window, skip): GQA and MHA,
#: several q and KV chunks (equal and unequal sizes), causal, windowed,
#: block-skipped, and one bidirectional case
FLASH_GRAD_CASES = [
    (2, 2, 3, 64, 16, 16, 16, True, 0, False),
    (2, 2, 3, 64, 16, 16, 16, True, 0, True),
    (1, 2, 2, 64, 8, 16, 32, True, 24, False),
    (1, 2, 2, 64, 8, 16, 32, True, 24, True),
    (2, 1, 4, 48, 8, 16, 16, True, 0, True),
    (1, 4, 1, 40, 8, 10, 8, True, 0, True),
    (1, 2, 1, 32, 8, 8, 16, False, 0, False),
]


@pytest.mark.parametrize("case", FLASH_GRAD_CASES, ids=lambda c: "b{}h{}g{}s{}d{}cq{}ck{}c{}w{}skip{}".format(*c))
def test_flash_gradients_match_the_reference_and_plain_autograd(case):
    b, hk, g, s, d, cq, ck, causal, window, skip = case
    rng = np.random.default_rng(sum(case[:7]))
    q = rng.normal(size=(b, hk, g, s, d)).astype(np.float32)
    k = rng.normal(size=(b, hk, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hk, s, d)).astype(np.float32)
    g_out = rng.normal(size=(b, hk, g, s, d)).astype(np.float32)
    statics = (causal, window, cq, ck, 0, skip)

    out, vjp = jax.vjp(lambda *a: ref_flash.flash_attention(*a, *statics), q, k, v)
    want = vjp(g_out)

    def port_grads(fn):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        o = fn(*leaves)
        return o, torch.autograd.grad(o, leaves, torch.from_numpy(g_out))

    got_out, got = port_grads(lambda *a: flash.flash_attention(*a, *statics))
    _, plain = port_grads(lambda *a: flash._flash_fwd_impl(*a, *statics)[0])
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    for name, w, gt, pl in zip("qkv", want, got, plain):
        scale = float(np.abs(np.asarray(w)).max())
        assert float(np.abs(gt.numpy() - np.asarray(w)).max()) <= 1e-5 * scale, f"d{name} vs the reference"
        assert float((gt - pl).abs().max()) <= 1e-5 * float(pl.abs().max()), f"d{name} vs plain autograd"


def test_flash_backward_casts_to_the_input_dtypes_and_serves_under_inference_mode():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16).requires_grad_()
               for s in ((1, 1, 2, 32, 8), (1, 1, 32, 8), (1, 1, 32, 8)))
    out = flash.flash_attention(q, k, v, True, 0, 16, 16, 0, True)
    assert out.dtype == torch.bfloat16
    dq, dk, dv = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    with torch.inference_mode():
        served = flash.gqa_flash_attention(q.detach().reshape(1, 2, 32, 8), k.detach(), v.detach(), chunk_q=16,
                                           chunk_kv=16)
    assert torch.equal(served.reshape(out.shape), out.detach())


# -- one train step per smoke arch -------------------------------------------------


def _ref_models(arch):
    ref_cfg, cfg = ref_get_smoke_config(arch), get_smoke_config(arch)
    ref_params = ref_lm.init_lm(jax.random.key(0), ref_cfg)
    return ref_cfg, ref_params, cfg


def _batch(cfg, step, b=2, s=16):
    pipe = RefPipeline(RefDataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=5,
                                     n_frontend_tokens=cfg.n_frontend_tokens if cfg.frontend else 0,
                                     d_model=cfg.d_model))
    return pipe.batch_at(step)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_the_reference(arch):
    """The reference takes one step from init; both packages then take the
    second from that state (its moments non-zero, step 1)."""
    ref_cfg, ref_params, cfg = _ref_models(arch)
    ref_opt = RefAdamWConfig(lr=1e-3, warmup_steps=5, total_steps=20)
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=20)
    ref_fn = jax.jit(ref_step.make_train_step(ref_cfg, ref_opt))
    ref_state, _ = ref_fn(ref_step.TrainState(ref_params, ref_adamw_init(ref_opt, ref_params)), _batch(cfg, 0))
    host = jax.tree.map(np.asarray, ref_state)
    state = TrainState(lm.params_from_numpy(host.params, cfg, device="cpu"),
                       lm.opt_state_from_numpy(host.opt_state, cfg, device="cpu"))
    batch_np = _batch(cfg, 1)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}

    (ref_total, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_step.loss_fn(p, ref_cfg, batch_np), has_aux=True))(ref_state.params)
    (total, metrics), grads = train_step_mod.value_and_grad(state.params, cfg, batch)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-5)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(ref_grads), flatten(grads), strict=True):
        want = np.asarray(want)
        assert got.shape == want.shape
        scale = float(np.abs(want).max())
        assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * scale, jax.tree_util.keystr(path)

    ref_next, ref_m = ref_fn(ref_state, batch_np)
    new_state, m = make_train_step(cfg, opt)(state, batch)
    for k in ("loss", "grad_norm", "total_loss", "aux_loss"):
        np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert int(new_state.opt_state["step"]) == int(ref_next.opt_state["step"]) == 2
    # the change each parameter takes, held to the step's size: a skipped
    # update, a wrong schedule or a wrong decay misses by about lr
    lr = float(ref_m["lr"])
    for old, got, want in zip(flatten(state.params), flatten(new_state.params), jax.tree.leaves(ref_next.params),
                              strict=True):
        assert got.dtype == torch.float32 and got.shape == want.shape
        err = np.abs((got - old).numpy() - (np.asarray(want) - old.numpy())).max()
        assert err <= 2e-2 * lr, (err, lr)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_leaves_every_gradient_bit_equal(arch):
    cfg = get_smoke_config(arch)
    params = lm.init_lm(0, cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 3).items()}
    (t0, _), g0 = train_step_mod.value_and_grad(params, cfg.with_(remat=False), batch)
    (t1, _), g1 = train_step_mod.value_and_grad(params, cfg.with_(remat=True), batch)
    assert torch.equal(t0, t1)
    assert all(torch.equal(a, b) for a, b in zip(flatten(g0), flatten(g1), strict=True))


def test_cross_entropy_ignores_negative_targets_and_matches_the_one_hot_form():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    targets[:, -1] = -1
    want = ref_step.cross_entropy(jnp.asarray(logits), jnp.asarray(targets))
    got = train_step_mod.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- MoE groups under a policy ----------------------------------------------------


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "deepseek_v2_236b"])
def test_moe_groups_follow_the_policy_as_in_the_reference(arch):
    """dp_size = 2 gives two groups, each with its own capacity; with
    capacity_factor 1.0 some pairs drop, so G = 2 and G = 1 differ, and the
    port equals the reference at both."""
    ref_cfg = ref_get_smoke_config(arch)
    ref_cfg = ref_cfg.with_(moe=dataclasses.replace(ref_cfg.moe, capacity_factor=1.0))
    cfg = get_smoke_config(arch)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    ref_p = ref_moe.init_moe(jax.random.key(3), ref_cfg)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref_p)
    x = np.random.default_rng(4).normal(size=(4, 32, cfg.d_model)).astype(np.float32)
    outs = {}
    for dp in (1, 2):
        mesh = SimpleNamespace(shape={"data": dp, "model": 1})
        ref_policy.install(mesh)
        assert policy.install(mesh).dp_size == dp and moe._num_groups(128) == ref_moe._num_groups(128) == dp
        want, want_aux = ref_moe.moe_ffn(ref_p, ref_cfg, jnp.asarray(x))
        got, aux = moe.moe_ffn(p, cfg, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-7)
        outs[dp] = got
    assert not torch.allclose(outs[1], outs[2], rtol=1e-4, atol=1e-4)
    assert moe._num_groups(127) == 1  # 2 does not divide 127 tokens


# -- the policy's data-parallel axes ----------------------------------------------

MESHES = {"1x1": {"data": 1, "model": 1}, "2x4": {"data": 2, "model": 4},
          "pod2x2x2": {"pod": 2, "data": 2, "model": 2}}


@pytest.mark.parametrize("mesh", MESHES)
def test_policy_install_reads_the_mesh_as_the_reference_does(mesh):
    """A mapping, its shape tuple and a stand-in with a ``shape`` mapping
    (what the reference's rules read of a ``jax.sharding.Mesh``) give the
    reference's dp axes and dp_size."""
    stand_in = SimpleNamespace(shape=MESHES[mesh])
    want = ref_policy.install(stand_in)
    assert sharding.dp_axes(stand_in) == tuple(ref_sharding.dp_axes(stand_in)) == want.dp
    for given in (MESHES[mesh], tuple(MESHES[mesh].values()), stand_in):
        got = policy.install(given)
        assert (got.dp, got.dp_size) == (want.dp, want.dp_size)
        assert policy.get_policy() is got
    with pytest.raises(ValueError, match="2 .* or 3"):
        policy.install((8,))


# -- the refusal to route under autograd ----------------------------------------------


def test_train_step_under_a_kernel_policy_raises_before_any_routed_gemm(monkeypatch):
    """On the CPU the routed product would run ``gemm_plain``, which
    autograd differentiates: the port refuses anyway, as the reference
    (whose Pallas kernel has no differentiation rule) does, and so trains
    the same way on both devices."""
    calls = []
    real = ops.scheduled_gemm
    monkeypatch.setattr(ops, "scheduled_gemm", lambda *a, **k: calls.append(a) or real(*a, **k))
    cfg = get_smoke_config("yi_34b")
    params = lm.init_lm(0, cfg, device="cpu")
    opt = AdamWConfig()
    state = TrainState(params, adamw_init(opt, params))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 0).items()}
    step = make_train_step(cfg, opt)
    with scheduled_kernels(build_backend(make_gemmini_description())):
        with pytest.raises(RuntimeError, match="no backward"):
            step(state, batch)
        assert not calls
        with torch.no_grad():  # serving under the policy still routes
            lm.forward(params, cfg, batch["inputs"])
        assert calls
    calls.clear()
    _, metrics = step(state, batch)  # no policy: unrouted
    assert not calls and np.isfinite(float(metrics["loss"]))


# -- the trainer (the reference's tests/test_train.py cases, on the port) ---------------


def test_trainer_end_to_end_loss_decreases(tmp_path):
    trainer, state, cfg = launch_train.build_trainer(
        "xlstm_125m", smoke=True, steps=30, global_batch=4, seq_len=32,
        checkpoint_dir=str(tmp_path / "ckpt"), lr=3e-3, device="cpu",
    )
    trainer.cfg.log_every = 2
    trainer.run(state)
    losses = [h["loss"] for h in trainer.history]
    assert len(losses) >= 5
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"


def test_trainer_resumes_from_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    kw = dict(smoke=True, steps=10, global_batch=2, seq_len=16, checkpoint_dir=ckpt, checkpoint_every=5,
              device="cpu")
    trainer, state, _ = launch_train.build_trainer("musicgen_medium", **kw)
    final = trainer.run(state)
    assert latest_step(ckpt) == 10
    trainer2, state2, _ = launch_train.build_trainer("musicgen_medium", **kw)
    out = trainer2.run(state2)  # resumes at 10 and does nothing
    assert trainer2.history == []
    assert all(torch.equal(a, b) for a, b in zip(flatten(out), flatten(final), strict=True))


def test_trainer_survives_induced_fault(tmp_path):
    trainer, state, _ = launch_train.build_trainer(
        "xlstm_125m", smoke=True, steps=8, global_batch=2, seq_len=16,
        checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=2, device="cpu",
    )
    real_step = trainer.train_step
    fails = {"n": 0}

    def flaky_step(state, batch):
        if fails["n"] == 0:
            fails["n"] += 1
            raise RuntimeError("injected device failure")
        return real_step(state, batch)

    trainer.train_step = flaky_step
    trainer.run(state)
    assert fails["n"] == 1
    assert latest_step(trainer.cfg.checkpoint_dir) == 8


def test_trainer_flags_a_straggler(tmp_path, monkeypatch):
    """A step 100x slower than the 6 before it is reported (z-score over
    the recent step times); a fast step after it is not."""
    import repro_torch.train.trainer as trainer_mod

    trainer, state, _ = launch_train.build_trainer(
        "qwen1_5_32b", smoke=True, steps=8, global_batch=2, seq_len=8, checkpoint_dir=str(tmp_path),
        checkpoint_every=100, device="cpu")
    durations = [0.01] * 6 + [1.0, 0.01]
    clock = iter([t for d in durations for t in (0.0, d)])
    monkeypatch.setattr(trainer_mod, "time", SimpleNamespace(perf_counter=lambda: next(clock)))
    seen = []
    trainer.on_straggler = lambda step, dt: seen.append(step)
    trainer.train_step = lambda s, b: (s, {"loss": torch.tensor(1.0), "grad_norm": torch.tensor(1.0)})
    trainer.run(state)
    assert trainer.straggler_events == seen == [6]


def test_launch_train_defaults_to_the_card_and_trains_on_the_cpu(tmp_path, capsys):
    assert launch_train.build_parser().parse_args(["--arch", "xlstm_125m"]).device == "cuda"
    launch_train.main(["--arch", "xlstm_125m", "--smoke", "--steps", "2", "--batch", "2", "--seq", "8",
                       "--ckpt", str(tmp_path), "--device", "cpu"])
    assert "[train] loss" in capsys.readouterr().out and latest_step(str(tmp_path)) == 2
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        launch_train.main(["--arch", "xlstm_125m", "--smoke", "--steps", "1", "--ckpt", str(tmp_path / "c")])
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "xlstm_125m", "--smoke", "--steps", "1",
         "--ckpt", str(tmp_path / "d")],
        capture_output=True, text=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120,
    )
    assert proc.returncode != 0 and "no CUDA device is available" in proc.stderr
