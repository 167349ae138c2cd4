"""The port's checkpoint store (``repro_torch.checkpoint``) on its own and
against the reference's, on the CPU.

Trees are drawn with numpy from a seed.  Restored leaves are held
bit-equal to what was saved (values, dtype and shape): the store copies
bytes and casts nothing that the template does not ask for.  A checkpoint
written by either package restores in the other (f32 trees), and a
bfloat16 tree written by the reference restores in the port; the
reference cannot restore its own bfloat16 leaves, which
``test_reference_cannot_restore_its_own_bfloat16_checkpoint`` shows (a
caveat about the reference, ROADMAP Queue C).
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.train import TrainState as RefTrainState
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.launch.train import build_trainer
from repro_torch.train import TrainState
from repro_torch.tree import flatten


def _np_tree(seed=0, dtype=np.float32):
    """A TrainState-shaped tree of numpy arrays: dicts, a list, a scalar."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.normal(size=shape).astype(np.float32).astype(dtype)

    params = {"embed": {"table": draw(6, 4)}, "prefix": [{"w": draw(4, 4)}, {"w": draw(4, 2)}], "b": draw(3)}
    opt = {"m": {"x": draw(2, 3)}, "step": np.array(7, np.int32)}
    return params, opt


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_equal_trees(got, want):
    got_leaves, want_leaves = flatten(got), flatten(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


def test_roundtrip_and_atomicity(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = TrainState(*_torch_tree(_np_tree()))
    save_checkpoint(d, 5, tree, extra={"data_step": 5})
    save_checkpoint(d, 10, tree, extra={"data_step": 10, "seed": 3})
    assert latest_step(d) == 10
    assert sorted(os.listdir(d)) == ["step_00000005", "step_00000010"]  # no .tmp left behind
    got, step, extra = restore_checkpoint(d, tree)
    assert step == 10 and extra == {"data_step": 10, "seed": 3}
    assert isinstance(got, TrainState)
    _assert_equal_trees(got, tree)
    # restoring casts to the template's dtype
    template = TrainState(jax.tree.map(lambda t: t.double(), tree.params), tree.opt_state)
    got64, _, _ = restore_checkpoint(d, template)
    assert got64.params["b"].dtype == torch.float64
    assert torch.equal(got64.params["b"], tree.params["b"].double())


def test_torn_arrays_fall_back_to_the_previous_step(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _torch_tree(_np_tree())
    save_checkpoint(d, 1, tree)
    save_checkpoint(d, 2, jax.tree.map(lambda t: t + 1, tree))
    with open(os.path.join(d, "step_00000002", "arrays.npz"), "wb") as f:
        f.write(b"garbage")
    got, step, _ = restore_checkpoint(d, tree)
    assert step == 1
    _assert_equal_trees(got, tree)


def test_tampered_leaf_fails_its_hash(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _torch_tree(_np_tree())
    save_checkpoint(d, 1, tree)
    path = save_checkpoint(d, 2, tree)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = dict(data)
    arrays["leaf_0"] = arrays["leaf_0"] + 1  # a valid file whose bytes changed
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    assert restore_checkpoint(d, tree)[1] == 1
    assert restore_checkpoint(d, tree, step=2) == (None, None, None)


def test_leftover_tmp_is_ignored_and_an_empty_directory_restores_nothing(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _torch_tree(_np_tree())
    assert restore_checkpoint(d, tree) == (None, None, None)  # no directory
    os.makedirs(d)
    assert latest_step(d) is None and restore_checkpoint(d, tree) == (None, None, None)
    save_checkpoint(d, 3, tree)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))  # a crash mid-write
    os.makedirs(os.path.join(d, "step_notanumber"))
    assert latest_step(d) == 3
    assert restore_checkpoint(d, tree)[1] == 3
    save_checkpoint(d, 9, tree)  # the next write of that step replaces the leftover
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000009", "step_notanumber"]


def test_a_given_step_and_a_mismatched_template(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _torch_tree(_np_tree())
    for s in (1, 2, 3):
        save_checkpoint(d, s, jax.tree.map(lambda t, s=s: t * s, tree))
    got, step, _ = restore_checkpoint(d, tree, step=2)
    assert step == 2
    _assert_equal_trees(got, jax.tree.map(lambda t: t * 2, tree))
    assert restore_checkpoint(d, tree, step=4) == (None, None, None)
    assert restore_checkpoint(d, {"only": tree[0]["b"]}) == (None, None, None)  # leaf counts differ


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    d = str(tmp_path / "ckpt")
    params, opt = _np_tree(1)
    ref_save(d, 4, RefTrainState(params, opt), extra={"data_step": 4})
    template = TrainState(*_torch_tree(_np_tree(2)))
    got, step, extra = restore_checkpoint(d, template)
    assert step == 4 and extra == {"data_step": 4}
    _assert_equal_trees(got, TrainState(*_torch_tree((params, opt))))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    d = str(tmp_path / "ckpt")
    params, opt = _np_tree(1)
    save_checkpoint(d, 4, TrainState(*_torch_tree((params, opt))), extra={"data_step": 4})
    got, step, extra = ref_restore(d, RefTrainState(*_np_tree(2)))
    assert step == 4 and extra == {"data_step": 4}
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves((params, opt)), strict=True):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_reference_bfloat16_checkpoint_restores_in_the_port(tmp_path):
    d = str(tmp_path / "ckpt")
    params, opt = _np_tree(3, dtype=ml_dtypes.bfloat16)
    ref_save(d, 2, RefTrainState(params, opt))
    template = TrainState(*jax.tree.map(
        lambda a: torch.zeros(a.shape, dtype=torch.int32 if a.dtype == np.int32 else torch.bfloat16),
        (params, opt)))
    got, step, _ = restore_checkpoint(d, template)
    assert step == 2
    for g, w in zip(flatten(got), jax.tree.leaves((params, opt)), strict=True):
        assert g.shape == w.shape
        assert np.array_equal(g.view(torch.int16).numpy(), w.view(np.int16)) if g.dtype == torch.bfloat16 else \
            np.array_equal(g.numpy(), w)


def test_port_bfloat16_checkpoint_is_written_as_the_reference_writes_one(tmp_path):
    """Same leaf bytes and hashes, manifest dtype ``bfloat16``; and the
    port restores its own bf16 leaves bit for bit."""
    params, opt = _np_tree(3, dtype=ml_dtypes.bfloat16)
    ref_path = ref_save(str(tmp_path / "ref"), 2, RefTrainState(params, opt))
    tree = TrainState(*jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)) if a.dtype == np.int32
        else torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16), (params, opt)))
    path = save_checkpoint(str(tmp_path / "port"), 2, tree)
    manifests = [json.load(open(os.path.join(p, "manifest.json"))) for p in (ref_path, path)]
    assert [m["leaves"] for m in manifests[1:]] == [manifests[0]["leaves"]]
    assert {leaf["dtype"] for leaf in manifests[1]["leaves"]} == {"bfloat16", "int32"}
    got, _, _ = restore_checkpoint(str(tmp_path / "port"), tree)
    _assert_equal_trees(got, tree)


def test_reference_cannot_restore_its_own_bfloat16_checkpoint(tmp_path):
    """The caveat the port does not copy: numpy writes ml_dtypes' bfloat16
    as 2-byte void words, which the reference's ``astype`` cannot cast
    back."""
    d = str(tmp_path / "ckpt")
    tree = {"w": jnp.ones((2, 2), jnp.bfloat16)}
    ref_save(d, 1, tree)
    with pytest.raises(ValueError, match="No cast function"):
        ref_restore(d, tree)


def test_a_trained_state_roundtrips_on_its_device(tmp_path):
    trainer, state, _ = build_trainer("jamba_v0_1_52b", smoke=True, steps=2, global_batch=2, seq_len=8,
                                      checkpoint_dir=str(tmp_path), checkpoint_every=1, device="cpu")
    final = trainer.run(state)
    got, step, extra = restore_checkpoint(str(tmp_path), state)
    assert step == 2 and extra["data_step"] == 2 and extra["seed"] == 0
    _assert_equal_trees(got, final)
    assert int(got.opt_state["step"]) == 2
