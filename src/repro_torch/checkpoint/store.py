"""Fault-tolerant checkpointing: atomic, content-verified, resumable.

Layout::

    <dir>/step_000123/
        arrays.npz          # flattened tree leaves
        manifest.json       # tree description, shapes/dtypes, sha256 per
                            # leaf, data-pipeline state

Writes go to ``step_X.tmp`` then ``os.replace`` — a crash mid-write never
corrupts the latest valid checkpoint.  ``restore_checkpoint`` verifies
hashes and falls back to the previous step if verification fails (torn
write on shared storage).  Leaves are copied to the host before writing
and restored onto the device of the template's leaf.

Port of ``repro.checkpoint.store``, with the reference's layout, so a
checkpoint written by either package restores in the port: leaves in
``jax.tree.flatten``'s order (dict keys sorted, lists and tuples, a
``TrainState`` among them, in order), ``leaf_<i>`` in the ``.npz``, the
sha256 of each leaf's raw bytes.  A bfloat16 leaf is written as the
reference writes one (2-byte void words, manifest dtype ``"bfloat16"``)
and restored by viewing the words as ``torch.bfloat16``: the reference's
own restore cannot cast them (ROADMAP Queue C).  A DTensor leaf is
gathered whole before it is hashed and written, so a sharded save holds
the bytes of an unsharded one; on a multi-rank group every rank gathers
and rank 0 writes.  A restored leaf takes the template leaf's mesh and
placements.  The manifest's
``treedef`` is the port's own description of the tree; restore reads it
in neither package.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.tree import flatten, unflatten


def _describe(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_describe(t) for t in tree) + "]"
    if isinstance(tree, tuple):
        return f"{type(tree).__name__}(" + ", ".join(_describe(t) for t in tree) + ")"
    return "*"


def _to_host(leaf) -> np.ndarray:
    """A leaf as the numpy array the reference would write for it."""
    if isinstance(leaf, torch.Tensor):
        if isinstance(leaf, DTensor):  # gathered: the bytes of an unsharded save
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # ml_dtypes' bfloat16 is written as 2-byte void words
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _sha256(a: np.ndarray) -> str:
    """The sha256 of ``a.tobytes()``, hashed in place (no copy)."""
    return hashlib.sha256(np.ascontiguousarray(a).reshape(-1).view(np.uint8)).hexdigest()


def _dtype_name(leaf, host: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(host.dtype)


def save_checkpoint(directory: str, step: int, tree, extra: dict | None = None) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    leaves = flatten(tree)
    host_leaves = [_to_host(leaf) for leaf in leaves]
    if dist.is_initialized() and dist.get_rank() != 0:  # every rank gathers; rank 0 writes
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {f"leaf_{i}": a for i, a in enumerate(host_leaves)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)

    manifest = {
        "step": step,
        "n_leaves": len(host_leaves),
        "treedef": _describe(tree),
        "leaves": [
            {
                "shape": list(a.shape),
                "dtype": _dtype_name(leaf, a),
                "sha256": _sha256(a),
            }
            for leaf, a in zip(leaves, host_leaves)
        ],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name.split("_")[1]))
            except (IndexError, ValueError):
                continue
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def _verify(path: str) -> tuple[list[np.ndarray], dict] | None:
    """The leaves and manifest of one step, or None when any leaf is
    missing, unreadable or fails its hash."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            leaves = []
            for i, meta in enumerate(manifest["leaves"]):
                a = data[f"leaf_{i}"]
                if _sha256(a) != meta["sha256"]:
                    return None
                leaves.append(a)
        return leaves, manifest
    except Exception:  # a torn or foreign write is skipped, as a failed hash is
        return None


def _to_tensor(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A leaf read from the ``.npz`` (a fresh, writable array) as a
    tensor sharing its memory."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _like(host: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A restored leaf on the template leaf's device, in its dtype and
    shape, and on its mesh with its placements when it is a DTensor."""
    host = host.to(dtype=t.dtype).reshape(t.shape)
    if isinstance(t, DTensor):
        return distribute_tensor(host.to(t.device), t.device_mesh, t.placements)
    return host.to(device=t.device)


def restore_checkpoint(directory: str, template, step: int | None = None):
    """Restore into the structure of `template` (its leaves' shapes,
    dtypes and devices).

    Returns (tree, step, extra) or (None, None, None) when nothing valid
    exists.  Tries newest-first so a torn newest write degrades gracefully.
    """
    steps = _steps(directory)
    if step is not None:
        steps = [s for s in steps if s == step]
    for s in reversed(steps):
        got = _verify(os.path.join(directory, f"step_{s:08d}"))
        if got is None:
            continue
        leaves, manifest = got
        t_leaves = flatten(template)
        if len(leaves) != len(t_leaves):
            continue
        cast = [
            _like(_to_tensor(a, meta["dtype"]), t)
            for a, meta, t in zip(leaves, manifest["leaves"], t_leaves)
        ]
        return unflatten(template, iter(cast)), s, manifest.get("extra", {})
    return None, None, None
