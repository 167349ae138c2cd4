"""Sharding rules: parameter / optimizer / activation specs, and DTensor
placement of a tree by them.

Parallelism map:
  * ``model`` axis — tensor parallelism: attention heads, d_ff, vocab,
    MoE experts (expert parallelism when E divides the axis, else TP
    inside each expert).
  * ``data`` (+ ``pod``) axes — batch data parallelism; with
    ``fsdp=True`` parameters/optimizer state are *also* sharded over the
    data axes on a non-TP dimension (ZeRO-3 style storage; DTensor
    all-gathers a weight where a product needs it whole).
  * decode caches shard batch over data and heads over model when the KV
    head count divides the axis, otherwise the *sequence* dim shards over
    model (sequence-parallel decode attention).

Every rule checks divisibility against the actual mesh axis sizes and
falls back to replication per-dimension, so any mesh shape that factors
(pod, data, model) works — the elastic-resume path re-derives specs for
whatever device count is available.

Port of ``repro.parallel.sharding``, every rule and the
``REPRO_REPLICATE_SMALL_RECURRENT`` knob as the reference reads it.  A
spec is a tuple with one entry per tensor dim — an axis name, a tuple of
axis names (one dim over several mesh axes, major first) or ``None`` —
the layout of the reference's ``PartitionSpec``, so the two compare
entry for entry.  The rules read only the mesh's axis sizes
(``policy.mesh_shape``): a ``DeviceMesh``, a shape tuple or a
``{name: size}`` mapping.  ``placements`` turns a spec into the DTensor
``Shard``/``Replicate`` placement of each mesh dim, and ``shard_tree``
places a tree with ``distribute_tensor``.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.parallel.policy import mesh_shape

Spec = tuple


def P(*axes) -> Spec:
    """A spec from per-dim entries, normalized as ``PartitionSpec`` does:
    a one-name tuple entry is the name itself."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in axes)


def _axsize(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= _axsize(mesh, n)
        return out
    return mesh_shape(mesh).get(name, 1)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel meta-axis: ('pod','data') on multi-pod meshes."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def _div(dim: int, mesh, ax) -> Any:
    """Return ax if dim is divisible by its size (else None = replicate)."""
    return ax if dim % max(_axsize(mesh, ax), 1) == 0 and dim > 0 else None


def _spec2(mesh, shape, ax0, ax1) -> Spec:
    return P(_div(shape[0], mesh, ax0), _div(shape[1], mesh, ax1))


def _walk(tree, rule, prefix=""):
    if isinstance(tree, dict):
        return {k: _walk(v, rule, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        t = [_walk(v, rule, f"{prefix}{i}/") for i, v in enumerate(tree)]
        return type(tree)(t) if not isinstance(tree, tuple) else tuple(t)
    return rule(prefix.rstrip("/"), tree)


def param_specs(cfg: ModelConfig, params, mesh, *, fsdp: bool = True):
    """Spec tree matching `params` (init_lm layout)."""
    dp = tuple(dp_axes(mesh)) if fsdp else None
    tp = "model"

    def rule(path: str, x) -> Spec:
        shape = tuple(x.shape)
        nd = len(shape)
        stacked = path.startswith("groups/")  # leading group-stack axis
        if stacked:
            shape = shape[1:]
            nd -= 1

        def out(*axes) -> Spec:
            axes = tuple(axes) + (None,) * (nd - len(axes))
            if stacked:
                axes = (None,) + axes
            return P(*axes)

        leaf = path.split("/")[-1]
        parent = path.split("/")[-2] if "/" in path else ""

        if nd == 0:
            return out()
        if nd == 1:
            # biases / norm scales: shard TP-dim biases when they match a
            # TP-sharded output dim; otherwise replicate (cheap).
            return out(_div(shape[0], mesh, tp) if shape[0] >= 1024 else None)

        # --- embeddings / head -------------------------------------------
        if parent == "embed" or (parent == "head" and leaf == "w"):
            if parent == "embed":  # [V, d]
                return out(_div(shape[0], mesh, tp), _div(shape[1], mesh, dp))
            return out(_div(shape[0], mesh, dp), _div(shape[1], mesh, tp))  # [d, V]

        # --- MoE expert banks [E, d, ff] / [E, ff, d] ----------------------
        if nd == 3:
            e = shape[0]
            if e % max(_axsize(mesh, tp), 1) == 0:
                # expert parallelism; FSDP on the middle dim
                return out(tp, _div(shape[1], mesh, dp), None)
            # TP inside experts on the ff dim
            ff_dim = 2 if leaf in ("gate", "up") else 1
            axes: list[Any] = [None, None, None]
            axes[ff_dim] = _div(shape[ff_dim], mesh, tp)
            axes[2 if ff_dim == 1 else 1] = _div(shape[2 if ff_dim == 1 else 1], mesh, dp)
            return out(*axes)

        # --- 2-D weights ----------------------------------------------------
        if leaf == "w":
            if (
                parent in ("w_in", "r")
                and shape[0] <= 1024
                and os.environ.get("REPRO_REPLICATE_SMALL_RECURRENT", "0") == "1"
            ):
                # tiny recurrent gate weights (sLSTM) replicated so the
                # sequential scan has no per-step weight collectives
                return out(None, None)
            if parent in ("q", "k", "v", "gate", "up", "k_up", "v_up", "in_proj", "dt_proj", "w_in", "r"):
                # column-parallel: output dim on TP, input dim on FSDP
                return out(_div(shape[0], mesh, dp), _div(shape[1], mesh, tp))
            if parent in ("o", "down", "out_proj", "out"):
                # row-parallel: input dim on TP (psum after), output on FSDP
                return out(_div(shape[0], mesh, tp), _div(shape[1], mesh, dp))
            if parent in ("kv_down", "x_proj", "router", "i_gate", "f_gate", "o_gate"):
                return out(_div(shape[0], mesh, dp), None)  # small projections
            return out(_div(shape[0], mesh, dp), None)
        # mamba/xlstm odd tensors: conv_w [K, d_in], A_log [d_in, n]
        if leaf == "conv_w":
            return out(None, _div(shape[1], mesh, tp))
        if leaf == "A_log":
            return out(_div(shape[0], mesh, tp), None)
        return out(*(None,) * nd)

    return _walk(params, rule)


def opt_state_specs(cfg: ModelConfig, opt_state, pspecs):
    """Optimizer moments mirror the parameter specs (ZeRO via FSDP dims)."""
    return {
        "m": pspecs,
        "v": pspecs,
        "step": P(),
    }


def batch_spec(mesh) -> Spec:
    return P(tuple(dp_axes(mesh)))


def logits_spec(mesh) -> Spec:
    return P(tuple(dp_axes(mesh)), None, "model")


def cache_specs(cfg: ModelConfig, cache, mesh):
    """Decode-cache specs: batch on data; heads on model if divisible,
    else sequence-parallel (S on model).  ``len`` (an int here, an int32
    scalar in the reference) is replicated."""
    dp = tuple(dp_axes(mesh))
    tp = "model"
    tp_size = _axsize(mesh, tp)

    def rule(path: str, x) -> Spec:
        full = tuple(getattr(x, "shape", ()))
        nd = len(full)
        stacked = path.startswith("groups/")
        shape = full[1:] if stacked else full
        ndl = nd - (1 if stacked else 0)

        def out(*axes) -> Spec:  # truncated to the leaf rank
            axes = tuple(axes)[:ndl] + (None,) * max(ndl - len(axes), 0)
            if stacked:
                axes = (None,) + axes
            return P(*axes)

        leaf = path.split("/")[-1]
        if ndl == 0:
            return P()
        b = shape[0]
        bdp = _div(b, mesh, dp)
        if leaf in ("k", "v", "k_scale", "v_scale"):  # [B, Hkv, S, dh?]
            if shape[1] % tp_size == 0:
                return out(bdp, tp, None, None)
            return out(bdp, None, _div(shape[2], mesh, tp), None)
        if leaf in ("latent", "k_rope"):  # [B, S, r] — sequence-parallel
            return out(bdp, _div(shape[1], mesh, tp), None)
        if leaf == "h":  # mamba state [B, d_in, n]
            return out(bdp, _div(shape[1], mesh, tp), None)
        if leaf == "conv":  # [B, K-1, d_in]
            return out(bdp, None, _div(shape[2], mesh, tp))
        if leaf == "c" and ndl == 4:  # mlstm [B, H, dh, dh]
            return out(bdp, _div(shape[1], mesh, tp), None, None)
        if leaf in ("n", "m", "c") and ndl >= 2:  # small recurrent states
            return out(bdp)
        if leaf == "len":
            return P()
        return out(bdp)

    return _walk(cache, rule)


def placements(spec: Spec, mesh) -> tuple:
    """The DTensor placement of each dim of ``mesh`` (a ``DeviceMesh``)
    for ``spec``: ``Shard(d)`` where tensor dim ``d`` names the mesh dim
    (alone or in a tuple entry, where the mesh dims shard the tensor dim
    in mesh order, major first), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in entry if isinstance(entry, tuple) else (entry,):
            if name is not None:
                if name in where:
                    raise ValueError(f"spec {spec} names mesh axis {name!r} twice")
                where[name] = d
    names = mesh.mesh_dim_names
    unknown = set(where) - set(names)
    if unknown:
        raise ValueError(f"spec {spec} names {sorted(unknown)}, not axes of the mesh {names}")
    return tuple(Shard(where[n]) if n in where else Replicate() for n in names)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``, each leaf with the spec at the
    same place in ``specs`` (a spec tree of ``tree``'s structure, whose
    leaves are the spec tuples)."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        children = [map_specs(fn, t, s) for t, s in zip(tree, specs, strict=True)]
        return type(tree)(*children) if hasattr(tree, "_fields") else type(tree)(children)
    return fn(tree, specs)


def shard_tree(tree, specs, mesh):
    """``distribute_tensor`` each tensor leaf of ``tree`` onto ``mesh`` by
    its spec in ``specs``; other leaves (a cache's ``len``) pass as they
    are."""
    from torch.distributed.tensor import distribute_tensor

    def put(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        return distribute_tensor(x, mesh, placements(spec, mesh))

    return map_specs(put, tree, specs)
