"""Activation-sharding policy: explicit layouts at key points.

Without these, a product's sharding strategy can pick a
parameter-centric layout (e.g. the FSDP dim of the embedding table) and
carry a *replicated batch* through the whole model.  The launcher
installs a policy describing the mesh's dp/tp axes; model code calls
``constrain`` at the few points that anchor the layout (embed output,
block boundaries, attention heads, MoE buffers, logits).

Port of ``repro.parallel.policy``: ``ActivationPolicy`` with the
reference's fields, ``install`` and ``constrain``.  ``constrain`` of a
DTensor ``redistribute``s it to the placements the reference's
``with_sharding_constraint`` names; on a plain tensor, or with no policy
installed, it is the identity (the reference's "no mesh context" case),
so the unsharded paths are unchanged.  ``install`` takes the mesh as a
``DeviceMesh``, a ``(data, model)`` or ``(pod, data, model)`` shape, a
mapping of axis names to sizes, or an object with such a ``shape``
mapping (what the reference's rules read of a ``jax.sharding.Mesh``).
"""

from __future__ import annotations

import functools
import threading
from collections.abc import Mapping
from dataclasses import dataclass

import torch

_lock = threading.Lock()
_POLICY: "ActivationPolicy | None" = None


@dataclass(frozen=True)
class ActivationPolicy:
    dp: tuple[str, ...]  # data-parallel axes ("pod","data") or ("data",)
    tp: str  # tensor-parallel axis name
    dp_size: int
    tp_size: int
    # layer-boundary residual-stream sharding: "seq" = Megatron-SP style
    # (S over model between blocks), "none" = batch-only
    boundary: str = "seq"


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size of a mesh given as a ``DeviceMesh``, a shape
    tuple, a mapping, or an object with a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a DeviceMesh
        return dict(zip(names, mesh.shape))
    shape = getattr(mesh, "shape", mesh)
    if isinstance(shape, Mapping):
        return dict(shape)
    shape = tuple(shape)
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if names is None:
        raise ValueError(
            f"a mesh shape has 2 (data, model) or 3 (pod, data, model) axes, not {shape}"
        )
    return dict(zip(names, shape))


def install(mesh, *, boundary: str = "seq") -> ActivationPolicy:
    from repro_torch.parallel.sharding import dp_axes

    if boundary not in ("seq", "none"):
        raise ValueError(f"boundary is 'seq' or 'none', not {boundary!r}")
    shape = mesh_shape(mesh)
    dp = dp_axes(shape)
    dp_size = 1
    for a in dp:
        dp_size *= shape[a]
    pol = ActivationPolicy(
        dp=dp,
        tp="model",
        dp_size=dp_size,
        tp_size=shape.get("model", 1),
        boundary=boundary,
    )
    set_policy(pol)
    return pol


def set_policy(p: ActivationPolicy | None) -> None:
    global _POLICY
    with _lock:
        _POLICY = p


def get_policy() -> ActivationPolicy | None:
    return _POLICY


def spec_for(shape, *dims: str | None) -> tuple:
    """The spec ``constrain`` names for a tensor of ``shape``: dims
    entries "dp" (data axes), "tp" (model axis), "boundary" (model axis
    iff the policy's boundary mode is "seq"), None (replicated); an axis
    that does not divide its dimension, or names a dimension of size 1,
    is dropped.  None without a policy."""
    pol = get_policy()
    if pol is None:
        return None
    spec: list = []
    for dim_size, d in zip(shape, dims):
        if d == "boundary":
            d = "tp" if pol.boundary == "seq" else None
        if dim_size == 1:  # nothing to split (DTensor cannot reshape a sharded singleton)
            d = None
        if d == "dp" and dim_size % pol.dp_size == 0:
            spec.append(pol.dp if len(pol.dp) > 1 else pol.dp[0])
        elif d == "tp" and dim_size % pol.tp_size == 0:
            spec.append(pol.tp)
        else:
            spec.append(None)
    spec.extend([None] * (len(shape) - len(spec)))
    return tuple(spec)


def constrain(x, *dims: str | None):
    """Lay ``x`` out as described symbolically (see ``spec_for``): a
    DTensor is redistributed to those placements on its own mesh, and its
    gradient to them in the backward; a plain
    tensor, or any tensor with no policy installed, is returned as it
    is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = spec_for(x.shape, *dims)
    if spec is None:
        return x
    from repro_torch.parallel.sharding import placements

    # redistributed even where the placements already match: like the
    # reference's constraint, it also lays out the gradient in the backward
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def gather_fsdp(w):
    """A DTensor weight made whole over every mesh axis but the model
    axis (the FSDP all-gather before a product); anything else as it
    is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    want = tuple(
        p if name == "model" else Replicate() for name, p in zip(names, w.placements)
    )
    if tuple(w.placements) == want:
        return w
    return w.redistribute(w.device_mesh, want)


def gather_rows(x):
    """A DTensor activation whose leading (row) dims are sharded over the
    model axis (the sequence-parallel residual stream) gathered there
    before a product with model-sharded weights, as Megatron-SP gathers
    the sequence before its column-parallel GEMMs; its data-axis shards
    and a sharded last dim are kept."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    last = x.ndim - 1
    want = tuple(
        Replicate() if name == "model" and isinstance(p, Shard) and p.dim < last else p
        for name, p in zip(x.device_mesh.mesh_dim_names, x.placements)
    )
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def heads_axis(n_heads: int) -> str | None:
    """"tp" when the policy's model axis divides ``n_heads`` (heads shard
    over it), else None."""
    pol = get_policy()
    return "tp" if pol is not None and n_heads % pol.tp_size == 0 else None


def reduce_partial(x):
    """A DTensor's pending (partial) sums reduced, so that each of its
    mesh dims is sharded or replicated; anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    want = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return x.redistribute(x.device_mesh, want)


def on_mesh(fn):
    """Run ``fn(params, ...)`` under DTensor's ``implicit_replication``
    when ``params`` holds DTensors, so the plain tensors the model makes
    (positions, masks, zero states) join DTensor ops as replicated; as it
    is otherwise."""
    import functools

    @functools.wraps(fn)
    def run(params, *args, **kwargs):
        from torch.distributed.tensor import DTensor

        # implicit_replication does not nest (leaving it turns it off), so
        # an inner entry point runs inside its caller's
        if not isinstance(params["embed"]["table"], DTensor) or getattr(
            DTensor._op_dispatcher, "_allow_implicit_replication", False
        ):
            return fn(params, *args, **kwargs)
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            return fn(params, *args, **kwargs)

    return run


def run_local(fn, *args, out_specs=None, grad_placements=None):
    """``fn(*args)`` on each shard's own local tensors (DTensor's
    ``local_map``) when ``args[0]`` is a DTensor: the inputs keep their
    placements, and the outputs take the placements of ``out_specs`` (a
    spec per output; one spec for ``fn`` of one output), or ``args[0]``'s
    for one output by default.
    ``grad_placements`` (one entry per input, None = the input's own
    placements) lays out the gradients the backward returns.  On plain
    tensors ``fn`` runs as it is.  On both, the gradients it returns are
    contiguous (``local_map`` reckons a local gradient's strides as
    contiguous), so a sharded and an unsharded run reduce them alike."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(args[0], DTensor):
        # the gradients made contiguous here too, so both paths sum alike
        return _with_contiguous_grads(fn, *args)
    from repro_torch.parallel.sharding import placements

    mesh = args[0].device_mesh
    if out_specs is None:
        out = list(args[0].placements)
    elif len(out_specs) == 1:  # one output
        out = list(placements(out_specs[0], mesh))
    else:
        out = tuple(list(placements(sp, mesh)) for sp in out_specs)
    in_placements = tuple(list(a.placements) if isinstance(a, DTensor) else None for a in args)
    grads = None
    if grad_placements is not None:
        grads = tuple(g if g is not None else p for g, p in zip(grad_placements, in_placements))
    mapped = local_map(
        functools.partial(_with_contiguous_grads, fn),
        out_placements=out,
        in_placements=in_placements,
        in_grad_placements=grads,
        device_mesh=mesh,
    )
    return mapped(*args)


def on_mesh_of(t, like):
    """``t`` as a DTensor on ``like``'s mesh: a plain tensor replicated on
    every rank, a DTensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    if isinstance(t, DTensor):
        return t
    return distribute_tensor(t, like.device_mesh, [Replicate()] * like.device_mesh.ndim)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _with_contiguous_grads(fn, *args):
    return fn(*(_ContiguousGrad.apply(a) if isinstance(a, torch.Tensor) and a.requires_grad else a for a in args))


def replicate(x):
    """A DTensor made whole on every rank (an all-gather of its shards,
    an all-reduce of its pending sums); anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def data_partial(x):
    """The placements of the gradient of a weight that ``x`` replicates
    and every data-parallel shard uses on its own rows: pending sums over
    the data axes, the same on the model axis."""
    from torch.distributed.tensor import Partial, Replicate

    return [Replicate() if name == "model" else Partial() for name in x.device_mesh.mesh_dim_names]
