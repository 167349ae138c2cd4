"""Activation-sharding policy: the mesh's data-parallel axes.

The reference's launcher installs a policy describing the mesh's dp/tp
axes, and its model code calls ``constrain`` at the few points that
anchor GSPMD's propagation (embed output, scan carries, MoE buffers,
logits).

Port of ``repro.parallel.policy``, as far as one card runs it: the
policy's ``dp_size`` decides the MoE layer's group count
(``repro_torch.models.moe._num_groups``).  With no GSPMD to hand a
layout to, ``constrain`` and the policy's tensor-parallel and boundary
fields wait for a multi-card port (ROADMAP Queue C).  ``install`` takes
the mesh as the port describes one: a ``(data, model)`` or
``(pod, data, model)`` shape, a mapping of axis names to sizes, or an
object with such a ``shape`` mapping (what the reference's rules read of
a ``jax.sharding.Mesh``).
"""

from __future__ import annotations

import threading
from collections.abc import Mapping
from dataclasses import dataclass

_lock = threading.Lock()
_POLICY: "ActivationPolicy | None" = None


@dataclass(frozen=True)
class ActivationPolicy:
    dp: tuple[str, ...]  # data-parallel axes ("pod","data") or ("data",)
    dp_size: int


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size of a mesh given as a shape tuple, a mapping, or
    an object with a ``shape`` mapping."""
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


def install(mesh) -> ActivationPolicy:
    from repro_torch.parallel.sharding import dp_axes

    shape = mesh_shape(mesh)
    dp = dp_axes(shape)
    dp_size = 1
    for a in dp:
        dp_size *= shape[a]
    pol = ActivationPolicy(dp=dp, dp_size=dp_size)
    set_policy(pol)
    return pol


def set_policy(p: ActivationPolicy | None) -> None:
    global _POLICY
    with _lock:
        _POLICY = p


def get_policy() -> ActivationPolicy | None:
    return _POLICY
