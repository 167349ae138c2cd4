"""Mesh factorization for sharded plans.

Port of ``repro.launch.mesh``: only ``mesh_factorization``, which is pure
Python (``repro_torch.api`` uses it to default ``Target(devices=N)``'s
mesh).  The reference's ``make_production_mesh`` and
``make_elastic_mesh`` build ``jax.make_mesh`` meshes over TPU chips; the
port runs every shard of a mesh on one card, so they have no counterpart
here.
"""

from __future__ import annotations

import warnings


def mesh_factorization(
    n_devices: int, model_parallel: int | None = None
) -> tuple[int, int]:
    """The elastic ``(data, model)`` factorization of ``n_devices``: the
    model axis is the largest power-of-two divisor of ``n_devices`` that is
    <= the requested ``model_parallel`` (default 16), the rest is data.

    Odd/prime device counts have no power-of-two divisor except 1, so the
    model axis silently collapses — a footgun when the caller explicitly
    asked for model parallelism, hence the warning.
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    requested = model_parallel
    # default: halve down from 16 so the model axis lands on the largest
    # power-of-two divisor; an explicit request is clamped to the device
    # count first (it may be a non-power-of-two that divides exactly)
    mp = 16 if requested is None else max(1, min(requested, n_devices))
    while n_devices % mp:
        mp //= 2
    if requested is not None and mp != requested:
        warnings.warn(
            f"mesh_factorization: model_parallel={requested} does not "
            f"divide n_devices={n_devices}; using ({n_devices // mp} data, "
            f"{mp} model) instead",
            UserWarning,
            stacklevel=2,
        )
    return (n_devices // mp, mp)
