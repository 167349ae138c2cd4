"""Mesh construction: the production meshes, the elastic mesh, and the
mesh factorization.

Port of ``repro.launch.mesh``.  The meshes are ``torch.distributed``
``DeviceMesh``es over the ranks of the initialized process group, with
the reference's shapes and axis names, so the sharding rules, the local
shard shapes and the bytes per rank equal the reference's:
``make_production_mesh`` is ``(16, 16)`` ``("data", "model")`` or, with
``multi_pod``, ``(2, 16, 16)`` ``("pod", "data", "model")``, over a
256- or 512-rank group (``launch.dryrun`` starts a fake one of that
size); ``make_elastic_mesh`` factors whatever group is running with
``mesh_factorization`` and, when none is, starts a 1-rank group in this
process (NCCL on ``cuda``, gloo on ``cpu``).  ``mesh_factorization`` is
pure Python (``repro_torch.api`` uses it to default
``Target(devices=N)``'s mesh).  Meshes are on the card unless the caller
asks for the CPU; a ``cuda`` mesh without a card raises.
"""

from __future__ import annotations

import warnings

import torch


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


def _mesh(device_type: str, shape: tuple[int, ...], names: tuple[str, ...]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a cuda mesh needs a CUDA device, but torch.cuda.is_available() is False; "
            "pass device_type='cpu' for a CPU mesh"
        )
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs an initialized process group of {n} ranks "
            "(torch.distributed.init_process_group)"
        )
    if dist.get_world_size() != n:
        raise ValueError(
            f"a {shape} mesh needs {n} ranks; the process group has {dist.get_world_size()}"
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 = 256 ranks/pod; multi-pod adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def _start_single_process_group(device_type: str = "cuda") -> None:
    """A 1-rank process group in this process over an in-memory store
    (NCCL on ``cuda``, gloo on ``cpu``); nothing when one is running."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a cuda process group needs a CUDA device, but torch.cuda.is_available() is False; "
            "pass device_type='cpu' for a gloo group on the CPU"
        )
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_elastic_mesh(
    n_devices: int | None = None,
    model_parallel: int | None = None,
    device_type: str = "cuda",
):
    """Best mesh for the ranks of the running process group (elastic
    resume): model axis = largest power-of-two divisor <= requested, rest
    data.  With no group running, a 1-rank group is started in this
    process.  The chosen factorization is ``mesh.shape``; use
    ``mesh_factorization`` directly for the pure computation (it warns
    when an explicitly requested ``model_parallel`` cannot be honored)."""
    import torch.distributed as dist

    _start_single_process_group(device_type)
    n = n_devices or dist.get_world_size()
    data, model = mesh_factorization(n, model_parallel)
    return _mesh(device_type, (data, model), ("data", "model"))
