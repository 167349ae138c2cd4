"""Sharding rules: the data-parallel axes of a mesh.

Port of the part of ``repro.parallel.sharding`` that the port runs:
``dp_axes``, which decides the policy's ``dp_size`` and so the MoE
layer's group count.  The reference's spec rules (``param_specs``,
``opt_state_specs``, ``cache_specs``, ``batch_spec``, ``logits_spec``,
with its ``REPRO_REPLICATE_SMALL_RECURRENT`` knob) and ``shard_tree``
hand layouts to GSPMD; the port runs on one card, where every leaf lives
whole, so they wait for a multi-card port (ROADMAP Queue C).
"""

from __future__ import annotations

from repro_torch.parallel.policy import mesh_shape


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel meta-axis: ('pod','data') on multi-pod meshes."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)
