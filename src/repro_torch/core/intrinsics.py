"""Hardware Intrinsic Generator (paper §3.3).

TVM tensorization requires registering, per intrinsic, a computation
*description* and an *implementation*; the paper generates both from the
functional description instead of requiring manual registration.  Here the
generated ``TensorIntrinsic`` carries:

  * the tile-shape description (what computation region it matches —
    checked against the schedule's PE-level factors, i.e. Eq. 1),
  * the implementation (the registered compute intrinsic function, which
    the emulated route calls once per PE tile),
  * accumulator dtype and epilogue capability flags.

Port of ``repro.core.intrinsics``, plus ``int32_tile_product``: the exact
tile product the in-tree compute intrinsics share.  The intrinsic
contract of the port is torch tensors on the module's device in, a torch
tensor out (the reference's is numpy arrays).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.arch_spec import GEMM_DIMS
from repro_torch.core.schedule import Schedule


def int32_tile_product(a_tile: torch.Tensor, b_tile: torch.Tensor) -> torch.Tensor:
    """``a_tile.astype(int32) @ b_tile.astype(int32)`` as numpy computes it,
    wraparound included, on any device.  Torch has no integer matmul on
    CUDA, so the product is an int64 broadcast-multiply summed over K and
    then truncated to int32: arithmetic mod 2^64 reduced mod 2^32 equals
    numpy's int32 arithmetic mod 2^32 (no float detour)."""
    a = a_tile.to(torch.int32).to(torch.int64)
    b = b_tile.to(torch.int32).to(torch.int64)
    return (a.unsqueeze(-1) * b.unsqueeze(0)).sum(dim=-2).to(torch.int32)


@dataclass(frozen=True)
class TensorIntrinsic:
    name: str
    tag: str
    tile_limits: dict[str, int]
    impl: Callable
    quantized: bool

    def matches(self, schedule: Schedule) -> bool:
        """Description side of tensorize: does the schedule's PE-level tile
        fit this intrinsic's region?"""
        pe = schedule.pe_tile()
        return all(pe[j] <= self.tile_limits.get(j, 10**9) for j in GEMM_DIMS)


class HardwareIntrinsicGenerator:
    """Auto-generates tensor intrinsics from the accelerator description."""

    def __init__(self, desc: AcceleratorDescription):
        self.desc = desc
        self._by_tag: dict[str, TensorIntrinsic] = {}
        for intr in desc.intrinsics.values():
            if intr.kind != "compute":
                continue
            cc = desc.core_computes.get(intr.tag or "")
            self._by_tag[intr.tag] = TensorIntrinsic(
                name=intr.name,
                tag=intr.tag or "",
                tile_limits=dict(intr.tile_limits or {}),
                impl=intr.fn,
                quantized=bool(cc and cc.quantized),
            )

    def for_tag(self, tag: str) -> TensorIntrinsic:
        if tag not in self._by_tag:
            raise KeyError(
                f"{self.desc.name}: no compute intrinsic generated for tag {tag!r}"
            )
        return self._by_tag[tag]

    def all(self) -> list[TensorIntrinsic]:
        return list(self._by_tag.values())

    def tensorize_check(self, tag: str, schedule: Schedule) -> None:
        intr = self.for_tag(tag)
        if not intr.matches(schedule):
            raise ValueError(
                f"schedule PE tile {schedule.pe_tile()} exceeds intrinsic "
                f"{intr.name} limits {intr.tile_limits} — Eq.(1) violated "
                f"upstream"
            )
