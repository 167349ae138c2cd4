"""In-tree accelerator descriptions.

Importing this package registers every in-tree accelerator with
``repro_torch.core.registry.REGISTRY`` (the registry imports it lazily on
first name lookup).

Port of ``repro.core.descriptions``: ``gemmini``, ``edge_npu`` and
``tpu_v5e`` (whose constants are the reference's TPU cost model; see
``tpu_v5e.py``).
"""

from repro_torch.core.descriptions.edge_npu import make_edge_npu_description
from repro_torch.core.descriptions.gemmini import make_gemmini_description
from repro_torch.core.descriptions.tpu_v5e import make_tpu_v5e_description
from repro_torch.core.registry import REGISTRY

# exist_ok: re-import is idempotent, and a user who registered one of these
# names before this import keeps their factory.
REGISTRY.register("gemmini", make_gemmini_description, exist_ok=True)
REGISTRY.register("tpu_v5e", make_tpu_v5e_description, exist_ok=True)

__all__ = [
    "make_edge_npu_description",
    "make_gemmini_description",
    "make_tpu_v5e_description",
]
