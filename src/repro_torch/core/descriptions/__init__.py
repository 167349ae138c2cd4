"""In-tree accelerator descriptions.

Importing this package registers every in-tree accelerator with
``repro_torch.core.registry.REGISTRY`` (the registry imports it lazily on
first name lookup).

Port of ``repro.core.descriptions``: ``gemmini`` only; ``edge_npu`` and
``tpu_v5e`` wait for their slice.
"""

from repro_torch.core.descriptions.gemmini import make_gemmini_description
from repro_torch.core.registry import REGISTRY

# exist_ok: re-import is idempotent, and a user who registered this name
# before this import keeps their factory.
REGISTRY.register("gemmini", make_gemmini_description, exist_ok=True)

__all__ = ["make_gemmini_description"]
