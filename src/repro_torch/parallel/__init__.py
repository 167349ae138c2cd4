"""The activation policy and the mesh's data-parallel axes.  Port of
``repro.parallel``, as far as one card runs it."""

from repro_torch.parallel.policy import ActivationPolicy, get_policy, install, set_policy
from repro_torch.parallel.sharding import dp_axes

__all__ = ["ActivationPolicy", "install", "set_policy", "get_policy", "dp_axes"]
