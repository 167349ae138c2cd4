"""The activation policy and the sharding rules.  Port of
``repro.parallel`` on ``torch.distributed`` ``DeviceMesh`` and DTensor."""

from repro_torch.parallel.policy import ActivationPolicy, constrain, get_policy, install, set_policy
from repro_torch.parallel.sharding import (
    batch_spec,
    cache_specs,
    dp_axes,
    logits_spec,
    opt_state_specs,
    param_specs,
    placements,
    shard_tree,
)

__all__ = [
    "param_specs",
    "opt_state_specs",
    "batch_spec",
    "cache_specs",
    "logits_spec",
    "placements",
    "shard_tree",
    "dp_axes",
    "ActivationPolicy",
    "install",
    "set_policy",
    "get_policy",
    "constrain",
]
