"""Logical-axis partitioning onto a ``torch.distributed`` ``DeviceMesh``
(the JAX package's ``repro.sharding``)."""

from repro_torch.sharding.partitioning import (NamedSharding, ShardingRules,
                                               activate, active,
                                               batch_shardings, constrain,
                                               gather, materialize,
                                               params_shardings, place,
                                               placements, resolve_spec,
                                               state_shardings)

__all__ = ["NamedSharding", "ShardingRules", "activate", "active",
           "batch_shardings", "constrain", "gather", "materialize",
           "params_shardings", "place", "placements", "resolve_spec",
           "state_shardings"]
