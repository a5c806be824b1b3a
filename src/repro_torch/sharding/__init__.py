"""Logical-axis partitioning onto a ``torch.distributed`` ``DeviceMesh``
(the JAX package's ``repro.sharding``)."""

from repro_torch.sharding.partitioning import (HeadSplit, NamedSharding,
                                               ShardingRules, activate,
                                               active, batch_shardings,
                                               constrain, gather,
                                               head_split, materialize,
                                               params_shardings, place,
                                               placements,
                                               repetition_range,
                                               repetition_shards,
                                               resolve_spec, state_shardings)

__all__ = ["HeadSplit", "NamedSharding", "ShardingRules", "activate",
           "active", "batch_shardings", "constrain", "gather", "head_split",
           "materialize", "params_shardings", "place", "placements",
           "repetition_range", "repetition_shards", "resolve_spec",
           "state_shardings"]
