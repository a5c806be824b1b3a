"""Logical-axis partitioning onto a ``torch.distributed`` ``DeviceMesh``
(the JAX package's ``repro.sharding``)."""

from repro_torch.sharding.partitioning import (BlockSplit, MoESplit,
                                               NamedSharding,
                                               RangeSplit, ShardingRules,
                                               activate, active,
                                               batch_shardings, block_split,
                                               constrain, expert_plan, gather,
                                               head_split, kv_heads,
                                               materialize,
                                               params_shardings, place,
                                               placements,
                                               repetition_range,
                                               repetition_shards,
                                               resolve_spec, split_plan,
                                               state_shardings)

__all__ = ["BlockSplit", "MoESplit", "NamedSharding", "RangeSplit",
           "ShardingRules", "activate", "active", "batch_shardings",
           "block_split", "constrain", "expert_plan", "gather", "head_split",
           "kv_heads", "materialize", "params_shardings", "place",
           "placements", "repetition_range", "repetition_shards",
           "resolve_spec", "split_plan", "state_shardings"]
