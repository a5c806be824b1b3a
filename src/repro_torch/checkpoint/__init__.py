"""Checkpoints (the JAX package's ``repro.checkpoint``): atomic, keep-N,
asynchronous, in the JAX package's on-disk format."""

from repro_torch.checkpoint.manager import (CheckpointManager, tree_flatten,
                                            tree_unflatten)

__all__ = ["CheckpointManager", "tree_flatten", "tree_unflatten"]
