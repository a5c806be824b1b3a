"""Training loop, train state and the straggler monitor (the JAX
package's ``repro.train``, single device; checkpoints and restarts come
with their slice)."""

from repro_torch.train.fault_tolerance import StragglerMonitor
from repro_torch.train.train_state import TrainState, new_train_state
from repro_torch.train.trainer import (TrainConfig, Trainer,
                                       make_optimizer_from_config,
                                       make_train_step)

__all__ = ["StragglerMonitor", "TrainConfig", "TrainState", "Trainer",
           "make_optimizer_from_config", "make_train_step", "new_train_state"]
