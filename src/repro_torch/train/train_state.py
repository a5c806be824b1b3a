"""TrainState: the step count, the params and the optimizer state."""

from __future__ import annotations

from typing import Any, NamedTuple


class TrainState(NamedTuple):
    step: int             # a Python int, as the optimizers' counts are
    params: Any
    opt_state: Any


def new_train_state(params, opt) -> TrainState:
    return TrainState(step=0, params=params, opt_state=opt.init(params))
