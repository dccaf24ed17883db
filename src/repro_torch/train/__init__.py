from repro_torch.train.graphed import compile_train_step
from repro_torch.train.loop import (LoopConfig, LoopResult, PreemptionGuard,
                                    train_loop)
from repro_torch.train.train_state import (TrainState, init_train_state,
                                           make_train_step)

__all__ = ["LoopConfig", "LoopResult", "PreemptionGuard", "TrainState",
           "compile_train_step", "init_train_state", "make_train_step",
           "train_loop"]
