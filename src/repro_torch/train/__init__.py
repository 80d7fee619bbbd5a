"""Training: AdamW, the train step factories, checkpoints and fault
tolerance.  The port of ``repro.train``."""

from .checkpoint import CheckpointManager
from .fault_tolerance import ResilientTrainer, StragglerWatchdog
from .optimizer import (OptimizerConfig, OptState, PartialUpdateError,
                        adamw_update, clip_by_global_norm, global_norm,
                        init_opt_state, lr_at)
from .train_step import (TrainState, init_train_state, make_loss_fn,
                         make_sparse_value_train_step, make_train_step)

__all__ = ["CheckpointManager", "ResilientTrainer", "StragglerWatchdog",
           "OptimizerConfig", "OptState", "PartialUpdateError",
           "adamw_update",
           "clip_by_global_norm", "global_norm", "init_opt_state", "lr_at",
           "TrainState", "init_train_state", "make_loss_fn",
           "make_train_step", "make_sparse_value_train_step"]
