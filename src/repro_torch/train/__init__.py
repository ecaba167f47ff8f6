"""Training: optimizers, synthetic data, the train step and checkpoints."""

from .checkpoint import CheckpointManager
from .data import DataConfig, Prefetcher, SyntheticStream
from .optimizer import AdamW, Lion, clip_by_global_norm, constant_schedule, cosine_schedule
from .train_loop import (
    TrainState,
    init_train_state,
    load_state_tree,
    make_train_step,
    state_tree,
)

__all__ = ["CheckpointManager", "DataConfig", "Prefetcher", "SyntheticStream",
           "AdamW", "Lion", "clip_by_global_norm", "constant_schedule",
           "cosine_schedule", "TrainState", "init_train_state", "load_state_tree",
           "make_train_step", "state_tree"]
