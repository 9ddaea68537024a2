"""Inverse-rendering training: optimize voxel densities + transfer function
from target images (BASELINE.json config 5).

A new capability relative to the reference (which has no autodiff,
SURVEY.md §2.11 item 1); the checkpoint/resume subsystem (§5.4) lands here
as standard orbax-style checkpointing of the optimized parameters.
"""

from libre.train.trainer import (
    InverseRenderProblem,
    TrainState,
    make_train_step,
)
from libre.train.store_trainer import (
    StoreProblem,
    make_train_step as make_store_train_step,
)
from libre.train.checkpoint import save_checkpoint, restore_checkpoint

__all__ = [
    "InverseRenderProblem",
    "TrainState",
    "make_train_step",
    "StoreProblem",
    "make_store_train_step",
    "save_checkpoint",
    "restore_checkpoint",
]
