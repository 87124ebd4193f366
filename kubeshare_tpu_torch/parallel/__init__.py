from .train import (
    TrainState,
    adamw,
    cross_entropy_loss,
    make_train_step,
    tree_leaves,
    tree_leaves_with_paths,
)

__all__ = [
    "TrainState",
    "adamw",
    "cross_entropy_loss",
    "make_train_step",
    "tree_leaves",
    "tree_leaves_with_paths",
]
