from .mesh import (MeshSpec, batch_sharding, device_put, make_mesh, replicated,
                   serving_mesh, shard_params)
from .train import (
    CapturedTrainStep,
    TrainState,
    adamw,
    cross_entropy_loss,
    make_train_step,
    tree_leaves,
    tree_leaves_with_paths,
)

__all__ = [
    "CapturedTrainStep",
    "MeshSpec",
    "TrainState",
    "adamw",
    "batch_sharding",
    "cross_entropy_loss",
    "device_put",
    "make_mesh",
    "make_train_step",
    "replicated",
    "serving_mesh",
    "shard_params",
    "tree_leaves",
    "tree_leaves_with_paths",
]
