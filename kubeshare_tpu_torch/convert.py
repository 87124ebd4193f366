"""Parameters and training state from the JAX package into the port, 1:1
by tree path.

The JAX trees (nested dicts and lists of arrays) are handed over as numpy
arrays — e.g. ``jax.device_get(params)`` — so this module needs no JAX.
Leaves stay f32, as in JAX; compute casts to ``config.dtype``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import resolve_device
from .parallel.mesh import shard_tensor
from .parallel.train import TrainState, make_train_step, tree_leaves_with_paths


def params_from_jax(tree: Any, device=None) -> Any:
    """The same tree with every array leaf as a torch tensor on
    ``device`` (default: the CUDA device; pass ``"cpu"`` for the CPU)."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {key: convert(value) for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(value) for value in node]
        array = np.asarray(node)
        if array.dtype.kind != "f":
            raise TypeError(f"expected a float array leaf, got {array.dtype}")
        return torch.from_numpy(np.array(array, dtype=array.dtype)).to(device)

    return convert(tree)


def train_state_from_jax(params: Any, mu: Any, nu: Any, count: Any,
                         device=None, mesh=None,
                         param_rules=None) -> TrainState:
    """A port :class:`TrainState` that carries a JAX ``optax.adamw(1e-3)``
    run on.

    ``params`` is ``jax.device_get(state.params)``; ``mu``, ``nu`` and
    ``count`` come from optax's ``ScaleByAdamState``
    (``state.opt_state[0]``), as numpy.  The port's AdamW (its default,
    :func:`~kubeshare_tpu_torch.parallel.train.adamw`) starts with those
    moments and that step count, so the port's next step is the JAX
    run's next step.

    With a ``mesh`` (a JAX sharded ``TrainState``, gathered to numpy by
    ``jax.device_get``): the parameters are placed by ``param_rules`` as
    ``make_train_step(..., mesh=mesh, param_rules=param_rules)`` places
    them, and each shard's moments are the same slices of ``mu`` and
    ``nu``; ``device`` is unused (the mesh names the devices)."""
    if mesh is not None:
        device = "cpu"  # converted on the host, then placed on the mesh
    tree = params_from_jax(params, device)
    init_state, _ = make_train_step(lambda p, t: None, mesh=mesh,
                                    param_rules=param_rules)
    state = init_state(tree)
    moments = {"exp_avg": params_from_jax(mu, device),
               "exp_avg_sq": params_from_jax(nu, device)}
    moment_leaves = {name: dict(tree_leaves_with_paths(m))
                     for name, m in moments.items()}
    step = int(np.asarray(count))
    for path, leaf in tree_leaves_with_paths(state.params):
        moment = {}
        for name, leaves in moment_leaves.items():
            if path not in leaves or leaves[path].shape != leaf.shape:
                raise ValueError(f"{name} has no leaf of shape "
                                 f"{tuple(leaf.shape)} at {path}")
            moment[name] = leaves[path]
        if mesh is None:
            pieces = [(leaf, moment)]
        else:
            placed = {name: shard_tensor(m, leaf.spec, mesh, copy=True)
                      for name, m in moment.items()}
            pieces = [(shard, {name: m.shards[i]
                               for name, m in placed.items()})
                      for i, shard in enumerate(leaf.shards)]
        for shard, entry in pieces:
            state.opt_state.state[shard] = {
                "step": torch.tensor(float(step), dtype=torch.float32),
                **entry}
    state.step = step
    return state
