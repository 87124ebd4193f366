"""Parameters from the JAX package into the port, 1:1 by tree path.

The JAX param tree (nested dicts and lists of arrays) is handed over as
numpy arrays — e.g. ``jax.device_get(params)`` — so this module needs no
JAX.  Leaves stay f32, as in JAX; compute casts to ``config.dtype``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import resolve_device


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
