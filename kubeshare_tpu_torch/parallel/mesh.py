"""The logical device-mesh shape, port of kubeshare_tpu/parallel/mesh.py's
:class:`MeshSpec`.

Axis vocabulary, as in the JAX package:
  dp  data parallel (the replica axis of a serving fleet)
  ep  expert parallel
  tp  tensor parallel (head/feature split inside layers)
  sp  sequence parallel

Only the spec and its resolution are ported: the serving fleet carves a
``dp`` x ``tp`` spec into per-replica device groups
(``serving.sharded.carve_replica_groups``).  Building a mesh over
``torch.distributed`` and the sharding helpers (JAX's ``make_mesh``,
``serving_mesh`` and friends) wait for tensor-parallel serving
(ROADMAP.md queue A item 9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True, kw_only=True)
class MeshSpec:
    """Logical mesh shape; -1 on one axis absorbs remaining devices.

    Keyword-only: the ep axis sits between dp and tp, so positional
    construction would silently reinterpret older (dp, tp, sp) calls.
    """

    dp: int = -1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int, int]:
        """Resolve to concrete (dp, ep, tp, sp); every degenerate spec
        fails loudly here:

        - an axis must be -1 (fill) or >= 1;
        - at most ONE axis may be -1;
        - the resolved product must equal ``n_devices`` exactly — an
          over-subscribed spec and an under-subscribed one both raise.
        """
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        axes = (self.dp, self.ep, self.tp, self.sp)
        names = ("dp", "ep", "tp", "sp")
        for name, d in zip(names, axes):
            if d != -1 and d < 1:
                raise ValueError(
                    f"mesh axis {name}={d} is degenerate — every axis "
                    f"must be -1 (absorb remaining devices) or >= 1")
        fills = sum(1 for d in axes if d == -1)
        if fills > 1:
            raise ValueError(
                f"mesh {self} has {fills} fill (-1) axes — the fill is "
                f"ambiguous; at most one axis may be -1")
        known = [d for d in axes if d != -1]
        prod = int(np.prod(known)) if known else 1
        if fills:
            if n_devices % prod != 0:
                raise ValueError(
                    f"mesh {self}: fixed axes need a multiple of {prod} "
                    f"devices, but {n_devices} are available")
            fill = n_devices // prod
        else:
            fill = None
            if prod != n_devices:
                raise ValueError(
                    f"mesh {self} spans {prod} devices != available "
                    f"{n_devices}")
        return tuple((fill if d == -1 else d) for d in axes)
