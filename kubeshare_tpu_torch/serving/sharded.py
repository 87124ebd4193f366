"""Serving over device groups, port of the fleet's side of
kubeshare_tpu/serving/sharded.py: :func:`carve_replica_groups`.

The rest of the JAX module — ``ShardedServingContext``, the
tensor-parallel twins of the paged steps and the Ulysses long-context
route — waits for tensor-parallel serving over ``torch.distributed``
(ROADMAP.md queue A item 9).
"""

from __future__ import annotations

from typing import List

import torch

from ..parallel.mesh import MeshSpec


def carve_replica_groups(mesh_spec: MeshSpec, devices=None) -> List[list]:
    """Resolve a ``dp > 1`` serving :class:`MeshSpec` into per-replica
    tp device groups — the fleet's side of the dp axis.

    A single engine never runs dp (slots are its batch axis); instead
    the fleet (serving/fleet.py) stands up ``dp`` engines and hands
    replica ``i`` the contiguous device slice ``[i*tp, (i+1)*tp)``.
    ``dp=-1`` fills: as many replicas as the device count covers.  Pure
    list slicing, so validation runs on any list (tests pass strings).
    ``devices=None`` takes every visible CUDA device, and raises when
    there is none — a carve never falls back to the CPU."""
    if mesh_spec.ep != 1 or mesh_spec.sp != 1:
        raise ValueError(
            f"carve_replica_groups carves dp x tp only: mesh_spec must "
            f"have ep=sp=1, got {mesh_spec}")
    tp = mesh_spec.tp
    if tp < 1:
        raise ValueError(
            f"carve_replica_groups needs an explicit tp >= 1 (the "
            f"per-replica mesh width cannot be inferred), got tp={tp}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "carve_replica_groups: no CUDA device is available; pass "
                "the devices to carve explicitly")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    avail = list(devices)
    dp = mesh_spec.dp
    if dp == -1:
        dp = len(avail) // tp
        if dp < 1:
            raise ValueError(
                f"mesh_spec {mesh_spec} fills dp from {len(avail)} "
                f"device(s) but tp={tp} does not fit even once")
    elif dp < 1:
        raise ValueError(
            f"dp must be >= 1 or -1 (fill), got dp={dp}")
    need = dp * tp
    if len(avail) < need:
        raise ValueError(
            f"mesh_spec {mesh_spec} needs {need} devices "
            f"({dp} replicas x tp={tp}), only {len(avail)} available")
    return [avail[i * tp: (i + 1) * tp] for i in range(dp)]
