"""Topology: cell-config generation, locality, local device discovery.

The port's copy of kubeshare_tpu/cell/topology.py (the port imports
nothing of the JAX package).  The pure functions are the JAX module's:

- ``generate_tpu_topology`` emits a cell config from node descriptions;
- ``cell_id_distance`` is the reference's locality metric, a string-path
  diff over cell IDs (ref pkg/scheduler/score.go:164-227), and
  ``ici_distance`` the hop distance over mesh coordinates, which the
  scorer prefers when both cells carry coordinates;
- ``slice_key`` names a cell's interconnect domain, and ``chip_box`` a
  selection's bounding box.

A CUDA cell carries no coordinates, so the port's scheduler scores CUDA
cells by ``cell_id_distance``.

``discover_local_chips`` walks ``torch.cuda`` in place of the JAX
package's PJRT walk.  Each visible CUDA device is one chip, named as the
reference's NVML collector named its GPUs (ref pkg/collector/
gpu.go:26-107): the NVML UUID, the device name with spaces replaced by
``-``, and its memory.  An H100 (or a node of NVSwitch-linked cards) has
no mesh coordinates, so ``coords`` is None; NVLink locality is not
modelled yet.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .allocator import ChipInfo
from .spec import TopologyConfig

# heterogeneity ranking by default: newer generations score higher
DEFAULT_MODEL_PRIORITY = {
    "TPU-v6e": 100,
    "TPU-v5p": 90,
    "TPU-v5e": 80,
    "TPU-v4": 60,
    "TPU-v3": 30,
    "TPU-v2": 10,
}


def ici_distance(
    a: Sequence[int], b: Sequence[int], torus_dims: Optional[Sequence[int]] = None
) -> float:
    """ICI hop count between two mesh coordinates.

    Manhattan distance per dimension; with ``torus_dims`` (the physical mesh
    shape) wrap-around links are taken into account (v4/v5p 3D torus).
    """
    n = max(len(a), len(b))
    ax = list(a) + [0] * (n - len(a))
    bx = list(b) + [0] * (n - len(b))
    total = 0.0
    for i in range(n):
        d = abs(ax[i] - bx[i])
        if torus_dims is not None and i < len(torus_dims) and torus_dims[i] > 0:
            d = min(d, torus_dims[i] - d)
        total += d
    return total


def slice_key(cell, slice_types: frozenset = frozenset()) -> str:
    """ICI-domain identity of a cell: the id of its nearest ancestor (or
    self) whose type is marked ``isSliceLevel``, else the root physical
    cell's id.  Two cells with different slice keys reach each other over
    DCN, not ICI — the scorer charges a flat DCN tier between them and the
    scheduler injects megascale bootstrap env for gangs that span keys
    (SURVEY §5: megascale/DCN flags are part of the visibility-env
    mandate; the reference's string-path heuristic, score.go:164-227, had
    no such tier).
    """
    top = cell
    node = cell
    while node is not None:
        if node.cell_type in slice_types:
            return node.id
        top = node
        node = node.parent
    return top.id


def cell_id_distance(current: Sequence[str], other_id: str) -> float:
    """Reference-compatible locality distance over slash-path cell IDs
    (ref score.go:164-227): align segments from the end; numeric segments
    contribute absolute difference, mismatched non-numeric segments 100,
    and leftover segments of the longer path their numeric value (or 100).
    """
    other = other_id.split("/")
    distance = 0.0
    i, j = len(other) - 1, len(current) - 1
    while i >= 0 and j >= 0:
        seg_c, seg_o = current[j], other[i]
        try:
            distance += abs(int(seg_c) - int(seg_o))
        except ValueError:
            if seg_c != seg_o:
                distance += 100
        i -= 1
        j -= 1
    for rest, idx in ((current, j), (other, i)):
        while idx >= 0:
            try:
                distance += int(rest[idx])
            except ValueError:
                distance += 100
            idx -= 1
    return distance


def generate_tpu_topology(
    nodes: Iterable[Tuple[str, str, int]],
    model_priority: Optional[Dict[str, int]] = None,
    cluster_cells: bool = True,
) -> dict:
    """Emit a kubeshare-config dict from ``(hostname, model, chip_count)``
    node descriptions.

    Hosts with the same (model, count) share a node cell type
    ``<N>-<MODEL>-NODE``; when ``cluster_cells`` and several hosts share a
    type, they are grouped under one multi-node cell so gang workloads can
    score ICI/DCN contiguity across hosts.
    """
    priority = dict(DEFAULT_MODEL_PRIORITY)
    if model_priority:
        priority.update(model_priority)

    cell_types: Dict[str, dict] = {}
    groups: Dict[Tuple[str, int], List[str]] = {}
    for hostname, model, count in nodes:
        groups.setdefault((model, count), []).append(hostname)

    cells: List[dict] = []
    for (model, count), hostnames in sorted(groups.items()):
        node_type = f"{count}-{model}-NODE"
        cell_types[node_type] = {
            "childCellType": model,
            "childCellNumber": count,
            "childCellPriority": priority.get(model, 50),
            "isNodeLevel": True,
        }
        if cluster_cells and len(hostnames) > 1:
            cluster_type = f"{len(hostnames)}x{count}-{model}-CLUSTER"
            cell_types[cluster_type] = {
                "childCellType": node_type,
                "childCellNumber": len(hostnames),
            }
            cells.append(
                {
                    "cellType": cluster_type,
                    "cellChildren": [{"cellId": h} for h in hostnames],
                }
            )
        else:
            for hostname in hostnames:
                cells.append({"cellType": node_type, "cellId": hostname})

    return {"cellTypes": cell_types, "cells": cells}


def chip_box(coords: Sequence[Optional[Sequence[int]]], n_chips: int) -> str:
    """Bounding-box shape of a chip selection as libtpu bounds syntax.

    The scheduler injects ``TPU_CHIPS_PER_PROCESS_BOUNDS`` so a pod granted a
    subset of a host's chips initializes its runtime over exactly that
    sub-mesh (the visibility contract the reference filled with
    NVIDIA_VISIBLE_DEVICES, ref pkg/scheduler/pod.go:388-396; SURVEY §7.2
    names the TPU equivalents).  When every selected cell carries ICI mesh
    coords and the selection tiles its bounding box exactly, the box dims
    are emitted (``"2,1,1"``); a gappy or coordinate-less selection falls
    back to a linear ``"<n>,1,1"`` bound, which libtpu accepts for any
    chip list.
    """
    known = [tuple(c) for c in coords if c]
    if len(known) != n_chips or n_chips == 0:
        return f"{max(n_chips, 1)},1,1"
    ndim = max(len(c) for c in known)
    if ndim > 3:
        # the bounds syntax is 3-D; truncating a >3-D box that tiles in
        # full ndim could emit a bound whose volume != n_chips
        return f"{n_chips},1,1"
    padded = [tuple(c) + (0,) * (ndim - len(c)) for c in known]
    lows = [min(c[i] for c in padded) for i in range(ndim)]
    highs = [max(c[i] for c in padded) for i in range(ndim)]
    dims = [highs[i] - lows[i] + 1 for i in range(ndim)]
    box_volume = 1
    for d in dims:
        box_volume *= d
    if box_volume != n_chips or len(set(padded)) != n_chips:
        return f"{n_chips},1,1"  # gaps or duplicates: not a clean sub-mesh
    dims += [1] * (3 - ndim)
    return ",".join(str(d) for d in dims[:3])


def generate_tpu_topology_config(
    nodes: Iterable[Tuple[str, str, int]], **kwargs
) -> TopologyConfig:
    from .spec import check_physical_cells

    config = TopologyConfig.from_dict(generate_tpu_topology(nodes, **kwargs))
    check_physical_cells(config)
    return config


def discover_local_chips() -> List[ChipInfo]:
    """One ChipInfo per visible CUDA device: ``uuid`` ``"GPU-<uuid>"``
    (the form ``nvidia-smi --query-gpu=uuid`` prints), ``memory`` the
    device's total memory in bytes, ``model`` its normalised name (e.g.
    ``NVIDIA-H100-80GB-HBM3``), ``index`` its ordinal.  A host without a
    CUDA device has no chips: the list is empty."""
    import torch

    chips: List[ChipInfo] = []
    for index in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(index)
        chips.append(ChipInfo(
            uuid=f"GPU-{props.uuid}",
            memory=int(props.total_memory),
            model=_normalize_kind(props.name),
            index=index,
            coords=None,
        ))
    return chips


def _normalize_kind(kind: str) -> str:
    """A device name as a cell-type leaf name: spaces are illegal in the
    ID path, so they become '-' (ref collector gpu.go:60)."""
    return kind.strip().replace(" ", "-")
