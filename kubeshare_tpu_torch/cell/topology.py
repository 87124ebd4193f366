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

A CUDA card has no mesh coordinates.  Its counterpart is the interconnect
``nvidia-smi topo -m`` prints, which :class:`LinkRecord` holds for one
card: its PCI bus id, NUMA node, PCIe upstream path and NVLink domain.
``link_distance`` orders two cards of one node by the tiers of that
matrix, and the scheduler scores two cells of one node by it when both
carry a record (``scheduler/plugin.py``'s ``cell_distance``).

``discover_local_chips`` walks ``torch.cuda`` in place of the JAX
package's PJRT walk.  Each visible CUDA device is one chip, named as the
reference's NVML collector named its GPUs (ref pkg/collector/
gpu.go:26-107): the NVML UUID, the device name with spaces replaced by
``-``, and its memory.  ``coords`` stays None; the link record comes
from NVML (``cell/nvml.py``) and sysfs, matched by UUID.  Out of scope:
NVLink fabrics that span nodes (NVL72, ``nvmlDeviceGetGpuFabricInfo``):
two cells on different nodes are never compared by their records.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .. import constants
from . import nvml
from .allocator import ChipInfo
from .spec import TopologyConfig
from ..utils.logger import get_logger

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


# nvidia-smi topo -m's tiers, nearest first, and the distance of each
LINK_TIERS = {"X": 0, "NV": 1, "PIX": 2, "PXB": 3, "PHB": 4, "NODE": 5,
              "SYS": 6}
NVSWITCH_DOMAIN = "nvswitch"
_ROOT = re.compile(r"^pci[0-9a-f]{4,8}:[0-9a-f]{2}$")


@dataclass(frozen=True)
class LinkRecord:
    """Where one CUDA card sits in its node.

    - ``bus_id``: its PCI bus id in NVML's form (``00000000:19:00.0``);
      where NVML hides the PCI function (a sandboxed host), the CUDA
      runtime's; "" where neither says;
    - ``numa_node``: sysfs's ``numa_node`` of the PCI function (its CPU
      affinity); -1 for none;
    - ``upstream``: the ``realpath`` of ``/sys/bus/pci/devices/<bus id>``
      from its root complex (``pci0000:00``) down to the card's parent
      bridge, in sysfs's form; empty where sysfs has no PCI tree;
    - ``nvlink``: its NVLink domain: ``"nvswitch"`` where an enabled link
      reaches an NVSwitch (the node's switch fabric), else the connected
      component of the node's GPU-to-GPU NVLink graph, named by its
      lowest bus id; "" for a card without an enabled link.

    :meth:`label` is the collector's ``topo`` label,
    ``<bus id>;<numa node>;<upstream joined by />;<nvlink>``, and
    :meth:`from_label` reads it back (None if malformed).
    """

    bus_id: str
    numa_node: int = -1
    upstream: Tuple[str, ...] = ()
    nvlink: str = ""

    def label(self) -> str:
        return ";".join((self.bus_id, str(self.numa_node),
                         "/".join(self.upstream), self.nvlink))

    @classmethod
    def from_label(cls, text: str) -> Optional["LinkRecord"]:
        fields = text.split(";")
        if len(fields) != 4:
            return None
        bus_id, numa, upstream, nvlink = fields
        try:
            if bus_id and bus_id != nvml.nvml_bus_id(bus_id):
                return None
            numa_node = int(numa)
            path = tuple(upstream.split("/")) if upstream else ()
            if path and not _ROOT.match(path[0]):
                return None
            for bridge in path[1:]:
                if bridge != nvml.sysfs_bus_id(bridge):
                    return None
        except ValueError:
            return None
        if numa_node < -1:
            return None
        return cls(bus_id, numa_node, path, nvlink)


def link_tier(a: LinkRecord, b: LinkRecord) -> str:
    """The ``nvidia-smi topo -m`` entry between two cards of one node:

    ====  ========  ==================================================
    tier  distance  the two cards
    ====  ========  ==================================================
    X     0         are one card (the same bus id)
    NV    1         share an NVLink domain (a bridge, or NVSwitches)
    PIX   2         meet below one PCIe switch: at most one bridge
                    below their common bridge on either side
    PXB   3         meet at a common bridge with several below it
    PHB   4         meet at their root complex (the PCIe host bridge)
    NODE  5         sit under two host bridges of one NUMA node
    SYS   6         sit on two NUMA nodes, or nothing says they share one
    ====  ========  ==================================================

    Within a node the distances stay inside the spread of
    ``cell_id_distance`` over its leaves, and far below the 100 that a
    crossed tree level costs there.
    """
    if a.bus_id and a.bus_id == b.bus_id:
        return "X"
    if a.nvlink and a.nvlink == b.nvlink:
        return "NV"
    if a.upstream and b.upstream and a.upstream[0] == b.upstream[0]:
        common = 0
        for x, y in zip(a.upstream[1:], b.upstream[1:]):
            if x != y:
                break
            common += 1
        if common == 0:
            return "PHB"
        below = max(len(a.upstream), len(b.upstream)) - 1 - common
        return "PIX" if below <= 1 else "PXB"
    if a.numa_node >= 0 and a.numa_node == b.numa_node:
        return "NODE"
    return "SYS"


def link_distance(a: LinkRecord, b: LinkRecord) -> float:
    """Locality of two cards of one node: :func:`link_tier`'s distance."""
    return float(LINK_TIERS[link_tier(a, b)])


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


def discover_local_chips(nvml_library: str = nvml.DEFAULT_LIBRARY,
                         sysfs: Optional[str] = None) -> List[ChipInfo]:
    """One ChipInfo per visible CUDA device: ``uuid`` ``"GPU-<uuid>"``
    (the form ``nvidia-smi --query-gpu=uuid`` prints), ``memory`` the
    device's total memory in bytes, ``model`` its normalised name (e.g.
    ``NVIDIA-H100-80GB-HBM3``), ``index`` its ordinal, and ``links`` its
    :class:`LinkRecord` from NVML and sysfs, matched by UUID (an
    index means another card under ``CUDA_VISIBLE_DEVICES``).  ``sysfs``
    defaults to ``$KUBESHARE_SYSFS`` or ``/sys``.  A host without a CUDA
    device has no chips: the list is empty."""
    import torch

    chips: List[ChipInfo] = []
    runtime_bus_ids: Dict[str, str] = {}
    for index in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(index)
        chip = ChipInfo(
            uuid=f"GPU-{props.uuid}",
            memory=int(props.total_memory),
            model=_normalize_kind(props.name),
            index=index,
            coords=None,
        )
        chips.append(chip)
        if getattr(props, "pci_bus_id", None) is not None:
            runtime_bus_ids[chip.uuid] = "%08X:%02X:%02X.0" % (
                props.pci_domain_id, props.pci_bus_id, props.pci_device_id)
    if chips:
        if sysfs is None:
            sysfs = os.environ.get(constants.ENV_SYSFS, "/sys")
        records = _link_records(nvml_library, sysfs, runtime_bus_ids)
        for chip in chips:
            chip.links = records.get(chip.uuid)
    return chips


def _link_records(nvml_library: str, sysfs: str,
                  runtime_bus_ids: Dict[str, str]) -> Dict[str, LinkRecord]:
    """UUID -> :class:`LinkRecord` of every device NVML reports, with its
    PCIe path and NUMA node from the ``sysfs`` tree; empty where NVML
    cannot be loaded or a query fails (those chips carry no record, as a
    TPU chip without coordinates: the record only orders cards, so a
    failing NVML must not cost the node its inventory).
    ``runtime_bus_ids`` (UUID -> bus id) stands in for a bus id NVML does
    not report."""
    try:
        devices = nvml.read_devices(nvml_library)
    except nvml.NvmlUnavailable:
        return {}
    except nvml.NvmlError as e:
        get_logger("kubeshare-collector").warning(
            "NVML failed, chips carry no link record: %s", e)
        return {}
    bus_ids = {d.uuid: d.bus_id or runtime_bus_ids.get(d.uuid, "")
               for d in devices}
    # the GPU-to-GPU NVLink graph over bus ids (peers NVML lists but this
    # process cannot see included), as a union-find; a card without a bus
    # id joins under its UUID, which sorts after every bus id
    parent: Dict[str, str] = {}

    def find(x: str) -> str:
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for d in devices:
        for link in d.links:
            if link.remote_type == nvml.LINK_GPU and link.remote_bus_id:
                a = find(bus_ids[d.uuid] or d.uuid)
                b = find(link.remote_bus_id)
                parent[max(a, b)] = min(a, b)
    records = {}
    for d in devices:
        bus_id = bus_ids[d.uuid]
        if any(l.remote_type == nvml.LINK_SWITCH for l in d.links):
            domain = NVSWITCH_DOMAIN
        elif any(l.remote_type == nvml.LINK_GPU and l.remote_bus_id
                 for l in d.links):
            domain = find(bus_id or d.uuid)
        else:
            domain = ""
        upstream, numa_node = _pci_placement(sysfs, bus_id)
        records[d.uuid] = LinkRecord(bus_id, numa_node, upstream, domain)
    return records


def _pci_placement(sysfs: str, bus_id: str) -> Tuple[Tuple[str, ...], int]:
    """The upstream path and ``numa_node`` of a PCI function in a sysfs
    tree; ``((), -1)`` where the tree does not hold it."""
    if not bus_id:
        return (), -1
    device = os.path.join(sysfs, "bus", "pci", "devices",
                          nvml.sysfs_bus_id(bus_id))
    if not os.path.exists(device):
        return (), -1
    parts = os.path.realpath(device).split(os.sep)
    roots = [i for i, part in enumerate(parts) if _ROOT.match(part)]
    upstream = tuple(parts[roots[0]:-1]) if roots else ()
    try:
        with open(os.path.join(device, "numa_node")) as f:
            numa_node = int(f.read().strip())
    except (OSError, ValueError):
        numa_node = -1
    return upstream, max(numa_node, -1)


def _normalize_kind(kind: str) -> str:
    """A device name as a cell-type leaf name: spaces are illegal in the
    ID path, so they become '-' (ref collector gpu.go:60)."""
    return kind.strip().replace(" ", "-")
