"""Topology config schema: cell types + cell instances, with ID inference.

The port's copy of kubeshare_tpu/cell/spec.py.  ``yaml`` is imported only
inside :func:`load_config`: a machine without PyYAML builds its topology
with :meth:`TopologyConfig.from_dict`.

The operator describes the cluster as a typed tree of "cells" in
``kubeshare-config.yaml`` (ref pkg/scheduler/config.go:15-35).  A cell type
says what its children are (``childCellType``/``childCellNumber``), whether
the type sits at node level, and the chip-model priority used for
heterogeneity ranking.  Cell instances may omit IDs and children; both are
inferred (ref config.go:77-120).

ID inference parity note: omitted child IDs are numbered by position within
the whole BFS *level* (1-based), not within the parent — a 3-host cell whose
hosts each hold 2 chips yields chip IDs ``h1/1 h1/2 h2/3 h2/4 h3/5 h3/6``.
The locality distance in the scorer operates on these slash-paths, so we
reproduce the numbering exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class CellTypeSpec:
    child_cell_type: str = ""
    child_cell_number: int = 0
    child_cell_priority: int = 0
    is_node_level: bool = False
    # marks the ICI-domain level: cells of this type are one slice; anything
    # grouping them sits across DCN.  Unmarked topologies treat each root
    # physical cell as a slice (see topology.slice_key).
    is_slice_level: bool = False

    @staticmethod
    def from_dict(d: dict) -> "CellTypeSpec":
        return CellTypeSpec(
            child_cell_type=str(d.get("childCellType", "")),
            child_cell_number=int(d.get("childCellNumber", 0)),
            child_cell_priority=int(d.get("childCellPriority", 0)),
            is_node_level=bool(d.get("isNodeLevel", False)),
            is_slice_level=bool(d.get("isSliceLevel", False)),
        )


@dataclass
class CellSpec:
    cell_type: str = ""
    cell_id: str = ""
    children: List["CellSpec"] = field(default_factory=list)

    @staticmethod
    def from_dict(d: dict) -> "CellSpec":
        return CellSpec(
            cell_type=str(d.get("cellType", "")),
            cell_id=str(d.get("cellId", "")),
            children=[CellSpec.from_dict(c) for c in d.get("cellChildren", []) or []],
        )


@dataclass
class TopologyConfig:
    cell_types: Dict[str, CellTypeSpec] = field(default_factory=dict)
    cells: List[CellSpec] = field(default_factory=list)

    @staticmethod
    def from_dict(d: dict) -> "TopologyConfig":
        return TopologyConfig(
            cell_types={
                k: CellTypeSpec.from_dict(v or {})
                for k, v in (d.get("cellTypes") or {}).items()
            },
            cells=[CellSpec.from_dict(c) for c in d.get("cells") or []],
        )


class ConfigError(ValueError):
    pass


def load_config(path: Optional[str] = None, text: Optional[str] = None) -> TopologyConfig:
    """Read + validate + infer a topology config (ref config.go:37-74)."""
    if text is None:
        if path is None:
            raise ConfigError("either path or text is required")
        with open(path) as f:
            text = f.read()
    import yaml

    raw = yaml.safe_load(text) or {}
    config = TopologyConfig.from_dict(raw)
    check_physical_cells(config)
    return config


def check_physical_cells(config: TopologyConfig) -> None:
    """Validate instances against types and infer omitted IDs/children
    (ref config.go:59-74)."""
    for idx, cell in enumerate(config.cells):
        cts = config.cell_types.get(cell.cell_type)
        if cts is None:
            raise ConfigError(f"cells contains unknown cellType: {cell.cell_type}")
        if not 0 <= cts.child_cell_priority <= 100:
            raise ConfigError(
                f"cell priority must be in 0~100: {cell.cell_type}"
                f" has {cts.child_cell_priority}"
            )
        infer_cell_spec(cell, config.cell_types, idx + 1)


def infer_cell_spec(
    spec: CellSpec, cell_types: Dict[str, CellTypeSpec], default_id: int
) -> None:
    """BFS auto-fill of omitted cell IDs and implied children in place
    (ref config.go:77-120; see module docstring for the numbering quirk)."""
    parent_ids: List[str] = []
    level: List[CellSpec] = [spec]
    first = True

    while level:
        next_parent_ids: List[str] = []
        next_level: List[CellSpec] = []
        for i, current in enumerate(level, start=1):
            if first:
                if current.cell_id == "":
                    current.cell_id = str(default_id)
                first = False
            else:
                previous_id = parent_ids[i - 1]
                if current.cell_id == "":
                    current.cell_id = f"{previous_id}/{i}"
                else:
                    current.cell_id = f"{previous_id}/{current.cell_id}"

            ct = cell_types.get(current.cell_type)
            if ct is None:
                # leaf cell type (a chip model); nothing below it
                continue
            if ct.child_cell_number > 0 and not current.children:
                current.children = [CellSpec() for _ in range(ct.child_cell_number)]
            if current.children and len(current.children) != ct.child_cell_number:
                raise ConfigError(
                    f"cell {current.cell_id} ({current.cell_type}) declares "
                    f"{len(current.children)} children, type requires "
                    f"{ct.child_cell_number}"
                )
            for child in current.children:
                if child.cell_type == "":
                    child.cell_type = ct.child_cell_type
                next_parent_ids.append(current.cell_id)
                next_level.append(child)
        parent_ids = next_parent_ids
        level = next_level
