"""Cell-type preprocessing: derive per-type structural facts.

The port's copy of kubeshare_tpu/cell/element.py.

``build_cell_chains`` walks the type graph and computes, per type: its level
(leaf=1), leaf cell type/count, node flags, and the chip-model priority table
used for heterogeneity ranking (ref pkg/scheduler/cell.go:34-129).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from .spec import CellTypeSpec, ConfigError

LOWEST_LEVEL = 1


@dataclass
class CellElement:
    cell_type: str
    level: int
    priority: int
    child_cell_number: float
    child_cell_type: str
    leaf_cell_number: float
    leaf_cell_type: str
    is_node: bool
    is_multi_nodes: bool


def build_cell_chains(
    cell_types: Dict[str, CellTypeSpec],
) -> Tuple[Dict[str, CellElement], Dict[str, int], List[str]]:
    """Returns (elements by type, chip-model priority table, models sorted by
    priority desc) — ref cell.go:46-72."""
    elements: Dict[str, CellElement] = {}
    chip_priority: Dict[str, int] = {}
    in_progress: set = set()

    def add(cell_type: str, priority: int) -> None:
        if cell_type in elements:
            return
        if cell_type in in_progress:
            raise ConfigError(f"cellTypes contains a cycle through {cell_type!r}")
        in_progress.add(cell_type)
        cts = cell_types.get(cell_type)
        if cts is None:
            # not declared as a composite type => it's a leaf (a chip model)
            elements[cell_type] = CellElement(
                cell_type=cell_type,
                level=LOWEST_LEVEL,
                priority=priority,
                child_cell_type="",
                child_cell_number=0.0,
                leaf_cell_type=cell_type,
                leaf_cell_number=1.0,
                is_node=False,
                is_multi_nodes=False,
            )
            chip_priority[cell_type] = priority
            return

        add(cts.child_cell_type, cts.child_cell_priority)
        child = elements[cts.child_cell_type]
        elements[cell_type] = CellElement(
            cell_type=cell_type,
            level=child.level + 1,
            priority=child.priority,
            child_cell_type=child.cell_type,
            child_cell_number=float(cts.child_cell_number),
            leaf_cell_type=child.leaf_cell_type,
            leaf_cell_number=child.leaf_cell_number * cts.child_cell_number,
            is_node=cts.is_node_level,
            is_multi_nodes=child.is_node or child.is_multi_nodes,
        )

    for cell_type in cell_types:
        add(cell_type, 1)

    sorted_models = sorted(
        chip_priority, key=lambda m: chip_priority[m], reverse=True
    )
    return elements, chip_priority, sorted_models
