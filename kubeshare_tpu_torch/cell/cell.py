"""Runtime cell tree: the allocation state the scheduler operates on.

The port's copy of kubeshare_tpu/cell/cell.py.  A ``Cell`` mirrors the reference's runtime node (ref pkg/scheduler/
cell.go:131-183): fractional availability, whole-cell availability, free/full
device memory, health, a chip UUID at the leaves, and parent/child links.
Leaves may carry mesh ``coords`` so locality scoring can use true hop
distance instead of the ID-path heuristic; a CUDA cell carries none.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .element import CellElement
from .spec import CellSpec


class CellState(str, enum.Enum):
    FREE = "FREE"
    FILLED = "FILLED"


@dataclass
class Cell:
    cell_type: str
    id: str
    level: int
    higher_than_node: bool  # above node level (multi-node cell)
    is_node: bool
    priority: int
    leaf_cell_type: str
    leaf_cell_number: float

    uuid: str = ""
    node: str = ""
    available: float = 0.0
    available_whole_cell: float = 0.0
    free_memory: int = 0
    full_memory: int = 0
    healthy: bool = False
    state: CellState = CellState.FREE
    coords: Optional[Tuple[int, ...]] = None  # mesh coordinates (None on CUDA)

    parent: Optional["Cell"] = field(default=None, repr=False)
    children: List["Cell"] = field(default_factory=list, repr=False)

    def __post_init__(self) -> None:
        # availability accrues as physical chips bind (see
        # CellAllocator._bind_cell_inventory) rather than starting at the
        # declared leaf_cell_number — declared-but-absent chips must never
        # count as schedulable capacity.
        self.available = 0.0
        self.available_whole_cell = 0.0

    # -- tree iteration helpers -------------------------------------------
    def walk(self):
        """Pre-order depth-first over the subtree, children in declaration order."""
        stack = [self]
        while stack:
            current = stack.pop()
            yield current
            stack.extend(reversed(current.children))

    def leaves(self):
        for c in self.walk():
            if c.level == 1:
                yield c

    def ancestors(self):
        current = self.parent
        while current is not None:
            yield current
            current = current.parent

    def __hash__(self) -> int:  # identity-hashable despite dataclass eq
        return id(self)

    def __eq__(self, other: object) -> bool:
        return self is other


# free-cell forest: leaf cell type -> level -> roots of that level
FreeCellList = Dict[str, Dict[int, List[Cell]]]


def build_cell_forest(
    elements: Dict[str, CellElement], cells: List[CellSpec]
) -> FreeCellList:
    """Instantiate the configured cell instances into runtime trees, keyed by
    leaf chip model x root level (ref cell.go:205-286)."""
    free_list: FreeCellList = {}
    for spec in cells:
        element = elements.get(spec.cell_type)
        if element is None:
            raise ValueError(
                f"cellType {spec.cell_type} in cells is not found in cellTypes"
            )
        if not (element.is_node or element.is_multi_nodes):
            raise ValueError(
                f"top cell must be node-level or above: {spec.cell_type}"
            )
        root = _build_cell(spec, spec.cell_type, "", elements)
        free_list.setdefault(root.leaf_cell_type, {}).setdefault(
            root.level, []
        ).append(root)
    return free_list


def _build_cell(
    spec: CellSpec,
    cell_type: str,
    current_node: str,
    elements: Dict[str, CellElement],
) -> Cell:
    element = elements[cell_type]
    if element.is_node:
        # node-level cells record their node name as the ID's last segment
        current_node = spec.cell_id.rsplit("/", 1)[-1]

    cell = Cell(
        cell_type=cell_type,
        id=spec.cell_id,
        level=element.level,
        higher_than_node=element.is_multi_nodes,
        is_node=element.is_node,
        priority=element.priority,
        leaf_cell_type=element.leaf_cell_type,
        leaf_cell_number=element.leaf_cell_number,
    )
    if not element.is_multi_nodes:
        cell.node = current_node

    if element.level == 1:
        return cell

    for child_spec in spec.children:
        child = _build_cell(child_spec, element.child_cell_type, current_node, elements)
        child.parent = cell
        if not element.is_multi_nodes:
            child.node = current_node
        cell.children.append(child)
    return cell
