from .spec import CellTypeSpec, CellSpec, TopologyConfig, load_config, infer_cell_spec
from .element import CellElement, build_cell_chains
from .cell import Cell, CellState, build_cell_forest
from .allocator import CellAllocator, ChipInfo
from .topology import discover_local_chips

__all__ = [
    "CellTypeSpec",
    "CellSpec",
    "TopologyConfig",
    "load_config",
    "infer_cell_spec",
    "CellElement",
    "build_cell_chains",
    "Cell",
    "CellState",
    "build_cell_forest",
    "CellAllocator",
    "ChipInfo",
    "discover_local_chips",
]
