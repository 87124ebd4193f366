"""Cell allocator: inventory binding, health, reserve/reclaim, fit checks.

The port's copy of kubeshare_tpu/cell/allocator.py (the port imports
nothing of the JAX package): the standalone allocation core the port's
scheduler plugin drives
(ref pkg/scheduler/node.go, pod.go:479-526, filter.go).  All operations are
pure tree-state manipulation; no I/O, no cluster API — which is what makes
the whole scheduler unit-testable (the reference has zero tests; SURVEY §4).

Thread-safety: a single RLock guards mutation, mirroring the reference's
``cellMutex``.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from .cell import Cell, CellState, FreeCellList


def _quantize(value: float) -> float:
    """Keep fractional-chip arithmetic exact: user requests carry at most a
    few decimals, so rounding to micro-chips kills float drift that would
    otherwise strand whole-chip capacity (0.3+0.1 released -> 0.99999...)."""
    return round(value, 6)


def _floor(value: float) -> float:
    return math.floor(value + 1e-9)


@dataclass
class ChipInfo:
    """One accelerator chip as reported by the collector
    (ref pkg/scheduler/gpu.go:17-20; memory = device memory in bytes)."""

    uuid: str
    memory: int
    model: str = ""
    index: int = 0
    coords: Optional[Tuple[int, ...]] = None


class CellAllocator:
    def __init__(self, free_list: FreeCellList, chip_priority: Dict[str, int]):
        self.free_list = free_list
        self.chip_priority = chip_priority
        self.leaf_cells: Dict[str, Cell] = {}  # uuid -> leaf cell
        self.chip_infos: Dict[str, Dict[str, List[ChipInfo]]] = {}  # node -> model -> chips
        self.node_health: Dict[str, bool] = {}
        self.lock = threading.RLock()
        # (node, model) -> healthy leaves; membership only changes on
        # bind/health events, so Filter/Score walks hit this cache
        self._leaf_cache: Dict[Tuple[str, str], List[Cell]] = {}
        # Feasibility cache: Filter re-ran the full tree DFS
        # for every (pod, node) pair, decaying throughput linearly with
        # cluster size.  Fit results are memoized per
        # (node, model, request, memory) and invalidated by generation
        # counters: reserve/reclaim touch one node's availability only
        # (shared ancestors' totals are never read by fit checks), so they
        # bump that node's counter; health/inventory events can cascade
        # through shared ancestors, so they bump the global counter.
        self._fit_cache: Dict[
            Tuple[str, str, float, int], Tuple[Tuple[int, int], Tuple[bool, float, int]]
        ] = {}
        self._fit_gen_global = 0
        self._fit_node_gen: Dict[str, int] = {}

    # ------------------------------------------------------------------
    # inventory + health (ref node.go:109-285)
    # ------------------------------------------------------------------
    def set_node_inventory(self, node: str, chips: Iterable[ChipInfo]) -> None:
        """Record the collector-reported chips for a node (ref gpu.go:39-53).

        If the node already registered healthy (health event raced ahead of
        the first inventory scrape), bind immediately.
        """
        by_model: Dict[str, List[ChipInfo]] = {}
        for chip in chips:
            by_model.setdefault(chip.model, []).append(chip)
        with self.lock:
            self.chip_infos[node] = by_model
            if self.node_health.get(node):
                self.set_node_status(node, True)

    def set_node_status(self, node: str, healthy: bool) -> None:
        """Bind inventory to the node's leaves (idempotent), then propagate
        health (ref node.go:109-124).

        Deliberate fixes over the reference: (a) binding is per-node rather
        than gated on a root-level FREE/FILLED flag — in the reference the
        first node to register marks a shared multi-node root FILLED and
        later nodes never get their chips bound (node.go:115-121 +
        node.go:151 skip); (b) shared-ancestor health is recomputed as
        OR-of-children rather than last-event-wins, so one dead node can't
        hide a live sibling subtree from traversal.
        """
        with self.lock:
            self.node_health[node] = healthy
            self._leaf_cache.clear()
            self._fit_gen_global += 1
            for free_list in self.free_list.values():
                for cell_list in free_list.values():
                    for cell in cell_list:
                        if healthy:
                            self._bind_cell_inventory(cell, node)
                        self._apply_health(cell, node, healthy)

    def _bind_cell_inventory(self, root: Cell, node: str) -> None:
        """Assign chip UUID + HBM to unbound leaf cells of ``node`` in
        declaration order and bubble memory to ancestors
        (ref node.go:127-197)."""
        chips = self.chip_infos.get(node, {}).get(root.leaf_cell_type, [])
        if not chips:
            return
        # pair only unbound leaves with not-yet-bound chips so a partial
        # first scrape followed by a fuller one binds correctly
        leaves = [l for l in root.leaves() if l.node == node and not l.uuid]
        chips = [c for c in chips if c.uuid not in self.leaf_cells]
        for leaf, chip in zip(leaves, chips):
            leaf.uuid = chip.uuid
            leaf.full_memory = chip.memory
            leaf.free_memory += chip.memory
            leaf.coords = chip.coords
            self.leaf_cells[chip.uuid] = leaf
            # capacity + HBM accrue to the leaf and every ancestor only as
            # physical chips bind (declared-but-absent chips never count)
            for cell in [leaf, *leaf.ancestors()]:
                cell.state = CellState.FILLED
                cell.available = _quantize(cell.available + 1.0)
                cell.available_whole_cell = _floor(cell.available)
                if cell is not leaf:
                    cell.free_memory += chip.memory
                    cell.full_memory += chip.memory

    def _apply_health(self, root: Cell, node: str, healthy: bool) -> None:
        """Set health for ``node``-owned cells; shared (multi-node) ancestors
        become healthy iff any child is healthy."""
        touched = False
        for cell in root.walk():
            if cell.node == node:
                # cells with no physical chip bound stay unschedulable
                if cell.level == 1:
                    cell.healthy = healthy and bool(cell.uuid)
                else:
                    cell.healthy = healthy and cell.state == CellState.FILLED
                touched = True
        if touched:
            self._recompute_shared_health(root)

    def _recompute_shared_health(self, cell: Cell) -> None:
        for child in cell.children:
            self._recompute_shared_health(child)
        if cell.node == "" and cell.children:
            cell.healthy = any(c.healthy for c in cell.children)

    # ------------------------------------------------------------------
    # reserve / reclaim (ref pod.go:479-526)
    # ------------------------------------------------------------------
    def reserve(self, cell: Cell, request: float, memory: int) -> None:
        with self.lock:
            for current in [cell, *cell.ancestors()]:
                current.free_memory -= memory
                current.available = _quantize(current.available - request)
                current.available_whole_cell = _floor(current.available)
            self._invalidate_fit(cell.node)

    def reclaim(self, cell: Cell, request: float, memory: int) -> None:
        with self.lock:
            for current in [cell, *cell.ancestors()]:
                current.free_memory += memory
                current.available = _quantize(current.available + request)
                current.available_whole_cell = _floor(current.available)
            self._invalidate_fit(cell.node)

    def _invalidate_fit(self, node: str) -> None:
        if node:
            self._fit_node_gen[node] = self._fit_node_gen.get(node, 0) + 1
        else:
            self._fit_gen_global += 1

    def fit_generation(self, node: str) -> Tuple[int, int]:
        """Version stamp of this node's allocation state: changes whenever
        a reserve/reclaim touches the node or inventory/health changes
        globally.  Callers key caches of node-state-derived values on it
        (the Score fast path does)."""
        with self.lock:
            return (self._fit_gen_global, self._fit_node_gen.get(node, 0))

    # ------------------------------------------------------------------
    # fit checks (ref filter.go)
    # ------------------------------------------------------------------
    def filter_node(
        self, node: str, model: str, request: float, memory: int
    ) -> Tuple[bool, float, int]:
        """Can this node fit (request, memory) on chips of ``model``?
        Returns (fit, available, free_memory) (ref filter.go:5-28).

        ``memory == 0`` means "no explicit cap": the fit check then demands
        request * chip_HBM per leaf — the same default Reserve will charge
        (ref pod.go:419-422) — otherwise a filter-passing pod could drive a
        chip's free HBM negative at reserve time (latent reference bug:
        its Filter checked 0 while Reserve charged the default).
        """
        key = (node, model, request, memory)
        with self.lock:
            gen = (self._fit_gen_global, self._fit_node_gen.get(node, 0))
            hit = self._fit_cache.get(key)
            if hit is not None and hit[0] == gen:
                return hit[1]
        ok = False
        available = 0.0
        free_memory = 0
        for cell_list in self.free_list.get(model, {}).values():
            for cell in cell_list:
                fit, cur_avail, cur_mem = self.check_cell_resource(
                    cell, node, request, memory
                )
                ok = ok or fit
                available += cur_avail
                free_memory += cur_mem
                if ok:
                    break
            if ok:
                break
        result = (ok, available, free_memory)
        with self.lock:
            if len(self._fit_cache) > 16384:  # many distinct request shapes
                self._fit_cache.clear()
            self._fit_cache[key] = (gen, result)
        return result

    def check_cell_resource(
        self, cell: Cell, node: str, request: float, memory: int
    ) -> Tuple[bool, float, int]:
        """DFS fit check over one tree (ref filter.go:32-104).

        Fractional (request <= 1): any healthy leaf of ``node`` with enough
        availability + HBM.  Multi-chip (request > 1, integer): accumulate
        whole-cell availability + HBM at node-level cells.
        """
        if cell.node not in ("", node):
            return False, 0.0, 0
        if not cell.healthy:
            return False, 0.0, 0

        multi_chip = request > 1.0
        available_whole = 0.0
        free_memory = 0
        stack = [cell]
        if multi_chip:
            while stack:
                current = stack.pop()
                if current.node == node and current.is_node and current.healthy:
                    available_whole += current.available_whole_cell
                    free_memory += current.free_memory
                    if available_whole >= request and free_memory >= memory:
                        return True, available_whole, free_memory
                if current.higher_than_node and current.healthy:
                    for child in current.children:
                        if child.node in ("", node) and child.healthy:
                            stack.append(child)
            return False, available_whole, free_memory

        while stack:
            current = stack.pop()
            if current.node == node and current.healthy and current.level == 1:
                required = memory if memory > 0 else int(
                    math.floor(request * current.full_memory)
                )
                if current.available >= request and current.free_memory >= required:
                    return True, current.available, current.free_memory
            for child in current.children:
                if child.node in ("", node) and child.healthy:
                    stack.append(child)
        return False, 0, 0

    # ------------------------------------------------------------------
    # leaf queries (ref score.go:230-294)
    # ------------------------------------------------------------------
    def leaf_cells_by_node(self, node: str, model: str = "") -> List[Cell]:
        with self.lock:
            cached = self._leaf_cache.get((node, model))
            if cached is not None:
                return list(cached)
            result: List[Cell] = []
            if model:
                free_lists = [self.free_list.get(model, {})]
            else:
                free_lists = list(self.free_list.values())
            for free_list in free_lists:
                for cell_list in free_list.values():
                    for cell in cell_list:
                        result.extend(self._leaves_of_node(cell, node))
            self._leaf_cache[(node, model)] = result
            return list(result)

    def _leaves_of_node(self, cell: Cell, node: str) -> List[Cell]:
        if cell.node not in ("", node) or not cell.healthy:
            return []
        leaves: List[Cell] = []
        stack = [cell]
        while stack:
            current = stack.pop()
            if current.level == 1:
                leaves.append(current)
            if current.node in ("", node):
                for child in reversed(current.children):
                    if child.node in ("", node) and child.healthy:
                        stack.append(child)
        return leaves

    def nodes_with_model(self, model: str) -> bool:
        return bool(self.free_list.get(model))
