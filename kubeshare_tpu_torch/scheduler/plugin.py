"""KubeShare scheduler plugin of the port: the full extension-point pipeline.

The port's copy of kubeshare_tpu/scheduler/plugin.py.  It mirrors the
reference plugin's behavior (ref pkg/scheduler/scheduler.go, filter.go,
score.go, pod.go) over the abstract cluster API:

    QueueSort -> PreFilter -> Filter -> Score -> NormalizeScore
      -> Reserve -> Permit (gang barrier) [-> Unreserve on timeout]

Its decisions (filter, score, reserve, permit, reclaim, recovery), its
annotations, ports, gang ranks, slice plans and metric text are the JAX
plugin's.  Only the env injected into a pod differs: the port injects
the device visibility of a CUDA pod and the names the port's own runtime
reads, and none of libtpu's:

- a fractional pod gets ``NVIDIA_VISIBLE_DEVICES=<uuid>``,
  ``NVIDIA_DRIVER_CAPABILITIES``, ``LD_PRELOAD`` of the CUDA driver
  interposer (``csrc/cuda_hook.cc``) and the broker / memory-cap env the
  interposer reads (``isolation/hook.hook_env``);
- a multi-chip pod gets the visibility of all its UUIDs and its name,
  no interposer and no port (ref pod.go:348-400);
- a gang member gets the names ``parallel/distributed.py`` reads
  (``TPUSHARE_GANG_*``, ``TPU_PROCESS_BOUNDS``, ``MEGASCALE_NUM_SLICES``
  / ``MEGASCALE_SLICE_ID``).

Other deltas over the reference:
- locality scoring charges a flat DCN tier between slices, then uses hop
  distance when mesh coords are known (a CUDA cell has none), then, for
  two CUDA cells of one node that both carry a link record, the tiers of
  ``nvidia-smi topo -m`` (NVLink, then PCIe, then NUMA:
  ``cell.topology.link_distance``), falling back to the reference's
  cell-ID path distance
- binding defaults to in-place patch+bind ("patch" mode); the reference's
  delete-and-recreate shadow-pod trick (ref scheduler.go:515-528) is kept as
  ``bind_mode="shadow"`` for parity
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .. import constants
from ..cell.allocator import CellAllocator, ChipInfo
from ..cell.cell import Cell
from ..cell.element import build_cell_chains
from ..cell.cell import build_cell_forest
from ..cell.spec import TopologyConfig
from ..cell.topology import (cell_id_distance, ici_distance, link_distance,
                             slice_key)
from ..cluster.api import Clock, ClusterAPI, Node, Pod, PodPhase
from ..utils.bitmap import RRBitmap
from ..utils.logger import get_logger
from .podgroup import PodGroupInfo, PodGroupRegistry
from .podspec import PodLabelError, PodStatus, parse_pod_labels, parse_priority

MAX_NODE_SCORE = 100
MIN_NODE_SCORE = 0


@dataclass
class SchedulerArgs:
    """Plugin configuration (ref scheduler.go:58-79)."""

    level: int = 2
    permit_waiting_time_base_seconds: float = constants.PERMIT_WAITING_TIME_BASE_SECONDS
    pod_group_gc_interval_seconds: float = constants.POD_GROUP_GC_INTERVAL_SECONDS
    pod_group_expiration_time_seconds: float = constants.POD_GROUP_EXPIRATION_TIME_SECONDS
    bind_mode: str = "patch"  # "patch" | "shadow"
    port_pool_size: int = constants.POD_MANAGER_PORT_POOL


class Status:
    SUCCESS = "Success"
    UNSCHEDULABLE = "Unschedulable"
    WAIT = "Wait"
    ERROR = "Error"

    def __init__(self, code: str, message: str = "") -> None:
        self.code = code
        self.message = message

    @property
    def ok(self) -> bool:
        return self.code == Status.SUCCESS

    def __repr__(self) -> str:
        return f"Status({self.code}, {self.message!r})"


# inventory provider: node name -> chips (collector-backed in production,
# a dict/callable in tests)
InventoryProvider = Callable[[str], List[ChipInfo]]


class KubeShareScheduler:
    def __init__(
        self,
        topology: TopologyConfig,
        cluster: ClusterAPI,
        inventory: InventoryProvider,
        args: Optional[SchedulerArgs] = None,
        clock: Optional[Clock] = None,
        log_dir: Optional[str] = None,
    ) -> None:
        self.args = args or SchedulerArgs()
        self.cluster = cluster
        self.inventory = inventory
        self.clock = clock or Clock()
        self.log = get_logger("kubeshare-scheduler", self.args.level, log_dir)

        elements, chip_priority, sorted_models = build_cell_chains(topology.cell_types)
        forest = build_cell_forest(elements, topology.cells)
        self.allocator = CellAllocator(forest, chip_priority)
        self.chip_priority = chip_priority
        self.sorted_models = sorted_models
        # ICI-domain (slice) boundaries for DCN-tiered locality + megascale
        # env injection: explicitly marked types, else each root cell
        self.slice_types = frozenset(
            name for name, t in topology.cell_types.items()
            if getattr(t, "is_slice_level", False)
        )

        self.pod_status: Dict[str, PodStatus] = {}
        self.pod_status_lock = threading.RLock()
        self.port_bitmaps: Dict[str, RRBitmap] = {}
        self.port_lock = threading.RLock()
        self.pod_groups = PodGroupRegistry(
            self.clock, self.args.pod_group_expiration_time_seconds
        )
        self.bound_pod_queue: Dict[str, List[Pod]] = {}
        self.bound_queue_lock = threading.RLock()
        self._suppressed_deletes: set = set()
        # keys whose shadow copy is being created: its add event is this
        # cycle's own pod, not one bound before a restart (see reserve)
        self._shadow_creates: set = set()
        # (node, model, kind) -> (fit_generation, node-local score)
        self._node_score_cache: Dict[tuple, tuple] = {}

        cluster.add_node_handler(self._on_node_event)
        cluster.add_pod_handler(self._on_pod_event)

    # ------------------------------------------------------------------
    # informer handlers (ref scheduler.go:199-224, node.go, pod.go:47-161)
    # ------------------------------------------------------------------
    def _is_shared_node(self, node: Node) -> bool:
        return node.labels.get(constants.NODE_LABEL_FILTER) == "true"

    def _on_node_event(self, event: str, obj: object) -> None:
        node = obj
        if not isinstance(node, Node) or not self._is_shared_node(node):
            return
        if event in ("add", "update"):
            self.register_node(node.name, healthy=node.is_healthy())
        elif event == "delete":
            self.allocator.set_node_status(node.name, False)
            # drop score-cache entries for the departed node: keyed by
            # (node, model, kind), they would otherwise accumulate forever
            # under node churn
            self._node_score_cache = {
                key: value
                for key, value in self._node_score_cache.items()
                if key[0] != node.name
            }

    def _on_pod_event(self, event: str, obj: object) -> None:
        pod = obj
        if not isinstance(pod, Pod):
            return
        if pod.scheduler_name != constants.SCHEDULER_NAME:
            return
        if event == "add":
            if pod.is_completed():
                self.handle_pod_deleted(pod)
            elif pod.is_bound():
                self._enqueue_bound_pod(pod)
        elif event == "update" and pod.is_completed():
            self.handle_pod_deleted(pod)
        elif event == "delete":
            self.handle_pod_deleted(pod)

    def register_node(self, node_name: str, healthy: bool = True) -> None:
        """Sync inventory + port pool for a node (ref node.go:28-52).  Called
        from node events and lazily from Filter."""
        self._port_bitmap(node_name)
        chips = self.inventory(node_name)
        if chips:
            self.allocator.set_node_inventory(node_name, chips)
        self.allocator.set_node_status(node_name, healthy)

    def _port_bitmap(self, node_name: str) -> RRBitmap:
        """Per-node pod-manager port pool; the creator masks index 0 so the
        first granted port is base+1 (ref node.go:37-39)."""
        bitmap = self.port_bitmaps.get(node_name)  # lock-free hot path
        if bitmap is not None:
            return bitmap
        with self.port_lock:
            bitmap = self.port_bitmaps.get(node_name)
            if bitmap is None:
                bitmap = RRBitmap(self.args.port_pool_size)
                bitmap.mask(0)
                self.port_bitmaps[node_name] = bitmap
            return bitmap

    def _enqueue_bound_pod(self, pod: Pod) -> None:
        # scheduler-restart recovery (ref pod.go:47-78)
        if constants.POD_GPU_MEMORY not in pod.annotations:
            return  # regular pod: nothing to re-reserve
        if pod.key in self._shadow_creates:
            return  # reserve's own shadow copy: its status is in hand
        with self.pod_status_lock:
            existing = self.pod_status.get(pod.key)
            if existing is not None and existing.uid == pod.uid:
                return
        with self.bound_queue_lock:
            self.bound_pod_queue.setdefault(pod.node_name, []).append(pod)
        self.pod_groups.get_or_create(pod, self.clock.now(), self._safe_priority(pod))

    # ------------------------------------------------------------------
    # pod status cache (ref pod.go:207-345)
    # ------------------------------------------------------------------
    def get_pod_status(self, pod: Pod) -> Tuple[str, bool, Optional[PodStatus]]:
        """Returns (error_msg, needs_chip, status); caches parsed status.

        needs_chip False + empty error -> regular pod.
        """
        # lock-free fast path (hot: once per node per Filter/Score); dict
        # reads are atomic under the GIL and a stale miss just falls through
        cached = self.pod_status.get(pod.key)
        if cached is not None and cached.uid == pod.uid:
            return "", True, cached
        with self.pod_status_lock:
            cached = self.pod_status.get(pod.key)
            if cached is not None and cached.uid == pod.uid:
                return "", True, cached
            try:
                status = parse_pod_labels(pod)
            except PodLabelError as e:
                self.log.error(str(e))
                return str(e), False, None
            if status is None:
                return "", False, None
            self.pod_status[pod.key] = status
            return "", True, status

    def delete_pod_status(self, pod: Pod) -> Optional[PodStatus]:
        with self.pod_status_lock:
            status = self.pod_status.get(pod.key)
            if status is not None and status.uid in ("", pod.uid):
                return self.pod_status.pop(pod.key)
            return None

    # ------------------------------------------------------------------
    # QueueSort (ref scheduler.go:247-267)
    # ------------------------------------------------------------------
    def sort_key(self, pod: Pod, initial_attempt_timestamp: float):
        info = self.pod_groups.get_or_create(
            pod, initial_attempt_timestamp, self._safe_priority(pod)
        )
        # higher priority first, earlier group timestamp, then key
        return (-info.priority, info.timestamp, info.key or pod.key)

    @staticmethod
    def _safe_priority(pod: Pod) -> int:
        """Priority for queue ordering; malformed labels sort as 0 — the
        validation error surfaces in PreFilter, never from the sort path."""
        try:
            return parse_priority(pod)
        except PodLabelError:
            return 0

    # ------------------------------------------------------------------
    # PreFilter (ref scheduler.go:275-324)
    # ------------------------------------------------------------------
    def pre_filter(self, pod: Pod) -> Status:
        error_msg, _needs_chip, status = self.get_pod_status(pod)
        if error_msg:
            return Status(Status.UNSCHEDULABLE, error_msg)

        info = self.pod_groups.get_or_create(pod, self.clock.now(), parse_priority(pod))
        if not info.key:
            return Status(Status.SUCCESS, "regular pod")

        assert status is not None
        if status.min_available != info.min_available:
            return Status(
                Status.WAIT,
                f"pod {pod.key} minAvailable {status.min_available} differs "
                f"from group {info.name} ({info.min_available})",
            )
        if status.priority != info.priority:
            return Status(
                Status.UNSCHEDULABLE,
                f"pod {pod.key} priority {status.priority} differs from "
                f"group {info.name} ({info.priority})",
            )
        total = self.count_group_pods(pod.namespace, info.name)
        if total < info.min_available:
            return Status(
                Status.UNSCHEDULABLE,
                f"group {info.key} has {total} pods, fewer than "
                f"minAvailable {info.min_available}",
            )
        return Status(Status.SUCCESS)

    def count_group_pods(self, namespace: str, group_name: str) -> int:
        """ref util.go:48-65 (failed pods excluded)."""
        pods = self.cluster.list_pods(
            namespace=namespace, label_selector={constants.POD_GROUP_NAME: group_name}
        )
        return sum(1 for p in pods if p.phase != PodPhase.FAILED)

    def count_bound_group_pods(
        self, namespace: str, group_name: str, exclude_key: str = ""
    ) -> int:
        """ref util.go:67-79; the in-flight pod is excluded because patch-mode
        Reserve has already stamped its node_name (the reference's snapshot
        excluded it implicitly)."""
        pods = self.cluster.list_pods(
            namespace=namespace, label_selector={constants.POD_GROUP_NAME: group_name}
        )
        return sum(1 for p in pods if p.node_name != "" and p.key != exclude_key)

    # ------------------------------------------------------------------
    # Filter (ref scheduler.go:332-408)
    # ------------------------------------------------------------------
    def filter(self, pod: Pod, node: Node) -> Status:
        node_name = node.name
        if self._is_shared_node(node):
            # lazy (re)registration only when unseen or health changed —
            # the reference re-fetched inventory on every Filter
            # (ref scheduler.go:335), a collector round-trip in the hot path
            if self.allocator.node_health.get(node_name) != node.is_healthy():
                self.register_node(node_name, healthy=node.is_healthy())
        self.process_bound_pod_queue(node_name)

        _, needs_chip, status = self.get_pod_status(pod)
        if not needs_chip:
            return Status(Status.SUCCESS)
        assert status is not None

        bitmap = self._port_bitmap(node_name)
        if not bitmap.has_free():
            return Status(
                Status.UNSCHEDULABLE, f"node {node_name} pod manager port pool is full"
            )

        request, memory = status.request, status.memory
        if status.model:
            if not self.allocator.chip_infos.get(node_name, {}).get(status.model):
                return Status(
                    Status.UNSCHEDULABLE,
                    f"node {node_name} lacks requested chip model {status.model}",
                )
            fit, _, _ = self.allocator.filter_node(node_name, status.model, request, memory)
            if fit:
                return Status(Status.SUCCESS)
            return Status(
                Status.UNSCHEDULABLE,
                f"node {node_name} cannot fit pod {pod.key} on model {status.model}",
            )

        available = 0.0
        free_memory = 0
        for model in self.allocator.chip_infos.get(node_name, {}):
            fit, cur_avail, cur_mem = self.allocator.filter_node(
                node_name, model, request, memory
            )
            available += cur_avail
            free_memory += cur_mem
            # the reference also passes when the *sum over models* covers the
            # request (ref scheduler.go:395-404)
            if fit or (available >= request and free_memory >= memory):
                return Status(Status.SUCCESS)
        return Status(
            Status.UNSCHEDULABLE, f"node {node_name} cannot fit pod {pod.key}"
        )

    # ------------------------------------------------------------------
    # Score (ref score.go)
    # ------------------------------------------------------------------
    def score(self, pod: Pod, node_name: str) -> float:
        _, needs_chip, status = self.get_pod_status(pod)
        if not needs_chip:
            # chips are a rare resource: steer regular pods away from chip
            # nodes (the reference code inverted its own stated intent here,
            # ref score.go:10-21 comment vs body; we implement the intent)
            return 0.0 if self.allocator.chip_infos.get(node_name) else 100.0
        assert status is not None
        if status.is_opportunistic:
            return self._opportunistic_node_score(node_name, status)
        return self._guarantee_node_score(node_name, status)

    def _score_cache_get(self, node_name: str, model: str, kind: str):
        """Node-local score fast path: both score bodies depend only on the
        node's cell state (priority/availability), which the allocator
        versions with fit generations — one (node, model) score survives
        until something reserves/reclaims on that node.  Without this,
        Score recomputes an O(cells) walk for every (pod, node) pair and
        dominates large-cluster cycles (docs/perf.md 64-node dip)."""
        gen = self.allocator.fit_generation(node_name)
        hit = self._node_score_cache.get((node_name, model, kind))
        if hit is not None and hit[0] == gen:
            return gen, hit[1]
        return gen, None

    def _opportunistic_node_score(self, node_name: str, status: PodStatus) -> float:
        """Packing score (ref score.go:42-68): prefer busy, high-priority
        cells; penalize breaking into free chips."""
        gen, cached = self._score_cache_get(node_name, status.model, "opp")
        if cached is not None:
            return cached
        cells = self.allocator.leaf_cells_by_node(node_name, status.model)
        if not cells:
            return 0.0
        score = 0.0
        free_leaves = 0.0
        for cell in cells:
            score += self.chip_priority.get(cell.cell_type, 0)
            if cell.available == 1:
                free_leaves += 1
            else:
                score += (1 - cell.available) * 100
        n = float(len(cells))
        score -= free_leaves / n * 100
        score /= n
        self._node_score_cache[(node_name, status.model, "opp")] = (gen, score)
        return score

    def _guarantee_node_score(self, node_name: str, status: PodStatus) -> float:
        """Performance + locality score (ref score.go:85-112): prefer idle,
        high-priority cells near the pod's gang peers.  The node-local
        part is generation-cached; the peer-locality part depends on the
        pod's gang and is computed fresh (cell coordinates are static, so
        it only costs when the pod actually has placed peers)."""
        cells = None
        gen, node_part = self._score_cache_get(node_name, status.model, "guar")
        if node_part is None:
            cells = self.allocator.leaf_cells_by_node(node_name, status.model)
            if not cells:
                return 0.0
            node_part = sum(
                self.chip_priority.get(cell.cell_type, 0)
                - (1 - cell.available) * 100
                for cell in cells
            ) / float(len(cells))
            self._node_score_cache[(node_name, status.model, "guar")] = (
                gen, node_part)
        peers = self.group_peer_cells(status.pod_group)
        if not peers:
            return node_part
        if cells is None:
            cells = self.allocator.leaf_cells_by_node(node_name, status.model)
            if not cells:
                return 0.0
        n_peers = float(len(peers))
        locality = sum(
            self.cell_distance(cell, peer)
            for cell in cells for peer in peers
        )
        return node_part - locality / n_peers * 100 / float(len(cells))

    def group_peer_cells(self, pod_group: str) -> List[Cell]:
        """Cells already held by pods of the same group (ref score.go:150-162)."""
        if not pod_group:
            return []
        with self.pod_status_lock:
            return [
                cell
                for ps in self.pod_status.values()
                if ps.pod_group == pod_group
                for cell in ps.cells
            ]

    # One DCN crossing costs more than any intra-slice spread: the largest
    # current slice is a few hundred ICI hops across, and the reference's
    # path heuristic charged 100 per crossed tree level (score.go:200-227),
    # so a flat 1000 keeps every cross-slice candidate strictly behind every
    # same-slice one while inter-slice id distance still breaks ties.
    DCN_CROSSING_COST = 1000.0

    def cell_distance(self, a: Cell, b: Cell) -> float:
        """Tiered locality (SURVEY §7.2, §5): ICI hop distance when mesh
        coords are known for both cells, else NVLink / PCIe distance when
        both are CUDA cards of one node with link records, else the
        reference's cell-ID path distance — but cells in different ICI
        domains (slices) first pay a flat DCN tier the reference's string
        heuristic never modeled."""
        if self.slice_of(a) != self.slice_of(b):
            return self.DCN_CROSSING_COST + cell_id_distance(
                a.id.split("/"), b.id
            )
        if a.coords is not None and b.coords is not None:
            return ici_distance(a.coords, b.coords)
        if a.links is not None and b.links is not None and a.node \
                and a.node == b.node:
            return link_distance(a.links, b.links)
        return cell_id_distance(a.id.split("/"), b.id)

    def slice_of(self, cell: Cell) -> str:
        return slice_key(cell, self.slice_types)

    def normalize_scores(self, scores: Dict[str, float]) -> Dict[str, int]:
        """ref scheduler.go:443-487."""
        if not scores:
            return {}
        int_scores = {k: int(v) for k, v in scores.items()}
        max_score = max(int_scores.values())
        min_score = min(int_scores.values())
        if min_score < 0:
            reverse = -min_score
            int_scores = {k: v + reverse for k, v in int_scores.items()}
            max_score += reverse
            min_score = 0
        if 0 <= max_score <= 100 and 0 <= min_score <= 100:
            return int_scores
        ratio = max_score - min_score or 100
        span = MAX_NODE_SCORE - MIN_NODE_SCORE
        return {
            k: span * (v - min_score) // ratio + MIN_NODE_SCORE
            for k, v in int_scores.items()
        }

    # ------------------------------------------------------------------
    # Reserve (ref scheduler.go:489-531, score.go:297-442, pod.go:348-476)
    # ------------------------------------------------------------------
    def reserve(self, pod: Pod, node_name: str) -> Status:
        _, needs_chip, status = self.get_pod_status(pod)
        if not needs_chip:
            return Status(Status.SUCCESS)
        assert status is not None

        cells = self._select_cells(node_name, status)
        if not cells:
            return Status(
                Status.UNSCHEDULABLE, f"pod {pod.key} cannot reserve resource"
            )
        status.cells = cells
        if status.is_multi_chip:
            assumed = self._assume_multi_chip_pod(pod, status, node_name)
        else:
            assumed = self._assume_shared_pod(pod, status, node_name)

        if self.args.bind_mode == "shadow":
            # reference parity: delete the original, create a pre-bound copy
            # (ref scheduler.go:515-528); the copy's NodeName short-circuits
            # any further scheduling.  The self-inflicted delete event must
            # not reclaim what we just reserved.
            self._suppressed_deletes.add(pod.key)
            try:
                self.cluster.delete_pod(pod.namespace, pod.name)
            finally:
                self._suppressed_deletes.discard(pod.key)
            assumed.uid = ""
            # The copy's add event can arrive before its uid is known
            # here (a cluster that dispatches synchronously always does).
            # Taken for a pod bound before a restart, it would be queued
            # for recovery, and if the pod were deleted before its node's
            # next Filter, recovery would reserve its cells again for
            # nobody: a leak JAX's plugin has.
            self._shadow_creates.add(pod.key)
            try:
                created = self.cluster.create_pod(assumed)
                status.uid = created.uid
            finally:
                self._shadow_creates.discard(pod.key)
        else:
            self.cluster.update_pod(assumed)
            status.uid = assumed.uid
        return Status(Status.SUCCESS)

    def _select_cells(self, node_name: str, status: PodStatus) -> List[Cell]:
        """Rank this node's leaf cells and greedily take enough for the
        request (ref score.go:297-442)."""
        cells = self.allocator.leaf_cells_by_node(node_name, status.model)
        multi = status.is_multi_chip
        peers = self.group_peer_cells(status.pod_group)
        n_peers = float(len(peers))
        scored: List[Tuple[float, Cell]] = []
        for cell in cells:
            if multi:
                if cell.available != 1:
                    continue
                score = float(cell.priority)
            elif status.is_opportunistic:
                # pack: busier cells first
                score = float(cell.priority) + (1 - cell.available) * 100
            else:
                # perform: idler cells first
                score = float(cell.priority) - (1 - cell.available) * 100
            if not status.is_opportunistic and n_peers:
                locality = sum(self.cell_distance(cell, peer) for peer in peers)
                score -= locality / n_peers * 100
            scored.append((score, cell))
        scored.sort(key=lambda t: t[0], reverse=True)

        chosen: List[Cell] = []
        remaining = status.request
        for score, cell in scored:
            if multi:
                chosen.append(cell)
                remaining -= 1.0
            else:
                # same implicit-memory default as the filter: no explicit
                # cap means request * device memory is charged at reserve
                required = status.memory if status.memory > 0 else int(
                    math.floor(remaining * cell.full_memory)
                )
                if cell.available >= remaining and cell.free_memory >= required:
                    chosen.append(cell)
                    remaining = 0
            if remaining <= 0:
                break
        if remaining > 0:
            return []
        return chosen

    def _allocate_port(self, node_name: str) -> int:
        with self.port_lock:
            bitmap = self.port_bitmaps[node_name]
            index = bitmap.find_next_from_current_and_set()
        if index == -1:
            return -1
        return index + constants.POD_MANAGER_PORT_START

    def _assume_shared_pod(self, pod: Pod, status: PodStatus, node_name: str) -> Pod:
        """Fractional pod: reserve one leaf + inject runtime env
        (ref pod.go:402-476)."""
        cell = status.cells[0]
        if status.memory == 0:
            status.memory = int(math.floor(status.request * cell.full_memory))
        self.allocator.reserve(cell, status.request, status.memory)

        assumed = pod.copy()
        assumed.node_name = node_name
        status.node_name = node_name
        status.uuid = cell.uuid
        status.model = cell.cell_type

        port = self._allocate_port(node_name)
        status.port = port

        assumed.annotations[constants.POD_CELL_ID] = cell.id
        assumed.annotations[constants.POD_GPU_MODEL] = cell.cell_type
        assumed.annotations[constants.POD_GPU_MEMORY] = str(status.memory)
        assumed.annotations[constants.POD_GPU_UUID] = cell.uuid
        assumed.annotations[constants.POD_MANAGER_PORT] = str(port)

        mem_fraction = (
            status.memory / cell.full_memory if cell.full_memory > 0 else 0.0
        )
        env = {
            constants.ENV_VISIBLE_DEVICES: cell.uuid,
            constants.ENV_DRIVER_CAPABILITIES: constants.DRIVER_CAPABILITIES,
            constants.ENV_SHIM_PRELOAD: constants.SHIM_LIBRARY,
            constants.ENV_POD_MANAGER_PORT: str(port),
            constants.ENV_POD_NAME: pod.key,
            constants.ENV_MEM_BYTES: str(status.memory),
            constants.ENV_MEM_FRACTION: f"{mem_fraction:.4f}",
        }
        env.update(self._gang_env(pod, status))
        for container in assumed.containers:
            container.env.update(env)
            container.volume_mounts.append(constants.LIBRARY_PATH)
        assumed.volumes.append(constants.LIBRARY_PATH)
        return assumed

    def _assume_multi_chip_pod(self, pod: Pod, status: PodStatus, node_name: str) -> Pod:
        """Whole-chip gang member: reserve N leaves, no shim/port (whole
        chips need no time-sharing; ref pod.go:348-400)."""
        assumed = pod.copy()
        assumed.node_name = node_name
        status.node_name = node_name

        cell_ids, uuids, models = [], [], []
        total_memory = 0
        for cell in status.cells:
            total_memory += cell.free_memory
            self.allocator.reserve(cell, cell.available, cell.free_memory)
            cell_ids.append(cell.id)
            uuids.append(cell.uuid)
            models.append(cell.cell_type)

        assumed.annotations[constants.POD_CELL_ID] = ",".join(cell_ids)
        assumed.annotations[constants.POD_GPU_MEMORY] = str(total_memory)
        assumed.annotations[constants.POD_GPU_MODEL] = ",".join(models)
        assumed.annotations[constants.POD_GPU_UUID] = ",".join(uuids)
        status.uuid = ",".join(uuids)
        status.model = ",".join(models)

        env = {
            # the pod sees exactly its granted cards (ref pod.go:388-396)
            constants.ENV_VISIBLE_DEVICES: ",".join(uuids),
            constants.ENV_DRIVER_CAPABILITIES: constants.DRIVER_CAPABILITIES,
            constants.ENV_POD_NAME: pod.key,
        }
        env.update(self._gang_env(pod, status))
        for container in assumed.containers:
            container.env.update(env)
        return assumed

    def _gang_env(self, pod: Pod, status: PodStatus) -> Dict[str, str]:
        """Gang coordinates for multi-host bootstrap (parallel.distributed).

        Ranks come from the group's lowest-unused-rank registry, not from
        the bound-pod count: a recreated mid-rank member reclaims a freed
        rank instead of duplicating a surviving peer's."""
        if not status.pod_group:
            return {}
        key = f"{pod.namespace}/{status.pod_group}"
        info = self.pod_groups.get(key)
        if info is None:
            info = self.pod_groups.get_or_create(
                pod, self.clock.now(), parse_priority(pod)
            )
        size = info.head_count if info.key else status.min_available
        rank = self.pod_groups.assign_rank(key, pod.key)
        from ..parallel.distributed import (
            ENV_GANG_NAME,
            ENV_GANG_RANK,
            ENV_GANG_SIZE,
        )

        env = {
            ENV_GANG_NAME: status.pod_group,
            ENV_GANG_SIZE: str(size),
            ENV_GANG_RANK: str(rank),
            # each gang member is one process in a linear process grid
            # (multislice_spec_from_env reads its processes per slice)
            constants.ENV_PROCESS_BOUNDS: f"{size},1,1",
        }
        if status.cells and key:
            # DCN layout: planned once at the gang's first chip-bearing
            # Reserve, then each member reads its slice assignment.  A
            # single-slice gang (the common case, and what the DCN-tiered
            # score steers toward) gets no megascale env at all.
            home = self.slice_of(status.cells[0])
            if not info.slice_plan:
                self.pod_groups.set_slice_plan(
                    key, self._plan_gang_slices(status, size, home)
                )
            elif home not in info.slice_plan:
                self.log.warning(
                    "gang %s member %s landed in slice %s outside the "
                    "planned layout %s; appending (earlier members' "
                    "MEGASCALE_NUM_SLICES is stale — their pods must be "
                    "recreated for multi-slice init to agree)",
                    key, pod.key, home, dict(info.slice_plan),
                )
            slice_id, num_slices, members, uniform = (
                self.pod_groups.slice_assignment(key, home)
            )
            if num_slices > 1 and uniform:
                # the process grid is per slice: each slice runs its own
                # linear grid of that slice's members, and the slice ids
                # give slice_device_mesh its "dcn" axis (the gang's
                # coordinator stays TPUSHARE_COORDINATOR's, rank 0's)
                env[constants.ENV_PROCESS_BOUNDS] = f"{members},1,1"
                env[constants.ENV_MEGASCALE_NUM_SLICES] = str(num_slices)
                env[constants.ENV_MEGASCALE_SLICE_ID] = str(slice_id)
        return env

    def _plan_gang_slices(
        self, status: PodStatus, size: int, home: str
    ) -> Dict[str, int]:
        """Greedy fewest-slices layout for a gang of ``size`` members, each
        needing ``len(status.cells)`` whole chips on one node: fill the
        placing member's slice first, then remaining slices by free
        capacity.  Capacity is counted in whole free leaves of the gang's
        chip model at plan time — the plan is a bootstrap-env contract
        (slice ids / counts), not a reservation; actual placement stays
        with Filter/Score, which the DCN tier already points at the plan's
        preference."""
        chips_per_member = max(len(status.cells), 1)
        model = status.cells[0].cell_type if status.cells else ""
        per_node: Dict[Tuple[str, str], int] = {}
        with self.allocator.lock:
            if model in self.allocator.free_list:
                levels = [self.allocator.free_list[model]]
            else:
                levels = list(self.allocator.free_list.values())
            for by_level in levels:
                for roots in by_level.values():
                    for root in roots:
                        for leaf in root.leaves():
                            if leaf.healthy and leaf.available >= 0.999:
                                k = (self.slice_of(leaf), leaf.node)
                                per_node[k] = per_node.get(k, 0) + 1
        caps: Dict[str, int] = {}
        for (skey, _node), free in per_node.items():
            caps[skey] = caps.get(skey, 0) + free // chips_per_member
        # the placing member's own chips are already reserved, so its
        # slice holds at least this one member
        caps[home] = caps.get(home, 0) + 1
        # a multi-slice mesh requires IDENTICALLY-shaped slices: every
        # member's per-slice process grid must agree, so the plan is the
        # smallest k with size % k == 0 where the home slice plus the
        # k-1 roomiest others each hold size/k members.  An uneven split
        # is not a viable bootstrap layout at all.
        order = [home] + sorted(
            (k for k in caps if k != home), key=lambda k: (-caps[k], k)
        )
        for k in range(1, len(order) + 1):
            if size % k:
                continue
            per = size // k
            if all(caps.get(s, 0) >= per for s in order[:k]):
                return {s: per for s in order[:k]}
        # no uniform layout fits the current capacity: plan single-slice
        # (no megascale env; Filter/Score still place the members where
        # they fit, and any off-plan member degrades the gang to the
        # linear gang-wide grid via the uniformity gate in _gang_env)
        self.log.warning(
            "gang slice plan: no uniform %d-member layout fits current "
            "per-slice capacity %s; planning single-slice on %s",
            size, caps, home,
        )
        return {home: size}

    # ------------------------------------------------------------------
    # Permit: the gang barrier (ref scheduler.go:551-587)
    # ------------------------------------------------------------------
    def permit(self, pod: Pod) -> Tuple[Status, float]:
        """Returns (status, timeout_seconds); WAIT holds the pod in the
        waiting room until groupmates bind or the timeout rejects the gang."""
        info = self.pod_groups.get_or_create(pod, self.clock.now(), parse_priority(pod))
        if not info.key:
            return Status(Status.SUCCESS), 0.0
        bound = self.count_bound_group_pods(pod.namespace, info.name, exclude_key=pod.key)
        current = bound + 1
        if current < info.min_available:
            timeout = self.args.permit_waiting_time_base_seconds * info.head_count
            return Status(Status.WAIT), timeout
        return Status(Status.SUCCESS), 0.0

    # ------------------------------------------------------------------
    # observability: scheduler-state metrics (beyond the reference's
    # log-only story, SURVEY §5)
    # ------------------------------------------------------------------
    def collect_metrics(self):
        from ..utils.promtext import MetricFamily

        pods = MetricFamily(
            "kubeshare_scheduler_pods", "Pods tracked by the scheduler.", "gauge"
        )
        with self.pod_status_lock:
            statuses = list(self.pod_status.values())
        placed = sum(1 for s in statuses if s.cells)
        pods.add({"state": "tracked"}, len(statuses))
        pods.add({"state": "placed"}, placed)

        cells = MetricFamily(
            "kubeshare_cell_available",
            "Fractional availability per leaf cell.", "gauge",
        )
        memory = MetricFamily(
            "kubeshare_cell_free_memory_bytes",
            "Free HBM per leaf cell.", "gauge",
        )
        with self.allocator.lock:
            for uuid, leaf in self.allocator.leaf_cells.items():
                labels = {"uuid": uuid, "node": leaf.node, "model": leaf.cell_type}
                cells.add(labels, leaf.available)
                memory.add(labels, leaf.free_memory)
        return [pods, cells, memory]

    # ------------------------------------------------------------------
    # teardown + recovery (ref pod.go:91-136, 528-617)
    # ------------------------------------------------------------------
    def handle_pod_deleted(self, pod: Pod) -> None:
        if pod.key in self._suppressed_deletes:
            return  # shadow-mode rebind in flight; reservation stands
        status = self.delete_pod_status(pod)
        if status is not None and status.cells:
            if status.is_multi_chip:
                for cell in status.cells:
                    self.allocator.reclaim(cell, 1.0, cell.full_memory)
            else:
                if status.port >= constants.POD_MANAGER_PORT_START:
                    with self.port_lock:
                        bitmap = self.port_bitmaps.get(status.node_name)
                        if bitmap is not None:
                            bitmap.unmask(status.port - constants.POD_MANAGER_PORT_START)
                self.allocator.reclaim(status.cells[0], status.request, status.memory)
        group = status.pod_group if status else pod.labels.get(constants.POD_GROUP_NAME, "")
        if group:
            key = f"{pod.namespace}/{group}"
            # free the gang rank so a recreated member can reuse it
            self.pod_groups.release_rank(key, pod.key)
            # live members = non-failed group pods excluding this one
            pods = self.cluster.list_pods(
                namespace=pod.namespace,
                label_selector={constants.POD_GROUP_NAME: group},
            )
            remaining = sum(
                1 for p in pods if p.phase != PodPhase.FAILED and p.key != pod.key
            )
            if remaining <= 0:
                # mark-then-expire (ref pod_group.go:119-129): a gang
                # recreated within the expiration window re-activates with
                # its original timestamp, keeping its queue seniority
                self.pod_groups.mark_deleted(key)

    def process_bound_pod_queue(self, node_name: str) -> None:
        """Scheduler-restart recovery: re-reserve resources for pods that
        were already bound before this process started (ref pod.go:528-582)."""
        if node_name not in self.bound_pod_queue:  # lock-free hot path
            return
        with self.bound_queue_lock:
            queue = self.bound_pod_queue.pop(node_name, [])
        for pod in queue:
            if pod.node_name == "":
                continue
            self._process_bound_pod(pod)

    def _process_bound_pod(self, pod: Pod) -> None:
        _, needs_chip, status = self.get_pod_status(pod)
        if not needs_chip or status is None:
            return
        try:
            memory = int(pod.annotations.get(constants.POD_GPU_MEMORY, ""))
        except ValueError:
            self.log.error("[recover] pod %s has no usable memory annotation", pod.key)
            return
        status.node_name = pod.node_name
        if not status.cells:
            self._rebind_cells_from_annotations(pod, status, memory)
        self._recover_gang_rank(pod, status)
        if not status.is_multi_chip:
            try:
                port = int(pod.annotations.get(constants.POD_MANAGER_PORT, ""))
            except ValueError:
                self.log.error("[recover] pod %s has no usable port annotation", pod.key)
                return
            status.port = port
            if port >= constants.POD_MANAGER_PORT_START:
                self._port_bitmap(pod.node_name).mask(
                    port - constants.POD_MANAGER_PORT_START
                )

    def _recover_gang_rank(self, pod: Pod, status: PodStatus) -> None:
        """Restart recovery: a bound gang pod carries its rank in container
        env — re-register it so later recreations don't collide with it."""
        if not status.pod_group:
            return
        from ..parallel.distributed import ENV_GANG_RANK

        for container in pod.containers:
            raw = container.env.get(ENV_GANG_RANK)
            if raw is None:
                continue
            try:
                rank = int(raw)
            except ValueError:
                return
            key = f"{pod.namespace}/{status.pod_group}"
            if self.pod_groups.get(key) is None:
                self.pod_groups.get_or_create(
                    pod, self.clock.now(), parse_priority(pod)
                )
            self.pod_groups.assign_rank(key, pod.key, rank=rank)
            return

    def _rebind_cells_from_annotations(
        self, pod: Pod, status: PodStatus, memory: int
    ) -> None:
        """ref pod.go:584-617."""
        raw = pod.annotations.get(constants.POD_GPU_UUID, "")
        status.uuid = raw
        cells: List[Cell] = []
        cell_ids: List[str] = []
        for uuid in raw.split(","):
            if not uuid:
                continue
            cell = self.allocator.leaf_cells.get(uuid)
            if cell is None:
                continue
            cells.append(cell)
            cell_ids.append(cell.id)
            if status.is_multi_chip:
                self.allocator.reserve(cell, cell.leaf_cell_number, cell.full_memory)
            else:
                self.allocator.reserve(cell, status.request, memory)
        status.cells = cells
        status.memory = memory
        updated = pod.copy()
        updated.annotations[constants.POD_CELL_ID] = ",".join(cell_ids)
        try:
            self.cluster.update_pod(updated)
        except ValueError:
            pass
