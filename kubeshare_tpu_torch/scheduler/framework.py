"""Scheduling engine: drives the plugin through the framework cycle.

The port's copy of kubeshare_tpu/scheduler/framework.py.  Its revert
list names the env the port's plugin injects (plugin.py's docstring).

The reference rides inside kube-scheduler's scheduling framework (one pod at
a time through QueueSort/PreFilter/Filter/Score/Reserve/Permit, with a
waiting room for gang Permit).  This module is that framework re-created as
an explicit, synchronous engine over the cluster API — deterministic in
tests (inject a FakeClock) and usable as the real control loop.

Gang-timeout fix over the reference: the reference's Unreserve only rejects
waiting groupmates and, because Reserve has already created the bound shadow
pod, a timed-out gang can leak placed pods (ref scheduler.go:515-549).  Here
rejection fully unreserves: cells reclaimed, port released, pod reverted to
unbound with injected metadata stripped.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .. import constants
from ..cluster.api import Clock, ClusterAPI, Node, Pod
from ..utils.logger import get_logger
from .plugin import KubeShareScheduler, Status


def injected_env_names() -> Tuple[str, ...]:
    """Every env name the plugin may inject into a pod (fractional,
    multi-chip and gang member alike): what :meth:`SchedulerEngine.
    unreserve` strips from a reverted pod."""
    from ..parallel.distributed import (
        ENV_GANG_NAME,
        ENV_GANG_RANK,
        ENV_GANG_SIZE,
    )

    return (
        constants.ENV_VISIBLE_DEVICES,
        constants.ENV_DRIVER_CAPABILITIES,
        constants.ENV_SHIM_PRELOAD,
        constants.ENV_POD_MANAGER_PORT,
        constants.ENV_POD_NAME,
        constants.ENV_MEM_BYTES,
        constants.ENV_MEM_FRACTION,
        ENV_GANG_NAME,
        ENV_GANG_SIZE,
        ENV_GANG_RANK,
        constants.ENV_PROCESS_BOUNDS,
        constants.ENV_MEGASCALE_NUM_SLICES,
        constants.ENV_MEGASCALE_SLICE_ID,
    )


@dataclass
class CycleStatus:
    pod_key: str
    result: str  # bound | waiting | unschedulable | error | skipped
    message: str = ""
    node: str = ""


@dataclass
class _WaitingPod:
    pod: Pod
    group_key: str
    deadline: float


class SchedulerEngine:
    def __init__(
        self,
        plugin: KubeShareScheduler,
        cluster: ClusterAPI,
        clock: Optional[Clock] = None,
    ) -> None:
        self.plugin = plugin
        self.cluster = cluster
        self.clock = clock or plugin.clock
        self.log = get_logger("kubeshare-engine")
        self._waiting: Dict[str, List[_WaitingPod]] = {}
        self._attempt_timestamps: Dict[str, float] = {}
        self._sort_keys: Dict[str, tuple] = {}
        self._sort_key_uids: Dict[str, str] = {}
        # event-maintained pending set (the reference rides kube-scheduler's
        # event-driven queue; re-listing every cycle is O(P) per pod)
        self._pending: Dict[str, Pod] = {}
        for pod in cluster.list_pods(scheduler_name=constants.SCHEDULER_NAME):
            if not pod.is_bound() and not pod.is_completed():
                self._pending[pod.key] = pod
        cluster.add_pod_handler(self._on_pod_event)

    def _on_pod_event(self, event: str, obj: object) -> None:
        pod = obj
        if not isinstance(pod, Pod) or pod.scheduler_name != constants.SCHEDULER_NAME:
            return
        if event == "delete" or pod.is_bound() or pod.is_completed():
            self._forget(pod.key)
        else:
            self._pending[pod.key] = pod

    def _forget(self, pod_key: str) -> None:
        """Drop a pod that left the queue terminally (bound / completed /
        deleted) from every per-pod map — the sort-key and attempt-stamp
        caches would otherwise grow one entry per pod for the process
        lifetime (pod churn on an HA leader runs for weeks)."""
        self._pending.pop(pod_key, None)
        self._sort_keys.pop(pod_key, None)
        self._sort_key_uids.pop(pod_key, None)
        self._attempt_timestamps.pop(pod_key, None)

    # ------------------------------------------------------------------
    def pending_pods(self) -> List[Pod]:
        waiting_keys = {
            w.pod.key for group in self._waiting.values() for w in group
        }
        # re-verify liveness at read time: under an eventually-consistent
        # watch (real k8s) the event stream may lag the API state
        pods = [
            p
            for p in list(self._pending.values())
            if not p.is_bound() and not p.is_completed()
            and p.key not in waiting_keys
        ]
        # sort keys are stable per pod lifetime (priority + the group's
        # initial-attempt timestamp), so cache them — the queue is re-sorted
        # every cycle (ref QueueSort runs per comparison too, but against a
        # heap, not a full list)
        for p in pods:
            if p.key not in self._sort_keys or self._sort_key_uids.get(p.key) != p.uid:
                self._attempt_timestamps.setdefault(p.key, self.clock.now())
                self._sort_keys[p.key] = self.plugin.sort_key(
                    p, self._attempt_timestamps[p.key]
                )
                self._sort_key_uids[p.key] = p.uid
        pods.sort(key=lambda p: self._sort_keys[p.key])
        return pods

    def _is_waiting(self, pod: Pod) -> bool:
        return any(
            w.pod.key == pod.key for group in self._waiting.values() for w in group
        )

    # ------------------------------------------------------------------
    def run_once(self) -> Optional[CycleStatus]:
        """Schedule the head-of-queue pod through one full cycle.

        The WHOLE cycle is error-guarded: any of its apiserver calls
        (re-fetch, list_nodes, the reserve patch, the bind subresource)
        can hit a transient 500/429/timeout, and none of them may crash
        the scheduler out of its loop — the cycle reports ``"error"``
        and the caller's backoff retries.  The full traceback is logged
        so a DETERMINISTIC failure (a bug, not a hiccup) repeating on
        the head-of-queue pod stays loudly visible rather than silently
        reclassified as weather."""
        self.expire_waiting_pods()
        self.plugin.pod_groups.gc()  # ref pod_group.go:119-129 (30s loop)
        pending = self.pending_pods()
        if not pending:
            return None
        pod = pending[0]
        try:
            return self.schedule_pod(pod)
        except Exception as e:
            self.log.warning("scheduling cycle for %s failed (will back "
                             "off and retry): %s", pod.key, e, exc_info=True)
            return CycleStatus(pod.key, "error", f"cycle failed: {e}")

    def run_until_idle(self, max_cycles: int = 1000) -> List[CycleStatus]:
        """Drive cycles until nothing schedulable remains (tests/simulator)."""
        results: List[CycleStatus] = []
        stuck: Dict[str, int] = {}
        for _ in range(max_cycles):
            self.expire_waiting_pods()
            self.plugin.pod_groups.gc()
            pending = [
                p for p in self.pending_pods() if stuck.get(p.key, 0) < 2
            ]
            if not pending:
                break
            status = self.schedule_pod(pending[0])
            results.append(status)
            if status.result in ("unschedulable", "error"):
                stuck[status.pod_key] = stuck.get(status.pod_key, 0) + 1
            else:
                stuck.pop(status.pod_key, None)
        return results

    # ------------------------------------------------------------------
    def schedule_pod(self, pod: Pod) -> CycleStatus:
        # Re-fetch the authoritative object before the cycle (what
        # kube-scheduler's cache snapshot gives it): under an
        # eventually-consistent watch the queued snapshot can be STALE —
        # a pod already bound (whose bound event lost a race with a
        # resync replay of its unbound past) would otherwise wedge the
        # queue head forever and, worse, re-reserve cells it already
        # holds under a fresh uuid (the stale snapshot carries no
        # placement annotations).
        current = self.cluster.get_pod(pod.namespace, pod.name)
        if current is None:
            self._forget(pod.key)
            return CycleStatus(pod.key, "stale", "pod no longer exists")
        if current.is_bound() or current.is_completed():
            self._forget(pod.key)
            return CycleStatus(pod.key, "bound", "already placed",
                               current.node_name)
        pod = current

        status = self.plugin.pre_filter(pod)
        if not status.ok:
            return CycleStatus(pod.key, "unschedulable", status.message)

        nodes = [n for n in self.cluster.list_nodes() if n.is_healthy()]
        feasible: List[Node] = []
        for node in nodes:
            if self.plugin.filter(pod, node).ok:
                feasible.append(node)
        if not feasible:
            return CycleStatus(pod.key, "unschedulable", "no node fits")

        raw_scores = {n.name: self.plugin.score(pod, n.name) for n in feasible}
        scores = self.plugin.normalize_scores(raw_scores)
        best = max(feasible, key=lambda n: (scores[n.name], n.name))

        status = self.plugin.reserve(pod, best.name)
        if not status.ok:
            return CycleStatus(pod.key, "unschedulable", status.message, best.name)

        permit, timeout = self.plugin.permit(pod)
        if permit.code == Status.WAIT:
            info = self.plugin.pod_groups.get_or_create(
                pod, self.clock.now(), self.plugin.pod_status[pod.key].priority
                if pod.key in self.plugin.pod_status
                else 0,
            )
            self._waiting.setdefault(info.key, []).append(
                _WaitingPod(pod, info.key, self.clock.now() + timeout)
            )
            return CycleStatus(pod.key, "waiting", f"gang barrier ({timeout:.0f}s)", best.name)

        self._bind(pod, best.name)
        self._allow_group(pod)
        self._forget(pod.key)  # terminal: no event round-trip needed
        return CycleStatus(pod.key, "bound", "", best.name)

    def _bind(self, pod: Pod, node_name: str) -> None:
        current = self.cluster.get_pod(pod.namespace, pod.name)
        if current is not None and not current.is_bound():
            self.cluster.bind_pod(pod.namespace, pod.name, node_name)

    def _allow_group(self, pod: Pod) -> None:
        """On a successful Permit, release all waiting groupmates
        (ref scheduler.go:579-584)."""
        group = pod.labels.get(constants.POD_GROUP_NAME, "")
        if not group:
            return
        key = f"{pod.namespace}/{group}"
        for waiting in self._waiting.pop(key, []):
            self._bind(waiting.pod, waiting.pod.node_name)

    # ------------------------------------------------------------------
    def expire_waiting_pods(self) -> None:
        """Reject gangs whose Permit barrier timed out (ref Unreserve,
        scheduler.go:534-549 — but with full resource rollback, see module
        docstring)."""
        now = self.clock.now()
        for key in list(self._waiting):
            group = self._waiting[key]
            if any(w.deadline <= now for w in group):
                self._waiting.pop(key)
                for waiting in group:
                    self.unreserve(waiting.pod)

    def unreserve(self, pod: Pod) -> None:
        """Roll a reserved-but-not-permitted pod back to pending."""
        current = self.cluster.get_pod(pod.namespace, pod.name) or pod
        self.plugin.handle_pod_deleted(current)
        reverted = current.copy()
        reverted.node_name = ""
        for annotation in (
            constants.POD_CELL_ID,
            constants.POD_GPU_MODEL,
            constants.POD_GPU_UUID,
            constants.POD_MANAGER_PORT,
        ):
            reverted.annotations.pop(annotation, None)
        # gpu_mem annotation only if the scheduler injected it (label absent)
        if constants.POD_GPU_MEMORY not in current.labels:
            reverted.annotations.pop(constants.POD_GPU_MEMORY, None)
        for container in reverted.containers:
            for name in injected_env_names():
                container.env.pop(name, None)
            if constants.LIBRARY_PATH in container.volume_mounts:
                container.volume_mounts.remove(constants.LIBRARY_PATH)
        if constants.LIBRARY_PATH in reverted.volumes:
            reverted.volumes.remove(constants.LIBRARY_PATH)
        try:
            self.cluster.update_pod(reverted)
        except ValueError:
            pass

    # ------------------------------------------------------------------
    def waiting_count(self) -> int:
        return sum(len(g) for g in self._waiting.values())
