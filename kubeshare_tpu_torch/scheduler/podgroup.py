"""Gang-scheduling pod groups (ref pkg/scheduler/pod_group.go).

The port's own copy of kubeshare_tpu/scheduler/podgroup.py (the port imports nothing
of the JAX package).

A pod opts into a gang with ``group_name`` + ``group_headcount`` +
``group_threshold``; minAvailable = round(headcount * threshold).  Group
state is tracked for queue ordering (priority + init timestamp) and the
Permit barrier, and garbage-collected after expiry.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .. import constants
from ..cluster.api import Clock, Pod


def parse_pod_group_labels(pod: Pod) -> Tuple[str, int, float, int]:
    """Returns (group_name, headcount, threshold, min_available); all-empty
    for non-gang pods or malformed gang labels (ref pod_group.go:86-117 —
    malformed values demote to a regular pod, they do not error)."""
    group_name = pod.labels.get(constants.POD_GROUP_NAME, "")
    if not group_name:
        return "", 0, 0.0, 0
    raw_headcount = pod.labels.get(constants.POD_GROUP_HEADCOUNT, "")
    if not raw_headcount:
        return "", 0, 0.0, 0
    try:
        headcount = int(raw_headcount)
    except ValueError:
        return "", 0, 0.0, 0
    if headcount < 1:
        return "", 0, 0.0, 0
    raw_threshold = pod.labels.get(constants.POD_GROUP_THRESHOLD, "")
    if not raw_threshold:
        return "", 0, 0.0, 0
    try:
        threshold = float(raw_threshold)
    except ValueError:
        return "", 0, 0.0, 0
    if threshold <= 0:
        return "", 0, 0.0, 0
    min_available = int(math.floor(threshold * headcount + 0.5))
    return group_name, headcount, threshold, min_available


@dataclass
class PodGroupInfo:
    key: str  # "<namespace>/<group name>"; "" for regular pods
    name: str
    priority: int
    timestamp: float  # initial scheduling-attempt timestamp
    min_available: int
    head_count: int
    threshold: float
    deletion_timestamp: Optional[float] = None
    # pod key -> gang rank.  Ranks are stable for a pod's lifetime and a
    # recreated member takes the lowest *unused* rank, so a mid-rank
    # restart never duplicates a surviving peer's TPUSHARE_GANG_RANK
    # (the torch.distributed rank must be unique per gang).
    assigned_ranks: Dict[str, int] = field(default_factory=dict)
    # slice key -> planned member count, insertion-ordered: the gang's
    # DCN layout, planned once at its first chip-bearing Reserve from
    # current per-slice capacity (fewest slices win; the placing member's
    # slice is slice 0).  A member's MEGASCALE_SLICE_ID is its key's
    # position in this dict; MEGASCALE_NUM_SLICES is its length.  The env
    # of already-bound members is immutable, so the plan is sticky: a
    # later member landing outside it is appended with a warning (the
    # DCN-tiered score makes that a pathological case).
    slice_plan: Dict[str, int] = field(default_factory=dict)


class PodGroupRegistry:
    def __init__(self, clock: Optional[Clock] = None, expiration_seconds: float = constants.POD_GROUP_EXPIRATION_TIME_SECONDS):
        self._groups: Dict[str, PodGroupInfo] = {}
        self._lock = threading.RLock()
        self._clock = clock or Clock()
        self._expiration = expiration_seconds

    def get_or_create(self, pod: Pod, timestamp: float, priority: int) -> PodGroupInfo:
        """ref pod_group.go:40-81; regular pods get an ephemeral record with
        empty key that is never stored."""
        group_name, headcount, threshold, min_available = parse_pod_group_labels(pod)
        key = f"{pod.namespace}/{group_name}" if group_name and min_available > 0 else ""
        with self._lock:
            if key and key in self._groups:
                info = self._groups[key]
                if info.deletion_timestamp is not None:
                    info.deletion_timestamp = None  # re-activate
                return info
            info = PodGroupInfo(
                key=key,
                name=group_name,
                priority=priority,
                timestamp=timestamp,
                min_available=min_available,
                head_count=headcount,
                threshold=threshold,
            )
            if key:
                self._groups[key] = info
            return info

    def mark_deleted(self, key: str) -> None:
        with self._lock:
            info = self._groups.get(key)
            if info is not None:
                info.deletion_timestamp = self._clock.now()

    def remove(self, key: str) -> None:
        with self._lock:
            self._groups.pop(key, None)

    def gc(self) -> None:
        """Drop groups expired longer than the expiration window
        (ref pod_group.go:119-129)."""
        now = self._clock.now()
        with self._lock:
            for key in list(self._groups):
                ts = self._groups[key].deletion_timestamp
                if ts is not None and ts + self._expiration < now:
                    del self._groups[key]

    def get(self, key: str) -> Optional[PodGroupInfo]:
        with self._lock:
            return self._groups.get(key)

    def assign_rank(self, key: str, pod_key: str, rank: Optional[int] = None) -> int:
        """Lowest-unused-rank assignment (idempotent per pod).  ``rank``
        pins an explicit value — used by restart recovery to re-register
        the rank already stamped into a bound pod's env.  A stamped rank is
        authoritative: if a dynamically-assigned pod already took it (its
        node's recovery had not run yet), that pod is evicted to the next
        unused rank."""
        with self._lock:
            info = self._groups.get(key)
            if info is None:
                return 0
            existing = info.assigned_ranks.get(pod_key)
            if existing is not None and rank is None:
                return existing
            if rank is None:
                used = set(info.assigned_ranks.values())
                rank = next(r for r in range(len(used) + 1) if r not in used)
            else:
                holder = next(
                    (k for k, r in info.assigned_ranks.items()
                     if r == rank and k != pod_key),
                    None,
                )
                if holder is not None:
                    used = set(info.assigned_ranks.values()) | {rank}
                    info.assigned_ranks[holder] = next(
                        r for r in range(len(used) + 1) if r not in used
                    )
            info.assigned_ranks[pod_key] = rank
            return rank

    def set_slice_plan(self, key: str, plan: Dict[str, int]) -> None:
        """Install the gang's DCN layout; first plan wins (sticky — bound
        members' env is immutable)."""
        with self._lock:
            info = self._groups.get(key)
            if info is not None and not info.slice_plan:
                info.slice_plan.update(plan)

    def slice_assignment(
        self, key: str, slice_key: str
    ) -> Tuple[int, int, int, bool]:
        """Returns (slice_id, num_slices, planned members in that slice,
        uniform) for a member placed in ``slice_key``.  A slice outside
        the plan is appended (placement deviated; the caller warns).
        ``uniform`` is whether every slice holds the same member count —
        a multi-slice mesh (parallel/distributed.py) needs
        identically-shaped slices, so the caller emits megascale env only
        for uniform plans."""
        with self._lock:
            info = self._groups.get(key)
            if info is None:
                return 0, 1, 1, True
            if slice_key not in info.slice_plan:
                info.slice_plan[slice_key] = 1
            keys = list(info.slice_plan)
            uniform = len(set(info.slice_plan.values())) == 1
            return (keys.index(slice_key), len(keys),
                    info.slice_plan[slice_key], uniform)

    def release_rank(self, key: str, pod_key: str) -> None:
        with self._lock:
            info = self._groups.get(key)
            if info is not None:
                info.assigned_ranks.pop(pod_key, None)
