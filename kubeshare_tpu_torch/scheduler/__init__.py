from .podspec import PodStatus, parse_pod_labels, PodLabelError
from .podgroup import PodGroupInfo, PodGroupRegistry, parse_pod_group_labels
from .plugin import KubeShareScheduler, SchedulerArgs
from .framework import SchedulerEngine, CycleStatus
from .leader import LeaderElector
from .placement import FleetPlacementPlane, ReplicaPlacement

__all__ = [
    "PodStatus",
    "parse_pod_labels",
    "PodLabelError",
    "PodGroupInfo",
    "PodGroupRegistry",
    "parse_pod_group_labels",
    "KubeShareScheduler",
    "SchedulerArgs",
    "SchedulerEngine",
    "CycleStatus",
    "LeaderElector",
    "FleetPlacementPlane",
    "ReplicaPlacement",
]
