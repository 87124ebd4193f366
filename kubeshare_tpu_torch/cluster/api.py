"""Cluster-API abstraction: the pod/node model the control plane operates on.

The port's own copy of kubeshare_tpu/cluster/api.py (the port imports nothing
of the JAX package).

The reference talks to a real Kubernetes API server through client-go
informers and clientsets.  Here the same surface is an abstract interface so
every component runs identically against the in-memory ``FakeCluster`` (unit
and integration tests, the trace simulator) or a real cluster adapter.  Only
the fields the framework actually reads/writes are modeled.
"""

from __future__ import annotations

import enum
import functools
import itertools
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class PodPhase(str, enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


@dataclass
class Container:
    name: str = "main"
    env: Dict[str, str] = field(default_factory=dict)
    volume_mounts: List[str] = field(default_factory=list)


@dataclass
class Pod:
    namespace: str = "default"
    name: str = ""
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    scheduler_name: str = "default-scheduler"
    node_name: str = ""
    phase: PodPhase = PodPhase.PENDING
    containers: List[Container] = field(default_factory=lambda: [Container()])
    volumes: List[str] = field(default_factory=list)
    creation_timestamp: float = 0.0
    # The manifest the API server returned for this pod (a dict in the
    # API's camelCase), or None for a pod built in memory.  Deliberately
    # not a dataclass field: the modelled fields stay JAX's, and the
    # Kubernetes adapter writes this spec back when it recreates the pod
    # (shadow bind), so image, command, resources, volumes and owner
    # references survive the fields modelled above.
    source = None

    @functools.cached_property
    def key(self) -> str:
        # namespace/name are fixed at construction (copy() builds a new Pod);
        # the key is on every hot path, so compute it once per instance
        return f"{self.namespace}/{self.name}"

    def is_bound(self) -> bool:
        return self.node_name != ""

    def is_completed(self) -> bool:
        return self.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED)

    def copy(self) -> "Pod":
        twin = Pod(
            namespace=self.namespace,
            name=self.name,
            uid=self.uid,
            labels=dict(self.labels),
            annotations=dict(self.annotations),
            scheduler_name=self.scheduler_name,
            node_name=self.node_name,
            phase=self.phase,
            containers=[
                Container(c.name, dict(c.env), list(c.volume_mounts))
                for c in self.containers
            ],
            volumes=list(self.volumes),
            creation_timestamp=self.creation_timestamp,
        )
        twin.source = self.source  # read only: manifests copy it first
        return twin

    def get_env(self, name: str) -> Optional[str]:
        for c in self.containers:
            if name in c.env:
                return c.env[name]
        return None


@dataclass
class Node:
    name: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    ready: bool = True
    unschedulable: bool = False

    def is_healthy(self) -> bool:
        # ref pkg/scheduler/node.go:95-106
        return self.ready and not self.unschedulable


# informer event handlers: (event_type, obj) with types add/update/delete
EventHandler = Callable[[str, object], None]


class ClusterAPI:
    """What the scheduler/daemons need from the cluster control plane."""

    def list_pods(
        self,
        namespace: Optional[str] = None,
        scheduler_name: Optional[str] = None,
        phase: Optional[PodPhase] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[Pod]:
        raise NotImplementedError

    def list_nodes(self) -> List[Node]:
        raise NotImplementedError

    def get_pod(self, namespace: str, name: str) -> Optional[Pod]:
        raise NotImplementedError

    def create_pod(self, pod: Pod) -> Pod:
        raise NotImplementedError

    def update_pod(self, pod: Pod) -> Pod:
        raise NotImplementedError

    def delete_pod(self, namespace: str, name: str) -> None:
        raise NotImplementedError

    def bind_pod(self, namespace: str, name: str, node_name: str) -> None:
        raise NotImplementedError

    def add_pod_handler(self, handler: EventHandler) -> None:
        raise NotImplementedError

    def add_node_handler(self, handler: EventHandler) -> None:
        raise NotImplementedError

    def lease_tryhold(
        self, name: str, identity: str, duration_s: float, now: float
    ) -> str:
        """Try to acquire or renew the named leader-election lease for
        ``identity``; returns the CURRENT holder after the attempt (the
        caller leads iff that equals its identity).  A lease is free when
        unheld or expired; the holder renews by calling again.  Backends
        without lease support raise NotImplementedError — the elector
        degrades to single-instance mode (the reference rode
        kube-scheduler's own leader election, deploy/scheduler.yaml)."""
        raise NotImplementedError


_uid_counter = itertools.count(1)


def next_uid(prefix: str = "uid") -> str:
    return f"{prefix}-{next(_uid_counter)}"


class Clock:
    """Injectable time source (ref k8s util.Clock) so gang timeouts and GC
    are deterministic in tests."""

    def now(self) -> float:
        import time

        return time.time()


class FakeClock(Clock):
    def __init__(self, start: float = 0.0) -> None:
        self._now = start
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def advance(self, seconds: float) -> None:
        with self._lock:
            self._now += seconds
