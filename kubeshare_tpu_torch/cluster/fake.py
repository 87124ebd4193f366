"""In-memory cluster: the test/simulation double for the Kubernetes API.

The port's own copy of kubeshare_tpu/cluster/fake.py (the port imports nothing
of the JAX package).

Dispatches informer-style add/update/delete events synchronously to
registered handlers, which is what makes scheduler integration tests
deterministic (the reference can only be tested against a live cluster;
SURVEY §4).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .api import ClusterAPI, EventHandler, Node, Pod, PodPhase, next_uid


class FakeCluster(ClusterAPI):
    def __init__(self) -> None:
        self._pods: Dict[str, Pod] = {}
        self._nodes: Dict[str, Node] = {}
        self._pod_handlers: List[EventHandler] = []
        self._node_handlers: List[EventHandler] = []
        self._leases: Dict[str, tuple] = {}  # name -> (holder, expires_at)
        self._lock = threading.RLock()

    # ---- pods --------------------------------------------------------
    def list_pods(
        self,
        namespace: Optional[str] = None,
        scheduler_name: Optional[str] = None,
        phase: Optional[PodPhase] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[Pod]:
        with self._lock:
            pods = list(self._pods.values())
        result = []
        for pod in pods:
            if namespace is not None and pod.namespace != namespace:
                continue
            if scheduler_name is not None and pod.scheduler_name != scheduler_name:
                continue
            if phase is not None and pod.phase != phase:
                continue
            if label_selector and any(
                pod.labels.get(k) != v for k, v in label_selector.items()
            ):
                continue
            result.append(pod)
        return result

    def get_pod(self, namespace: str, name: str) -> Optional[Pod]:
        with self._lock:
            return self._pods.get(f"{namespace}/{name}")

    def create_pod(self, pod: Pod) -> Pod:
        with self._lock:
            if pod.key in self._pods:
                raise ValueError(f"pod {pod.key} already exists")
            if not pod.uid:
                pod.uid = next_uid("pod")
            self._pods[pod.key] = pod
        self._dispatch(self._pod_handlers, "add", pod)
        return pod

    def update_pod(self, pod: Pod) -> Pod:
        with self._lock:
            old = self._pods.get(pod.key)
            if old is None:
                raise ValueError(f"pod {pod.key} not found")
            self._pods[pod.key] = pod
        self._dispatch(self._pod_handlers, "update", pod)
        return pod

    def delete_pod(self, namespace: str, name: str) -> None:
        key = f"{namespace}/{name}"
        with self._lock:
            pod = self._pods.pop(key, None)
        if pod is not None:
            self._dispatch(self._pod_handlers, "delete", pod)

    def bind_pod(self, namespace: str, name: str, node_name: str) -> None:
        with self._lock:
            pod = self._pods[f"{namespace}/{name}"]
            pod.node_name = node_name
        self._dispatch(self._pod_handlers, "update", pod)

    def set_pod_phase(self, namespace: str, name: str, phase: PodPhase) -> None:
        with self._lock:
            pod = self._pods[f"{namespace}/{name}"]
            pod.phase = phase
        self._dispatch(self._pod_handlers, "update", pod)

    # ---- nodes -------------------------------------------------------
    def list_nodes(self) -> List[Node]:
        with self._lock:
            return list(self._nodes.values())

    def add_node(self, node: Node) -> None:
        with self._lock:
            self._nodes[node.name] = node
        self._dispatch(self._node_handlers, "add", node)

    def update_node(self, node: Node) -> None:
        with self._lock:
            self._nodes[node.name] = node
        self._dispatch(self._node_handlers, "update", node)

    def delete_node(self, name: str) -> None:
        with self._lock:
            node = self._nodes.pop(name, None)
        if node is not None:
            self._dispatch(self._node_handlers, "delete", node)

    # ---- handlers ----------------------------------------------------
    def add_pod_handler(self, handler: EventHandler) -> None:
        self._pod_handlers.append(handler)
        for pod in self.list_pods():
            handler("add", pod)

    def add_node_handler(self, handler: EventHandler) -> None:
        self._node_handlers.append(handler)
        for node in self.list_nodes():
            handler("add", node)

    def _dispatch(self, handlers: List[EventHandler], event: str, obj: object) -> None:
        for handler in list(handlers):
            handler(event, obj)

    # ---- leader-election leases --------------------------------------
    def lease_tryhold(
        self, name: str, identity: str, duration_s: float, now: float
    ) -> str:
        with self._lock:
            holder, expires = self._leases.get(name, ("", 0.0))
            if not holder or now >= expires or holder == identity:
                self._leases[name] = (identity, now + duration_s)
                return identity
            return holder
