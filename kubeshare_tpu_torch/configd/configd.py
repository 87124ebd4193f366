"""Per-node config daemon: placement decisions -> token-runtime config files
(ref pkg/config).

The port's copy of kubeshare_tpu/configd/configd.py: the files it writes
equal the JAX daemon's byte for byte, and the same ``tpushare-tokend`` and
``tpushare-pmgr`` read them for a node of CUDA cards.

Watches shared pods scheduled to this node and (re)writes two file families
per chip UUID on the hostPath bus (ref pkg/config/query.go:43-105):

- ``config/<UUID>``: line 1 = N pods, then ``ns/name limit request memory``
- ``podmanagerport/<UUID>``: line 1 = N, then ``ns/name port``

The C++ tokend/launcher consume these.  Decision source is the cluster API
directly (the scheduler's annotations are authoritative) — dropping the
reference's Prometheus round-trip, its acknowledged weak point
(ref README.md:141 "Modify the prometheus to etcd"); an aggregator-scrape
mode is available for deployments that want the reference wiring.
"""

from __future__ import annotations

import os
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from .. import constants
from ..cluster.api import ClusterAPI, Pod
from ..utils.atomicfile import write_atomic
from ..utils.logger import get_logger
from ..utils.promtext import parse_text


def write_scheduler_ip(ip: str, library_path: str = constants.LIBRARY_PATH) -> str:
    """ref cmd/kubeshare-query-ip/main.go:22-34: record the node daemon's IP
    where in-pod shims can find it."""
    os.makedirs(library_path, exist_ok=True)
    path = os.path.join(library_path, "schedulerIP.txt")
    write_atomic(path, ip + "\n")
    return path


# one pod's share entry: (ns/name, limit, request, memory) and (ns/name, port)
ShareEntry = Tuple[str, str, str, str]
PortEntry = Tuple[str, str]


class ConfigDaemon:
    def __init__(
        self,
        node_name: str,
        cluster: Optional[ClusterAPI] = None,
        aggregator_url: Optional[str] = None,
        config_dir: str = constants.CHIP_CONFIG_DIR,
        port_dir: str = constants.POD_MANAGER_PORT_DIR,
        on_change: Optional[Callable[[], None]] = None,
    ) -> None:
        if cluster is None and aggregator_url is None:
            raise ValueError("need a cluster API or an aggregator URL")
        self.node_name = node_name
        self.cluster = cluster
        self.aggregator_url = aggregator_url
        self.config_dir = config_dir
        self.port_dir = port_dir
        self.on_change = on_change
        self.log = get_logger("kubeshare-config")
        os.makedirs(config_dir, exist_ok=True)
        os.makedirs(port_dir, exist_ok=True)
        if cluster is not None:
            cluster.add_pod_handler(self._on_pod_event)

    # ------------------------------------------------------------------
    def _on_pod_event(self, event: str, obj: object) -> None:
        pod = obj
        if not isinstance(pod, Pod) or not self._is_shared_pod(pod):
            return
        self.sync()

    def _is_shared_pod(self, pod: Pod) -> bool:
        """ref pkg/config/config.go:100-124: scheduled pods with fractional
        limit."""
        if pod.node_name != self.node_name:
            return False
        limit = pod.labels.get(constants.POD_GPU_LIMIT)
        if limit is None:
            return False
        try:
            return float(limit) <= 1.0
        except ValueError:
            return False

    # ------------------------------------------------------------------
    def query_decision(self) -> Tuple[Dict[str, List[ShareEntry]], Dict[str, List[PortEntry]]]:
        """Placement for this node, grouped by chip UUID
        (ref query.go:22-67)."""
        if self.cluster is not None:
            return self._query_cluster()
        return self._query_aggregator()

    def _query_cluster(self):
        shares: Dict[str, List[ShareEntry]] = {}
        ports: Dict[str, List[PortEntry]] = {}
        assert self.cluster is not None
        for pod in self.cluster.list_pods(scheduler_name=constants.SCHEDULER_NAME):
            if not self._is_shared_pod(pod) or pod.is_completed():
                continue
            uuid = pod.annotations.get(constants.POD_GPU_UUID, "")
            if not uuid or "," in uuid:
                continue  # not placed yet / multi-chip pods are not shared
            limit = pod.labels.get(constants.POD_GPU_LIMIT, "0.0")
            request = pod.labels.get(constants.POD_GPU_REQUEST, "0.0")
            memory = pod.annotations.get(
                constants.POD_GPU_MEMORY,
                pod.labels.get(constants.POD_GPU_MEMORY, "0"),
            )
            port = pod.annotations.get(constants.POD_MANAGER_PORT, "0")
            shares.setdefault(uuid, []).append((pod.key, limit, request, memory))
            ports.setdefault(uuid, []).append((pod.key, port))
        return shares, ports

    def _query_aggregator(self):
        shares: Dict[str, List[ShareEntry]] = {}
        ports: Dict[str, List[PortEntry]] = {}
        assert self.aggregator_url is not None
        try:
            text = urllib.request.urlopen(self.aggregator_url, timeout=5).read().decode()
        except Exception as e:
            self.log.warning("aggregator scrape failed: %s", e)
            return shares, ports
        for sample in parse_text(text):
            if sample.name != constants.METRIC_REQUIREMENT:
                continue
            labels = sample.labels
            if labels.get("node") != self.node_name:
                continue
            uuid = labels.get("uuid", "")
            if not uuid or "," in uuid:
                continue  # not placed yet / multi-chip pods are not shared
            try:
                request = float(labels.get("request", "0"))
            except ValueError:
                continue
            if request > 1.0:
                continue
            key = f"{labels.get('namespace', '')}/{labels.get('pod', '')}"
            shares.setdefault(uuid, []).append(
                (key, labels.get("limit", "0"), labels.get("request", "0"),
                 labels.get("memory", "0"))
            )
            ports.setdefault(uuid, []).append((key, labels.get("port", "0")))
        return shares, ports

    # ------------------------------------------------------------------
    def sync(self) -> None:
        """Write config + port files for every chip (ref query.go:70-138);
        chips that lost all pods are reset to '0'."""
        shares, ports = self.query_decision()
        for uuid, entries in shares.items():
            data = f"{len(entries)}\n" + "".join(
                f"{key} {limit} {request} {memory}\n"
                for key, limit, request, memory in entries
            )
            self._write_if_changed(os.path.join(self.config_dir, uuid), data)
        for uuid, entries in ports.items():
            data = f"{len(entries)}\n" + "".join(
                f"{key} {port}\n" for key, port in entries
            )
            self._write_if_changed(os.path.join(self.port_dir, uuid), data)
        # reset files for chips with no remaining shared pods
        for directory, live in ((self.config_dir, shares), (self.port_dir, ports)):
            for name in os.listdir(directory):
                if name.startswith("."):
                    continue
                if name not in live:
                    self._write_if_changed(os.path.join(directory, name), "0\n")
        if self.on_change is not None:
            self.on_change()

    def _write_if_changed(self, path: str, data: str) -> None:
        """Skip no-op rewrites: every mtime change fires tokend inotify
        reloads and launcher reconciles node-wide."""
        try:
            with open(path) as f:
                if f.read() == data:
                    return
        except OSError:
            pass
        write_atomic(path, data)
