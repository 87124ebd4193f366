"""Per-node chip-inventory exporter (ref pkg/collector): port of
kubeshare_tpu/collector/collector.py.

Exports one ``gpu_capacity`` sample per local CUDA device — the same
wire format as the JAX package's exporter and the reference's NVML-based
one (ref pkg/collector/collector.go:42-60): labels node/uuid/model/
memory/index, value = scrape unix time, and a ``coords`` label when a
chip has mesh coordinates (a CUDA device has none).

A CUDA card with a link record (``cell.topology.LinkRecord``: NVML and
sysfs, see ``discover_local_chips``) adds one label, ``topo``:

    topo="<bus id>;<NUMA node>;<PCIe upstream path>;<NVLink domain>"

e.g. ``topo="00000000:18:00.0;0;pci0000:15/0000:15:01.0/0000:16:00.0/0000:17:00.0;nvswitch"``:
the bus id in NVML's form, the NUMA node (-1 for none), the bridges from
the root complex down to the card's parent joined by ``/`` (empty
without a sysfs PCI tree), and the NVLink domain (``nvswitch``, the
lowest bus id of a bridged group, or empty).  A chip without a record
exports exactly the JAX package's labels, and the JAX package's
``PromInventory`` ignores ``topo``, so either scheduler reads either
collector.  ``PromInventory`` reads the label back; a malformed one
means no record, as a malformed ``coords`` means no coordinates.

Enumeration is behind a callable so tests and daemons inject fakes; the
real backend, :class:`CudaEnumerator`, walks ``torch.cuda`` through
``cell.topology.discover_local_chips`` in place of the JAX package's
PJRT walk.
"""

from __future__ import annotations

import socket
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence

from .. import constants
from ..cell.allocator import ChipInfo
from ..cell.topology import LinkRecord
from ..utils.logger import get_logger
from ..utils.promtext import MetricFamily, MetricServer, parse_text

Enumerator = Callable[[], List[ChipInfo]]


class FakeEnumerator:
    def __init__(self, chips: Sequence[ChipInfo]):
        self._chips = list(chips)

    def __call__(self) -> List[ChipInfo]:
        return list(self._chips)


class CudaEnumerator:
    """Enumeration through ``torch.cuda``; a host without a CUDA device
    exports nothing (the reference idles when NVML init fails,
    ref cmd/kubeshare-collector/main.go:42-49).

    Discovery runs under a timeout: a wedged driver can HANG device
    enumeration, and a hung enumerator would stall every scrape — a
    failed enumeration exports nothing (the scheduler then treats the
    node as chipless), a hung one the last inventory it knew, until the
    driver recovers.
    """

    def __init__(self, timeout_s: float = 60.0):
        self._timeout_s = timeout_s
        self._log = get_logger("kubeshare-collector")
        self._cache: List[ChipInfo] = []

    def __call__(self) -> List[ChipInfo]:
        import threading

        result: List[List[ChipInfo]] = []

        def discover() -> None:
            try:
                from ..cell import topology

                result.append(topology.discover_local_chips())
            except Exception as e:  # no driver / no CUDA runtime
                self._log.warning("chip enumeration failed: %s", e)
                result.append([])

        worker = threading.Thread(target=discover, daemon=True)
        worker.start()
        worker.join(timeout=self._timeout_s)
        if not result:
            self._log.warning(
                "chip enumeration hung > %.0fs; exporting last-known inventory",
                self._timeout_s,
            )
            return list(self._cache)
        self._cache = result[0]
        return list(result[0])


class Collector:
    def __init__(
        self,
        enumerate_chips: Enumerator,
        node_name: Optional[str] = None,
    ) -> None:
        self.enumerate_chips = enumerate_chips
        self.node_name = node_name or socket.gethostname()

    def collect(self) -> List[MetricFamily]:
        family = MetricFamily(
            constants.METRIC_CAPACITY, "TPU chip information (HBM in bytes)."
        )
        now = float(int(time.time()))
        for chip in self.enumerate_chips():
            labels = {
                "node": self.node_name,
                "uuid": chip.uuid,
                "model": chip.model,
                "memory": str(chip.memory),
                "index": str(chip.index),
            }
            if chip.coords is not None:
                labels["coords"] = ",".join(str(c) for c in chip.coords)
            if chip.links is not None:
                labels["topo"] = chip.links.label()
            family.add(labels, now)
        return [family]

    def serve(self, port: int = constants.COLLECTOR_PORT) -> MetricServer:
        server = MetricServer(self.collect, port=port, path="/kubeshare-collector")
        server.start()
        return server


class PromInventory:
    """Scheduler-side inventory provider backed by capacity scrapes.

    Replaces the reference's Prometheus ``Series`` query per node
    (ref pkg/scheduler/gpu.go:22-53) with a direct scrape of collector
    endpoints (or of a Prometheus federation endpoint exposing the same
    series).  Results are cached per node for ``ttl`` seconds.
    """

    def __init__(self, urls: Sequence[str], ttl: float = 5.0) -> None:
        self.urls = list(urls)
        self.ttl = ttl
        self._cache: Dict[str, List[ChipInfo]] = {}
        self._fetched_at = 0.0
        self._log = get_logger("kubeshare-scheduler")

    def __call__(self, node_name: str) -> List[ChipInfo]:
        now = time.time()
        if now - self._fetched_at > self.ttl:
            self._refresh()
            self._fetched_at = now
        return self._cache.get(node_name, [])

    def _refresh(self) -> None:
        cache: Dict[str, List[ChipInfo]] = {}
        any_success = False
        for url in self.urls:
            try:
                text = urllib.request.urlopen(url, timeout=5).read().decode()
                any_success = True
            except Exception as e:
                self._log.warning("inventory scrape %s failed: %s", url, e)
                continue
            for sample in parse_text(text):
                if sample.name != constants.METRIC_CAPACITY:
                    continue
                labels = sample.labels
                coords = None
                if labels.get("coords"):
                    try:
                        coords = tuple(
                            int(x) for x in labels["coords"].split(",")
                        )
                    except ValueError:
                        coords = None
                try:
                    memory = int(labels.get("memory", "0"))
                    index = int(labels.get("index", "0"))
                except ValueError:
                    continue
                chip = ChipInfo(
                    uuid=labels.get("uuid", ""),
                    memory=memory,
                    model=labels.get("model", ""),
                    index=index,
                    coords=coords,
                )
                if labels.get("topo"):
                    chip.links = LinkRecord.from_label(labels["topo"])
                cache.setdefault(labels.get("node", ""), []).append(chip)
        if any_success:
            self._cache = cache
        # else: keep last-known-good inventory through transient scrape outages
