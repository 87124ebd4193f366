"""Prometheus text-exposition-format encoding and a minimal scrape server.

The port's own copy of kubeshare_tpu/utils/promtext.py (the port imports
nothing of the JAX package).

The reference uses prometheus/client_golang and a prometheus-operator
ServiceMonitor as its metadata bus (ref pkg/collector/collector.go:30-60,
pkg/aggregator/aggregator.go:22-67).  We keep wire-format parity — the
``gpu_capacity`` / ``gpu_requirement`` series are byte-for-byte scrapeable by
a stock Prometheus — without depending on a client library.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Sequence, Tuple


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


@dataclass
class Sample:
    name: str
    labels: Dict[str, str]
    value: float

    def encode(self) -> str:
        if self.labels:
            inner = ",".join(
                f'{k}="{_escape_label_value(str(v))}"'
                for k, v in sorted(self.labels.items())
            )
            return f"{self.name}{{{inner}}} {_format_value(self.value)}"
        return f"{self.name} {_format_value(self.value)}"


def _format_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


@dataclass
class MetricFamily:
    name: str
    help: str
    kind: str = "counter"
    samples: List[Sample] = field(default_factory=list)

    def add(self, labels: Dict[str, str], value: float) -> None:
        self.samples.append(Sample(self.name, labels, value))

    def encode(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        lines.extend(s.encode() for s in self.samples)
        return "\n".join(lines) + "\n"


def encode_families(families: Sequence[MetricFamily]) -> str:
    return "".join(f.encode() for f in families)


def parse_text(text: str) -> List[Sample]:
    """Parse exposition text back into samples (the scheduler-side consumer).

    Replaces the reference's PromQL ``Series`` queries (ref pkg/scheduler/
    gpu.go:22-37): our components scrape each other directly over HTTP, or —
    preferred, in-process — skip the round trip entirely.
    """
    samples: List[Sample] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        if not name_part:
            continue
        # exposition lines may carry an optional trailing timestamp
        # ("name{...} value ts"); peel it so foreign exporters parse too
        head, _, prev = name_part.rpartition(" ")
        if head and ("}" in head or "{" not in name_part):
            try:
                float(value_part)
                float(prev)
            except ValueError:
                pass
            else:
                name_part, value_part = head, prev
        labels: Dict[str, str] = {}
        name = name_part
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            rest = rest.rsplit("}", 1)[0]
            labels = _parse_labels(rest)
        try:
            value = float(value_part)
        except ValueError:
            continue
        samples.append(Sample(name, labels, value))
    return samples


def _parse_labels(body: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    i = 0
    n = len(body)
    while i < n:
        eq = body.find("=", i)
        if eq < 0:
            break
        key = body[i:eq].strip().lstrip(",").strip()
        j = eq + 1
        if j >= n or body[j] != '"':
            break
        j += 1
        buf = []
        while j < n:
            c = body[j]
            if c == "\\" and j + 1 < n:
                nxt = body[j + 1]
                buf.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
                continue
            if c == '"':
                break
            buf.append(c)
            j += 1
        labels[key] = "".join(buf)
        i = j + 1
    return labels


class MetricServer:
    """Tiny threaded HTTP server exposing a metrics callback on a path.

    Equivalent to promhttp.Handler on ``:9004/kubeshare-collector`` /
    ``:9005/kubeshare-aggregator`` (ref cmd/kubeshare-collector/main.go:23-24).
    """

    def __init__(
        self,
        collect: Callable[[], Sequence[MetricFamily]],
        port: int = 0,
        path: str = "/metrics",
    ) -> None:
        self._collect = collect
        self._path = path
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802
                if self.path.split("?")[0] not in (outer._path, "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = encode_families(outer._collect()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args: object) -> None:
                pass

        self._server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
