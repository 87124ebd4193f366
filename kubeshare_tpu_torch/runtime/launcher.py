"""Per-chip runtime supervisor (ref docker/kubeshare-gemini-scheduler/
launcher.py): port of kubeshare_tpu/runtime/launcher.py, which imports
no JAX; the port keeps its own copy.

One supervisor per chip (here a CUDA device, named by its UUID): starts
the native ``tpushare-tokend`` for the chip, watches the chip's
podmanagerport file, and reconciles the set of ``tpushare-pmgr`` broker
processes (spawn on new pods, kill on removal — ref launcher.py:34-67).
Polling replaces inotify on the Python side (the C++ tokend has inotify
for its own config); the file is atomically renamed into place so a poll
never sees a torn write.
"""

from __future__ import annotations

import contextlib
import os
import signal
import socket
import subprocess
import tempfile
import threading
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

from .. import constants
from ..utils.logger import get_logger

_BINARY_DIRS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "build"),
    "/kubeshare/library",
    "/usr/local/bin",
)


def find_binary(name: str) -> Optional[str]:
    for directory in _BINARY_DIRS:
        path = os.path.abspath(os.path.join(directory, name))
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    return None


def ensure_binary(name: str = "tpushare-tokend") -> str:
    """A native runtime binary (the token daemon, or ``tpushare-pmgr``),
    built from ``native/`` with ``make`` when it is missing (only that
    target: the port needs no PJRT interposer)."""
    binary = find_binary(name)
    if binary is None:
        native = os.path.abspath(os.path.join(_BINARY_DIRS[0], ".."))
        subprocess.run(["make", "-C", native, f"build/{name}"],
                       check=True, capture_output=True, timeout=300)
        binary = find_binary(name)
    if binary is None:
        raise RuntimeError(f"cannot build {name}")
    return binary


class ChipSupervisor:
    def __init__(
        self,
        chip_uuid: str,
        config_dir: str = constants.CHIP_CONFIG_DIR,
        port_dir: str = constants.POD_MANAGER_PORT_DIR,
        tokend_port: int = constants.TOKEND_BASE_PORT,
        base_quota_ms: float = constants.TOKEN_BASE_QUOTA_MS,
        min_quota_ms: float = constants.TOKEN_MIN_QUOTA_MS,
        window_ms: float = constants.TOKEN_WINDOW_MS,
        tokend_binary: Optional[str] = None,
        pmgr_binary: Optional[str] = None,
        poll_interval: float = 0.5,
        log_dir: Optional[str] = None,
        gang_peer_ports: Optional[Tuple[int, ...]] = None,
    ) -> None:
        self.chip_uuid = chip_uuid
        self.config_dir = config_dir
        self.port_dir = port_dir
        self.tokend_port = tokend_port
        self.base_quota_ms = base_quota_ms
        self.min_quota_ms = min_quota_ms
        self.window_ms = window_ms
        # sibling tokend ports on this host (the node's other chips): wired
        # into tokend -G so multi-chip gang pods' grants stay aligned
        self.gang_peer_ports = tuple(gang_peer_ports or ())
        self.tokend_binary = tokend_binary or find_binary("tpushare-tokend")
        self.pmgr_binary = pmgr_binary or find_binary("tpushare-pmgr")
        self.poll_interval = poll_interval
        self.log = get_logger("kubeshare-launcher", log_dir=log_dir)

        self.tokend: Optional[subprocess.Popen] = None
        # "ns/name port" line -> (alive_flag, process)
        self.pod_managers: Dict[str, subprocess.Popen] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def start(self) -> None:
        if self.tokend_binary is None:
            raise RuntimeError("tpushare-tokend binary not found; run `make -C native`")
        os.makedirs(self.config_dir, exist_ok=True)
        os.makedirs(self.port_dir, exist_ok=True)
        config_path = os.path.join(self.config_dir, self.chip_uuid)
        if not os.path.exists(config_path):
            with open(config_path, "w") as f:
                f.write("0\n")
        self._spawn_tokend()
        self.reconcile()
        self._thread = threading.Thread(target=self._watch_loop, daemon=True)
        self._thread.start()

    def _watch_loop(self) -> None:
        path = os.path.join(self.port_dir, self.chip_uuid)
        last_mtime = 0.0
        while not self._stop.is_set():
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                mtime = 0.0
            if mtime != last_mtime:
                last_mtime = mtime
                try:
                    self.reconcile()
                except Exception as e:  # tolerate torn/partial content
                    self.log.warning("reconcile failed: %s", e)
            self._check_processes()
            self._stop.wait(self.poll_interval)

    def _check_processes(self) -> None:
        """Failure detection: restart a crashed tokend; reap+respawn dead
        pod managers (the reference launcher dies with its children,
        ref launcher.py:100-110 — here the supervisor self-heals)."""
        if self.tokend is not None and self.tokend.poll() is not None:
            self.log.warning(
                "tokend for %s exited with %s; restarting",
                self.chip_uuid, self.tokend.returncode,
            )
            self._spawn_tokend()
        dead = [key for key, proc in self.pod_managers.items()
                if proc.poll() is not None]
        for key in dead:
            self.log.warning("pod manager %r died; respawning", key)
            del self.pod_managers[key]
        if dead:
            self.reconcile()

    def _spawn_tokend(self) -> None:
        cmd = [
            self.tokend_binary,
            "-p", self.config_dir,
            "-f", self.chip_uuid,
            "-P", str(self.tokend_port),
            "-q", str(self.base_quota_ms),
            "-m", str(self.min_quota_ms),
            "-w", str(self.window_ms),
        ]
        if self.gang_peer_ports:
            cmd += ["-G", ",".join(str(p) for p in self.gang_peer_ports)]
        self.tokend = subprocess.Popen(cmd, start_new_session=True)

    # ------------------------------------------------------------------
    def read_port_file(self) -> Dict[str, str]:
        """Parse the podmanagerport file into {pod_key: port}
        (ref launcher.py:34-46)."""
        path = os.path.join(self.port_dir, self.chip_uuid)
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            return {}
        if not lines:
            return {}
        try:
            count = int(lines[0])
        except ValueError:
            return {}
        entries: Dict[str, str] = {}
        for line in lines[1 : count + 1]:
            parts = line.split()
            if len(parts) == 2:
                entries[parts[0]] = parts[1]
        return entries

    def reconcile(self) -> None:
        """Spawn/kill pmgr processes to match the port file
        (ref launcher.py:47-67)."""
        desired = self.read_port_file()
        desired_keys = {f"{pod} {port}" for pod, port in desired.items()}
        # kill removed
        for key in list(self.pod_managers):
            if key not in desired_keys:
                proc = self.pod_managers.pop(key)
                self._kill(proc)
                self.log.info("pod manager %r stopped", key)
        # spawn new
        if self.pmgr_binary is None:
            return
        for pod, port in desired.items():
            key = f"{pod} {port}"
            if key in self.pod_managers:
                continue
            env = dict(
                os.environ,
                SCHEDULER_IP="127.0.0.1",
                SCHEDULER_PORT=str(self.tokend_port),
                POD_MANAGER_IP="0.0.0.0",
                POD_MANAGER_PORT=str(port),
                POD_NAME=pod,
            )
            self.pod_managers[key] = subprocess.Popen(
                [self.pmgr_binary], env=env, start_new_session=True
            )
            self.log.info("pod manager %r started on port %s", pod, port)

    # ------------------------------------------------------------------
    def _kill(self, proc: subprocess.Popen) -> None:
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        try:
            proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            pass

    # ------------------------------------------------------------------
    def collect_metrics(self):
        """Translate tokend STAT into Prometheus gauges (observability the
        reference's Gemini side never had — its logs were the only window,
        SURVEY §5)."""
        import json
        import socket as socketlib

        from ..utils.promtext import MetricFamily

        share = MetricFamily("tpushare_pod_share",
                             "Decayed device-time share per pod.", "gauge")
        mem = MetricFamily("tpushare_pod_mem_used_bytes",
                           "Accounted HBM per pod.", "gauge")
        grants = MetricFamily("tpushare_pod_grants_total",
                              "Token grants per pod.", "counter")
        waiters = MetricFamily("tpushare_waiters",
                               "Pods currently waiting for a token.", "gauge")
        try:
            with socketlib.create_connection(
                ("127.0.0.1", self.tokend_port), timeout=2
            ) as sock:
                sock.sendall(b"STAT\n")
                data = sock.makefile().readline()
            stat = json.loads(data)
        except (OSError, ValueError):
            return [share, mem, grants, waiters]
        waiters.add({"chip": self.chip_uuid}, stat.get("waiters", 0))
        for pod, info in stat.get("pods", {}).items():
            labels = {"chip": self.chip_uuid, "pod": pod}
            share.add(labels, info.get("share", 0.0))
            mem.add(labels, info.get("mem_used", 0))
            grants.add(labels, info.get("grants", 0))
        return [share, mem, grants, waiters]

    def serve_metrics(self, port: int = 0):
        from ..utils.promtext import MetricServer

        server = MetricServer(self.collect_metrics, port=port)
        server.start()
        return server

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        for proc in self.pod_managers.values():
            self._kill(proc)
        self.pod_managers.clear()
        if self.tokend is not None:
            self._kill(self.tokend)
            self.tokend = None

    def __enter__(self) -> "ChipSupervisor":
        self.start()
        return self

    def __exit__(self, *exc: object) -> None:
        self.stop()


@contextlib.contextmanager
def cell_tokend(cells: Sequence[Tuple[str, str, str]],
                min_quota_ms: float = 5.0) -> Iterator[int]:
    """A ``tpushare-tokend`` (built if missing) for one chip whose share
    table lists ``cells``, ``(pod, limit, request)`` triples with no
    memory cap, at a 50 ms quota over a 1 s window, under a
    :class:`ChipSupervisor` in a temporary directory; yields the port it
    listens on.  The serving examples' runtime: each pool's guard talks
    to it with its cell's name, with no pod manager between them."""
    from ..utils.atomicfile import write_atomic
    from ..utils.net import wait_listening

    chip_uuid = "demo-chip-0"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="tokend-") as workdir:
        table = "".join(f"{pod} {limit} {request} 0\n"
                        for pod, limit, request in cells)
        write_atomic(os.path.join(workdir, chip_uuid),
                     f"{len(cells)}\n{table}")
        with ChipSupervisor(chip_uuid, config_dir=workdir,
                            port_dir=os.path.join(workdir, "ports"),
                            tokend_port=port, base_quota_ms=50.0,
                            min_quota_ms=min_quota_ms, window_ms=1000.0,
                            tokend_binary=ensure_binary("tpushare-tokend")):
            wait_listening(port)
            yield port
