"""Token-protocol clients: the in-process half of runtime isolation.

The port's own copy of kubeshare_tpu/isolation/client.py (the port
imports nothing of the JAX package).  Speaks the tokend/pmgr wire
protocol (see native/tokend.cc), unchanged: ``tpushare-tokend`` and
``tpushare-pmgr`` serve JAX and PyTorch pods alike.  Two
implementations with one interface:

- ``TokenClient``: pure Python sockets — the default for in-process
  gating (:class:`~kubeshare_tpu_torch.isolation.guard.ExecutionGuard`;
  no LD_PRELOAD required).
- ``NativeTokenClient``: ctypes over ``libtpushare_client.so`` — the same C
  code the PJRT interposer uses, for bit-identical behavior with the
  LD_PRELOAD path.
"""

from __future__ import annotations

import ctypes
import os
import socket
import time
import zlib
from typing import Optional, Tuple

from .. import constants


class TokenClient:
    # Transient-failure retry policy: attempt 0 plus ``max_retries``
    # retries, exponential backoff with deterministic jitter (seeded
    # from pod_name so two pods never sync their retry storms, yet the
    # same pod replays the same schedule).
    BACKOFF_BASE_S = 0.05
    BACKOFF_CAP_S = 1.0

    def __init__(self, host: str, port: int, pod_name: str, timeout: float = 60.0,
                 max_retries: int = 3):
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.host = host
        self.port = port
        self.pod_name = pod_name
        self.timeout = timeout
        self.max_retries = max_retries
        self._sock: Optional[socket.socket] = None
        self._file = None
        self._blocking_ok = True  # cleared when the daemon lacks REQB
        # chaos seam: a FaultClock here injects transient refusals
        self.fault_clock = None
        self.retry_counts = {"retried": 0, "recovered": 0, "exhausted": 0}

    # -- wire ----------------------------------------------------------
    def _connect(self) -> None:
        if self._sock is not None:
            return
        sock = socket.create_connection((self.host, self.port), timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._file = sock.makefile("rw", newline="\n")

    def _backoff_s(self, retry: int) -> float:
        base = min(self.BACKOFF_CAP_S, self.BACKOFF_BASE_S * (2 ** retry))
        jitter = zlib.crc32(f"{self.pod_name}:{retry}".encode()) % 1000 / 1000.0
        return base * (0.75 + 0.5 * jitter)

    def _sleep(self, seconds: float) -> None:
        if self.fault_clock is not None:
            self.fault_clock.advance(seconds)  # virtual time under chaos
        else:
            time.sleep(seconds)

    def _round_trip(self, request: str) -> str:
        verb = request.split(" ", 1)[0].strip()
        last_error = "no attempt made"
        for attempt in range(self.max_retries + 1):
            if attempt > 0:
                self.retry_counts["retried"] += 1
                self._sleep(self._backoff_s(attempt - 1))
            if (self.fault_clock is not None
                    and self.fault_clock.on_tokend_request(verb)):
                last_error = "injected transient refusal"
                self.close()
                continue
            try:
                self._connect()
                assert self._file is not None
                self._file.write(request)
                self._file.flush()
                reply = self._file.readline()
                if reply:
                    if attempt > 0:
                        self.retry_counts["recovered"] += 1
                    return reply.strip()
                last_error = "connection closed by peer"
            except OSError as e:
                last_error = str(e) or type(e).__name__
            self.close()
        self.retry_counts["exhausted"] += 1
        raise ConnectionError(
            f"token endpoint {self.host}:{self.port} unreachable after "
            f"{self.max_retries + 1} attempts ({verb}: {last_error})")

    def collect_metrics(self):
        """Retry counters as a prom family (lazy import keeps the wire
        client free of a hard metrics dependency)."""
        from ..utils.promtext import MetricFamily, Sample

        return [MetricFamily(
            "kubeshare_tokend_retries_total",
            "Tokend round-trip retries by outcome.", "counter",
            [Sample("kubeshare_tokend_retries_total", {"outcome": k}, float(v))
             for k, v in sorted(self.retry_counts.items())])]

    # -- protocol ------------------------------------------------------
    # server-side park per blocking request; re-issued until granted
    BLOCKING_WINDOW_MS = 2000.0

    def acquire(self, est_ms: float = 0.0) -> float:
        """Block until granted a compute token; returns the quota in ms.

        Uses the long-poll ``REQB`` verb: this client sends RET from the
        same synchronous step loop (never from a runtime callback), so
        the connection can safely park server-side and the handoff is
        event-driven — a released token wakes this waiter immediately
        instead of at a poll tick (the polling alternative measurably
        costs the co-run bench on a serial-core host; tokend.cc protocol
        notes).  Falls back to ``REQ`` polling against an older daemon
        that answers ``ERR`` for REQB."""
        import time

        while True:
            start = time.monotonic()
            if self._blocking_ok:
                reply = self._round_trip(
                    f"REQB {self.pod_name} {est_ms:.3f} "
                    f"{self.BLOCKING_WINDOW_MS:.0f}\n")
                if reply.startswith("ERR"):
                    self._blocking_ok = False
                    continue
            else:
                reply = self._round_trip(f"REQ {self.pod_name} {est_ms:.3f}\n")
            if reply.startswith("TOK "):
                return float(reply[4:])
            if reply.startswith("WAIT "):
                # A WAIT that came back well before the park window means
                # the server answered poll-shaped — an old daemon (REQ) or
                # a gang-gated one (-G degrades REQB to REQ; peer
                # consultation cannot park).  Honor the retry hint there;
                # a WAIT after a full park re-issues immediately.
                elapsed_ms = (time.monotonic() - start) * 1e3
                if (not self._blocking_ok
                        or elapsed_ms < self.BLOCKING_WINDOW_MS / 2):
                    time.sleep(min(0.1, max(0.001, float(reply[5:]) / 1e3)))
                continue
            raise ConnectionError(f"unexpected token reply: {reply!r}")

    def release(self, used_ms: float) -> None:
        self._round_trip(f"RET {self.pod_name} {used_ms:.3f}\n")

    def cancel(self) -> None:
        """Roll back the newest grant with zero charge (gang unwind).

        RET retires the pod's *oldest* grant FIFO-style — under overlapped
        dispatch that would release a legitimately in-flight token; CAN
        pops the just-granted one."""
        self._round_trip(f"CAN {self.pod_name}\n")

    def request_memory(self, delta_bytes: int) -> Tuple[bool, int, int]:
        """Account an HBM delta; returns (granted, used, cap)."""
        reply = self._round_trip(f"MEM {self.pod_name} {delta_bytes}\n")
        parts = reply.split()
        if not parts or parts[0] not in ("OK", "DENY"):
            raise ConnectionError(f"unexpected mem reply: {reply!r}")
        ok = parts[0] == "OK"
        used = int(parts[1]) if len(parts) > 1 else 0
        cap = int(parts[2]) if len(parts) > 2 else 0
        return ok, used, cap

    def stat(self) -> str:
        return self._round_trip("STAT\n")

    def ping(self) -> None:
        """Eagerly verify the broker is reachable (raises ConnectionError)."""
        try:
            self._connect()
        except OSError as e:
            raise ConnectionError(
                f"token endpoint {self.host}:{self.port} unreachable"
            ) from e

    def close(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


class GangTokenClient:
    """One token client spanning the chips of a multi-chip (gang) pod.

    Wraps a ``TokenClient`` per chip broker behind the single-client
    interface ``ExecutionGuard`` expects.  Chips are acquired in sorted
    (host, port) order — a global lock order, so two gang pods sharing the
    same chip set cannot hold-and-wait each other under the exclusive
    tokend mode — and released together.  Server side, sibling tokends
    launched with ``-G`` cross-check eligibility before granting, so by the
    time the first chip grants, every chip of the gang is within one
    quantum of granting: per-chip shares advance in lockstep and
    synchronous collectives see uniform pacing (VERDICT r1 #9).

    HBM deltas are charged to every chip's ledger: a gang pod's dominant
    buffers (replicated parameters/optimizer state under data parallelism)
    exist on each chip, so the replicated charge is the accurate model; a
    deny on any chip rolls back the chips already charged.
    """

    def __init__(self, clients):
        if not clients:
            raise ValueError("gang client needs at least one endpoint")
        self.clients = sorted(clients, key=lambda c: (c.host, c.port))
        self.pod_name = self.clients[0].pod_name

    def acquire(self, est_ms: float = 0.0) -> float:
        quotas = []
        for i, client in enumerate(self.clients):
            try:
                quotas.append(client.acquire(est_ms))
            except Exception:
                # a chip that failed mid-gang must not leave earlier chips
                # held (under exclusive tokend mode a leaked hold blocks
                # every co-tenant until this process dies); CAN pops the
                # just-granted token — RET would retire the oldest one
                for held in self.clients[:i]:
                    try:
                        held.cancel()
                    except Exception:
                        pass
                raise
        return min(quotas)  # budget bounded by the tightest chip

    def release(self, used_ms: float) -> None:
        first_error: Optional[Exception] = None
        for client in self.clients:
            try:
                client.release(used_ms)
            except Exception as e:  # keep returning the other chips' tokens
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error

    def request_memory(self, delta_bytes: int) -> Tuple[bool, int, int]:
        charged = []
        try:
            for client in self.clients:
                ok, used, cap = client.request_memory(delta_bytes)
                if not ok:
                    self._credit(charged, delta_bytes)
                    return False, used, cap
                charged.append(client)
        except Exception:
            # a broker that *errors* (vs a clean DENY) mid-gang must not
            # leave earlier chips' ledgers charged: tokend's disconnect
            # Abandon refunds tokens but never MEM, so a missed credit
            # here would shrink the pod's headroom permanently
            self._credit(charged, delta_bytes)
            raise
        return True, used, cap

    @staticmethod
    def _credit(charged, delta_bytes: int) -> None:
        for done in charged:
            try:
                done.request_memory(-delta_bytes)
            except Exception:
                pass  # crediting is best-effort during unwind

    def stat(self) -> str:
        return "[" + ",".join(client.stat() for client in self.clients) + "]"

    def ping(self) -> None:
        for client in self.clients:
            client.ping()

    def close(self) -> None:
        for client in self.clients:
            client.close()


class NativeTokenClient:
    """ctypes binding over the C client (native/shim/client.cc).

    ``port`` may be an int or a comma-separated string of gang broker
    ports — the C client handles multi-endpoint acquire/release/MEM with
    the same rollback semantics as :class:`GangTokenClient`."""

    def __init__(self, host: str, port, pod_name: str,
                 library_path: Optional[str] = None):
        path = library_path or _find_client_library()
        if path is None:
            raise RuntimeError(
                "libtpushare_client.so not found; run `make -C native`"
            )
        lib = ctypes.CDLL(path)
        lib.tpushare_connect_ports.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p
        ]
        lib.tpushare_connect_ports.restype = ctypes.c_int
        lib.tpushare_acquire.argtypes = [ctypes.c_double]
        lib.tpushare_acquire.restype = ctypes.c_double
        lib.tpushare_release.argtypes = [ctypes.c_double]
        lib.tpushare_release.restype = ctypes.c_int
        lib.tpushare_mem_request.argtypes = [ctypes.c_longlong]
        lib.tpushare_mem_request.restype = ctypes.c_int
        self._lib = lib
        self.pod_name = pod_name
        ports = str(port)
        if lib.tpushare_connect_ports(
                host.encode(), ports.encode(), pod_name.encode()) != 0:
            raise ConnectionError(f"token endpoint {host}:{ports} unreachable")

    def acquire(self, est_ms: float = 0.0) -> float:
        quota = self._lib.tpushare_acquire(est_ms)
        if quota < 0:
            raise ConnectionError("token acquire failed")
        return quota

    def release(self, used_ms: float) -> None:
        self._lib.tpushare_release(used_ms)

    def request_memory(self, delta_bytes: int) -> Tuple[bool, int, int]:
        result = self._lib.tpushare_mem_request(delta_bytes)
        if result < 0:
            raise ConnectionError("mem request failed")
        return bool(result), 0, 0

    def close(self) -> None:
        self._lib.tpushare_disconnect()


def _find_client_library() -> Optional[str]:
    candidates = (
        os.path.join(
            os.path.dirname(__file__), "..", "..", "native", "build",
            "libtpushare_client.so",
        ),
        os.path.join(constants.LIBRARY_PATH, "libtpushare_client.so"),
    )
    for path in candidates:
        path = os.path.abspath(path)
        if os.path.isfile(path):
            return path
    return None


def connect_from_env(native: bool = False) -> Optional[TokenClient]:
    """Build a client from the scheduler-injected env (POD_MANAGER_PORT /
    POD_NAME), mirroring the shim's endpoint resolution.  Returns None when
    the pod is not token-managed (whole-chip or regular pods)."""
    port = os.environ.get(constants.ENV_POD_MANAGER_PORT)
    if not port:
        return None
    pod_name = os.environ.get(constants.ENV_POD_NAME, "unknown/unknown")
    host = os.environ.get("POD_MANAGER_IP", "")
    if not host:
        ip_file = os.environ.get(
            "TPUSHARE_SCHEDULER_IP_FILE", constants.SCHEDULER_IP_FILE
        )
        try:
            host = open(ip_file).read().strip()
        except OSError:
            host = "127.0.0.1"
    host = host or "127.0.0.1"
    if "," in port:
        # multi-chip gang pod: one broker per chip, comma-separated ports
        # (the scheduler injects them in chip order; sorted-order acquire
        # is the gang lock order)
        if native:
            return NativeTokenClient(host, port, pod_name)
        members = [
            TokenClient(host, int(p), pod_name)
            for p in port.split(",") if p.strip()
        ]
        gang = GangTokenClient(members)
        gang.ping()
        return gang
    if native:
        return NativeTokenClient(host, int(port), pod_name)
    client = TokenClient(host, int(port), pod_name)
    client.ping()  # surface an unreachable broker at setup, not mid-training
    return client
