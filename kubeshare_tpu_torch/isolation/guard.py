"""Execution gating and the device-memory cap for PyTorch workloads.

Port of kubeshare_tpu/isolation/guard.py.  The enforcement points on a
CUDA card:

- **Compute share**: the guard brackets each step — acquire a token from
  the chip's tokend, run the step, synchronize the step's device, release
  with the measured wall time.  The step is the unit the broker
  arbitrates, so it should be one device burst: a captured step
  (``make_train_step(..., capture=True)``, one CUDA graph replay) rather
  than an eager one, whose time is mostly the host's dispatch.
- **Memory cap**: placement admission (the scheduler's ``gpu_mem``) is
  the hard guarantee; :func:`apply_hbm_cap` adds the in-process level,
  the caching allocator's per-process fraction (see its docstring for
  what that covers).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Callable, Iterator, Optional, TypeVar

import torch

from .. import constants, resolve_device
from ..utils.logger import get_logger
from .client import TokenClient, connect_from_env

F = TypeVar("F", bound=Callable)


def apply_hbm_cap(environ: Optional[dict] = None,
                  device=None) -> Optional[float]:
    """Install the pod's device-memory cap, ``TPUSHARE_MEM_FRACTION``, as
    the caching allocator's per-process fraction
    (``torch.cuda.set_per_process_memory_fraction``) on ``device`` (the
    current CUDA device by default).  Returns the fraction, or None when
    the variable is unset, empty, not a float, or outside (0, 1].  With
    ``device="cpu"`` it parses and installs nothing.

    What the cap does not cover: it limits only the memory PyTorch's
    caching allocator hands out in this process.  The CUDA context,
    cuBLAS / convolution workspaces that libraries allocate themselves,
    and anything allocated outside the allocator lie outside it, so
    admission (the scheduler's ``gpu_mem``) stays the hard guarantee, as
    in the JAX guard's level 1.  An allocation over the cap raises
    ``torch.OutOfMemoryError`` in this process; co-tenants are untouched.
    """
    env = environ if environ is not None else os.environ
    fraction_raw = env.get(constants.ENV_MEM_FRACTION)
    if not fraction_raw:
        return None
    try:
        fraction = float(fraction_raw)
    except ValueError:
        return None
    if not 0.0 < fraction <= 1.0:
        return None
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_per_process_memory_fraction(fraction, device)
    return fraction


class ExecutionGuard:
    """Token-gates callables that dispatch work to the shared card.

    With no broker configured (solo run, tests) the guard is a
    passthrough, so the same training script runs managed and unmanaged.
    That is the JAX guard's semantics for a missing broker, not a device
    fallback: the step runs on the same device either way.
    """

    def __init__(self, client: Optional[TokenClient] = None,
                 from_env: bool = True, idle_release_ms: float = 200.0) -> None:
        self.log = get_logger("tpushim")
        if client is None and from_env:
            try:
                client = connect_from_env()
            except ConnectionError as e:
                self.log.warning("token broker unreachable, running ungated: %s", e)
                client = None
        self.client = client
        self._estimate_ms = 1.0  # EMA of step wall time
        self._budget_ms = 0.0  # remaining quota on the held token
        self._held_used_ms = 0.0  # device time consumed on the held token
        self._held = False
        self._lock = threading.RLock()
        self._last_activity = 0.0
        self._idle_release_ms = idle_release_ms
        self._in_flight = False  # between acquire() and charge(): a step runs
        self._monitor: Optional[threading.Thread] = None
        self.tokens_acquired = 0
        self.total_gated_ms = 0.0

    @property
    def gated(self) -> bool:
        return self.client is not None

    def __call__(self, fn: F) -> F:
        if self.client is None:
            return fn

        def gated(*args: Any, **kwargs: Any) -> Any:
            self.acquire()
            start = time.monotonic()
            try:
                result = fn(*args, **kwargs)
                _synchronize(result)
            finally:
                elapsed_ms = (time.monotonic() - start) * 1e3
                self.charge(elapsed_ms)
            return result

        gated.__name__ = getattr(fn, "__name__", "gated")
        return gated  # type: ignore[return-value]

    def acquire(self) -> float:
        """Ensure a token with remaining budget is held.

        Tokens are *budgeted*: one grant covers many steps until its quota
        (ms of device time) is consumed — the Gemini token model (quota
        20-300 ms per grant), without a broker round trip per step.  A
        monitor thread returns a held token after ``idle_release_ms`` of
        inactivity so an idle workload never starves co-tenants (relevant
        under the exclusive tokend mode).
        """
        if self.client is None:
            return 0.0
        with self._lock:
            self._last_activity = time.monotonic()
            self._in_flight = True  # a step follows; idle monitor backs off
            # reuse the held token only when its remaining budget covers
            # the coming burst: a full step on a sliver of leftover budget
            # overdraws the grant and skips the broker's re-arbitration
            if self._held and self._budget_ms >= 0.5 * self._estimate_ms:
                return self._budget_ms
            if self._held:
                self._release_held()
            quota = self.client.acquire(self._estimate_ms)
            self.tokens_acquired += 1
            self._held = True
            self._budget_ms = quota
            self._held_used_ms = 0.0
            self._ensure_monitor()
            return quota

    def charge(self, elapsed_ms: float) -> None:
        """Consume budget for one step; release the token when exhausted."""
        if self.client is None:
            return
        with self._lock:
            self._last_activity = time.monotonic()
            self._in_flight = False
            self._estimate_ms = 0.8 * self._estimate_ms + 0.2 * elapsed_ms
            self.total_gated_ms += elapsed_ms
            self._budget_ms -= elapsed_ms
            self._held_used_ms += elapsed_ms
            # release at the step boundary once the budget cannot fund
            # another burst: holding a near-empty token through the
            # caller's input-pipeline wait idles the card for the wait
            # (the waiter is parked broker-side), while a budget still
            # worth a step keeps amortizing grants over many steps
            if self._held and self._budget_ms < 0.5 * self._estimate_ms:
                self._release_held()

    def finish(self) -> None:
        """Return any held token (call when the workload goes idle)."""
        with self._lock:
            if self._held:
                self._release_held()

    def _release_held(self) -> None:
        assert self.client is not None
        self.client.release(self._held_used_ms)
        self._held = False
        self._budget_ms = 0.0
        self._held_used_ms = 0.0

    def _ensure_monitor(self) -> None:
        if self._monitor is not None or self._idle_release_ms <= 0:
            return

        def watch() -> None:
            while True:
                time.sleep(self._idle_release_ms / 1e3 / 4)
                with self._lock:
                    idle_ms = (time.monotonic() - self._last_activity) * 1e3
                    # never release mid-step: a long execution (a first
                    # step's build and capture) between acquire and charge
                    # is not idleness
                    if (self._held and not self._in_flight
                            and idle_ms >= self._idle_release_ms):
                        try:
                            self._release_held()
                        except ConnectionError:
                            # broker gone (teardown/restart); it reclaims the
                            # token via its own drop handling
                            self._held = False
                            self._budget_ms = 0.0

        self._monitor = threading.Thread(target=watch, daemon=True)
        self._monitor.start()

    def request_memory(self, delta_bytes: int) -> bool:
        if self.client is None:
            return True
        ok, used, cap = self.client.request_memory(delta_bytes)
        if not ok:
            self.log.warning(
                "HBM request denied: used %d + %d > cap %d", used, delta_bytes, cap
            )
        return ok


def _tensors(result: Any) -> Iterator[torch.Tensor]:
    """The tensors in a result: tensors, and tuples, lists, dicts and
    dataclasses (a ``TrainState``) of them."""
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, (tuple, list)):
        for item in result:
            yield from _tensors(item)
    elif isinstance(result, dict):
        for item in result.values():
            yield from _tensors(item)
    elif dataclasses.is_dataclass(result) and not isinstance(result, type):
        for field in dataclasses.fields(result):
            yield from _tensors(getattr(result, field.name))


def _synchronize(result: Any) -> None:
    """Wait for the devices of the step's result, so that the measured
    time covers the device's burst and not only the host's enqueue (a
    no-op for CPU tensors).  A result that holds no tensor the walk can
    see (None, a number, an object of its own) waits for the current
    CUDA device once CUDA is in use: the step enqueued its work there."""
    tensors = list(_tensors(result))
    if tensors:
        devices = {t.device for t in tensors if t.device.type == "cuda"}
    elif torch.cuda.is_initialized():
        devices = {torch.device("cuda", torch.cuda.current_device())}
    else:
        devices = set()
    for device in devices:
        torch.cuda.synchronize(device)


def token_gated(fn: F) -> F:
    """Decorator: gate a step function with an env-configured guard."""
    return ExecutionGuard()(fn)
