"""Small TCP helpers shared by the launchers, examples, and tests.

The port's own copy of kubeshare_tpu/utils/net.py.
"""

from __future__ import annotations

import socket
import time


def wait_listening(
    port: int,
    host: str = "127.0.0.1",
    deadline_s: float = 15.0,
    poll_s: float = 0.05,
) -> None:
    """Block until something accepts on ``host:port`` or raise TimeoutError.

    The native runtime (tokend, per-pod pmgr brokers) comes up
    asynchronously under the supervisor; a fixed sleep races their accept
    loops on a loaded host, so every driver polls with this instead.
    """
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        try:
            socket.create_connection((host, port), timeout=0.5).close()
            return
        except OSError:
            time.sleep(poll_s)
    raise TimeoutError(f"nothing listening on {host}:{port}")
