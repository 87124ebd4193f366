"""Where the native runtime's binaries live: the port's copy of
``find_binary`` from kubeshare_tpu/runtime/launcher.py.  The per-chip
supervisor (``ChipSupervisor``) is not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional

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
