"""Atomic config-file writes for the hostPath bus.

The port's own copy of kubeshare_tpu/utils/atomicfile.py.

The reference writes per-chip config files in place (ref pkg/config/
query.go:70-105) and its launcher tolerates torn reads with a bare
``except`` (ref launcher.py:96-98).  We write tmp+rename so consumers
(inotify/poll watchers, the C++ tokend) never observe a partial file.
"""

from __future__ import annotations

import os
import tempfile


def write_atomic(path: str, data: str) -> None:
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        # mkstemp creates 0600; consumers run as other UIDs (pod containers)
        os.chmod(tmp, 0o644)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
