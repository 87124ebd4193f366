"""The CUDA driver interposer, ``libcudahook.so.1``: build it, give a pod
the environment that preloads it, read its counters.

The hook (``csrc/cuda_hook.cc``) is the port's counterpart of the JAX
shim ``native/shim/interposer.cc``: LD_PRELOADed into a PyTorch process
that knows nothing of tokens, it gates kernel and graph launches through
the chip's token broker, charges the device time it measures at
completion, and charges device allocations against the pod's cap.  It is
host code, built with ``g++`` alone (``cuda_driver_api.h`` declares the
driver API it uses), so it builds wherever the tests run.

:func:`hook_path` builds it at first use into the git-ignored
``kubeshare_tpu_torch/_build/``, keyed by a hash of the sources and flags
as ``ops/_build.py`` keys the kernels:

    python -c "from kubeshare_tpu_torch.isolation.hook import hook_path; print(hook_path())"

What the memory cap does not cover: the hook charges every allocation
the driver is asked for (``cuMemAlloc*``, ``cuMemCreate``), which is all
that PyTorch's caching allocator reserves, but not the CUDA context's
own memory (about 480 MiB on an H100, never a ``cuMemAlloc``), nor the
32-bit v1 entry points it passes through.  Placement admission (the
scheduler's ``gpu_mem``) stays the hard guarantee, as for
:func:`~kubeshare_tpu_torch.isolation.guard.apply_hbm_cap`.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

from .. import constants

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
# the broker's C client, compiled in unchanged (as native/Makefile does for
# libtpushim.so.1)
CLIENT = _PACKAGE.parent / "native" / "shim" / "client.cc"
HOOK_NAME = "libcudahook.so.1"
CXXFLAGS = ("-std=c++17", "-O2", "-Wall", "-Wextra", "-pthread")
SHARED = ("-shared", "-fPIC")

ENV_STATS = "CUDAHOOK_STATS"  # the counters' JSON file, written at exit


def compiler() -> str:
    """``$CXX`` or ``g++`` from ``$PATH``."""
    found = os.environ.get("CXX") or shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: libcudahook.so.1 cannot be built")
    return found


def build(name: str, sources: Sequence[Path], flags: Sequence[str],
          headers: Sequence[Path] = (), directory: Path = BUILD_DIR,
          label: Optional[str] = None) -> Path:
    """``directory/<label>-<hash>/<name>`` compiled by g++ from
    ``sources`` with ``flags`` (after the sources, so that libraries
    link), built unless present.  The hash covers the sources, the
    headers and the flags; the output appears atomically, so concurrent
    builders see all of it or nothing."""
    digest = hashlib.sha256()
    for path in (*sources, *headers):
        digest.update(Path(path).read_bytes())
    digest.update(" ".join(flags).encode())
    out_dir = Path(directory) / f"{label or Path(name).stem}-{digest.hexdigest()[:16]}"
    target = out_dir / name
    if target.exists():
        return target
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{name}.{os.getpid()}.tmp"
    cmd = [compiler(), *CXXFLAGS, "-o", str(tmp), *map(str, sources), *flags]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed building {name}:\n{proc.stderr}")
    os.replace(tmp, target)
    return target


def hook_path() -> Path:
    """``libcudahook.so.1``, built on first use."""
    return build(HOOK_NAME, (CSRC / "cuda_hook.cc", CLIENT),
                 (*SHARED, "-ldl"), headers=(CSRC / "cuda_driver_api.h",),
                 label="cudahook")


def hook_env(pod_manager_port, pod_name: str,
             pod_manager_ip: str = "127.0.0.1",
             mem_fraction: Optional[float] = None,
             stats_path: Optional[str] = None,
             library: Optional[str] = None) -> Dict[str, str]:
    """The part of a fractional pod's env that the hook reads, as the
    port's scheduler injects it (scheduler/plugin.py): the hook preloaded (``library``, by default :func:`hook_path`; on a
    node, ``constants.SHIM_LIBRARY``), the pod's broker and name, and its
    memory cap as a fraction of the card.  ``stats_path`` asks for the
    counters at exit."""
    env = {
        constants.ENV_SHIM_PRELOAD: str(library or hook_path()),
        constants.ENV_POD_MANAGER_PORT: str(pod_manager_port),
        constants.ENV_POD_NAME: pod_name,
        "POD_MANAGER_IP": pod_manager_ip,
    }
    if mem_fraction is not None:
        env[constants.ENV_MEM_FRACTION] = f"{mem_fraction:.4f}"
    if stats_path is not None:
        env[ENV_STATS] = str(stats_path)
    return env


def read_stats(path) -> dict:
    """The counters a hooked process wrote at exit to ``$CUDAHOOK_STATS``."""
    with open(path) as f:
        return json.load(f)


def _loaded():
    """The hook's exported functions in this process (it is preloaded),
    or a RuntimeError."""
    process = ctypes.CDLL(None)
    try:
        stats = process.cudahook_stats
        settle = process.cudahook_settle
    except AttributeError:
        raise RuntimeError(
            "libcudahook.so.1 is not loaded in this process (run it with "
            "LD_PRELOAD, see hook_env)") from None
    stats.argtypes = [ctypes.c_char_p, ctypes.c_long]
    stats.restype = ctypes.c_long
    settle.argtypes = [ctypes.c_double]
    settle.restype = ctypes.c_int
    return stats, settle


def preloaded() -> bool:
    """Whether ``libcudahook.so.1`` is loaded in this process (the pod
    runs under ``LD_PRELOAD``, as the port's scheduler injects it)."""
    try:
        _loaded()
    except RuntimeError:
        return False
    return True


def live_stats() -> dict:
    """The counters of the hook preloaded into this process."""
    stats, _ = _loaded()
    size = stats(None, 0)
    buf = ctypes.create_string_buffer(size + 1)
    stats(buf, size + 1)
    return json.loads(buf.value.decode())


def settle(timeout_ms: float = 2000.0) -> int:
    """Hand back the hook's lease and wait until every charge is at the
    broker; returns how many were still outstanding at the timeout."""
    _, settle_fn = _loaded()
    return settle_fn(timeout_ms)
