"""Build and load the port's CUDA kernels at first use.

Each source under ``kubeshare_tpu_torch/csrc/`` is compiled by ``nvcc``
into its own shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries go
to ``kubeshare_tpu_torch/_build/`` (git-ignored), keyed by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged
one is reused.  :func:`build_all` starts one ``nvcc`` per source at once.

Nothing here runs at import time: the CPU tests import every module of
the package on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# ctypes signatures of each library's launcher, by source stem
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # flash_fwd_launch(q, k, v, out, lse, dtype, b, h, h_kv, s, d, causal,
    #                  window, scale, stream) -> cudaError_t
    "flash_fwd": ("flash_fwd_launch",
                  [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``$PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (library path, process or None, temporary output path)."""
    target = library_path(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, proc, tmp


def _finish(name: str, target: Path, proc, tmp) -> None:
    if proc is None:
        return
    output, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{output}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> None:
    """Compile every named kernel source, all nvcc processes at once."""
    started = [(name, *_start(name)) for name in names]
    for name, target, proc, tmp in started:
        _finish(name, target, proc, tmp)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use,
    with its launcher's ``argtypes``/``restype`` set."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            target, proc, tmp = _start(name)
            _finish(name, target, proc, tmp)
            lib = ctypes.CDLL(str(target))
            symbol, argtypes = SIGNATURES[name]
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib
