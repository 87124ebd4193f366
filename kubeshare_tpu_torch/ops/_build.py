"""Build and load the port's CUDA kernels at first use.

Each source under ``kubeshare_tpu_torch/csrc/`` is compiled by ``nvcc``
into its own shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries go
to ``kubeshare_tpu_torch/_build/`` (git-ignored), keyed by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source at once.

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
from typing import Dict, Iterable, Optional

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # each kernel's registers, shared memory and spills
)

# ctypes signatures of each library's launchers, by source stem; every
# launcher returns a cudaError_t
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# dtype, b, h, h_kv, s, d, causal, window, scale, stream
_SHAPE_ARGS = [_I, _I, _I, _I, _I, _I, _I, _I, _F, _P]
# the block-sparse launchers' mask arguments before those: mask bytes,
# mask columns, block_q, block_k
_MASK_ARGS = [_P, _I, _I, _I]
SIGNATURES = {
    # flash_fwd_launch(q, k, v, out, lse, ...)
    "flash_fwd": {
        "flash_fwd_launch": [_P] * 5 + _SHAPE_ARGS,
        "flash_fwd_block_sparse_launch": [_P] * 5 + _MASK_ARGS + _SHAPE_ARGS,
    },
    # flash_bwd_dkv_launch(q, k, v, dout, lse, delta, dk, dv, ...)
    # flash_bwd_dq_launch(q, k, v, dout, lse, delta, dq, ...)
    "flash_bwd": {
        "flash_bwd_dkv_launch": [_P] * 8 + _SHAPE_ARGS,
        "flash_bwd_dq_launch": [_P] * 7 + _SHAPE_ARGS,
        "flash_bwd_dkv_block_sparse_launch":
            [_P] * 8 + _MASK_ARGS + _SHAPE_ARGS,
        "flash_bwd_dq_block_sparse_launch":
            [_P] * 7 + _MASK_ARGS + _SHAPE_ARGS,
    },
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
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
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


def _finish(name: str, target: Path, proc, tmp) -> Optional[str]:
    """Wait for nvcc; returns its output (the ptxas -v lines), or None
    when the library already existed."""
    if proc is None:
        return None
    output, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{output}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    return output


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every named kernel source, all nvcc processes at once;
    returns nvcc's output for each source it compiled."""
    started = [(name, *_start(name)) for name in names]
    logs = {name: _finish(name, target, proc, tmp)
            for name, target, proc, tmp in started}
    return {name: log for name, log in logs.items() if log is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use,
    with its launchers' ``argtypes``/``restype`` set."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            target, proc, tmp = _start(name)
            _finish(name, target, proc, tmp)
            lib = ctypes.CDLL(str(target))
            for symbol, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib
