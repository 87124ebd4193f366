"""Profiling helpers.  Port of kubeshare_tpu/utils/profiling.py.

Thin wrappers so workloads and benches capture device traces without
importing profiler plumbing everywhere: ``jax.profiler``'s trace becomes
``torch.profiler`` (CPU activity, plus the CUDA kernels when a card is
present), exported as a Chrome trace (viewable in Perfetto or
TensorBoard's profiler plugin).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Iterator, Optional

import torch

from .logger import get_logger


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the block into ``log_dir`` (no-op when None or empty): CPU
    activity, and CUDA activity when a CUDA device is available; on exit
    the trace is written as ``<host>.<pid>.<ns>.pt.trace.json``."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}"
                 ".pt.trace.json"))


@contextlib.contextmanager
def timed(label: str, logger_name: str = "kubeshare-profile") -> Iterator[dict]:
    """Wall-time a block; yields a dict that receives ``seconds``."""
    log = get_logger(logger_name)
    result: dict = {}
    start = time.perf_counter()
    try:
        yield result
    finally:
        result["seconds"] = time.perf_counter() - start
        log.info("%s took %.3fs", label, result["seconds"])
