"""The chip record of kubeshare_tpu/cell/allocator.py: the port's copy of
``ChipInfo`` (the port imports nothing of the JAX package).  The
allocator itself is control plane that serves both packages and is not
ported."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class ChipInfo:
    """One accelerator chip as reported by the collector
    (ref pkg/scheduler/gpu.go:17-20; memory = device memory in bytes)."""

    uuid: str
    memory: int
    model: str = ""
    index: int = 0
    coords: Optional[Tuple[int, ...]] = None
