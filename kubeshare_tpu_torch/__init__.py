"""PyTorch / CUDA port of the kubeshare_tpu workload library.

The JAX package ``kubeshare_tpu`` stays the reference; this package
mirrors its module names (``ops/attention.py`` <- ``kubeshare_tpu/ops/
attention.py`` and so on) and imports nothing from it.  Every Pallas
kernel on a ported path is a hand-written Hopper kernel here, with a
plain PyTorch version beside it that CPU tensors take.

Entry points run on ``torch.device("cuda")`` unless the caller asks for
the CPU explicitly (``device="cpu"``); without a CUDA device they raise
instead of dropping quietly to the CPU.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The device entry points use when the caller names none: the
    current CUDA device.  Raises when no CUDA device is present — pass
    ``device="cpu"`` to run on the CPU on purpose."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU explicitly"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device) -> torch.device:
    """``None`` -> :func:`default_device`; anything else -> torch.device."""
    return default_device() if device is None else torch.device(device)
