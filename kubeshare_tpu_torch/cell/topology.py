"""Local device discovery: port of ``discover_local_chips`` from
kubeshare_tpu/cell/topology.py, over ``torch.cuda``.

The JAX package enumerates TPU chips through PJRT; here each visible
CUDA device is one chip, named as the reference's NVML collector named
its GPUs (ref pkg/collector/gpu.go:26-107): the NVML UUID, the device
name with spaces replaced by ``-``, and its memory.  An H100 (or a node
of NVSwitch-linked cards) has no mesh coordinates, so ``coords`` is
None; NVLink locality is not modelled yet.
"""

from __future__ import annotations

from typing import List

from .allocator import ChipInfo


def discover_local_chips() -> List[ChipInfo]:
    """One ChipInfo per visible CUDA device: ``uuid`` ``"GPU-<uuid>"``
    (the form ``nvidia-smi --query-gpu=uuid`` prints), ``memory`` the
    device's total memory in bytes, ``model`` its normalised name (e.g.
    ``NVIDIA-H100-80GB-HBM3``), ``index`` its ordinal.  A host without a
    CUDA device has no chips: the list is empty."""
    import torch

    chips: List[ChipInfo] = []
    for index in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(index)
        chips.append(ChipInfo(
            uuid=f"GPU-{props.uuid}",
            memory=int(props.total_memory),
            model=_normalize_kind(props.name),
            index=index,
            coords=None,
        ))
    return chips


def _normalize_kind(kind: str) -> str:
    """A device name as a cell-type leaf name: spaces are illegal in the
    ID path, so they become '-' (ref collector gpu.go:60)."""
    return kind.strip().replace(" ", "-")
