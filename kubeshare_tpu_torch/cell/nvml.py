"""The driver's NVML (``libnvidia-ml.so.1``) through ctypes: what device
discovery needs to place a CUDA card among its peers.

No NVML package is installed: the calls and the ``nvmlPciInfo_t`` layout
are declared in-tree, in ``csrc/nvml_api.h``, which the card's machine
holds against the toolkit's ``nvml.h`` (``csrc/nvml_test/api_check.cc``);
the structure below is held against that header by a g++ probe in the
CPU tests.  The library path is an argument, so the tests point it at
``csrc/nvml_test/fake_nvml.cc``.

:func:`read_devices` raises :class:`NvmlUnavailable` where the library
is missing or fails to initialise, and :class:`NvmlError` for any other
failure: it never answers an empty list for a broken driver.  Two
answers are normal and not failures:

- a link that answers ``NVML_ERROR_NOT_SUPPORTED`` (a PCIe card without
  a bridge) or ``NVML_ERROR_INVALID_ARGUMENT`` (a link index past the
  device's own links) is absent;
- a PCI query that answers ``NOT_SUPPORTED`` (a sandboxed or virtualised
  host that hides the PCI function) leaves the bus id ``None``.

The NUMA node is not read here: a card's CPU affinity is sysfs's
``numa_node`` of its PCI function (``cell/topology.py``), while NVML's
``nvmlDeviceGetNumaNodeId`` names the GPU's own memory node, which only
Grace Hopper has.

Bus ids come in two forms: NVML's, an 8-digit upper-case domain
(``00000000:19:00.0``), and sysfs's, 4 digits in lower case
(``0000:19:00.0``); :func:`nvml_bus_id` and :func:`sysfs_bus_id` turn
either into each.
"""

from __future__ import annotations

import ctypes
import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

DEFAULT_LIBRARY = "libnvidia-ml.so.1"

# nvmlReturn_t (csrc/nvml_api.h)
SUCCESS = 0
ERROR_INVALID_ARGUMENT = 2
ERROR_NOT_SUPPORTED = 3
ERROR_LIBRARY_NOT_FOUND = 12
ERROR_FUNCTION_NOT_FOUND = 13
FEATURE_ENABLED = 1
# nvmlIntNvLinkDeviceType_t
LINK_GPU = 0x00
LINK_SWITCH = 0x02
LINK_UNKNOWN = 0xFF
MAX_LINKS = 18  # NVML_NVLINK_MAX_LINKS: Hopper's 18 links
UUID_SIZE = 96  # NVML_DEVICE_UUID_V2_BUFFER_SIZE


class PciInfo(ctypes.Structure):
    """``nvmlPciInfo_t`` as ``nvmlDeviceGetPciInfo_v3`` and
    ``nvmlDeviceGetNvLinkRemotePciInfo_v2`` fill it."""

    _fields_ = [
        ("busIdLegacy", ctypes.c_char * 16),
        ("domain", ctypes.c_uint),
        ("bus", ctypes.c_uint),
        ("device", ctypes.c_uint),
        ("pciDeviceId", ctypes.c_uint),
        ("pciSubSystemId", ctypes.c_uint),
        ("busId", ctypes.c_char * 32),
    ]


class NvmlError(RuntimeError):
    def __init__(self, call: str, code: int) -> None:
        super().__init__(f"{call} failed: NVML error {code}")
        self.call = call
        self.code = code


class NvmlUnavailable(NvmlError):
    """The library is missing or would not initialise."""


@dataclass(frozen=True)
class NvLink:
    """One enabled NVLink: its index, the far end's bus id (NVML's form,
    ``None`` where NVML does not say) and type (``LINK_GPU``,
    ``LINK_SWITCH``, ...)."""

    link: int
    remote_bus_id: Optional[str]
    remote_type: int


@dataclass(frozen=True)
class NvmlDevice:
    index: int
    uuid: str  # "GPU-<uuid>", as nvidia-smi --query-gpu=uuid prints it
    bus_id: Optional[str]  # NVML's form; None where NOT_SUPPORTED
    links: Tuple[NvLink, ...]  # the enabled links


_BUS_ID = re.compile(
    r"^([0-9a-fA-F]{1,8}):([0-9a-fA-F]{1,2}):([0-9a-fA-F]{1,2})\.([0-7])$")


def _bus_fields(text: str) -> Tuple[int, int, int, int]:
    match = _BUS_ID.match(text.strip())
    if match is None:
        raise ValueError(f"not a PCI bus id: {text!r}")
    return tuple(int(x, 16) for x in match.groups())


def nvml_bus_id(text: str) -> str:
    """``0000:19:00.0`` or ``00000000:19:00.0`` -> ``00000000:19:00.0``."""
    return "%08X:%02X:%02X.%X" % _bus_fields(text)


def sysfs_bus_id(text: str) -> str:
    """Either form -> ``0000:19:00.0``, the name under
    ``/sys/bus/pci/devices``."""
    return "%04x:%02x:%02x.%x" % _bus_fields(text)


_HANDLE = ctypes.c_void_p
_UINT_P = ctypes.POINTER(ctypes.c_uint)
_INT_P = ctypes.POINTER(ctypes.c_int)
_PCI_P = ctypes.POINTER(PciInfo)
# every call and its parameters (nvml_api.h); each returns an nvmlReturn_t
_CALLS = {
    "nvmlInit_v2": (),
    "nvmlShutdown": (),
    "nvmlDeviceGetCount_v2": (_UINT_P,),
    "nvmlDeviceGetHandleByIndex_v2": (ctypes.c_uint,
                                      ctypes.POINTER(_HANDLE)),
    "nvmlDeviceGetUUID": (_HANDLE, ctypes.c_char_p, ctypes.c_uint),
    "nvmlDeviceGetPciInfo_v3": (_HANDLE, _PCI_P),
    "nvmlDeviceGetNvLinkState": (_HANDLE, ctypes.c_uint, _INT_P),
    "nvmlDeviceGetNvLinkRemotePciInfo_v2": (_HANDLE, ctypes.c_uint, _PCI_P),
    "nvmlDeviceGetNvLinkRemoteDeviceType": (_HANDLE, ctypes.c_uint, _INT_P),
}


def _open(library: str):
    try:
        lib = ctypes.CDLL(library)
    except OSError as e:
        raise NvmlUnavailable(f"dlopen({library}): {e}",
                              ERROR_LIBRARY_NOT_FOUND) from None
    for name, argtypes in _CALLS.items():
        fn = getattr(lib, name, None)
        if fn is None:
            raise NvmlUnavailable(f"{library} lacks {name}",
                                  ERROR_FUNCTION_NOT_FOUND)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(call: str, code: int, absent: Tuple[int, ...] = ()) -> bool:
    """True on success, False for a code in ``absent``; raises otherwise."""
    if code == SUCCESS:
        return True
    if code in absent:
        return False
    raise NvmlError(call, code)


def _pci(info: PciInfo) -> Optional[str]:
    text = info.busId.decode(errors="replace")
    return nvml_bus_id(text) if text else None


def read_devices(library: str = DEFAULT_LIBRARY) -> List[NvmlDevice]:
    """Every device NVML reports, in NVML's order (not CUDA's: match them
    by UUID).  Initialises NVML and shuts it down again."""
    lib = _open(library)
    code = lib.nvmlInit_v2()
    if code != SUCCESS:
        raise NvmlUnavailable("nvmlInit_v2", code)
    try:
        count = ctypes.c_uint()
        _check("nvmlDeviceGetCount_v2",
               lib.nvmlDeviceGetCount_v2(ctypes.byref(count)))
        return [_read_device(lib, index) for index in range(count.value)]
    finally:
        lib.nvmlShutdown()


def _read_device(lib, index: int) -> NvmlDevice:
    handle = ctypes.c_void_p()
    _check("nvmlDeviceGetHandleByIndex_v2",
           lib.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(handle)))
    uuid = ctypes.create_string_buffer(UUID_SIZE)
    _check("nvmlDeviceGetUUID", lib.nvmlDeviceGetUUID(handle, uuid, UUID_SIZE))
    pci = PciInfo()
    bus_id = None
    if _check("nvmlDeviceGetPciInfo_v3",
              lib.nvmlDeviceGetPciInfo_v3(handle, ctypes.byref(pci)),
              absent=(ERROR_NOT_SUPPORTED,)):
        bus_id = _pci(pci)
    links = []
    for link in range(MAX_LINKS):
        state = ctypes.c_int()
        if not _check("nvmlDeviceGetNvLinkState",
                      lib.nvmlDeviceGetNvLinkState(handle, link,
                                                   ctypes.byref(state)),
                      absent=(ERROR_NOT_SUPPORTED, ERROR_INVALID_ARGUMENT)):
            continue
        if state.value != FEATURE_ENABLED:
            continue
        kind = ctypes.c_int(LINK_UNKNOWN)
        if not _check("nvmlDeviceGetNvLinkRemoteDeviceType",
                      lib.nvmlDeviceGetNvLinkRemoteDeviceType(
                          handle, link, ctypes.byref(kind)),
                      absent=(ERROR_NOT_SUPPORTED,)):
            kind.value = LINK_UNKNOWN
        remote = PciInfo()
        remote_bus_id = None
        if _check("nvmlDeviceGetNvLinkRemotePciInfo_v2",
                  lib.nvmlDeviceGetNvLinkRemotePciInfo_v2(
                      handle, link, ctypes.byref(remote)),
                  absent=(ERROR_NOT_SUPPORTED,)):
            remote_bus_id = _pci(remote)
        links.append(NvLink(link, remote_bus_id, kind.value))
    return NvmlDevice(index=index, uuid=uuid.value.decode(), bus_id=bus_id,
                      links=tuple(links))
