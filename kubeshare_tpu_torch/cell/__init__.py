from .allocator import ChipInfo
from .topology import discover_local_chips

__all__ = ["ChipInfo", "discover_local_chips"]
