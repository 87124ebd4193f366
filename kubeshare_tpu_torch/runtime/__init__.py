from .launcher import ChipSupervisor, find_binary

__all__ = ["ChipSupervisor", "find_binary"]
