from .launcher import ChipSupervisor, cell_tokend, ensure_binary, find_binary

__all__ = ["ChipSupervisor", "cell_tokend", "ensure_binary", "find_binary"]
