from .launcher import find_binary

__all__ = ["find_binary"]
