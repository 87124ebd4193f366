from .bitmap import Bitmap, RRBitmap
from .logger import get_logger

__all__ = ["Bitmap", "RRBitmap", "get_logger"]
