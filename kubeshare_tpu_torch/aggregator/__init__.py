from .aggregator import Aggregator

__all__ = ["Aggregator"]
