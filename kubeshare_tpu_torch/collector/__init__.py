from .collector import Collector, CudaEnumerator, FakeEnumerator, PromInventory

__all__ = ["Collector", "CudaEnumerator", "FakeEnumerator", "PromInventory"]
