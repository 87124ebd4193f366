from .pipeline import ShardedBatchLoader, prefetch_to_device

__all__ = ["ShardedBatchLoader", "prefetch_to_device"]
