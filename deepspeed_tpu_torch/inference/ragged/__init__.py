from .allocator import BlockedAllocator
from .state import KVCacheConfig, RaggedBatch, StateManager

__all__ = ["BlockedAllocator", "KVCacheConfig", "RaggedBatch",
           "StateManager"]
