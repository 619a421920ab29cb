from .engine import InferenceConfig, InferenceEngine
from .overload import AdmissionVerdict, OverloadConfig
from .ragged import BlockedAllocator, KVCacheConfig, RaggedBatch, StateManager
from .sampler import SamplingParams

__all__ = ["AdmissionVerdict", "BlockedAllocator", "InferenceConfig",
           "InferenceEngine", "KVCacheConfig", "OverloadConfig",
           "RaggedBatch", "SamplingParams", "StateManager"]
