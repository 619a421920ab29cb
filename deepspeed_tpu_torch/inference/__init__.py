from .engine import InferenceConfig, InferenceEngine
from .overload import AdmissionVerdict, OverloadConfig
from .ragged import BlockedAllocator, KVCacheConfig, RaggedBatch, StateManager
from .sampler import SamplingParams
from .spec_decode import NgramProposer

__all__ = ["AdmissionVerdict", "BlockedAllocator", "InferenceConfig",
           "InferenceEngine", "KVCacheConfig", "NgramProposer",
           "OverloadConfig", "RaggedBatch", "SamplingParams",
           "StateManager"]
