from .engine import InferenceConfig, InferenceEngine
from .failures import (DispatchTimeoutError, EngineDeadError, FailureConfig,
                       InjectedFault, classify_failure)
from .overload import AdmissionVerdict, OverloadConfig
from .ragged import BlockedAllocator, KVCacheConfig, RaggedBatch, StateManager
from .sampler import SamplingParams
from .spec_decode import NgramProposer

__all__ = ["AdmissionVerdict", "BlockedAllocator", "DispatchTimeoutError",
           "EngineDeadError", "FailureConfig", "InferenceConfig",
           "InferenceEngine", "InjectedFault", "KVCacheConfig",
           "NgramProposer", "OverloadConfig", "RaggedBatch",
           "SamplingParams", "StateManager", "classify_failure"]
