from .config import (Config, ConfigError, ConfigModel, FP16Config, BF16Config,
                     OptimizerConfig, SchedulerConfig, ZeroConfig, OffloadConfig,
                     MeshConfig, PipelineConfig, TensorParallelConfig,
                     SequenceParallelConfig, MoEConfig,
                     ActivationCheckpointingConfig, CommsLoggerConfig,
                     FlopsProfilerConfig, AioConfig, CheckpointConfig,
                     ElasticityConfig, load_config)

__all__ = [
    "Config", "ConfigError", "ConfigModel", "FP16Config", "BF16Config",
    "OptimizerConfig", "SchedulerConfig", "ZeroConfig", "OffloadConfig",
    "MeshConfig", "PipelineConfig", "TensorParallelConfig",
    "SequenceParallelConfig", "MoEConfig", "ActivationCheckpointingConfig",
    "CommsLoggerConfig", "FlopsProfilerConfig", "AioConfig",
    "CheckpointConfig", "ElasticityConfig", "load_config",
]
