"""FLOPs / params / latency profiler (counterpart of
``deepspeed_tpu/profiling``)."""

from .flops_profiler import (FlopsProfiler, analyze_fn, count_flops,
                             duration_to_string, flops_to_string,
                             get_model_profile, macs_to_string,
                             number_to_string, params_to_string, time_fn)

__all__ = ["FlopsProfiler", "analyze_fn", "count_flops", "time_fn",
           "get_model_profile", "flops_to_string", "macs_to_string",
           "params_to_string", "number_to_string", "duration_to_string"]
