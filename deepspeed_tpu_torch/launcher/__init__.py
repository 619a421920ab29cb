"""The launcher (counterpart of ``deepspeed_tpu/launcher``)."""

from .runner import (build_parser, main, parse_hostfile,
                     parse_inclusion_exclusion, RUNNERS)
from .launch import init_distributed_from_env, terminate_process_tree

__all__ = ["main", "build_parser", "parse_hostfile",
           "parse_inclusion_exclusion", "RUNNERS",
           "init_distributed_from_env", "terminate_process_tree"]
