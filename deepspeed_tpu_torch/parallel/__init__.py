"""Parallelism of the port: the logical-axis sharding rules
(``sharding``, counterpart of ``deepspeed_tpu/parallel/sharding.py``)
and mixture-of-experts layers (``moe``)."""

from .sharding import (DEFAULT_RULES, spec_for_axes, add_fsdp_to_spec,
                       tree_specs, infer_logical_axes, named, tree_named)
from . import moe

__all__ = ["DEFAULT_RULES", "spec_for_axes", "add_fsdp_to_spec", "tree_specs",
           "infer_logical_axes", "named", "tree_named", "moe"]
