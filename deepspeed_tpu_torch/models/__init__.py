from .presets import PRESETS, build_config, build_model
from .transformer import (Model, TransformerConfig, apply, init_params,
                          params_from_numpy, quant_tree_from_numpy)

__all__ = ["PRESETS", "Model", "TransformerConfig", "apply", "build_config",
           "build_model", "init_params", "params_from_numpy",
           "quant_tree_from_numpy"]
