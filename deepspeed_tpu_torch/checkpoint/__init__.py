"""Checkpoints of the port: the JAX package's fragment format
(``engine``) and HuggingFace state-dict import (``hf``)."""

from .engine import (consolidate, load_checkpoint, load_tree, save_checkpoint,
                     save_tree)

__all__ = ["save_tree", "load_tree", "save_checkpoint", "load_checkpoint",
           "consolidate"]
