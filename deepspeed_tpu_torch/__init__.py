"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, written in PyTorch for an NVIDIA
H100.  Its module layout follows ``deepspeed_tpu`` so every module has one
obvious reference; it never imports JAX or the JAX package.  Entry points
run on the card unless the caller passes ``device="cpu"``.

Ported so far: the single-device serving path (``models``, ``inference``)
with paged attention as a hand-written Hopper kernel (with its quantized
cache and ALiBi variants) and seeded sampling on the JAX package's
threefry keys (``utils.prng``), quantized serving with the mixed-input
GEMM, and one-device training (``runtime``: ``initialize`` ->
``Engine.train_batch``) with flash attention forward and backward as
hand-written Hopper kernels (``ops``), checkpoints in the JAX package's
fragment format and HuggingFace import (``checkpoint``), and
mixture-of-experts layers (``parallel.moe``) for training and serving.
"""

__version__ = "0.1.0"

from .config import Config, load_config                     # noqa: F401
from .inference import (InferenceConfig, InferenceEngine,   # noqa: F401
                        SamplingParams)
from .runtime.engine import Engine, initialize              # noqa: F401
