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
fragment format and HuggingFace import (``checkpoint``),
mixture-of-experts layers (``parallel.moe``) for training and serving,
offload, and the host layers above the engine: telemetry
(``telemetry``, ``monitor``), the fleet router (``serving``) and the
HTTP gateway (``gateway``), and RLHF and data-efficient training: the
hybrid engine (``HybridEngine``: training and serving on one set of
weights), LoRA (``linear``), progressive layer drop, random-LTD, the
curriculum, MoQ with eigenvalue pacing (``runtime``), compression
(``compression``) and the flops profiler (``profiling``), the model
families (encoders, CLIP, the diffusion UNet and VAE), the fp6/fp12
minifloat weight layouts (``ops.quant``, served through
``weight_quant="fp6"|"fp12"``), and the aux subsystems: elastic batch
planning (``elasticity``), the environment report (``env_report``), the
autotuner (``autotuning``), the launcher (``launcher``) and
``runtime.partition_balanced`` / ``see_memory_usage``, and
tensor-parallel serving over ``torch.distributed``: the named-axis
mesh and its collectives (``comm``), the logical-axis sharding rules
(``parallel.sharding``) and ``InferenceEngine(topology=...)``.
"""

__version__ = "0.1.0"

from .comm import MeshTopology, init_distributed            # noqa: F401
from .config import Config, load_config                     # noqa: F401
from .inference import (InferenceConfig, InferenceEngine,   # noqa: F401
                        SamplingParams)
from .runtime.engine import Engine, initialize              # noqa: F401
from .runtime.hybrid_engine import HybridEngine             # noqa: F401
