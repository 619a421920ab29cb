"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, written in PyTorch for an NVIDIA
H100.  Its module layout follows ``deepspeed_tpu`` so every module has one
obvious reference; it never imports JAX or the JAX package.  Entry points
run on the card unless the caller passes ``device="cpu"``.

Ported so far: the single-device serving path (``models``, ``inference``)
with paged attention as a hand-written Hopper kernel (``ops``).
"""

__version__ = "0.1.0"
