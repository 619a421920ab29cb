"""Platform: the CUDA device the port runs on.

Counterpart of ``deepspeed_tpu/platform/tpu.py``.  Every entry point of
the port resolves its device here: ``None`` means the card, and with no
card that raises — nothing falls back to the CPU unless the caller asked
for it with ``device="cpu"`` (as the CPU tests do).
"""

from __future__ import annotations

import shutil
import subprocess
import weakref
from typing import Dict, Optional, Union

import torch

# the paged-attention kernel is built for sm_90a (Hopper)
REQUIRED_CAPABILITY = (9, 0)


class NoCudaDeviceError(RuntimeError):
    pass


def default_device() -> torch.device:
    """``cuda`` (the current card); raises when there is none."""
    if not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "no CUDA device is visible; pass device='cpu' explicitly to run "
            "the plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` -> :func:`default_device`; anything else as given."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDeviceError(f"device {dev} requested but CUDA is "
                                "not available")
    return dev


def host_empty(shape, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    """A host tensor, page-locked with ``cudaHostRegister`` when ``pin``
    (PyTorch's pinned allocator rounds a block up to a power of two: up to
    twice the bytes of a large buffer).  A failed allocation or
    registration raises, naming the bytes; the registration is undone when
    the tensor is freed."""
    nbytes = torch.empty((), dtype=dtype).element_size()
    for n in shape:
        nbytes *= int(n)
    try:
        t = torch.empty(tuple(shape), dtype=dtype)
    except RuntimeError as e:
        raise RuntimeError(f"could not allocate {nbytes:,} bytes of host "
                           f"memory: {e}") from e
    if pin and nbytes:
        cudart = torch.cuda.cudart()
        err = int(cudart.cudaHostRegister(t.data_ptr(), nbytes, 0))
        if err != 0 or not t.is_pinned():
            raise RuntimeError(f"could not pin {nbytes:,} bytes of host "
                               f"memory (cudaHostRegister: error {err})")
        weakref.finalize(t, cudart.cudaHostUnregister, t.data_ptr())
    return t


def nvidia_smi_power() -> Optional[str]:
    """``name, power.limit`` of the card as nvidia-smi reports them, or
    None where nvidia-smi is missing."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    proc = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    if proc.returncode != 0:
        return None
    return proc.stdout.strip()


def device_report() -> Dict[str, object]:
    """Name, count and compute capability of the visible cards, plus the
    nvidia-smi name and power limit.  Raises without a card."""
    dev = default_device()
    cap = torch.cuda.get_device_capability(dev)
    return {
        "name": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count(),
        "capability": cap,
        # sm_90a code runs on compute capability 9.0 only
        "sm90": tuple(cap) == REQUIRED_CAPABILITY,
        "nvidia_smi": nvidia_smi_power(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
