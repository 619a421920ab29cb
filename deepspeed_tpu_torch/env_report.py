"""Environment report CLI (the ``ds_report`` analog).

Counterpart of ``deepspeed_tpu/env_report.py``, with its rows and format:
python, the platform, numpy; in place of jax/jaxlib and ``pinned_host``,
torch and its CUDA version, the card (name, count, compute capability,
memory) and whether page-locked host memory can be allocated; the
optional modules; then the native ops: the g++ and nvcc toolchains (path
and version), triton, and each kernel library of ``ops.BUILDERS``
(compatible: nvcc and a compute-capability 9.0 card; built or not in
``build/kernels/``).  Nothing is built but the host aio pool (g++), the
counterpart of the JAX report's aio op.

Usage: ``python -m deepspeed_tpu_torch.env_report``
"""

from __future__ import annotations

import platform as _platform
import shutil
import subprocess
import sys

GREEN_OK = "\033[92m[OKAY]\033[0m"
RED_NO = "\033[93m[NO]\033[0m"


def _row(name: str, status: str, extra: str = "") -> str:
    return f"{name:.<30} {status} {extra}"


def _nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, timeout=60).stdout
    rel = [ln for ln in out.splitlines() if "release" in ln]
    return rel[-1].strip() if rel else out.strip()[-60:]


def main() -> int:
    lines = ["-" * 60, "DeepSpeed-TPU (PyTorch/CUDA port) environment report",
             "-" * 60]

    import numpy
    lines.append(_row("python", GREEN_OK, sys.version.split()[0]))
    lines.append(_row("platform", GREEN_OK, _platform.platform()))
    lines.append(_row("numpy", GREEN_OK, numpy.__version__))

    import torch
    lines.append(_row("torch", GREEN_OK, torch.__version__))
    lines.append(_row("torch CUDA", GREEN_OK if torch.version.cuda else RED_NO,
                      torch.version.cuda or "(a CPU build)"))
    sm90 = False
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        props = torch.cuda.get_device_properties(0)
        cap = torch.cuda.get_device_capability(0)
        sm90 = tuple(cap) == (9, 0)
        lines.append(_row("devices", GREEN_OK,
                          f"{n} x cuda ({props.name}, capability "
                          f"{cap[0]}.{cap[1]})"))
        lines.append(_row("device memory", GREEN_OK,
                          f"{props.total_memory / 2**30:.1f} GiB"))
        try:
            torch.empty(1 << 20, dtype=torch.uint8, pin_memory=True)
            lines.append(_row("pinned host memory", GREEN_OK,
                              "(ZeRO-Offload capable)"))
        # failure surfaces as the RED_NO row in the printed report
        except RuntimeError as e:  # tpulint: disable=silent-except
            lines.append(_row("pinned host memory", RED_NO, str(e)[:60]))
    else:
        lines.append(_row("devices", RED_NO, "no CUDA device"))

    for mod in ("scipy", "einops", "transformers"):
        try:
            m = __import__(mod)
            lines.append(_row(mod, GREEN_OK, getattr(m, "__version__", "?")))
        except ImportError:  # tpulint: disable=silent-except
            lines.append(_row(mod, RED_NO))

    # native ops (reference: the op compatibility table in ds_report)
    lines.append("-" * 60)
    lines.append("native ops:")
    gxx = shutil.which("g++")
    lines.append(_row("g++ toolchain", GREEN_OK if gxx else RED_NO,
                      gxx or ""))
    from .ops.builder import BuildError, find_nvcc
    nvcc = find_nvcc()
    lines.append(_row("nvcc toolchain", GREEN_OK if nvcc else RED_NO,
                      f"{nvcc} ({_nvcc_version(nvcc)})" if nvcc else ""))
    try:
        import triton
        lines.append(_row("triton", GREEN_OK, triton.__version__))
    except ImportError:  # tpulint: disable=silent-except
        lines.append(_row("triton", RED_NO))
    from .ops import BUILDERS
    for b in BUILDERS:
        ok = bool(nvcc) and sm90
        built = b.library_path().exists()
        lines.append(_row(b.name, GREEN_OK if ok else RED_NO,
                          "built" if built else "not built"))
    from .ops.aio import BUILDER as aio
    lines.append(_row("async_io", GREEN_OK if gxx else RED_NO))
    if gxx:
        try:
            aio.load()
            lines.append(_row("async_io build", GREEN_OK))
        except (BuildError, OSError) as e:  # tpulint: disable=silent-except
            lines.append(_row("async_io build", RED_NO, str(e)[:60]))

    lines.append("-" * 60)
    print("\n".join(lines))  # tpulint: disable=print — the report IS the output
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
