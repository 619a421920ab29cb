"""Build the port's CUDA kernels with nvcc, and its host C++ with g++,
and load them with ctypes.

Counterpart of ``deepspeed_tpu/ops/builder.py:35-94`` (``OpBuilder``,
``AsyncIOBuilder``): sources under ``ops/csrc/`` compile at first use into
``<checkout>/build/kernels/`` (listed in ``.gitignore``), cached by a hash
of the sources, headers and flags, and load through ``ctypes`` behind a
plain C ABI — ``torch.utils.cpp_extension.load`` is not used, because a
source that includes PyTorch's headers takes minutes to build.
:class:`HostOpBuilder` is the g++ builder of host libraries (the aio
pool, ``csrc/aio.cpp``); it shares the cache and the hash.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ..utils.logging import logger

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    pass


def find_nvcc() -> Optional[str]:
    exe = shutil.which("nvcc")
    if exe is not None:
        return exe
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else None


class CUDAOpBuilder:
    """One shared library = its sources under ``csrc/`` + nvcc flags.
    ``headers`` (under ``csrc/``) are the files the sources include: they
    are not compiled on their own but count in the cache key;
    ``extra_flags`` follow the class's flags.

    ``build_log`` and ``build_seconds`` hold the last build's compiler
    output (``-Xptxas -v``: registers, shared memory, spills) and wall
    time; both stay empty when the library came from the cache."""

    flags = NVCC_FLAGS

    def __init__(self, name: str, sources: Sequence[str],
                 headers: Sequence[str] = (),
                 extra_flags: Sequence[str] = ()):
        self.name = name
        self.sources = list(sources)
        self.headers = list(headers)
        self.flags = [*type(self).flags, *extra_flags]
        self.build_log = ""
        self.build_seconds = 0.0
        self.command: List[str] = []

    def source_paths(self) -> List[Path]:
        return [CSRC_DIR / s for s in self.sources]

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in self.source_paths() + [CSRC_DIR / s for s in self.headers]:
            h.update(p.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"{self.name}_{h.hexdigest()[:16]}.so"

    def start(self, force: bool = False) -> Optional[subprocess.Popen]:
        """Launch nvcc for a library not yet in the cache (None when it
        is, unless ``force``); :meth:`finish` waits for it."""
        so = self.library_path()
        if so.exists() and not force:
            return None
        compiler = self.compiler()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        self.command = [compiler, *self.flags,
                        *[str(p) for p in self.source_paths()],
                        "-o", str(tmp)]
        logger.info("building %s: %s", self.name, " ".join(self.command))
        self._t0 = time.perf_counter()
        self._tmp = tmp
        return subprocess.Popen(self.command, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish(self, proc: Optional[subprocess.Popen]) -> Path:
        so = self.library_path()
        if proc is None:
            return so
        out, _ = proc.communicate()
        self.build_log = out
        self.build_seconds = time.perf_counter() - self._t0
        if proc.returncode != 0:
            self._tmp.unlink(missing_ok=True)
            raise BuildError(f"{Path(self.command[0]).name} build of "
                             f"{self.name} failed "
                             f"(exit {proc.returncode}):\n{out[-8000:]}")
        os.replace(self._tmp, so)     # atomic: readers never see half a file
        return so

    def compiler(self) -> str:
        nvcc = find_nvcc()
        if nvcc is None:
            raise BuildError(f"nvcc not found: cannot build {self.name}")
        return nvcc

    def load(self) -> ctypes.CDLL:
        """Build (when not cached) and dlopen, once per process."""
        with _lock:
            lib = _loaded.get(self.name)
            if lib is None:
                lib = ctypes.CDLL(str(self.finish(self.start())))
                _loaded[self.name] = lib
            return lib


class HostOpBuilder(CUDAOpBuilder):
    """A host C++ library built by g++ (``GXX_FLAGS``), cached and loaded
    as the CUDA ones are (reference: ``OpBuilder._build``)."""

    flags = GXX_FLAGS

    def compiler(self) -> str:
        gxx = shutil.which("g++")
        if gxx is None:
            raise BuildError(f"g++ not found: cannot build {self.name}")
        return gxx


def build_all(builders: Sequence[CUDAOpBuilder], force: bool = False) -> None:
    """Build every library at once: one nvcc per library, all started
    together, each waited for on a thread of its own, so that every
    ``build_seconds`` is that library's own wall time (``force`` rebuilds
    cached ones)."""
    procs = [(b, b.start(force)) for b in builders]
    with ThreadPoolExecutor(max_workers=max(1, len(procs))) as pool:
        for f in [pool.submit(b.finish, p) for b, p in procs]:
            f.result()
