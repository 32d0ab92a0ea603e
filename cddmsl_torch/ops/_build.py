"""Builds the hand-written CUDA kernels under cddmsl_torch/csrc/ and loads
them through ctypes.

Each `.cu` file is compiled on its own by nvcc for sm_90a into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). The library is built at first use into `csrc/build/`, which git
ignores; its file name carries a hash of the source and flags, so an edited
source is rebuilt. `build(*kernels)` starts one nvcc per missing library, all
at once, and waits for them.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


class CudaKernel:
    """One csrc/*.cu file, its C entry points and its launch count.

    `functions` maps each exported C name to its ctypes argtypes; every entry
    returns the `cudaError_t` of its launches as an int.
    """

    def __init__(self, source: str, functions: Dict[str, Sequence], extra_flags: Tuple[str, ...] = ()):
        self.source = CSRC / source
        self.functions = functions
        self.flags = ARCH_FLAGS + BASE_FLAGS + tuple(extra_flags)
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None

    @property
    def library_path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes() + " ".join(self.flags).encode()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.source.stem}_{digest}.so"

    def _start_build(self) -> Optional[Tuple[subprocess.Popen, Path, Path]]:
        out = self.library_path
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        cmd = [_nvcc(), *self.flags, "-o", str(tmp), str(self.source)]
        with open(log, "w") as fh:
            proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        return proc, tmp, log

    def _finish_build(self, started) -> None:
        proc, tmp, log = started
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{log.read_text()}")
        os.replace(tmp, self.library_path)

    def build_log(self) -> str:
        log = self.library_path.with_suffix(".log")
        return log.read_text() if log.exists() else ""

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            build(self)
            lib = ctypes.CDLL(str(self.library_path))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, name: str, *args) -> None:
        """Calls one C entry point and raises on a launch error."""
        err = getattr(self.library(), name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed with cudaError_t {err}")
        self.launches += 1


def build(*kernels: CudaKernel) -> float:
    """Builds every missing library, one nvcc per source, all in parallel.
    Returns the wall seconds it took."""
    t0 = time.perf_counter()
    started = [(k, k._start_build()) for k in kernels]
    try:
        for k, s in started:
            if s is not None:
                k._finish_build(s)
    finally:
        for _, s in started:
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()
    return time.perf_counter() - t0
