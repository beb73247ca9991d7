"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``repro_torch/csrc`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded through ``ctypes``: no PyTorch
headers, so a build takes seconds.  Libraries are built at first use into
``build/kernels/`` at the repository root, named by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
reused.  A build failure raises with the compiler's output.

Every C entry point takes device pointers, integer sizes and the CUDA
stream last, launches on that stream, allocates nothing, and returns
``cudaGetLastError()``; :class:`CudaKernel` raises when that is nonzero and
counts the launches it made.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("symmetric_contraction.cu", "channelwise_tp.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / spill report) of each source built by
# this process
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the CUDA kernels of "
        "repro_torch are built at first use and need the CUDA toolkit"
    )


def library_path(source: str) -> Path:
    """Where ``source``'s library lives, keyed by source and flag contents."""
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(sources: Iterable[str] = SOURCES) -> None:
    """Compile every source whose library is missing: one ``nvcc`` process
    per source, all started together."""
    jobs = []
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((source, out, tmp, proc))
    failed: List[str] = []
    for source, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        build_logs[source] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source}:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(library_path(source)))
            _libs[source] = lib
        return lib


class CudaKernel:
    """One C entry point ``symbol(args..., stream) -> cudaError_t`` of
    ``source``, with a count of the launches made through it."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._count_lock = threading.Lock()

    def _bind(self):
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        fn = self._bind()
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.symbol} ({self.source}) failed to launch: "
                f"cudaError_t {err}"
            )
        with self._count_lock:
            self.launches += 1


PTR = ctypes.c_void_p
INT = ctypes.c_int
