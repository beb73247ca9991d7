"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``repro_torch/csrc`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded through ``ctypes``: no PyTorch
headers, so a build takes seconds.  Each source is built with a generated
header (included as ``KERNEL_HEADER``) that fixes compile-time constants,
such as the CG entries of one spec and the operand precision
(:func:`precision_define`); each (source, header) pair is its own library.
Libraries are built at first use into ``build/kernels/`` at the repository
root, named by a hash of the source, the shared headers (``csrc/*.cuh``),
the generated header and the flags, so an edited source or a new header is
rebuilt and an unchanged one is reused.  A build failure raises with the compiler's output.

Every C entry point takes device pointers, integer sizes and the CUDA
stream last, launches on that stream, allocates nothing, and returns
``cudaGetLastError()``; :class:`CudaKernel` raises when that is nonzero and
counts the launches it made.

A launch made while a CUDA graph is captured does not run: inside
:func:`recording_launches` for the capture stream, it goes into the graph's
tally instead of the counts, and each replay of the graph adds the tally to
the counts (:func:`count_replay`), since a replay runs no Python.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.precision import PRECISIONS, check_precision

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# (source under csrc/, generated header text)
Unit = Tuple[str, str]

_lock = threading.Lock()
_libs: Dict[Unit, ctypes.CDLL] = {}
# capture stream handle -> the tally of the graph being captured on it
_captures: Dict[int, "LaunchTally"] = {}
_captures_lock = threading.Lock()
# compiler output (ptxas register / stack / spill report) of each library,
# by library name; kept beside the library so one built earlier still has
# its report
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


def library_path(source: str, header: str) -> Path:
    """Where a unit's library lives, keyed by source, shared headers,
    generated header and flags."""
    shared = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + shared + header.encode()
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(units: Iterable[Unit]) -> None:
    """Compile every unit whose library is missing: one ``nvcc`` process
    per unit, all started together."""
    jobs = []
    for source, header in units:
        out = library_path(source, header)
        if out.exists():
            if out.with_suffix(".log").exists():
                build_logs[out.stem] = out.with_suffix(".log").read_text()
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        hdr = out.with_suffix(".cuh")
        hdr_tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.cuh")
        hdr_tmp.write_text(header)
        os.replace(hdr_tmp, hdr)  # a concurrent build never reads half a header
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), f'-DKERNEL_HEADER="{hdr}"',
               str(CSRC / source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((source, out, tmp, proc))
    failed: List[str] = []
    for source, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        build_logs[out.stem] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source} ({out.stem}):\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))


def load(source: str, header: str) -> ctypes.CDLL:
    """The loaded library of a unit, built first if needed."""
    with _lock:
        lib = _libs.get((source, header))
        if lib is None:
            build([(source, header)])
            lib = ctypes.CDLL(str(library_path(source, header)))
            _libs[(source, header)] = lib
        return lib


class CudaKernel:
    """One C entry point ``symbol(args..., stream) -> cudaError_t`` of
    ``source``, with a count of the launches made through it: ``launches``
    over every header the source is built with, ``launches_by_header`` per
    header (so per spec and precision)."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.launches_by_header: Dict[str, int] = {}
        self._fns: Dict[str, object] = {}
        self._count_lock = threading.Lock()

    def reset(self) -> None:
        """Set both launch counts to zero."""
        with self._count_lock:
            self.launches = 0
            self.launches_by_header = {}

    def _bind(self, header: str):
        fn = self._fns.get(header)
        if fn is None:
            fn = getattr(load(self.source, header), self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fns[header] = fn
        return fn

    def add_launches(self, header: str, n: int) -> None:
        """Count ``n`` launches of the ``header`` build: one per call that
        ran the kernel, ``n`` per replay of a graph that captured it ``n``
        times."""
        with self._count_lock:
            self.launches += n
            self.launches_by_header[header] = self.launches_by_header.get(header, 0) + n

    def __call__(self, *args, header: str, launches: int = 1) -> None:
        """Run the entry point, which makes ``launches`` device launches of
        the kernel, and count them."""
        fn = self._bind(header)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.symbol} ({self.source}) failed to launch: "
                f"cudaError_t {err}"
            )
        tally = _captures.get(stream)
        if tally is not None:
            with _captures_lock:
                tally[(self, header)] = tally.get((self, header), 0) + launches
        elif torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"CUDA kernel {self.symbol} was captured into a graph outside "
                "recording_launches: its replays would go uncounted"
            )
        else:
            self.add_launches(header, launches)


# (kernel, header) -> launches captured into one graph
LaunchTally = Dict[Tuple[CudaKernel, str], int]


@contextlib.contextmanager
def recording_launches(stream: torch.cuda.Stream) -> Iterator[LaunchTally]:
    """Around the capture of a CUDA graph on ``stream``: the kernels
    launched on it, from any thread (autograd runs a backward on its own
    thread, on the stream of the forward), are tallied in the yielded dict
    instead of counted, since they do not run."""
    key = stream.cuda_stream
    tally: LaunchTally = {}
    with _captures_lock:
        if key in _captures:
            raise RuntimeError("a graph is already being captured on this stream")
        _captures[key] = tally
    try:
        yield tally
    finally:
        with _captures_lock:
            del _captures[key]


def count_replay(tally: LaunchTally) -> None:
    """Count one replay of a graph whose capture tallied ``tally``."""
    for (kernel, header), n in tally.items():
        kernel.add_launches(header, n)


PTR = ctypes.c_void_p
INT = ctypes.c_int


def precision_define(precision: str) -> str:
    """The line of a generated header that selects ``round_op``'s operand
    rounding (``csrc/round_op.cuh``) for ``precision``."""
    code = PRECISIONS.index(check_precision(precision))
    return f"#define PRECISION {code}  // {precision}"


def f32_literal(v: float) -> str:
    """``v`` rounded to float32, as an exact C++ hex literal (for generated
    headers)."""
    return float(np.float32(v)).hex() + "f"
