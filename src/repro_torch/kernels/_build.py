"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Each kernel is one CUDA C++ source under ``repro_torch/csrc/`` with a
plain C interface (no PyTorch headers), compiled by ``nvcc`` for
``sm_90a`` into a shared library under ``repro_torch/csrc/build/`` and
loaded with :mod:`ctypes`.  A library's file name carries a digest of
its source and flags, so an edited source is rebuilt and a built one is
reused.  Nothing here runs when the package is imported: the first
launch of a kernel builds it, and :func:`build_all` builds several at
once, one ``nvcc`` process per source, all started together.

Every C entry point returns the ``cudaError_t`` of its launch (0 on
success); :func:`raise_on_error` turns anything else into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "build_all", "function", "raise_on_error",
           "require_cuda", "require_contiguous", "stream_handle", "library_path"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME); the CUDA "
        "kernels of repro_torch are built from source at first use")


def library_path(name: str) -> Path:
    """Where the shared library of kernel ``name`` is (or will be) built."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path]) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)               # atomic: concurrent builders agree
    out.with_suffix(".log").write_text(log)
    return log


def build_all(names) -> dict[str, str]:
    """Build every kernel of ``names`` not built yet, one ``nvcc`` per
    source, all running at once.  Returns each kernel's ``nvcc`` output
    (ptxas register and shared-memory report) — read back from the log
    when the library was already built."""
    jobs = {name: _start(name) for name in names}
    logs = {}
    try:
        for name, job in jobs.items():
            if job is not None:
                logs[name] = _finish(name, job)
    finally:
        for job in jobs.values():      # stop every nvcc this call started
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    for name in names:
        if name not in logs:
            log = library_path(name).with_suffix(".log")
            logs[name] = log.read_text() if log.exists() else ""
    return logs


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def function(name: str, symbol: str, argtypes) -> object:
    """The C function ``symbol`` of kernel ``name``, with its argument
    types declared and an ``int`` (``cudaError_t``) result."""
    key = (name, symbol)
    fn = _FUNCS.get(key)
    if fn is None:
        with _LOCK:
            fn = _FUNCS.get(key)
            if fn is None:
                fn = getattr(_library(name), symbol)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                _FUNCS[key] = fn
    return fn


def raise_on_error(name: str, err: int) -> None:
    if err:
        msg = getattr(_LIBS[name], f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one CUDA device all ``tensors`` lie on, else raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(
                f"{name}: the CUDA kernel takes CUDA tensors; got one on "
                f"{t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    return dev


def require_contiguous(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous (the kernels index them
    as dense row-major arrays)."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")


def stream_handle(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
