"""Builds the port's CUDA sources and loads them with ctypes.

Every `csrc/*.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library of its own with a plain C interface, one `nvcc` per source, all
started together. The libraries go to `build/kernels/` at the root of the
checkout, named by a hash of the sources and flags, so a rebuild happens
only when a source changes. The build runs at the first CUDA call, never
at import. A failed build or a non-zero CUDA error from a launch raises:
there is no fall back to the plain versions.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: compiler output (ptxas register/shared-memory report) per source
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (nvcc on PATH or under "
                           "/usr/local/cuda/bin)")
    return path


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def _build_locked() -> float:
    """Compile every source whose library is missing; returns seconds."""
    t0 = time.perf_counter()
    todo = [(src, _lib_path(src)) for src in sorted(CSRC.glob("*.cu"))]
    todo = [(src, out) for src, out in todo if not out.exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for src, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src, out, tmp, proc))
        failed = []
        for src, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            BUILD_LOG[src.name] = log
            if proc.returncode:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
    finally:
        for _src, _out, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def build_all() -> float:
    """Build every kernel library now (the first CUDA call does this
    anyway); returns the build's seconds, 0 when all were built."""
    with _lock:
        return _build_locked()


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use.
    `signatures` maps each C entry point to its ctypes argument types;
    every entry point returns a CUDA error code (int)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked()
            lib = ctypes.CDLL(str(_lib_path(CSRC / f"{name}.cu")))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(rc: int, what: str):
    """Raise on a non-zero CUDA error code returned by an entry point."""
    if rc:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def on_device(t: torch.Tensor):
    """A context that makes `t`'s device the current one for a launch; a
    no-op when it already is."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on `t`'s device. Read
    without building a `torch.cuda.Stream` (`current_stream()`), which
    costs a few microseconds of host time a launch."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def refuse_dtensor(name: str, *tensors):
    """Raise TypeError for a DTensor among `tensors`: a wrapper takes a
    rank's local tensors only (the model calls it under `local_map`); it
    neither gathers a DTensor nor runs on its local shard by itself."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name}: got a DTensor; call it on local tensors "
                        f"(e.g. through torch.distributed.tensor."
                        f"experimental.local_map)")


def is_fake(t) -> bool:
    """A tensor with no memory behind it (a `FakeTensor`, or one on the
    meta device): a wrapper sends it to its custom op, whose fake
    implementation gives the output shapes."""
    from torch._subclasses.fake_tensor import is_fake as _fake
    return t.device.type == "meta" or _fake(t)


def require_cuda(name: str, *tensors: torch.Tensor, dtype: torch.dtype):
    """Validate what a kernel takes: CUDA, one device, `dtype`, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
