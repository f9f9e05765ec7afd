"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel source under ``csrc/`` has a plain C interface and compiles
on its own into a shared library for ``sm_90a`` (Hopper). Libraries land
in ``build/`` at the repository root, named by a hash of the sources and
flags, so a changed source rebuilds and an unchanged one is loaded as
is. Nothing is built at import time: the first launch of a kernel builds
it, and ``build_all`` builds every kernel at once, one ``nvcc`` process
per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

# kernel name -> source file under csrc/
SOURCES = {
    "paged_decode": "paged_decode.cu",
    "decode_attention": "decode_attention.cu",
    "flash_attention": "flash_attention.cu",
    "ssd_scan": "ssd_scan.cu",
    "gelu": "gelu.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: name -> compiler output of the build that produced the library
#: (register and shared-memory use, from ``-Xptxas -v``)
build_logs: Dict[str, str] = {}


class BuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    src = CSRC / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc for ``name`` (None when its library is built)."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc failed for {name} "
                         f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a reader never sees a partial library


def check_no_grad(name: str, *tensors) -> None:
    """A kernel has no backward: a launch on inputs that require grad,
    under grad mode, raises instead of returning an output that silently
    cuts the autograd graph (training takes the plain routes)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: call it under "
                           f"torch.no_grad() or take the plain route")


def build_all() -> Dict[str, Path]:
    """Build every kernel, all nvcc processes running at once."""
    with _lock:
        started = {name: _start(name) for name in SOURCES}
        try:
            for name, st in started.items():
                _finish(name, st)
        finally:
            for st in started.values():
                if st is not None and st[0].poll() is None:
                    st[0].kill()
                    st[0].wait()
    return {name: _target(name) for name in SOURCES}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
    return lib
