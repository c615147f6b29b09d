"""Build-at-first-use for the hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` into a shared library and loaded with
``ctypes``. Libraries live under ``build/sdfa_tpu_torch/`` at the repo
root (git-ignored), keyed by a hash of the source and the flags, so a
fresh checkout builds them on its first CUDA launch and an unchanged
source is never rebuilt. Nothing here runs at import time: a CPU host
needs no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "sdfa_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_INFO: Dict[str, dict] = {}  # name → {"seconds", "ptxas", "path"} of this process's builds


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library.
    Raises if the build fails."""
    if name in _LIBS:
        return _LIBS[name]
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as fp:
        digest = hashlib.sha256(fp.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, f"{name}-{digest}")
    lib_path = os.path.join(out_dir, f"lib{name}.so")
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
        BUILD_INFO[name] = dict(seconds=time.perf_counter() - t0,
                                ptxas=proc.stderr.strip(), path=lib_path)
    lib = ctypes.CDLL(lib_path)
    # every kernel source exports its runtime's cudaGetErrorString
    lib.sdfa_error_string.argtypes = [ctypes.c_int]
    lib.sdfa_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(name: str, t, shape):
    """Raise unless ``t`` is a contiguous float32 CUDA tensor of ``shape``."""
    if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 CUDA tensor, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes {tuple(shape)}")


def launch(name: str, tensors, ints, device):
    """Call ``sdfa_<name>(pointers..., ints..., stream)`` of csrc/<name>.cu on
    the current stream; ``None`` passes a null pointer. Raises on a
    non-zero cudaError_t (a refused launch never runs, and a later
    synchronize would not report it)."""
    lib = load_library(name)
    fn = getattr(lib, f"sdfa_{name}")
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(*(None if t is None else t.data_ptr() for t in tensors), *ints,
              torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{name} launch: CUDA error {code} "
                           f"({lib.sdfa_error_string(code).decode()})")
