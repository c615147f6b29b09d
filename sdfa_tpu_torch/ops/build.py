"""Build-at-first-use for the hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` into a shared library and loaded with
``ctypes``. Libraries live under ``build/sdfa_tpu_torch/`` at the repo
root (git-ignored), keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a fresh checkout builds them on its
first CUDA launch and an unchanged source is never rebuilt.
``load_libraries`` builds several sources at once, one ``nvcc`` each.
``load_host_library`` builds a C++ source for the host CPU the same way
(the native deformation runtime, ``csrc/deformation.cpp``), with the host's
C++ compiler and the flags of the JAX package's ``csrc/Makefile``, keyed also
by the CPU it was built on (``-march=native``). Nothing here runs at import
time: a CPU host needs no ``nvcc``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import glob
import hashlib
import logging
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence

import torch

log = logging.getLogger(__name__)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "sdfa_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# csrc/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-fopenmp", "-Wall", "-shared"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_QUERIES: Dict[tuple, list] = {}  # (name, entry, device index) → what query_ints returned
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


def _compile(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; return the
    library's path. Raises if the build fails."""
    src = os.path.join(CSRC, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as fp:
            digest.update(fp.read())
    out_dir = os.path.join(BUILD_ROOT, f"{name}-{digest.hexdigest()[:16]}")
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
    return lib_path


def _host_cpu() -> str:
    """What ``-march=native`` compiles for: the CPU's feature flags."""
    try:
        with open("/proc/cpuinfo") as fp:
            return next((line for line in fp if line.startswith("flags")), "")
    except OSError:
        import platform

        return platform.processor() or platform.machine()


def _host_build(name: str, cxx: str, flags) -> str:
    """Compile ``csrc/<name>.cpp`` with ``flags`` unless built; the library's
    path. Raises with the compiler's output if the build fails."""
    src = os.path.join(CSRC, name + ".cpp")
    digest = hashlib.sha256(" ".join([cxx, *flags, _host_cpu()]).encode())
    with open(src, "rb") as fp:
        digest.update(fp.read())
    out_dir = os.path.join(BUILD_ROOT, f"{name}-host-{digest.hexdigest()[:16]}")
    lib_path = os.path.join(out_dir, f"lib{name}.so")
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([cxx, *flags, "-o", tmp, src], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed for {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)
        BUILD_INFO[name] = dict(seconds=time.perf_counter() - t0, ptxas="", path=lib_path,
                                openmp="-fopenmp" in flags)
    return lib_path


def load_host_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cpp`` for this host's CPU unless its library
    exists, and return it loaded. A compiler without OpenMP's runtime builds it
    without ``-fopenmp``: the source guards its OpenMP loops (over frames, each
    computed alone), so its results are the same bits, on one thread; the
    build says so in the log and in ``BUILD_INFO``. Raises if the build fails."""
    key = f"host:{name}"
    if key in _LIBS:
        return _LIBS[key]
    cxx = os.environ.get("CXX") or "g++"
    try:
        lib_path = _host_build(name, cxx, CXX_FLAGS)
    except RuntimeError as exc:
        if "omp" not in str(exc):
            raise
        log.warning("%s has no OpenMP runtime; building %s.cpp single-threaded", cxx, name)
        lib_path = _host_build(name, cxx, [f for f in CXX_FLAGS if f != "-fopenmp"])
    _LIBS[key] = ctypes.CDLL(lib_path)
    return _LIBS[key]


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library.
    Raises if the build fails."""
    if name not in _LIBS:
        lib = ctypes.CDLL(_compile(name))
        # every kernel source exports its runtime's cudaGetErrorString
        lib.sdfa_error_string.argtypes = [ctypes.c_int]
        lib.sdfa_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def load_libraries(names: Sequence[str]):
    """Build the named kernels side by side (one ``nvcc`` process each, all
    started together) and load them. Raises if any build fails."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for future in [pool.submit(_compile, name) for name in names]:
            future.result()
    for name in names:
        load_library(name)


def check(name: str, t, shape):
    """Raise unless ``t`` is a contiguous float32 CUDA tensor of ``shape``."""
    if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 CUDA tensor, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes {tuple(shape)}")


def launch(name: str, tensors, ints, device, entry: str = ""):
    """Call ``sdfa_<entry or name>(pointers..., ints..., stream)`` of
    csrc/<name>.cu on ``device``'s current stream; ``None`` passes a null
    pointer. The device is made current for the call, so a launch from
    autograd's thread lands on the tensors' card. Raises on a non-zero
    cudaError_t (a refused launch never runs, and a later synchronize would
    not report it)."""
    lib = load_library(name)
    fn = getattr(lib, f"sdfa_{entry or name}")
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        code = fn(*(None if t is None else t.data_ptr() for t in tensors), *ints,
                  torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{entry or name} launch: CUDA error {code} "
                           f"({lib.sdfa_error_string(code).decode()})")


def query_ints(name: str, entry: str, count: int, device):
    """Call ``sdfa_<entry>(int*)`` of csrc/<name>.cu, which fills ``count``
    ints about ``device`` (how many clusters of a kernel it holds at once,
    the tiles it was built with), and return them; a device is asked once.
    Raises on a non-zero cudaError_t."""
    index = torch.device(device).index
    key = (name, entry, torch.cuda.current_device() if index is None else index)
    if key in _QUERIES:
        return list(_QUERIES[key])
    lib = load_library(name)
    fn = getattr(lib, f"sdfa_{entry}")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * count)()
    with torch.cuda.device(device):
        code = fn(out)
    if code != 0:
        raise RuntimeError(f"{entry}: CUDA error {code} ({lib.sdfa_error_string(code).decode()})")
    _QUERIES[key] = list(out)
    return list(out)
