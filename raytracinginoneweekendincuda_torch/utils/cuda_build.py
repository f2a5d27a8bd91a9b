"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each library is compiled at first use into ``build/torch_kernels/`` at the
repository root, under a name keyed by a hash of every file in ``csrc/``
and the nvcc flags, so an edited source rebuilds and an unchanged one
loads the cached ``.so``.  The sources have a plain C interface (no
PyTorch headers), which keeps a cold build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# name -> (CDLL, build record); one load per process
_LOADED: dict = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def load_library(name: str):
    """Compile ``csrc/<name>.cu`` (if not cached) and load it.  Returns
    (ctypes.CDLL, record) where record holds the build seconds (0.0 when
    the cached library was loaded) and nvcc's ptxas report."""
    if name in _LOADED:
        return _LOADED[name]
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = f"{name}_{_source_hash()}"
    lib_path = os.path.join(BUILD_DIR, stem + ".so")
    log_path = os.path.join(BUILD_DIR, stem + ".log")
    seconds = 0.0
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        with open(log_path, "w") as f:
            f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n"
                               f"{res.stderr[-4000:]}")
        os.replace(tmp, lib_path)
    ptxas = ""
    if os.path.exists(log_path):
        with open(log_path) as f:
            ptxas = f.read()
    lib = ctypes.CDLL(lib_path)
    record = {"path": lib_path, "seconds": seconds, "ptxas": ptxas}
    _LOADED[name] = (lib, record)
    return _LOADED[name]
