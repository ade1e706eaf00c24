"""Builds a CUDA source under csrc/ into a shared library and loads it.

The sources have a plain C interface, so nvcc builds each in seconds without
PyTorch's headers (``nvcc ... -shared -Xcompiler -fPIC``), and ctypes binds
it. The build runs at first use, into ``_build/`` beside this file (listed in
``.gitignore``), under a name keyed by the source's hash, so an edited source
is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: dict = {}
# name -> seconds spent in nvcc (0.0 when the library was already built)
build_seconds: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    if name in _libs:
        return _libs[name]
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as fp:
        digest = hashlib.sha256(fp.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(so):
        build_seconds[name] = 0.0
    else:
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
        build_seconds[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(so)
    _libs[name] = lib
    return lib
