"""Build the port's CUDA sources with nvcc into shared libraries for ctypes.

Each library is compiled at first use, from the sources in this checkout, into
``build/kernels/`` at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>_<hash>.so <sources>

The file name carries a hash of the sources and flags, so an edited ``.cu``
is rebuilt. The sources have a plain C interface and include no PyTorch
header, which keeps a build to seconds. Nothing here runs at import time:
the CPU-only test environment has no nvcc.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def build(name, sources):
    """Compile ``sources`` (file names under csrc/) into a shared library
    and return its path. Raises RuntimeError with nvcc's stderr on failure."""
    paths = [os.path.join(_CSRC, s) for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, out)
    return out
