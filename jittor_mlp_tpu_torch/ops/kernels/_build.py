"""Build the port's CUDA sources with nvcc into shared libraries for ctypes.

Each library is compiled at first use, from the sources in this checkout, into
``build/kernels/`` at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>_<hash>.so <sources>

The file name carries a hash of the sources, the shared headers (``*.cuh``)
and the flags, so an edited ``.cu`` or ``.cuh`` is rebuilt; so copies of the
sources may share one build directory (``JMT_KERNEL_BUILD_DIR``, which
``tools/mutation_check.py`` sets for its mutant copies). Libraries are
independent, so several may build at once (one nvcc each). The sources have a plain C interface and include no PyTorch
header, which keeps a build to seconds. Nothing here runs at import time:
the CPU-only test environment has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.environ.get("JMT_KERNEL_BUILD_DIR") or os.path.join(os.path.dirname(_PKG),
                                                                    "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
# The GEMM cores a product may take (csrc/gemm_sm90.cuh's routes, in order):
# bf16 on wgmma or WMMA, int8 on wgmma or mma.sync.
ROUTES = ("sm90", "wmma", "sm90_s8", "mma_s8")
BF16_ROUTES, S8_ROUTES = ROUTES[:2], ROUTES[2:]


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name, sources, csrc=_CSRC, build_dir=None):
    """The shared library that ``sources`` (file names under ``csrc``) build
    into: its name carries a hash of them, of every header and of the flags."""
    paths = [os.path.join(csrc, s) for s in sources]
    headers = sorted(os.path.join(csrc, f) for f in os.listdir(csrc) if f.endswith(".cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths + headers:
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir or BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def build(name, sources, csrc=_CSRC, build_dir=None):
    """Compile ``sources`` (file names under ``csrc``) into a shared library
    and return its path. Raises RuntimeError with nvcc's stderr on failure."""
    out = library_path(name, sources, csrc, build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(os.path.join(csrc, s) for s in sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, out)
    return out


class Library:
    """One kernel library: built and loaded with ctypes at first use, then
    launched on PyTorch's current stream.

    ``functions`` maps each C entry to (number of pointer arguments, number
    of int arguments); every entry takes the stream last and returns a
    cudaError_t code. ``workspace`` maps each entry that returns a size_t
    (the bytes of scratch a kernel needs, or another size of its plan) to
    its number of int arguments. ``queries`` maps each entry that returns a
    long long (a count, or a constant of a kernel's design) to its number of
    int arguments; ``routes`` names the query that counts the library's
    products per GEMM core (its argument the index of the route in
    ``ROUTES``), and ``route_names`` the routes ``routes()`` reports.
    ``error`` names the entry that turns a code into its message."""

    def __init__(self, name, sources, functions, error, workspace=None, queries=None,
                 routes=None, route_names=BF16_ROUTES):
        self.name = name
        self.sources = sources
        self.functions = functions
        self.error = error
        self.workspace_fns = workspace or {}
        self.queries = dict(queries or {})
        if routes is not None:
            self.queries.setdefault(routes, 1)
        self.routes_fn = routes
        self.route_names = tuple(route_names)
        self._lib = None
        self._lock = threading.Lock()  # first use may come from several threads

    @property
    def loaded(self):
        return self._lib is not None

    def load(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(build(self.name, self.sources))
                for fn, (n_ptr, n_int) in self.functions.items():
                    f = getattr(lib, fn)
                    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                                  + [ctypes.c_void_p])
                    f.restype = ctypes.c_int
                getattr(lib, self.error).argtypes = [ctypes.c_int]
                getattr(lib, self.error).restype = ctypes.c_char_p
                for fn, n_int in self.workspace_fns.items():
                    getattr(lib, fn).argtypes = [ctypes.c_int] * n_int
                    getattr(lib, fn).restype = ctypes.c_size_t
                for fn, n_int in self.queries.items():
                    getattr(lib, fn).argtypes = [ctypes.c_int] * n_int
                    getattr(lib, fn).restype = ctypes.c_longlong
                self._lib = lib
        return self._lib

    def workspace(self, *dims, entry=None):
        """Bytes of device scratch for these dimensions, from ``entry`` (by
        default the library's only workspace entry)."""
        if entry is None:
            (entry,) = self.workspace_fns
        return getattr(self.load(), entry)(*dims)

    def query(self, entry, *ints):
        """The long long that query ``entry`` returns for these ints."""
        return getattr(self.load(), entry)(*ints)

    def routes(self, names=None):
        """{route: n}: the products this library has launched on each GEMM
        core of ``names`` (by default ``route_names``) since it was loaded
        (zeros if it is not loaded: it has launched nothing)."""
        if self.routes_fn is None:
            raise ValueError(f"{self.name} keeps no count of GEMM routes")
        names = self.route_names if names is None else tuple(names)
        if self._lib is None:
            return dict.fromkeys(names, 0)
        return {r: self.query(self.routes_fn, ROUTES.index(r)) for r in names}

    def launch(self, fn, device, tensors, ints):
        """Call entry ``fn`` with the tensors' device pointers, the ints and
        ``device``'s current stream; raise on a nonzero cudaError_t."""
        import torch

        lib = self.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, fn)(*(t.data_ptr() for t in tensors), *ints, stream)
        if err:
            msg = getattr(lib, self.error)(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} (cudaError {err})")
