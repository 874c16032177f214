"""Host-side batch loader backed by native C++ (counterpart of
``jittor_mlp_tpu/data/loader.py``).

Two libraries, each built with ``g++`` at first use from the sources in
``data/native/`` into ``build/native/`` at the repository root (gitignored)
in a checkout, or the per-user cache's ``jittor_mlp_tpu_torch/native`` once
installed (``ops/kernels/_build.build_root``; ``JMT_NATIVE_BUILD_DIR``
overrides both), as ``<name>_<hash>.so`` with a hash of the source and the flags (the naming
of ``ops/kernels/_build.py``), and bound with ctypes:

- ``fastloader``: uint8 NHWC → normalized float32 NCHW, and bilinear uint8
  resize. Without a compiler both fall back to plain numpy / PyTorch on the
  CPU, with the JAX package's semantics.
- ``decode``: threaded JPEG/PNG decode (libjpeg, libpng) with shorter-side
  resize and center crop to a square; ``decode_batch`` flags per image what
  it could not read (other containers, CMYK, alpha PNGs, corrupt data), for
  the caller's PIL fallback.

``HostLoader`` assembles model-ready NCHW float batches from uint8 HWC
images with no per-pixel Python work; ``preprocess.make_preprocess`` is the
on-device alternative. Nothing builds at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..ops.kernels._build import build_root

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
BUILD_DIR = build_root("native", "JMT_NATIVE_BUILD_DIR")
_LOCK = threading.Lock()
_LIBS = {}  # name → CDLL, or None when the build failed


def library_path(name, flags):
    """``<BUILD_DIR>/<name>_<hash>.so``: the hash covers the source and the
    flags, so an edited source builds anew."""
    with open(os.path.join(_NATIVE, f"{name}.cpp"), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def _compile(name, flags, libs=()):
    """g++ ``native/<name>.cpp`` with ``flags`` into its build path (atomic:
    a temporary file renamed into place). Returns the path."""
    out = library_path(name, flags)
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", *flags, "-o", tmp,
                        os.path.join(_NATIVE, f"{name}.cpp"), *libs],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def _load(name, build, bind):
    """The library ``name``, built and bound at first use; None if it cannot
    be built (no g++, missing headers) — tried once per process."""
    with _LOCK:
        if name not in _LIBS:
            try:
                lib = ctypes.CDLL(build())
                bind(lib)
            except (OSError, subprocess.CalledProcessError):
                lib = None
            _LIBS[name] = lib
        return _LIBS[name]


def _build_fastloader():
    try:
        return _compile("fastloader", ["-fopenmp"])
    except (OSError, subprocess.CalledProcessError):
        return _compile("fastloader", [])  # without OpenMP


def _bind_fastloader(lib):
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.normalize_u8_nhwc_to_nchw_f32.argtypes = [ptr, ptr, i64, i64, i64, i64, ptr, ptr]
    lib.normalize_u8_nhwc_to_nchw_f32.restype = None
    lib.resize_bilinear_u8.argtypes = [ptr, ptr, i64, i64, i64, i64, i64, i64]
    lib.resize_bilinear_u8.restype = None


def _bind_decode(lib):
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.decode_batch_to_square_rgb.argtypes = [ptr, ptr, i64, ptr, i64, i64, ptr]
    lib.decode_batch_to_square_rgb.restype = None


def _lib():
    return _load("fastloader", _build_fastloader, _bind_fastloader)


def _decode_lib():
    return _load("decode", lambda: _compile("decode", [], ["-ljpeg", "-lpng", "-lpthread"]),
                 _bind_decode)


def native_available():
    """True when the fastloader library built and loaded."""
    return _lib() is not None


def decode_available():
    """True when the decoder library built and loaded (g++ with the libjpeg
    and libpng headers)."""
    return _decode_lib() is not None


def decode_batch(buffers, size, threads=None):
    """Decode a list of encoded image byte strings (JPEG/PNG) to a
    (n, size, size, 3) uint8 batch — shorter-side resize + center crop,
    the ImageFolderDataset.get geometry — on a native thread pool.

    Returns (batch, fail) where fail[i] is True for images the native path
    could not handle (other containers, CMYK, alpha, corrupt data); the
    caller falls back to PIL for those. Raises RuntimeError if the native
    library is unavailable — gate on decode_available()."""
    lib = _decode_lib()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    n = len(buffers)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(b) for b in buffers], out=offsets[1:])
    blob = b"".join(buffers)
    blob_arr = np.frombuffer(blob, np.uint8) if blob else np.zeros(1, np.uint8)
    out = np.empty((n, size, size, 3), np.uint8)
    fail = np.zeros(n, np.uint8)
    if threads is None:
        threads = min(8, os.cpu_count() or 1)
    lib.decode_batch_to_square_rgb(blob_arr.ctypes.data, offsets.ctypes.data, n,
                                   out.ctypes.data, size, threads, fail.ctypes.data)
    return out, fail.astype(bool)


def normalize_batch(images_u8, mean, std):
    """(N, H, W, C) uint8 → (N, C, H, W) float32 standardized."""
    images_u8 = np.ascontiguousarray(images_u8, dtype=np.uint8)
    n, h, w, c = images_u8.shape
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib = _lib()
    if lib is None:
        x = (images_u8.astype(np.float32) / 255.0 - mean) / std
        return np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    out = np.empty((n, c, h, w), np.float32)
    lib.normalize_u8_nhwc_to_nchw_f32(images_u8.ctypes.data, out.ctypes.data, n, h, w, c,
                                      mean.ctypes.data, std.ctypes.data)
    return out


def resize_batch(images_u8, size):
    """(N, H, W, C) uint8 → (N, size, size, C) uint8, bilinear half-pixel.
    Without the native library: ``preprocess.resize_bilinear`` (antialiased
    when shrinking, as ``jax.image.resize``) on the CPU, rounded."""
    images_u8 = np.ascontiguousarray(images_u8, dtype=np.uint8)
    n, h, w, c = images_u8.shape
    oh, ow = (size, size) if isinstance(size, int) else size
    lib = _lib()
    if lib is None:
        import torch

        from .preprocess import resize_bilinear

        out = resize_bilinear(torch.from_numpy(images_u8), (oh, ow))
        return torch.clamp(out + 0.5, 0, 255).to(torch.uint8).numpy()
    out = np.empty((n, oh, ow, c), np.uint8)
    lib.resize_bilinear_u8(images_u8.ctypes.data, out.ctypes.data, n, h, w, c, oh, ow)
    return out


class HostLoader:
    """Assemble model-ready batches from uint8 HWC images on the host."""

    def __init__(self, image_size=224, mean=(0.485, 0.456, 0.406),
                 std=(0.229, 0.224, 0.225)):
        self.image_size = image_size
        self.mean = mean
        self.std = std

    def __call__(self, images_u8):
        x = np.asarray(images_u8)
        if x.shape[1] != self.image_size or x.shape[2] != self.image_size:
            x = resize_batch(x, self.image_size)
        return normalize_batch(x, self.mean, self.std)
