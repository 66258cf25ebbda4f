"""The native host runtime: ``apex_runtime.cpp`` built with ``g++`` at first
use and bound with ctypes (port of ``apex_tpu/csrc/build.py:1-115``).

The library goes into the repository's ``build/`` directory beside the CUDA
kernels' (``apex_tpu_torch.csrc.build.BUILD_DIR``), named by a hash of the
source and the flags, so an unchanged tree reuses it. Unlike the CUDA
kernels this is host I/O, not a device kernel, and it keeps the reference's
stance: where no compiler is found or the build fails, :func:`available` is
False and every entry point takes its plain Python path.

- :func:`flatten` / :func:`unflatten`: contiguous bucket packing
  (``csrc/flatten_unflatten.cpp``);
- :func:`native_stream`: the threaded batch streamer behind
  :class:`apex_tpu_torch.csrc.TokenLoader`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from apex_tpu_torch.csrc.build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "apex_runtime.cpp")
CFLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"apex_runtime-{h.hexdigest()[:16]}.so")


def _compile(path: str) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("g++")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="apex_runtime-", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CFLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)  # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    path = library_path()
    try:
        if os.path.exists(path):
            try:
                return ctypes.CDLL(path)
            except OSError:
                pass  # built on another host's libraries: build it here
        _compile(path)
        return ctypes.CDLL(path)
    except Exception:  # noqa: BLE001 - any failure selects the Python paths
        _build_failed = True
        return None


def _get() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            lib = _build()
            if lib is not None:
                lib.apex_flatten.argtypes = [
                    ctypes.POINTER(ctypes.c_void_p),
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int]
                lib.apex_unflatten.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                    ctypes.c_int]
                lib.tl_create.restype = ctypes.c_void_p
                lib.tl_create.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                    ctypes.c_int64, ctypes.c_int, ctypes.c_int]
                lib.tl_next.restype = ctypes.c_int
                lib.tl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                lib.tl_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library built and loaded (else the Python paths
    run)."""
    return _get() is not None


def flatten(arrays: Sequence[np.ndarray], threads: int = 4) -> np.ndarray:
    """Pack arrays into one contiguous uint8 buffer (``apex_C.flatten``,
    ``csrc/flatten_unflatten.cpp:15``)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    out = np.empty((sum(a.nbytes for a in arrays),), np.uint8)
    lib = _get()
    if lib is None or not arrays:
        off = 0
        for a in arrays:
            out[off:off + a.nbytes] = a.view(np.uint8).reshape(-1)
            off += a.nbytes
        return out
    n = len(arrays)
    srcs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays])
    sizes = (ctypes.c_int64 * n)(*[a.nbytes for a in arrays])
    lib.apex_flatten(srcs, sizes, n, out.ctypes.data_as(ctypes.c_void_p),
                     threads)
    return out


def unflatten(flat: np.ndarray, like: Sequence[np.ndarray],
              threads: int = 4) -> List[np.ndarray]:
    """Split a flat buffer back into arrays shaped and typed like ``like``
    (``apex_C.unflatten``, ``csrc/flatten_unflatten.cpp:16``)."""
    flat = np.ascontiguousarray(flat).view(np.uint8).reshape(-1)
    total = sum(a.nbytes for a in like)
    if flat.nbytes != total:
        raise ValueError(f"flat buffer {flat.nbytes}B != templates {total}B")
    outs = [np.empty(a.shape, a.dtype) for a in like]
    lib = _get()
    if lib is None or not outs:
        off = 0
        for o in outs:
            o.view(np.uint8).reshape(-1)[:] = flat[off:off + o.nbytes]
            off += o.nbytes
        return outs
    n = len(outs)
    dsts = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
    sizes = (ctypes.c_int64 * n)(*[o.nbytes for o in outs])
    lib.apex_unflatten(flat.ctypes.data_as(ctypes.c_void_p), dsts, sizes, n,
                       threads)
    return outs


def native_stream(paths: Sequence[str], batch_shape: Sequence[int],
                  dtype: np.dtype, n_buffers: int, loop: bool
                  ) -> Iterator[np.ndarray]:
    """The batches of ``paths`` (concatenated, cut into ``batch_shape``, a
    ragged tail dropped, re-looped with ``loop``) from the native worker
    thread of a stream of its own, which closing the generator stops."""
    lib = _get()
    if lib is None:
        raise RuntimeError("the native runtime is not available")
    batch_bytes = int(np.prod(batch_shape)) * np.dtype(dtype).itemsize
    names = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    handle = lib.tl_create(names, len(paths), batch_bytes, n_buffers,
                           int(loop))
    out = np.empty(tuple(batch_shape), dtype)
    try:
        while lib.tl_next(handle, out.ctypes.data_as(ctypes.c_void_p)):
            yield out.copy()
    finally:
        lib.tl_destroy(handle)
