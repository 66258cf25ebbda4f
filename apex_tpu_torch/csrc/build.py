"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Counterpart of ``apex_tpu/csrc/build.py`` (a lazy ``g++`` build bound with
ctypes), without its fallback: if ``nvcc`` is missing or the build fails,
:func:`load` raises.

At first use every ``*.cu`` source beside this file is compiled by its own
``nvcc`` process, all started together, for ``sm_90a``; the objects are
linked into one shared library under ``build/`` at the repository root,
named by a hash of the sources and flags, so an unchanged tree reuses it and
a changed one rebuilds. Ranks that start together build once: the build
runs under an ``fcntl`` lock on a file in ``build/`` (:func:`build_once`),
and a process that waited on it finds the library and loads it. The
library exports plain C functions: pointers and
the CUDA stream are ``c_void_p``, and each function returns
``cudaGetLastError()``, which :func:`check` turns into an exception.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Callable, Optional

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ("-std=c++17", "-O3", "-Xptxas", "-v") + ARCH_FLAGS

#: element-type codes of the entry points (``DType`` in common.cuh)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: argument types of every exported entry point (restype is int)
#: the segment arguments of the flash entry points, before the stream: the
#: q and k ids, the bounds, the outer and inner (min, max) tables, the outer
#: rows' ranges, pad_id, has_pad
_SEG = [_P] * 6 + [_I] * 2

SIGNATURES = {
    "apex_ln_fwd": [_P] * 6 + [_L, _I, _F] + [_I] * 4 + [_P],
    "apex_flash_fwd": [_P] * 5 + [_I] * 5 + [_L] * 9 + [_P] + [_L] * 4
                      + [_F] + [_I] * 7 + _SEG + [_P],
    "apex_flash_decode": [_P] * 8 + [_I] * 7 + [_F] + [_I] * 3 + [_P],
    "apex_flash_decode_multi": [_P] * 8 + [_I] * 8 + [_F] + [_I] * 3
                               + [_P],
    "apex_ln_bwd": [_P] * 10 + [_L] + [_I] * 6 + [_P],
    "apex_flash_bwd_dq": [_P] * 10 + [_I] * 5 + [_L] * 16 + [_I] * 2
                         + [_F] + [_I] * 7 + _SEG + [_P],
    "apex_flash_bwd_dkv": [_P] * 9 + [_I] * 5 + [_L] * 16
                          + [_F] + [_I] * 7 + _SEG + [_P],
    "apex_flash_fwd_stream": [_P] * 8 + [_I] * 5 + [_L] * 9
                             + [_F] + [_I] * 8 + _SEG + [_P],
    "apex_flash_bwd_dq_stream": [_P] * 7 + [_I] * 5 + [_L] * 12
                                + [_F] + [_I] * 8 + _SEG + [_P],
    "apex_flash_bwd_dkv_stream": [_P] * 8 + [_I] * 5 + [_L] * 12
                                 + [_F] + [_I] * 8 + _SEG + [_P],
    "apex_xent_fwd": [_P] * 4 + [_L, _I, _F, _L, _I, _P],
    "apex_xent_bwd": [_P] * 5 + [_L, _I, _F, _L, _I, _P],
    "apex_softmax_fwd": [_P] * 3 + [_L] + [_I] * 4 + [_F] + [_I] * 3 + [_P],
    "apex_softmax_bwd": [_P] * 3 + [_L, _I, _F, _I, _I, _P],
    "apex_empty_kernel": [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took (0.0 when the cached library was reused)
last_build_seconds = 0.0


def sources():
    return sorted(glob.glob(os.path.join(_DIR, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_DIR, "*.cu"))
                       + glob.glob(os.path.join(_DIR, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from source at first use and have no fallback")


def _compile(lib_path: str) -> None:
    """One nvcc per source, all running at once, then one link."""
    global last_build_seconds
    t0 = time.perf_counter()
    compiler = nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="kernels-", dir=BUILD_DIR)
    srcs = sources()
    procs = []
    try:
        for src in srcs:
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [compiler, *CFLAGS, "-Xcompiler", "-fPIC", "-c", src,
                   "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        log = []
        failed = []
        for src, _obj, proc in procs:
            out, _ = proc.communicate(timeout=600)
            log.append(f"== {os.path.basename(src)}\n{out.decode(errors='replace')}")
            if proc.returncode:
                failed.append(os.path.basename(src))
        with open(lib_path + ".log", "w") as f:
            f.write("\n".join(log))
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log)[-8000:])
        tmp_lib = os.path.join(work, "lib.so")
        link = subprocess.run(
            [compiler, *ARCH_FLAGS, "-shared", "-o", tmp_lib,
             *[obj for _src, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=300)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace")[-8000:])
        os.replace(tmp_lib, lib_path)
    finally:
        for _src, _obj, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    last_build_seconds = time.perf_counter() - t0


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"apex_tpu_torch_kernels-{_digest()}.so")


@contextlib.contextmanager
def file_lock(path: str):
    """An exclusive ``fcntl`` lock on ``path`` (made if missing), held
    across processes for the ``with`` block."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_once(path: str, compile_fn: Callable[[str], None]) -> None:
    """``compile_fn(path)`` unless ``path`` exists, under a file lock beside
    it: of the processes that call this together one compiles, the others
    wait and find the file."""
    if os.path.exists(path):
        return
    with file_lock(path + ".lock"):
        if not os.path.exists(path):
            compile_fn(path)


def load() -> ctypes.CDLL:
    """The kernel library, built on first call (raises if it cannot be)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            build_once(path, _compile)
            lib = ctypes.CDLL(path)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.apex_torch_error_string.argtypes = [ctypes.c_int]
            lib.apex_torch_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def current_stream(device_index: int) -> int:
    """The raw handle of PyTorch's current stream on the CUDA device of
    that index (``tensor.get_device()``), the kernels' stream argument."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def empty_kernel(device_index: int) -> None:
    """Launch an empty kernel on the current stream: the launch floor that a
    kernel's time at a small shape is read against."""
    check(load().apex_empty_kernel(current_stream(device_index)),
          "apex_empty_kernel")


def check(err: int, name: str) -> None:
    """Raise if an entry point returned a CUDA error."""
    if err:
        msg = load().apex_torch_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
