"""Token-file streaming (port of ``TokenLoader``, ``apex_tpu/csrc/
build.py:117-195``).

As the reference, it streams ``.bin`` files on a native worker thread
(the C++ of ``apex_runtime.cpp``, :mod:`apex_tpu_torch.csrc.runtime`) where
the runtime built, and otherwise reads them in Python on the background
thread of :class:`apex_tpu_torch.data.loader.PrefetchIterator`
(``available()`` says which). It is host-side I/O, no device kernel. The
stream is the reference's on both paths: the files concatenated in order as
one token sequence, cut into batches of ``batch_shape`` (a ragged tail is
dropped), re-looped with ``loop=True``; every ``iter()`` restarts the
stream on a worker of its own, so iterators are independent; a missing
file raises at construction.
"""

from __future__ import annotations

import os
from typing import Iterator, Sequence

import numpy as np

from apex_tpu_torch.csrc import runtime
from apex_tpu_torch.data.loader import PrefetchIterator


class TokenLoader:
    """Stream fixed-size batches of ``dtype`` tokens from binary files.

    ``n_buffers``: batches read ahead by each iterator's thread."""

    def __init__(self, paths: Sequence[str], batch_shape: Sequence[int],
                 dtype=np.int32, n_buffers: int = 4, loop: bool = False):
        self.paths = [os.fspath(p) for p in paths]
        if not self.paths:
            raise ValueError("no input files")
        for p in self.paths:
            if not os.path.exists(p):
                raise FileNotFoundError(p)
        self.batch_shape = tuple(batch_shape)
        self.dtype = np.dtype(dtype)
        self.batch_bytes = int(np.prod(self.batch_shape)) * self.dtype.itemsize
        if self.batch_bytes <= 0:
            raise ValueError(f"empty batch shape {self.batch_shape}")
        self.loop = loop
        self._n_buffers = n_buffers
        self._iters: list = []

    def __iter__(self) -> Iterator[np.ndarray]:
        """Each iteration restarts the stream."""
        if runtime.available():
            it = runtime.native_stream(self.paths, self.batch_shape,
                                       self.dtype, self._n_buffers,
                                       self.loop)
        else:
            it = PrefetchIterator(self._stream(), depth=self._n_buffers)
        self._iters.append(it)
        return it

    def _stream(self) -> Iterator[np.ndarray]:
        carry = b""
        while True:
            produced = 0  # a pass over empty files ends even a looped stream
            for p in self.paths:
                with open(p, "rb") as f:
                    while chunk := f.read(1 << 16):
                        produced += len(chunk)
                        carry += chunk
                        while len(carry) >= self.batch_bytes:
                            buf = carry[:self.batch_bytes]
                            carry = carry[self.batch_bytes:]
                            yield np.frombuffer(buf, self.dtype).reshape(
                                self.batch_shape).copy()
            if not self.loop or produced == 0:
                return

    def close(self) -> None:
        """Stop every live iterator's worker thread."""
        while self._iters:
            self._iters.pop().close()
