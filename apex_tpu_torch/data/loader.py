"""Batch loaders with background prefetch (a copy of
``apex_tpu/data/loader.py``; the port imports nothing of the JAX package).

Reference shape: examples/imagenet/main_amp.py:183-254 builds DALI/torch
loaders whose job is to keep the accelerator fed; ``data_prefetcher``
(main_amp.py:256-280) double-buffers host->device copies on a side CUDA
stream. Here a background thread prepares the *next* host batch while the
current step runs (the card's work is issued asynchronously, so one batch
of lookahead hides host latency). Pure numpy and threads.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np


class PrefetchIterator:
    """Wrap any iterator with an N-deep background prefetch thread — the
    ``data_prefetcher`` equivalent (main_amp.py:256-280), with a thread in
    place of the side CUDA stream."""

    _SENTINEL = object()

    def __init__(self, it: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def _worker():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(item)
            except BaseException as e:  # surfaced on next()
                # deliberate retention: the worker failure must re-raise on
                # next(); host-side iterator state, freed with the loader,
                # no device frames in the traceback
                # lint: disable=exception-retention -- re-raised on next(); host-side, no device frames
                self._err = e
            finally:
                if not self._stop.is_set():
                    self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=_worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            # re-arm so repeated next() keeps raising instead of blocking on
            # the dead worker (iterator protocol: StopIteration is sticky)
            self._q.put(self._SENTINEL)
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the worker: it ends at its next item (a put blocked on a
        full queue is freed by emptying it); ``next`` raises StopIteration
        from then on."""
        self._stop.set()
        while True:  # the worker puts at most one more item
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            try:
                self._q.put_nowait(self._SENTINEL)
                return
            except queue.Full:
                continue


class NpyBatchLoader:
    """Stream ``(images, labels)`` batches from a directory of ``.npz`` files.

    Each file holds arrays ``images`` (N,H,W,C) and ``labels`` (N,); files are
    visited in sorted order and re-batched to ``batch_shape[0]``. Prefetches
    ``prefetch`` batches ahead on a background thread.
    """

    def __init__(
        self,
        data_dir: str,
        batch_shape: Sequence[int],
        prefetch: int = 2,
        loop: bool = False,
    ):
        self.data_dir = data_dir
        self.batch = int(batch_shape[0])
        self.prefetch = prefetch
        self.loop = loop
        self.files = sorted(
            os.path.join(data_dir, f)
            for f in os.listdir(data_dir)
            if f.endswith(".npz")
        )
        if not self.files:
            raise FileNotFoundError(f"no .npz batch files in {data_dir}")

    def _raw(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        buf_x, buf_y = [], []
        while True:
            for path in self.files:
                with np.load(path) as z:
                    buf_x.append(np.asarray(z["images"]))
                    buf_y.append(np.asarray(z["labels"]))
                x = np.concatenate(buf_x) if len(buf_x) > 1 else buf_x[0]
                y = np.concatenate(buf_y) if len(buf_y) > 1 else buf_y[0]
                while x.shape[0] >= self.batch:
                    yield x[: self.batch], y[: self.batch]
                    x, y = x[self.batch :], y[self.batch :]
                buf_x, buf_y = ([x] if x.shape[0] else []), ([y] if y.shape[0] else [])
            if not self.loop:
                return

    def __iter__(self):
        return PrefetchIterator(self._raw(), depth=self.prefetch)
