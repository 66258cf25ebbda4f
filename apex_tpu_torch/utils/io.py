"""Atomic JSON artifact writes (port of ``apex_tpu/utils/io.py``).

A record written with a plain ``open(path, "w")`` and cut by a crash or a
kill leaves a truncated file for every later reader. ``os.replace`` of a
fully written temp file in the same directory is atomic on POSIX, so a
reader sees the old file or the complete new one, never a torn half.
"""

from __future__ import annotations

import json
import os
from typing import Any


def atomic_write_json(path: str, obj: Any, *, indent: int = 1,
                      default=str) -> str:
    """Write ``obj`` as JSON to ``path`` atomically (temp file + rename,
    ``io.py:24-49``). The temp file lives in the target's directory, so the
    rename never crosses file systems. Serialization and I/O errors raise,
    and the temp file is removed on failure: ``path`` keeps its old
    contents. Returns ``path``."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=indent, default=default)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path
