"""Checkpoint / resume (port of ``apex_tpu/checkpoint.py``, its npz
backend).

The whole train state is one tree -- ``{"params": ..., "opt": ...}`` in the
JAX package's layout (:func:`apex_tpu_torch._params.module_tree`,
:func:`apex_tpu_torch.amp.state_tree`) -- saved as one ``.npz`` file under
``directory/step_{N}/state.npz``, with ``latest_step`` discovery. The file
format is the reference's exactly (``checkpoint.py:44-97``): keys are the
``/``-joined tree paths, and a bfloat16 leaf (numpy has none) is stored as
its bytes (uint8) with ``{"dtype", "shape"}`` recorded under
``__apex_tpu_dtypes__``. So a checkpoint written by either package restores
in the other. bfloat16 is encoded and decoded through an int16 view and
``torch.bfloat16``, without ml_dtypes; other byte-stored dtypes (fp8)
raise on restore.

Leaves may be tensors (any device; bf16 kept), numpy arrays or Python
numbers; restored leaves are CPU tensors in the saved dtypes. The orbax
backend is not ported.

Tensor parallelism keeps the file topology-free, as the reference's
``sharding_tree`` restore does: :func:`save_checkpoint` with ``specs`` (the
split of each leaf over the model axis, ``tensor_parallel.layers``' form)
gathers every model-sharded leaf to its full shape -- every rank of the
axis calls it -- and the first rank of the world writes; and
:func:`restore_checkpoint` with ``specs`` cuts the full tree to one tensor-
parallel rank's shard. So a checkpoint saved at tp 2 resumes serial, and a
serial one resumes at tp 2. Pipeline stages save and restore the same way
over ``("model", "pipe")``: the file holds the whole layer stack, and an
expert-parallel MoE model over ``("model", "pipe", "data")``: the file
holds every expert. A subtree with no entry in ``specs`` (None) is
replicated.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.parallel.mesh import AXIS_MODEL

_STEP_RE = re.compile(r"^step_(\d+)$")
_SEP = "/"
_META_KEY = "__apex_tpu_dtypes__"

#: the dtype numpy has no native form of that the port's trees hold,
#: stored as bytes under ml_dtypes' name (the one the JAX package writes)
_BF16 = "bfloat16"


def _leaves(tree, path: Tuple = ()) -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` of a tree of dicts, lists and tuples (JAX's order:
    sorted dict keys); None is an empty subtree, as in JAX."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield _SEP.join(str(p) for p in path), tree


def _encode(leaf) -> Tuple[np.ndarray, Optional[dict]]:
    """A leaf as a numpy array, and its ``{"dtype", "shape"}`` record where
    it is stored as bytes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype != torch.bfloat16:
            return t.numpy(), None
        raw = t.reshape(-1).view(torch.int16).numpy().view(np.uint8)
        return raw, {"dtype": _BF16, "shape": list(t.shape)}
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or not arr.dtype.isbuiltin:
        return (np.ascontiguousarray(arr).reshape(-1).view(np.uint8),
                {"dtype": arr.dtype.name, "shape": list(arr.shape)})
    return arr, None


def _decode(arr: np.ndarray, meta: Optional[dict]) -> torch.Tensor:
    if meta is None:
        return torch.from_numpy(np.array(arr))
    if meta["dtype"] != _BF16:
        raise ValueError(f"checkpoint leaf of dtype {meta['dtype']!r}: the "
                         f"port reads bfloat16 bytes only")
    raw = np.ascontiguousarray(arr).view(np.int16).copy()
    return torch.from_numpy(raw).view(torch.bfloat16).reshape(meta["shape"])


def _flatten(tree) -> Dict[str, np.ndarray]:
    """``{path: ndarray}`` plus the dtype record (``checkpoint.py:58-73``)."""
    flat, meta = {}, {}
    for key, leaf in _leaves(tree):
        flat[key], record = _encode(leaf)
        if record is not None:
            meta[key] = record
    flat[_META_KEY] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                    dtype=np.uint8)
    return flat


def _unflatten_into(target, flat):
    """``target``'s structure with every leaf read from ``flat`` (a dict or
    an open ``NpzFile``, read leaf by leaf) as a CPU tensor; a missing key
    raises ``KeyError`` (``checkpoint.py:76-97``)."""
    meta = {}
    if _META_KEY in flat:
        meta = json.loads(bytes(np.asarray(flat[_META_KEY])).decode("utf-8"))

    def rebuild(tree, path):
        if isinstance(tree, dict):
            return {k: rebuild(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, path + (i,))
                              for i, v in enumerate(tree))
        if tree is None:
            return None
        key = _SEP.join(str(p) for p in path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        return _decode(flat[key], meta.get(key))

    return rebuild(target, ())


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}")


def latest_step(directory: str) -> Optional[int]:
    """Largest saved step number under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := _STEP_RE.match(name))]
    return max(steps) if steps else None


def _axes(axis: Union[str, Sequence[str]]) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def save_checkpoint(directory: str, step: int, state: Any,
                    specs: Any = None,
                    axis: Union[str, Sequence[str]] = AXIS_MODEL) -> str:
    """Save ``state`` (a tree) as ``directory/step_{step}/state.npz``;
    returns the step directory. With ``specs`` (tensor and pipeline
    parallelism) the leaves split over ``axis`` (a name or a tuple of
    them: ``("model", "pipe")`` gathers the pipeline stages' layer blocks
    too) are gathered first, so every rank of it must call this, and only
    the world's first rank writes."""
    path = _step_dir(directory, step)
    if specs is not None:
        from apex_tpu_torch.transformer.tensor_parallel import gather_params

        for a in _axes(axis):
            state = gather_params(state, specs, a)
        if dist.is_available() and dist.is_initialized() \
                and dist.get_rank() != 0:
            return path
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "state.npz"), **_flatten(state))
    return path


def restore_checkpoint(directory: str, target: Any,
                       step: Optional[int] = None, specs: Any = None,
                       axis: Union[str, Sequence[str]] = AXIS_MODEL) -> Any:
    """The tree saved at ``step`` (default: the latest) in the structure of
    ``target`` (only its keys are read: the dtypes and shapes are the
    saved ones), with CPU tensors as leaves. Keys of the file that
    ``target`` does not name are not read. With ``specs`` the full tree is
    cut to this process's shard along ``axis`` (a name or a tuple) of the
    installed topology."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    with np.load(os.path.join(_step_dir(directory, step), "state.npz")) as z:
        tree = _unflatten_into(target, z)
    if specs is None:
        return tree
    from apex_tpu_torch.transformer.tensor_parallel import mappings, \
        shard_params

    for a in _axes(axis):
        rank, size = mappings.axis_world(a)
        tree = shard_params(tree, specs, rank, size, a)
    return tree
