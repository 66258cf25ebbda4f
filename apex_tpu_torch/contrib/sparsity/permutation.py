"""ASP channel-permutation search, the accuracy-recovery half of 2:4
sparsity (port of ``apex_tpu/contrib/sparsity/permutation.py``, the
counterpart of apex's ``permutation_lib.py`` and its search kernels).

2:4 pruning keeps the 2 largest-magnitude entries of every 4 contiguous
input channels. The magnitude lost depends on which channels share a group
of 4, so permuting input channels before masking can keep strictly more
of it, and the permutation is free at inference: permuting layer i's input
channels (C dim) is undone by permuting the producing layer's output
channels (K dim), its bias and any per-channel params in between.

The search is the reference's host code, copied: vectorized numpy that
evaluates every canonical permutation of a stripe window for a batch of
stripe groups at once (:func:`_batched_sum_2to4`), the greedy stripe-group
loop with seeded escape perturbations, the window-12 subdivision and the
progressive channel-swap fallback for wide matrices, with swap budgets in
place of wall-clock limits so results reproduce across hosts. It runs on
the host in the port too: no kernel.

Which layers share a permutation is declared, not inferred from a graph:
:class:`ChannelGroup` (consumers sharing a C-permutation, producers
absorbing it on K) and :func:`sequential_groups` for a chain.
:func:`apply_channel_permutation` permutes tensors (on their device, in
their dtype) of a flat ``{layer: {param: tensor}}`` dict whose kernels
keep the JAX layout ``(..., in, out)``: the search matrix is
``kernel.T``, shape (K, C) with C the contraction dim that 2:4 groups.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

GROUP_WIDTH = 4  # N:4 hardware stripe — only group width the reference supports

__all__ = [
    "sum_after_2_to_4",
    "magnitude_after_mask",
    "predict_unique_combinations",
    "canonical_permutations",
    "exhaustive_search_matrix",
    "progressive_channel_swap",
    "search_for_good_permutation",
    "ChannelGroup",
    "sequential_groups",
    "apply_channel_permutation",
    "search_and_permute",
]


# ---------------------------------------------------------------------------
# magnitude-after-pruning evaluation (reference: permutation_utilities.py
# sum_after_2_to_4:49-80 — scalar loops / CUDA kernel → one vectorized sort)
# ---------------------------------------------------------------------------


def sum_after_2_to_4(matrix: np.ndarray) -> float:
    """Total |magnitude| surviving 2:4 pruning of ``matrix`` (K, C): in each
    row, every aligned group of 4 columns keeps its top-2 magnitudes."""
    k, c = matrix.shape
    if c % GROUP_WIDTH:
        raise ValueError(f"column count {c} not divisible by {GROUP_WIDTH}")
    a = np.abs(matrix).reshape(k, c // GROUP_WIDTH, GROUP_WIDTH)
    a = np.sort(a, axis=-1)
    return float(a[..., 2:].sum(dtype=np.float64))


def _batched_sum_2to4(columns: np.ndarray) -> np.ndarray:
    """``columns``: (..., K, C) → (...) surviving magnitude per leading index.
    The vectorized equivalent of the reference's ``build_permute_map`` CUDA
    kernel: callers stack (stripe-group × permutation) candidates into the
    leading axes and evaluate them in one shot."""
    *lead, k, c = columns.shape
    a = np.abs(columns).reshape(*lead, k, c // GROUP_WIDTH, GROUP_WIDTH)
    a = np.sort(a, axis=-1)
    return a[..., 2:].sum(axis=(-3, -2, -1), dtype=np.float64)


def magnitude_after_mask(kernel) -> float:
    """Surviving magnitude of an ``(in, out)`` kernel (an array or a
    tensor) under the m4n2 mask (convenience wrapper transposing into the
    search layout)."""
    if isinstance(kernel, torch.Tensor):
        kernel = kernel.detach().double().cpu().numpy()
    return sum_after_2_to_4(np.asarray(kernel, dtype=np.float64).T)


# ---------------------------------------------------------------------------
# canonical permutation enumeration (reference: exhaustive_search.py:17-86)
# ---------------------------------------------------------------------------


def predict_unique_combinations(c: int, m: int = GROUP_WIDTH) -> int:
    """C!/( (M!)^G * G! ) distinct groupings of C columns into G=C/M
    unordered groups of unordered columns (exhaustive_search.py:83-86)."""
    if c % m:
        raise ValueError(f"{c} columns not divisible by group width {m}")
    g = c // m
    return math.factorial(c) // (math.factorial(m) ** g * math.factorial(g))


@lru_cache(maxsize=None)
def canonical_permutations(c: int, m: int = GROUP_WIDTH) -> np.ndarray:
    """All unique column groupings as an (N, c) int array, canonical form:
    values sorted within each group, groups sorted by first element
    (exhaustive_search.py:32-79, without the on-disk pickle cache — the
    enumeration is cheap enough to memoize in memory)."""
    out: List[List[int]] = []

    def build(perm: List[int], remaining: List[int]) -> None:
        if not remaining:
            out.append(perm.copy())
            return
        for i, col in enumerate(remaining):
            if len(perm) % m == 0:
                # new group: canonical iff all smaller ids already used and
                # group leaders ascend
                if any(v < col and v in remaining for v in range(col)):
                    continue
                if perm and col <= perm[-m]:
                    continue
            elif col <= perm[-1]:
                continue
            perm.append(col)
            rest = remaining[:i] + remaining[i + 1 :]
            build(perm, rest)
            perm.pop()

    build([0], list(range(1, c)))
    return np.asarray(out, dtype=np.int64)


# ---------------------------------------------------------------------------
# exhaustive / stripe-group search (reference: exhaustive_search.py:93-371)
# ---------------------------------------------------------------------------

_EVAL_CHUNK_ELEMS = 32 * 1024 * 1024  # cap candidate-tensor size per batch


def exhaustive_search_matrix(matrix: np.ndarray) -> tuple[np.ndarray, float]:
    """Best canonical permutation of *all* columns of ``matrix`` (K, C),
    evaluated as one batched tensor op (reference search_matrix:93-116).
    Returns (permutation, improvement over identity)."""
    k, c = matrix.shape
    perms = canonical_permutations(c)
    base = sum_after_2_to_4(matrix)
    sums = np.empty(len(perms), dtype=np.float64)
    chunk = max(1, _EVAL_CHUNK_ELEMS // (k * c))
    for i in range(0, len(perms), chunk):
        p = perms[i : i + chunk]
        sums[i : i + len(p)] = _batched_sum_2to4(matrix.T[p].swapaxes(-1, -2))
    best = int(np.argmax(sums))
    return perms[best].copy(), float(sums[best] - base)


def _stripe_groups(num_stripes: int, window: int) -> np.ndarray:
    """All C(num_stripes, window) sorted stripe combinations
    (generate_stripe_groups, exhaustive_search.py:149-164)."""
    from itertools import combinations

    return np.asarray(list(combinations(range(num_stripes), window)), dtype=np.int64)


def _search_stripe_windows(
    matrix: np.ndarray,
    stripe_group_size: int,
    escape_attempts: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Greedy stripe-group optimization (Exhaustive_Search's windowed loop,
    exhaustive_search.py:340-365): repeatedly evaluate every window of
    ``stripe_group_size`` columns, apply the best non-overlapping window
    permutations, and rebuild only the stripe groups that changed —
    perturbing randomly (``escape_attempts``) when no window improves."""
    k, c = matrix.shape
    window = stripe_group_size // GROUP_WIDTH
    num_stripes = c // GROUP_WIDTH
    work = matrix.copy()
    permutation = np.arange(c, dtype=np.int64)

    groups = _stripe_groups(num_stripes, window)
    perms = canonical_permutations(stripe_group_size)
    n_groups, n_perms = len(groups), len(perms)

    # improvement + argbest permutation per stripe group (the stripe map /
    # perm map of exhaustive_search.py:171-241), updated incrementally
    stripe_map = np.zeros(n_groups, dtype=np.float64)
    perm_map = np.zeros(n_groups, dtype=np.int64)
    dirty = np.ones(n_groups, dtype=bool)
    perturbations = 0

    # group col-indices: (n_groups, window*4) gather of each group's columns
    col_idx = (groups[:, :, None] * GROUP_WIDTH + np.arange(GROUP_WIDTH)).reshape(
        n_groups, window * GROUP_WIDTH
    )

    def refresh(idx: np.ndarray) -> None:
        if idx.size == 0:
            return
        chunk = max(1, _EVAL_CHUNK_ELEMS // (k * stripe_group_size * n_perms))
        for i in range(0, len(idx), chunk):
            sel = idx[i : i + chunk]
            sub = work.T[col_idx[sel]]               # (g, w*4, K)
            cand = sub[:, perms]                      # (g, P, w*4, K)
            sums = _batched_sum_2to4(cand.swapaxes(-1, -2))  # (g, P)
            base = sums[:, 0]                         # perms[0] is identity
            best = np.argmax(sums, axis=1)
            stripe_map[sel] = sums[np.arange(len(sel)), best] - base
            perm_map[sel] = best

    while True:
        refresh(np.nonzero(dirty)[0])
        dirty[:] = False

        used_stripes: set[int] = set()
        order = np.argsort(stripe_map)[::-1]
        for gid in order:
            perm_local = perms[perm_map[gid]]
            if stripe_map[gid] <= 1e-4:
                # escape: random window + random cross-half swap
                # (use_stripe_map perturbations, exhaustive_search.py:260-270)
                if not used_stripes and perturbations < escape_attempts:
                    perturbations += 1
                    gid = int(rng.integers(n_groups))
                    perm_local = perms[perm_map[gid]].copy()
                    half = len(perm_local) // 2
                    src = int(rng.integers(half))
                    dst = half + int(rng.integers(half))
                    perm_local[src], perm_local[dst] = perm_local[dst], perm_local[src]
                else:
                    break
            group = groups[gid]
            if used_stripes.intersection(group.tolist()):
                continue
            cols = col_idx[gid]
            work.T[cols] = work.T[cols[perm_local]]
            permutation[cols] = permutation[cols[perm_local]]
            # a stripe changed iff its slot no longer holds exactly its own
            # original columns. Stricter than the reference's aligned-
            # consecutive check (use_stripe_map, exhaustive_search.py:290-304),
            # which treats a wholesale-relocated stripe as unchanged and can
            # leave stale cached improvements for overlapping groups.
            for s, stripe in enumerate(group.tolist()):
                blk = perm_local[s * GROUP_WIDTH : (s + 1) * GROUP_WIDTH]
                if np.any(blk != np.arange(s * GROUP_WIDTH, (s + 1) * GROUP_WIDTH)):
                    used_stripes.add(stripe)

        if not used_stripes:
            return permutation
        for gid in range(n_groups):
            if used_stripes.intersection(groups[gid].tolist()):
                dirty[gid] = True


def progressive_channel_swap(
    matrix: np.ndarray,
    max_swap_attempts: int = 10_000,
    improvement_threshold: float = 1e-9,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Randomized cross-stripe column swaps, keeping improvements — the
    reference's fallback for very wide matrices
    (call_permutation_search_kernels.py:42-58), bounded by attempt count
    instead of wall-clock seconds for determinism."""
    rng = rng or np.random.default_rng(1)
    k, c = matrix.shape
    work = matrix.copy()
    permutation = np.arange(c, dtype=np.int64)
    for _ in range(max_swap_attempts):
        src, dst = int(rng.integers(c)), int(rng.integers(c))
        s_grp, d_grp = src // GROUP_WIDTH, dst // GROUP_WIDTH
        if s_grp == d_grp:
            continue
        cols = lambda g: slice(g * GROUP_WIDTH, (g + 1) * GROUP_WIDTH)
        base = sum_after_2_to_4(work[:, cols(s_grp)]) + sum_after_2_to_4(
            work[:, cols(d_grp)]
        )
        work[:, [src, dst]] = work[:, [dst, src]]
        new = sum_after_2_to_4(work[:, cols(s_grp)]) + sum_after_2_to_4(
            work[:, cols(d_grp)]
        )
        if new - base > improvement_threshold:
            permutation[[src, dst]] = permutation[[dst, src]]
        else:
            work[:, [src, dst]] = work[:, [dst, src]]  # revert
    return permutation


def search_for_good_permutation(
    matrix: np.ndarray,
    stripe_group_size: int = 8,
    escape_attempts: int = 100,
    seed: int = 1,
    wide_matrix_threshold: int = 2048,
    max_swap_attempts: int = 10_000,
) -> np.ndarray:
    """Channel permutation maximizing 2:4 surviving magnitude of ``matrix``
    (K, C). Strategy selection mirrors the reference
    (accelerated_search_for_good_permutation + permutation_lib.py:381-392):

    - C > ``wide_matrix_threshold``: progressive channel swap;
    - stripe_group_size 12 with C > 512: subdivide halves then polish with
      window 8 (Exhaustive_Search:330-337);
    - C <= stripe_group_size: single exhaustive canonical search;
    - otherwise: greedy stripe-window search with escape perturbations.

    Skips the search entirely when pruning loses (numerically) nothing
    (permutation_lib.py:351-362). Returns a length-C permutation ``p``
    such that ``matrix[:, p]`` is the improved layout.
    """
    matrix = np.ascontiguousarray(matrix, dtype=np.float64)
    k, c = matrix.shape
    if c % GROUP_WIDTH:
        raise ValueError(f"channel count {c} not divisible by {GROUP_WIDTH}")
    if stripe_group_size % GROUP_WIDTH:
        raise ValueError(
            f"stripe_group_size ({stripe_group_size}) must be a multiple of "
            f"{GROUP_WIDTH}"
        )
    rng = np.random.default_rng(seed)

    total = float(np.abs(matrix).sum(dtype=np.float64))
    if total == 0.0 or abs(total - sum_after_2_to_4(matrix)) / max(total, 1e-30) < 1e-3:
        return np.arange(c, dtype=np.int64)

    if c > wide_matrix_threshold:
        return progressive_channel_swap(
            matrix, max_swap_attempts=max_swap_attempts, rng=rng
        )
    if stripe_group_size == 12 and c > 512:
        half = (c // 2 // GROUP_WIDTH) * GROUP_WIDTH
        left = search_for_good_permutation(
            matrix[:, :half], stripe_group_size=12, escape_attempts=escape_attempts,
            seed=seed,
        )
        right = search_for_good_permutation(
            matrix[:, half:], stripe_group_size=12, escape_attempts=escape_attempts,
            seed=seed + 1,
        )
        perm = np.concatenate([left, right + half])
        polished = _search_stripe_windows(
            matrix[:, perm], 8, max(escape_attempts, 100) * 10, rng
        )
        return perm[polished]
    if c <= stripe_group_size:
        perm, _ = exhaustive_search_matrix(matrix)
        return perm
    return _search_stripe_windows(matrix, stripe_group_size, escape_attempts, rng)


# ---------------------------------------------------------------------------
# applying permutations across a network (reference: permutation_lib.py's
# FX-graph pass — here an explicit group contract over param pytrees)
# ---------------------------------------------------------------------------


@dataclass
class ChannelGroup:
    """One shared input-channel permutation (the reference's
    ``unique_siblings`` group, permutation_lib.py:554-601).

    ``consumers``: layer names whose kernels' **input** (C) dim is permuted
    — siblings reading the same activation, so they must share the
    permutation (the search runs on their K-concatenated weights,
    search_for_good_permutation's matrix_group, permutation_lib.py:279-337).

    ``producers``: layer names whose **output** (K) dim absorbs the inverse
    — the layers writing that activation, plus any per-channel params
    (bias, norm scale/offset, BN running stats) between them and the
    consumers (apply_permutation_in_K_dim, permutation_lib.py:204-232).
    Function is preserved exactly for elementwise / channelwise ops in
    between.
    """

    consumers: List[str]
    producers: List[str] = field(default_factory=list)


def sequential_groups(layer_names: Sequence[str]) -> List[ChannelGroup]:
    """Groups for a plain chain: layer i's input channels are produced by
    layer i-1 (the linear-stack case of the reference's graph pass — first
    layer K-only, middle KC, last C-only, init_permutation_flag
    permutation_lib.py:440-467)."""
    return [
        ChannelGroup(consumers=[layer_names[i]], producers=[layer_names[i - 1]])
        for i in range(1, len(layer_names))
    ]


_KERNEL_KEYS = ("kernel", "weight", "w")


def _split_layer(layer: Dict[str, Any]):
    """(kernel_key, per-channel keys) of one layer dict: the kernel is 2-D+
    ``(in, out)``; everything else 1-D of size out is channelwise."""
    kkey = next((k for k in _KERNEL_KEYS if k in layer), None)
    if kkey is None:
        raise KeyError(f"no kernel leaf in layer (keys: {list(layer)})")
    return kkey, [k for k in layer if k != kkey]


def apply_channel_permutation(
    params: Dict[str, Dict[str, Any]],
    group: ChannelGroup,
    permutation: np.ndarray,
) -> Dict[str, Dict[str, Any]]:
    """Permute ``group.consumers``' input channels by ``permutation`` and
    ``group.producers``' output channels (kernel out-dim, bias, and any
    other per-channel vectors) to compensate — function-preserving
    (reference apply_offline_permutation, permutation_lib.py:82-129).

    ``params`` is a flat {layer_name: {param_name: tensor}} dict; returns
    a new dict of new tensors (the input is unmodified). Conv kernels
    ``(..., in, out)`` permute on their -2/-1 dims, matching the
    reference's R·S·K×C reshape (permutation_lib.py:298-312).
    """
    perm = np.asarray(permutation)
    out = {name: dict(layer) for name, layer in params.items()}

    def take(t: torch.Tensor, axis: int) -> torch.Tensor:
        return t.index_select(axis, torch.as_tensor(perm, device=t.device))

    for name in group.consumers:
        kkey, _ = _split_layer(out[name])
        kern = out[name][kkey]
        if kern.shape[-2] != len(perm):
            raise ValueError(
                f"consumer {name} input dim {kern.shape[-2]} != perm {len(perm)}"
            )
        out[name][kkey] = take(kern, -2)

    for name in group.producers:
        kkey, chan_keys = _split_layer(out[name])
        kern = out[name][kkey]
        if kern.shape[-1] != len(perm):
            raise ValueError(
                f"producer {name} output dim {kern.shape[-1]} != perm {len(perm)}"
            )
        out[name][kkey] = take(kern, -1)
        for ck in chan_keys:
            vec = out[name][ck]
            if vec.shape[-1] == len(perm):
                out[name][ck] = take(vec, -1)
    return out


def search_and_permute(
    params: Dict[str, Dict[str, Any]],
    groups: Sequence[ChannelGroup],
    **search_kwargs: Any,
) -> tuple[Dict[str, Dict[str, Any]], Dict[int, np.ndarray]]:
    """Full offline pipeline (reference build_offline_permutation_graph +
    apply_offline_permutation): for each group, search on the consumers'
    K-concatenated ``(K, C)`` weights, then apply. Returns
    ``(permuted_params, {group_index: permutation})``.

    Run *before* :func:`apex_tpu_torch.contrib.sparsity.
    compute_sparse_masks`;
    producers' K-permutations never change their own mask quality, so
    group order is irrelevant (the property the reference exploits by
    searching all groups before applying, permutation_lib.py:256-258).
    """
    perms: Dict[int, np.ndarray] = {}
    for gi, group in enumerate(groups):
        mats = []
        for name in group.consumers:
            kkey, _ = _split_layer(params[name])
            kern = params[name][kkey].detach().double().cpu().numpy()
            # (..., in, out) -> (K_i, C): fold every non-contraction dim
            # into rows (the reference's R*S*K x C conv reshape,
            # permutation_lib.py:298-312)
            mats.append(np.moveaxis(kern, -2, -1).reshape(-1, kern.shape[-2]))
        # each mat is (K_i, C); concat along K (permutation_lib.py:317-333)
        matrix = np.concatenate(mats, axis=0)
        perm = search_for_good_permutation(matrix, **search_kwargs)
        perms[gi] = perm
        params = apply_channel_permutation(params, group, perm)
    return params, perms
