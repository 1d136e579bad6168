"""The kd forest's seed descent of a KDT index's walk.

A KDT search seeds its graph walk per query from the kd forest
(trees/kdtree.py): for each tree, the greedy leaf (the child on the
query's side of every split), and the leaves under the `backtrack` other
branches of that path whose split planes lie closest to the query, each
descended greedily in turn.  `kd_seeds` computes them for a batch of
queries where the queries are:

* a CPU tensor: `kd_seeds_reference`, plain PyTorch, every query of a
  tree descended at once, one level a step;
* a CUDA tensor: ``kd_descent_kernel`` (``csrc/kd_descent.cu``), one
  warp a (query, tree), in the caller's stream, so a captured walk
  (algo/engine.py) holds it.  No CUDA tensor takes the plain version.

The result is (Q, trees * (1 + backtrack)) int64 row ids, -1 padded: for
tree t, column t * (1 + backtrack) is the greedy leaf and the next
columns the chosen leaves by ascending bound (ties to the shallower
level), then -1.  `KDTree.collect_seeds`, the host numpy descent the
JAX package shares, gives the same leaves in each (query, tree) group;
only the order of the chosen ones may differ (numpy's argpartition
leaves it open), and which branch wins a tie of exactly equal bounds at
the `backtrack`-th place.

The forest is `forest_words` of the tree's node records: (M, 4) int32
words (left, right, split_dim, split_value's float32 bits; a child
``< 0`` is the leaf ``-id - 1``) and its (trees,) int32 roots.  A
``reads`` accumulator (one int64 on the queries' device), when given,
gains the number of node records the descent read: the kernel adds it
with one atomic a warp, so a replayed graph counts too.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from sptag_tpu_torch import _build

#: kernel -> launches (the CPU path never counts)
KERNELS = ("kd_descent",)
_launches = dict.fromkeys(KERNELS, 0)
_count_lock = threading.Lock()

# a CTA's dynamic shared memory on Hopper (232,448 bytes)
MAX_SMEM = 227 * 1024
# warps a CTA, one a (query, tree)
_WARPS = 4
# bytes of one path entry in shared memory: the other child and its bound
_ENTRY_BYTES = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"sptag_kd_descent": (_I, (_P,) * 5 + (_I,) * 7 + (_P,))}


def launch_counts() -> dict:
    with _count_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in KERNELS:
            _launches[name] = 0


def library() -> ctypes.CDLL:
    return _build.load("kd_descent", _SIGNATURES)


def forest_words(nodes: np.ndarray) -> np.ndarray:
    """The (M, 4) int32 words of KDTNode records (io/format.py's
    KDT_NODE_DTYPE), bit for bit."""
    nodes = np.ascontiguousarray(nodes)
    return nodes.view(np.int32).reshape(len(nodes), 4)


def forest_depth(words: np.ndarray, tree_starts: np.ndarray) -> int:
    """The longest root-to-leaf path of the forest, in internal nodes (a
    cyclic, malformed forest stops at M + 1)."""
    words = np.asarray(words)
    frontier = np.unique(np.asarray(tree_starts, np.int64))
    frontier = frontier[frontier >= 0]
    depth = 0
    while frontier.size and depth <= len(words):
        depth += 1
        kids = words[frontier, :2].reshape(-1).astype(np.int64)
        frontier = kids[kids >= 0]
    return depth


# ---- the plain version -------------------------------------------------------

def _greedy(queries, words, ptr, active, rows, reads, track: bool):
    """The greedy descent of every (row, start) at once: (leaf ids, -1
    where inactive or not reached; the path's other children and bounds,
    +inf where absent, when `track`)."""
    left, right, dim = words[:, 0], words[:, 1], words[:, 2]
    value = words[:, 3].contiguous().view(torch.float32)
    D = queries.shape[1]
    others, bounds = [], []
    for _ in range(words.shape[0] + 1):
        internal = active & (ptr >= 0)
        if not bool(internal.any()):
            break
        if reads is not None:
            reads += internal.sum()
        safe = torch.where(internal, ptr, 0)
        diff = (queries[rows, dim[safe].long().clamp(0, D - 1)]
                - value[safe])
        go_left = diff < 0
        best = torch.where(go_left, left[safe], right[safe]).long()
        if track:
            others.append(torch.where(go_left, right[safe], left[safe]))
            bounds.append(torch.where(internal, diff * diff,
                                      torch.full_like(diff, float("inf"))))
        ptr = torch.where(internal, best, ptr)
    leaf = torch.where(active & (ptr < 0), -ptr - 1, -1)
    return leaf, others, bounds


def kd_seeds_reference(queries: torch.Tensor, nodes: torch.Tensor,
                       tree_starts: torch.Tensor, backtrack: int,
                       reads: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The descent in plain PyTorch (any device; the CPU's path)."""
    q = queries.to(torch.float32)
    Q = q.shape[0]
    per = 1 + backtrack
    starts = tree_starts.tolist()
    out = torch.full((Q, len(starts) * per), -1, dtype=torch.int64,
                     device=q.device)
    rows = torch.arange(Q, device=q.device)
    everyone = torch.ones(Q, dtype=torch.bool, device=q.device)
    for t, root in enumerate(starts):
        leaf, others, bounds = _greedy(
            q, nodes, torch.full((Q,), int(root), dtype=torch.int64,
                                 device=q.device),
            everyone, rows, reads, track=True)
        out[:, t * per] = leaf
        if backtrack <= 0 or not others:
            continue
        nb = min(backtrack, len(others))
        sorted_b, order = torch.sort(torch.stack(bounds, 1), dim=1,
                                     stable=True)
        chosen = torch.gather(torch.stack(others, 1).long(), 1,
                              order[:, :nb])
        ok = torch.isfinite(sorted_b[:, :nb])
        sub, _, _ = _greedy(q, nodes, chosen.reshape(-1), ok.reshape(-1),
                            rows.repeat_interleave(nb), reads, track=False)
        out[:, t * per + 1:t * per + 1 + nb] = sub.view(Q, nb)
    return out


# ---- the kernel's wrapper ------------------------------------------------------

def _layout(depth: int):
    """(warps a CTA, dynamic shared bytes) for a forest `depth` deep."""
    per_warp = max(depth, 1) * _ENTRY_BYTES
    for warps in (_WARPS, 1):
        if warps * per_warp <= MAX_SMEM:
            return warps, warps * per_warp
    raise ValueError(f"kd_descent: a forest {depth} nodes deep does not fit "
                     f"a CTA's shared memory (at most "
                     f"{MAX_SMEM // _ENTRY_BYTES})")


def kd_seeds(queries: torch.Tensor, nodes: torch.Tensor,
             tree_starts: torch.Tensor, backtrack: int,
             depth: Optional[int] = None,
             reads: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Q, trees * (1 + backtrack)) int64 seeds of the (Q, D) `queries`
    from the forest (`nodes` (M, 4) int32 words, `tree_starts` (trees,)
    int32 roots, on the queries' device).  `depth` is the forest's
    `forest_depth` (read from `nodes` when None, a host copy); `reads`, a
    (1,) int64 tensor, gains the node records read.  A CPU tensor runs
    the plain version; on the card one launch."""
    if backtrack < 0:
        raise ValueError(f"kd_seeds: backtrack {backtrack} < 0")
    if queries.device.type == "cpu":
        return kd_seeds_reference(queries, nodes, tree_starts, backtrack,
                                  reads)
    dev = queries.device
    Q, D = queries.shape
    T = tree_starts.shape[0]
    M = nodes.shape[0]
    for key, t, dtype, shape in (("nodes", nodes, torch.int32, (M, 4)),
                                 ("tree_starts", tree_starts, torch.int32,
                                  (T,))):
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise TypeError(f"kd_seeds: {key} must be a contiguous {dtype} "
                            f"tensor of shape {shape} on {dev}")
    if reads is not None and (reads.dtype != torch.int64
                              or reads.numel() != 1 or reads.device != dev):
        raise TypeError(f"kd_seeds: reads must be one int64 on {dev}")
    if depth is None:
        depth = forest_depth(nodes.cpu().numpy(), tree_starts.cpu().numpy())
    out = torch.empty((Q, T * (1 + backtrack)), dtype=torch.int64,
                      device=dev)
    if Q == 0:
        return out
    q = queries.to(torch.float32).contiguous()
    warps, smem = _layout(depth)
    with torch.cuda.device(dev):
        rc = library().sptag_kd_descent(
            q.data_ptr(), nodes.data_ptr(), tree_starts.data_ptr(),
            out.data_ptr(), None if reads is None else reads.data_ptr(), Q,
            D, T, backtrack, depth, warps, smem,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kd_descent: CUDA launch failed ({rc})")
    with _count_lock:
        _launches["kd_descent"] += 1
    return out
