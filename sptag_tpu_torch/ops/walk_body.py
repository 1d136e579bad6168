"""The exact walk body's glue: pop, expand, merge (algo/engine.py's `_Walk`).

One body of the exact walk (``merge_bins == 0``) pops the best B
unexpanded beam entries, gathers their B * m graph neighbours, keeps the
unvisited ones (the first copy of an id reached twice), scores them (the
scoring launch of ops/walk_dots.py, not here), injects spare pivots when
the frontier falls behind them, merges beam and candidates into the top L
by a stable sort, and updates the counters.  ``csrc/walk_body.cu`` runs
that glue as two kernels a body, one CTA a query row:

* ``walk_pop_expand`` (``walk_pop_expand_kernel``): the pop by a prefix
  rank-select over the sorted beam, the neighbour gather, the visited test
  and the in-body de-duplication; updates `expanded` and `visited` in
  place and returns the popped ids, the fresh ids (-1 elsewhere) and the
  pop's per-row control values for the merge;
* ``walk_merge`` (``walk_merge_kernel``): the spare trigger and injection,
  the top-L merge by rank over the candidates that can enter, and the
  counters; returns a new state;
* ``walk_resident`` (``walk_resident_kernel``): every body of a walk run
  with no host sync between bodies (``_Walk.run_all``: a captured walk or
  segment) in one launch, one cluster of CTAs a query row, the row's state
  in the leader CTA's shared memory from the first body to the last, the
  scoring of each body's fresh ids split over the cluster; returns the
  state the two kernels and the scoring would leave after those bodies
  (`visited` updated in place).  `resident_walk` is the rule that picks it.

A CPU tensor runs the plain versions (`pop_reference`, `expand_reference`,
`merge_reference`): the PyTorch body the port ran before the kernels, so
the CPU walk keeps the JAX package's results.  On the card the kernels
give the same state tensors bit for bit (tests/test_torch_cuda.py).  The
`ctl` the pop hands to the merge is (active, best_pop_d, frontier_worse):
three (Q,) tensors in the plain versions, one (Q, 3) int32 tensor on the
card (the float's bits in column 1).  A CTA's work area grows with L,
B * m and the spares injected at once; a plan too wide for the card's
227 KB of shared memory a CTA takes a device scratch (`work_area`).  The
resident kernel's area adds the visited set, one bit a corpus row, and
has no scratch form: a plan or corpus too wide for it keeps the two
kernels a body.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from sptag_tpu_torch import _build
from sptag_tpu_torch.algo.dense import _sorted_dup_mask
from sptag_tpu_torch.core.types import DistCalcMethod
from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.ops import walk_dots as walk_ops
from sptag_tpu_torch.ops.walk_dots import MAX_DIST

#: kernel -> launches (the CPU path never counts)
KERNELS = ("walk_pop_expand", "walk_merge", "walk_resident")
#: the kernels of one body launched on its own (two a body)
BODY_KERNELS = KERNELS[:2]
_launches = dict.fromkeys(KERNELS, 0)
_count_lock = threading.Lock()

# a CTA's dynamic shared memory on Hopper (232,448 bytes)
MAX_SMEM = 227 * 1024
_INT32_MAX = 2 ** 31 - 1

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "sptag_walk_pop_expand": (_I, (_P,) * 13 + (_I,) * 4
                              + (_L, _I, _L, _F, _I, _P, _L, _I, _P)),
    "sptag_walk_merge": (_I, (_P,) * 18 + (_I,) * 5
                         + (_L, _F, _P, _L, _I, _P)),
    "sptag_walk_resident": (_I, (_P,) * 21 + (_I,) * 4 + (_L, _I, _I, _L)
                            + (_I,) * 4 + (_F,) + (_I,) * 3 + (_P,)),
    "sptag_walk_resident_smem": (_L, (_I,) * 4 + (_L, _I, _I)),
}

# the resident kernel's counters and barrier scratch (csrc/walk_body.cu)
_MISC_BYTES = 256


def launch_counts() -> dict:
    with _count_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in KERNELS:
            _launches[name] = 0


def library() -> ctypes.CDLL:
    return _build.load("walk_body", _SIGNATURES)


def _launch(fn: str, kernel: str, device, *args) -> None:
    with torch.cuda.device(device):
        rc = getattr(library(), fn)(
            *args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed ({rc})")
    with _count_lock:
        _launches[kernel] += 1


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _hash_log2(C: int) -> int:
    """log2 of the pop's hash table: at least twice the B * m slots."""
    return max(1, (2 * C - 1).bit_length())


def pop_expand_smem(L: int, B: int, m: int) -> int:
    C = B * m
    return 4 * (2 * (1 << _hash_log2(C)) + C + 2 * B)


def merge_smem(L: int, C: int, inject: int) -> int:
    # the beam's keys and ids, the candidates' keys and their sort's second
    # buffer (whole runs of 32), the beam's flags
    return 8 * (2 * L + 2 * max(_pow2(C + inject), 32)) + L


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def resident_layout(L: int, B: int, m: int, inject: int, N: int,
                    D: int) -> dict:
    """The resident kernel's shared memory a CTA by part, each rounded up
    to 16 bytes, in csrc/walk_body.cu's `resident_layout` order: the query;
    the row's counters and barrier scratch; two beam buffers (keys,
    distances, ids, flags: 17 bytes an entry); the hash table, whose room
    the merge's candidate keys and its sort's second buffer reuse; the
    slots; the pops; the fresh list (ids, distances, slots); the
    compaction's counts (8 warps a round of 256 slots); the next
    injection's spares; the visited bitset of the N + 1 columns."""
    C = B * m
    table = 8 * max(1 << _hash_log2(C), 2 * (-(-(C + inject) // 32) * 32))
    parts = {"query": 4 * (-(-D // 128) * 128), "misc": _MISC_BYTES,
             "beam0": 17 * L, "beam1": 17 * L, "hash": table,
             "slots": 4 * C, "pops": 8 * B, "fresh": 12 * C,
             "rounds": 32 * -(-C // 256), "spares": 12 * inject,
             "bits": 4 * (-(-(N + 1) // 32))}
    return {k: _align16(v) for k, v in parts.items()}


def resident_smem(L: int, B: int, m: int, inject: int, N: int,
                  D: int) -> int:
    """The resident kernel's shared memory a CTA in bytes: the sum of
    `resident_layout`."""
    return sum(resident_layout(L, B, m, inject, N, D).values())


def cluster_for(Q: int, sms: int) -> int:
    """CTAs a row's cluster at Q rows on a card of `sms` SMs: the most (of
    8, 4, 2, 1) whose clusters take at most half the SMs (on the H100 the
    fastest at 4, 16 and 256 rows, chip_smoke.py's walk_resident row)."""
    c = 8
    while c > 1 and 2 * Q * c > sms:
        c //= 2
    return c


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def resident_walk(device, merge_bins: int, f32_gather: bool, L: int, B: int,
                  m: int, inject: int, N: int, D: int) -> bool:
    """Whether a walk run whole (``_Walk.run_all``, no host sync between
    bodies) runs as one ``walk_resident`` launch: on the card, the exact
    body (not binned), float32 queries scored against the float32 corpus
    by gather (`f32_gather`: no packed neighbours, no bf16 shadow, no int8
    cascade), and the row's work area with its visited bitset within one
    CTA's shared memory.  `inject` is the spares injected at once (0
    without spares)."""
    return (torch.device(device).type == "cuda" and not merge_bins
            and f32_gather and D <= walk_ops.MAX_SCORE_D
            and resident_smem(L, B, m, inject, N, D) <= MAX_SMEM)


def work_area(nbytes: int, Q: int, device):
    """A CTA's work area of `nbytes`: (scratch, row bytes, dynamic shared
    memory).  In shared memory when it fits a CTA; else a device scratch
    of one 16-byte-aligned area a row (a plan too wide for shared
    memory: L, or B * m, in the tens of thousands)."""
    if nbytes <= MAX_SMEM:
        return None, 0, nbytes
    row = -(-nbytes // 16) * 16
    return torch.empty(Q * row, dtype=torch.uint8, device=device), row, 0


# ---- plain versions ---------------------------------------------------------

def row_active(no_better, ptr, n_spare, nbp_limit: int):
    """Rows whose walk may go on: nbp not tripped, or real spares left
    (the injection resets the counter), as SPTAG re-enters its trees."""
    act = no_better < nbp_limit
    if n_spare is not None:
        act = act | (ptr < n_spare)
    return act


def spare_injection(spare_ids, spare_d, n_spare, ptr, no_better, active,
                    best_pop_d, nbp_limit: int, steps: torch.Tensor):
    """The spares injected when the frontier falls behind the next one, or
    the nbp counter would trip with spares left; `steps` is
    ``arange(inject)``: (trigger (Q,), inj_ids (Q, inject), inj_d
    (Q, inject), new ptr)."""
    Ps = spare_ids.shape[1]
    inject = steps.shape[0]
    next_d = torch.gather(spare_d, 1, ptr.clamp_max(Ps - 1)[:, None])[:, 0]
    stalled = no_better + 1 >= nbp_limit
    trigger = active & (ptr < n_spare) & ((best_pop_d > next_d) | stalled)
    idxs = ptr[:, None] + steps[None, :]
    ok = trigger[:, None] & (idxs < Ps)
    safe = idxs.clamp_max(Ps - 1)
    inj_ids = torch.where(ok, torch.gather(spare_ids, 1, safe), -1)
    inj_d = torch.where(ok & (inj_ids >= 0), torch.gather(spare_d, 1, safe),
                        MAX_DIST)
    return trigger, inj_ids, inj_d, torch.where(trigger, ptr + inject, ptr)


def pop_reference(cand_ids, cand_d, expanded, no_better, ptr, it, t_limit,
                  n_spare, k_eff: int, B: int, nbp_limit: int):
    """The exact pop: the stable top-B of where(expanded, MAX, cand_d),
    marked expanded in place (the picks that are not a pop go to the dump
    column L).  A row past its own budget is frozen like an nbp-tripped
    one.  Returns (sel_ok, sel_ids (-1 where not a pop), ctl)."""
    L = cand_d.shape[1]
    active = row_active(no_better, ptr, n_spare, nbp_limit) & (it < t_limit)
    sel_score = torch.where(expanded[:, :L], MAX_DIST, cand_d)
    sel_d, spos = dist_ops.smallest_k(sel_score, B)
    sel_ok = (sel_d < MAX_DIST) & active[:, None]
    best_pop_d = sel_d[:, 0]
    sel_ids = torch.where(sel_ok, torch.gather(cand_ids, 1, spos), -1)
    expanded.scatter_(1, torch.where(sel_ok, spos, L), True)
    frontier_worse = best_pop_d > cand_d[:, k_eff - 1]
    return sel_ok, sel_ids, (active, best_pop_d, frontier_worse)


def expand_reference(graph, sel_ok, sel_ids, visited):
    """The pops' B * m neighbours in `flat` order: the ids not visited
    before this body and not reached at an earlier slot of it (-1
    elsewhere), every valid id marked visited in place (column N takes
    the -1 slots)."""
    Q = sel_ids.shape[0]
    N = visited.shape[1] - 1
    nbrs = graph[sel_ids.clamp_min(0)].to(torch.int64)
    nbrs = torch.where(sel_ok[..., None], nbrs, -1)          # (Q, B, m)
    flat = nbrs.reshape(Q, -1)
    flat_safe = torch.where(flat >= 0, flat, N)
    seen = torch.gather(visited, 1, flat_safe)
    # a node reached from two parents in one iteration: keep the first copy
    fresh = (flat >= 0) & ~seen & ~_sorted_dup_mask(flat_safe)
    visited.scatter_(1, flat_safe, True)
    return torch.where(fresh, flat, -1)


def merge_reference(cand_ids, cand_d, expanded, nd, fresh_ids, ctl,
                    no_better, ptr, it, n_spare, spare_ids, spare_d,
                    inject: int, nbp_limit: int):
    """Spare injection, the stable merge of beam, candidates and spares
    into the top L, and the counters: (cand_ids, cand_d, expanded,
    no_better, ptr, it), new tensors.  A candidate whose id is -1 scored
    MAX_DIST and enters only as an empty (-1) entry."""
    active, best_pop_d, frontier_worse = ctl
    L = cand_d.shape[1]
    trigger = None
    if n_spare is not None:
        trigger, inj_ids, inj_d, ptr = spare_injection(
            spare_ids, spare_d, n_spare, ptr, no_better, active, best_pop_d,
            nbp_limit, torch.arange(inject, device=ptr.device))
        nd = torch.cat([nd, inj_d], dim=1)
        fresh_ids = torch.cat([fresh_ids, inj_ids], dim=1)
    all_d = torch.cat([cand_d, nd], dim=1)
    all_ids = torch.cat([cand_ids, fresh_ids], dim=1)
    all_exp = torch.cat(
        [expanded[:, :L], torch.zeros((all_d.shape[0], all_d.shape[1] - L),
                                      dtype=torch.bool,
                                      device=all_d.device)], dim=1)
    new_d, mpos = dist_ops.smallest_k(all_d, L)
    new_ids = torch.where(new_d < MAX_DIST, torch.gather(all_ids, 1, mpos),
                          -1)
    new_exp = torch.cat([torch.gather(all_exp, 1, mpos),
                         torch.zeros_like(expanded[:, :1])], dim=1)
    # non-live rows freeze their counter
    nb = torch.where(active, torch.where(frontier_worse, no_better + 1, 0),
                     no_better)
    if trigger is not None:
        nb = torch.where(trigger, 0, nb)         # a fresh re-seed resets it
    return new_ids, new_d, new_exp, nb, ptr, it + 1


# ---- the kernels' wrappers --------------------------------------------------

def _check(name: str, device, specs) -> None:
    """Each (key, tensor, dtype, shape) contiguous, with that dtype and
    shape, on `device`; else TypeError."""
    for key, t, dtype, shape in specs:
        if (t.dtype != dtype or t.shape != shape or t.device != device
                or not t.is_contiguous()):
            raise TypeError(f"{name}: {key} must be a contiguous {dtype} "
                            f"tensor of shape {shape} on {device}")


def walk_pop_expand(cand_ids, cand_d, expanded, visited, no_better, ptr, it,
                    t_limit, n_spare, graph, k_eff: int, B: int,
                    nbp_limit: int) -> Tuple[torch.Tensor, torch.Tensor,
                                             object]:
    """The pop and the expand of one body: (sel_ids (Q, B), fresh_ids
    (Q, B * m), ctl); `expanded` and `visited` are updated in place.
    `n_spare` (Q,) is the row's real spare count, None without spares.  A
    CPU tensor runs the plain versions; on the card one launch."""
    if cand_d.device.type == "cpu":
        sel_ok, sel_ids, ctl = pop_reference(
            cand_ids, cand_d, expanded, no_better, ptr, it, t_limit,
            n_spare, k_eff, B, nbp_limit)
        return sel_ids, expand_reference(graph, sel_ok, sel_ids,
                                         visited), ctl
    dev = cand_d.device
    Q, L = cand_d.shape
    N1 = visited.shape[1]
    m = graph.shape[1]
    if not 1 <= B <= L or not 1 <= k_eff <= L or B * m >= _INT32_MAX // 4:
        raise ValueError(f"walk_pop_expand: B {B} and k {k_eff} within L "
                         f"{L}, B * m {B * m} slots below 2^29")
    specs = [("cand_ids", cand_ids, torch.int64, (Q, L)),
             ("cand_d", cand_d, torch.float32, (Q, L)),
             ("expanded", expanded, torch.bool, (Q, L + 1)),
             ("visited", visited, torch.bool, (Q, N1)),
             ("graph", graph, torch.int32, (N1 - 1, m))]
    specs += [(key, t, torch.int64, (Q,)) for key, t in (
        ("no_better", no_better), ("ptr", ptr), ("it", it),
        ("t_limit", t_limit), ("n_spare", n_spare)) if t is not None]
    _check("walk_pop_expand", dev, specs)
    sel_ids = torch.empty((Q, B), dtype=torch.int64, device=dev)
    fresh_ids = torch.empty((Q, B * m), dtype=torch.int64, device=dev)
    ctl = torch.empty((Q, 3), dtype=torch.int32, device=dev)
    if Q == 0:
        return sel_ids, fresh_ids, ctl
    scratch, row, smem = work_area(pop_expand_smem(L, B, m), Q, dev)
    _launch("sptag_walk_pop_expand", "walk_pop_expand", dev,
            cand_ids.data_ptr(), cand_d.data_ptr(), expanded.data_ptr(),
            visited.data_ptr(), no_better.data_ptr(), ptr.data_ptr(),
            it.data_ptr(), t_limit.data_ptr(),
            None if n_spare is None else n_spare.data_ptr(),
            graph.data_ptr(), sel_ids.data_ptr(), fresh_ids.data_ptr(),
            ctl.data_ptr(), Q, L, B, m, N1 - 1, k_eff, nbp_limit, MAX_DIST,
            _hash_log2(B * m), None if scratch is None else scratch.data_ptr(),
            row, smem)
    return sel_ids, fresh_ids, ctl


def walk_merge(cand_ids, cand_d, expanded, nd, fresh_ids, ctl, no_better,
               ptr, it, n_spare: Optional[torch.Tensor],
               spare_ids: Optional[torch.Tensor],
               spare_d: Optional[torch.Tensor], inject: int,
               nbp_limit: int):
    """The merge of one body: (cand_ids, cand_d, expanded, no_better, ptr,
    it), new tensors.  `nd` (Q, C) scores `fresh_ids`; the spares
    (`n_spare`, `spare_ids`, `spare_d`) are None without spares.  A CPU
    tensor runs the plain version; on the card one launch."""
    if cand_d.device.type == "cpu":
        return merge_reference(cand_ids, cand_d, expanded, nd, fresh_ids,
                               ctl, no_better, ptr, it, n_spare, spare_ids,
                               spare_d, inject, nbp_limit)
    dev = cand_d.device
    Q, L = cand_d.shape
    C = nd.shape[1]
    spares = n_spare is not None
    Ps = spare_ids.shape[1] if spares else 0
    inj = inject if spares else 0
    if (spares and (Ps < 1 or inject < 0)) \
            or L + C + inj >= _INT32_MAX // 4:
        raise ValueError(f"walk_merge: a spare queue, and L + C + inject "
                         f"{L + C + inj} entries below 2^29")
    specs = [("cand_ids", cand_ids, torch.int64, (Q, L)),
             ("cand_d", cand_d, torch.float32, (Q, L)),
             ("expanded", expanded, torch.bool, (Q, L + 1)),
             ("nd", nd, torch.float32, (Q, C)),
             ("fresh_ids", fresh_ids, torch.int64, (Q, C)),
             ("ctl", ctl, torch.int32, (Q, 3)),
             ("no_better", no_better, torch.int64, (Q,)),
             ("ptr", ptr, torch.int64, (Q,)), ("it", it, torch.int64, (Q,))]
    if spares:
        specs += [("n_spare", n_spare, torch.int64, (Q,)),
                  ("spare_ids", spare_ids, torch.int64, (Q, Ps)),
                  ("spare_d", spare_d, torch.float32, (Q, Ps))]
    _check("walk_merge", dev, specs)
    out_ids = torch.empty((Q, L), dtype=torch.int64, device=dev)
    out_d = torch.empty((Q, L), dtype=torch.float32, device=dev)
    out_exp = torch.empty((Q, L + 1), dtype=torch.bool, device=dev)
    # no_better, ptr, it: one allocation
    counters = torch.empty((3, Q), dtype=torch.int64, device=dev)
    nb, new_ptr, new_it = counters.unbind(0)
    if Q:
        scratch, row, smem = work_area(merge_smem(L, C, inj), Q, dev)
        _launch("sptag_walk_merge", "walk_merge", dev, cand_ids.data_ptr(),
                cand_d.data_ptr(), expanded.data_ptr(), nd.data_ptr(),
                fresh_ids.data_ptr(), ctl.data_ptr(), no_better.data_ptr(),
                ptr.data_ptr(), it.data_ptr(),
                n_spare.data_ptr() if spares else None,
                spare_ids.data_ptr() if spares else None,
                spare_d.data_ptr() if spares else None, out_ids.data_ptr(),
                out_d.data_ptr(), out_exp.data_ptr(),
                nb.data_ptr(), new_ptr.data_ptr(), new_it.data_ptr(), Q, L,
                C, Ps, inj, nbp_limit, MAX_DIST,
                None if scratch is None else scratch.data_ptr(), row, smem)
    return out_ids, out_d, out_exp, nb, new_ptr, new_it


def walk_resident(queries, x, x_sqnorm, metric, base: int, cand_ids, cand_d,
                  expanded, visited, no_better, ptr, it, t_limit,
                  n_spare: Optional[torch.Tensor],
                  spare_ids: Optional[torch.Tensor],
                  spare_d: Optional[torch.Tensor], graph, k_eff: int, B: int,
                  nbp_limit: int, inject: int, iters: int):
    """`iters` exact bodies: (cand_ids, cand_d, expanded, no_better, ptr,
    it), new tensors, and `visited` updated in place; the input `expanded`
    is left as it was.  The (Q, D) float32 `queries` score against the
    float32 rows `x` by gather (L2 reads `x_sqnorm`, one norm a row; cosine
    takes base 1).  The spares are None without spares.  A CPU tensor runs
    the plain body `iters` times; on the card one launch of Q clusters of
    `cluster_for` CTAs."""
    metric = int(metric)
    cosine = metric == int(DistCalcMethod.Cosine)
    if cosine and base != 1:
        raise ValueError("walk_resident: float cosine has base 1")
    spares = n_spare is not None
    if cand_d.device.type == "cpu":
        expanded = expanded.clone()
        for _ in range(iters):
            sel_ok, sel_ids, ctl = pop_reference(
                cand_ids, cand_d, expanded, no_better, ptr, it, t_limit,
                n_spare, k_eff, B, nbp_limit)
            fresh = expand_reference(graph, sel_ok, sel_ids, visited)
            nd = walk_ops.walk_distance_reference(
                queries, x, metric, base, walk_ops.GATHER, idx=fresh,
                x_sqnorm=x_sqnorm)
            cand_ids, cand_d, expanded, no_better, ptr, it = \
                merge_reference(cand_ids, cand_d, expanded, nd, fresh, ctl,
                                no_better, ptr, it, n_spare, spare_ids,
                                spare_d, inject, nbp_limit)
        return cand_ids, cand_d, expanded, no_better, ptr, it
    dev = cand_d.device
    Q, L = cand_d.shape
    N1 = visited.shape[1]
    m = graph.shape[1]
    D = queries.shape[1]
    Ps = spare_ids.shape[1] if spares else 0
    inj = inject if spares else 0
    if not 1 <= B <= L or not 1 <= k_eff <= L or B * m >= _INT32_MAX // 4 \
            or (spares and (Ps < 1 or inject < 0)) or Q < 1 or iters < 1:
        raise ValueError(f"walk_resident: B {B} and k {k_eff} within L "
                         f"{L}, B * m {B * m} slots below 2^29, a spare "
                         f"queue, a row and a body")
    smem = resident_smem(L, B, m, inj, N1 - 1, D)
    if smem > MAX_SMEM or D > walk_ops.MAX_SCORE_D:
        raise ValueError(f"walk_resident: {smem} bytes of shared memory "
                         f"(at most {MAX_SMEM}), D {D}")
    specs = [("queries", queries, torch.float32, (Q, D)),
             ("x", x, torch.float32, (N1 - 1, D)),
             ("cand_ids", cand_ids, torch.int64, (Q, L)),
             ("cand_d", cand_d, torch.float32, (Q, L)),
             ("expanded", expanded, torch.bool, (Q, L + 1)),
             ("visited", visited, torch.bool, (Q, N1)),
             ("graph", graph, torch.int32, (N1 - 1, m))]
    if not cosine:
        specs.append(("x_sqnorm", x_sqnorm, torch.float32, (N1 - 1,)))
    specs += [(key, t, torch.int64, (Q,)) for key, t in (
        ("no_better", no_better), ("ptr", ptr), ("it", it),
        ("t_limit", t_limit), ("n_spare", n_spare)) if t is not None]
    if spares:
        specs += [("spare_ids", spare_ids, torch.int64, (Q, Ps)),
                  ("spare_d", spare_d, torch.float32, (Q, Ps))]
    _check("walk_resident", dev, specs)
    out_ids = torch.empty((Q, L), dtype=torch.int64, device=dev)
    out_d = torch.empty((Q, L), dtype=torch.float32, device=dev)
    out_exp = torch.empty((Q, L + 1), dtype=torch.bool, device=dev)
    counters = torch.empty((3, Q), dtype=torch.int64, device=dev)
    nb, new_ptr, new_it = counters.unbind(0)
    cluster = cluster_for(Q, _sm_count(dev.index if dev.index is not None
                                       else torch.cuda.current_device()))
    _launch("sptag_walk_resident", "walk_resident", dev,
            cand_ids.data_ptr(), cand_d.data_ptr(), expanded.data_ptr(),
            visited.data_ptr(), no_better.data_ptr(), ptr.data_ptr(),
            it.data_ptr(), t_limit.data_ptr(),
            n_spare.data_ptr() if spares else None,
            spare_ids.data_ptr() if spares else None,
            spare_d.data_ptr() if spares else None, graph.data_ptr(),
            queries.data_ptr(), x.data_ptr(),
            None if cosine else x_sqnorm.data_ptr(), out_ids.data_ptr(),
            out_d.data_ptr(), out_exp.data_ptr(), nb.data_ptr(),
            new_ptr.data_ptr(), new_it.data_ptr(), Q, L, B, m, N1 - 1, D,
            k_eff, nbp_limit, Ps, inj, iters,
            walk_ops.COSINE if cosine else walk_ops.L2, MAX_DIST,
            _hash_log2(B * m), int(cluster), smem)
    return out_ids, out_d, out_exp, nb, new_ptr, new_it
