"""Mesh-wide segment engine: continuous batching over a sharded index (port
of ``sptag_tpu/parallel/mesh_engine.py``).

`ShardedBKTIndex.search` walks every shard of a mesh to the end of the
batch.  This module gives the mesh the engine surface the slot scheduler
(algo/scheduler.py) drives — `walk_plan` / `seed_state` / `run_segment` /
`capture_segment` / `finalize` / `chunk_size` — over the shards' own
engines:

* **seed**: every shard seeds the query batch from its own pivot set;
* **segment**: every shard advances its rows by at most S iterations of
  the single engine's walk body, each on its card (parallel/sharded.py
  `Mesh.map`); shards converge independently, and a query stays resident
  until every shard's row is done;
* **finalize**: every shard re-ranks / tombstone-filters its pool to
  k_local, its ids become global, and the shards merge
  (parallel/sharded.py `_gather_merge`), the monolithic mesh search's
  merge.

The state is QUERY-major like the single engine's, and each shard's slice
of it lives on that shard's card for the whole residency, as the JAX
package's specs ``P(None, SHARD_AXIS, ...)`` place it: a state value is a
`ShardSlices`, one tensor a shard with the slot rows on axis 0, which the
scheduler's row bookkeeping (insert, blank, compact and retire index axis
0) indexes as it indexes one tensor, every shard's slice taking the same
rows.  What crosses between cards is counted by kind
(`sharded.card_transfer_bytes`): the newly seated queries (``queries``),
each segment's ``t_limit`` and ``alive`` flags, and the candidates at
finalize (``candidates``); row indices are built on the host, so none
cross.  On the card a segment the scheduler replays is one CUDA graph a
shard, captured and replayed on the shard's card.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from sptag_tpu_torch.algo.engine import (
    _VISITED_BUDGET,
    GraphSearchEngine,
    _finalize,
    _finalize_cost,
    _num_words,
    _seed_pivot_cost,
    _walk_iter_cost,
    beam_pool_size,
    beam_width_for,
)
from sptag_tpu_torch.parallel.sharded import (_gather_merge, _global_ids,
                                              _sharded_merge_cost, to_card)
from sptag_tpu_torch.utils import costmodel, recompile_guard, roofline

#: the loop-carried state keys with a shard axis (queries are seated on
#: every shard's card too)
_SHARDED_KEYS = ("cand_ids", "cand_d", "expanded", "visited", "no_better",
                 "ptr", "it", "spare_ids", "spare_d")


def _key_on(key, device, cache: dict):
    """`key` with its tensors on `device` (a host index moves there once
    a call; an index on another card is a transfer of kind ``index``)."""
    if isinstance(key, tuple):
        return tuple(_key_on(k, device, cache) for k in key)
    if not isinstance(key, torch.Tensor) or key.device == device:
        return key
    moved = cache.get(device)
    if moved is None:
        moved = cache[device] = to_card(key, device, "index")
    return moved


class ShardSlices:
    """One slot-state array of the mesh scheduler: a tensor a shard, each
    on its shard's card, slot rows on axis 0.  Indexing and assignment
    act on every shard's slice with the same key; a plain tensor assigned
    or copied in goes to every card (a scalar to each)."""

    __slots__ = ("parts",)

    def __init__(self, parts: List[torch.Tensor]):
        self.parts = list(parts)

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.parts)

    def devices(self) -> list:
        return [p.device for p in self.parts]

    def new_rows(self, capacity: int) -> "ShardSlices":
        return ShardSlices([
            torch.empty((capacity,) + tuple(p.shape[1:]), dtype=p.dtype,
                        device=p.device) for p in self.parts])

    def clone(self) -> "ShardSlices":
        return ShardSlices([p.clone() for p in self.parts])

    def _value(self, value, s: int, kind: str):
        if isinstance(value, ShardSlices):
            return value.parts[s]
        if isinstance(value, torch.Tensor):
            return to_card(value, self.parts[s].device, kind)
        return value

    def copy_(self, src) -> "ShardSlices":
        for s, p in enumerate(self.parts):
            p.copy_(self._value(src, s, "t_limit"))
        return self

    def __getitem__(self, key) -> "ShardSlices":
        cache: dict = {}
        return ShardSlices([p[_key_on(key, p.device, cache)]
                            for p in self.parts])

    def __setitem__(self, key, value) -> None:
        cache: dict = {}
        for s, p in enumerate(self.parts):
            p[_key_on(key, p.device, cache)] = self._value(value, s, "state")

    def to_host(self) -> np.ndarray:
        """The rows read back, shards on axis 1 (a blessed readback)."""
        return np.stack(recompile_guard.device_get(self.parts), axis=1)


class _MeshSegmentGraph:
    """The scheduler's replay of a mesh segment: every shard's captured
    graph replayed on its card, then the shards' alive flags merged on the
    mesh's first card into one static output.  The scheduler holds
    `capture_lock` around `replay`."""

    def __init__(self, graphs, alive_parts, alive_out, device):
        self.graphs = graphs
        self.alive_parts = alive_parts
        self.alive_out = alive_out
        self.device = device

    def replay(self) -> None:
        for g in self.graphs:
            g.replay()
        self.alive_out.copy_(torch.stack(
            [to_card(a, self.device, "alive") for a in self.alive_parts],
            1).any(1))


# ---------------------------------------------------------------------------
# cost-ledger entries (the JAX package's formulas): per-shard work runs on
# every shard, so a dispatch's work is n_dev x the single-engine formula
# at the shard shapes; the finalize adds the merge.
# ---------------------------------------------------------------------------

def _mesh_seed_cost(Q, P, D, L, W, n_dev, **_):
    f, b = _seed_pivot_cost(Q, P, D, L, W)
    return n_dev * f, n_dev * b


def _mesh_segment_cost(Q, X, D, W, n_dev, score_itemsize=4,
                       merge_bins=0, L=0, N=0, score_scale=0, **_):
    f, b = _walk_iter_cost(Q, X, D, W, score_itemsize,
                           merge_bins=merge_bins, L=L, N=N,
                           score_scale=score_scale)
    return n_dev * f, n_dev * b


def _mesh_finalize_cost(Q, L, D, N, k_local, k_final, n_dev,
                        rerank=False, **_):
    f, b = _finalize_cost(Q, L, D, N, rerank=rerank)
    mf, mb = _sharded_merge_cost(Q, k_local, k_final, n_dev)
    return n_dev * f + mf, n_dev * b + mb


class MeshGraphEngine:
    """`BeamSlotScheduler`-drivable engine over a `ShardedBKTIndex`.

    Wraps the placement's shard engines (no second corpus copy); one
    instance is one immutable placement — a swap builds a new engine and
    retires the old scheduler.  Seeds from each shard's pivots only (KDT
    shards serve through their fallback pivot sets here)."""

    def __init__(self, sharded):
        self._sharded = sharded
        self.engines = list(sharded.engines)
        self.mesh = sharded.mesh
        self.device = self.mesh.devices[0]
        self.n = int(sharded.n)
        self.n_local = int(sharded.n_local)
        self.n_shards = int(self.mesh.size)
        # the shards share one geometry: the first shard's engine stands
        # for all in the ledger's shapes and the roofline's dtype
        first = self.engines[0]
        self.data = first.data
        self.graph = first.graph
        self.data_score = first.data_score
        self.score_src = first.score_src
        self.score_scale = float(first.score_scale)
        params = getattr(sharded, "params", None)
        self.device_sample_rate = max(0.0, float(getattr(
            params, "flight_device_sample_rate", 0.0) or 0.0))
        self._seg_dispatches = 0
        try:
            self._capability = roofline.capability(probe=bool(int(getattr(
                params, "roofline_probe", 0) or 0)))
        except Exception:                               # noqa: BLE001
            self._capability = None

    #: the scheduler builds its row indices on the host: each card copies
    #: them in, and none crosses between cards
    index_device = torch.device("cpu")

    # ---- scheduler surface (GraphSearchEngine contract) -------------------

    def walk_plan(self, k: int, max_check: int, beam_width: int = 16,
                  pool_size: Optional[int] = None, nbp_limit: int = 3
                  ) -> Tuple[int, int, int, int, int]:
        """The monolithic mesh search's plan: the shard plan at n_local
        rows (every shard runs the full budget), and k_eff = the GLOBAL
        merge width the futures resolve at."""
        k_local = self._sharded._merge_k_local(k)
        L = beam_pool_size(k_local, max_check, self.n_local, pool_size)
        B = beam_width_for(beam_width, max_check, L)
        T = max(1, -(-max_check // B))
        limit = max(nbp_limit, (max_check // 64) // B, 1)
        k_final = min(k, self.n, k_local * self.n_shards)
        return k_final, L, B, T, limit

    def _k_local(self, k_eff: int) -> int:
        # the one MeshKLocal clamp (ShardedBKTIndex), so the scheduler
        # returns the monolithic search's ids
        return self._sharded._merge_k_local(k_eff)

    def chunk_size(self) -> int:
        """The single engine's visited budget, per shard."""
        return max(1, min(_VISITED_BUDGET // max(self.n_local // 8, 1),
                          1024))

    def merge_bins_for(self, L: int, B: int) -> int:
        return self.engines[0].merge_bins_for(L, B)

    def seed_keep_for(self, L: int) -> int:
        return self.engines[0].seed_keep_for(L)

    def finalize_bins_for(self, k_local: int, L: int) -> int:
        return self.engines[0].finalize_bins_for(k_local, L)

    score_itemsize = GraphSearchEngine.score_itemsize
    score_dtype_name = GraphSearchEngine.score_dtype_name
    segment_timer = GraphSearchEngine.segment_timer
    publish_segment_sample = GraphSearchEngine.publish_segment_sample

    def walk_iter_cost(self, rows: int, B: int, L: int = 0):
        """Mesh device work of ONE walk iteration at batch `rows` (every
        shard walks at once): the scheduler's attribution unit."""
        return costmodel.estimate(
            "sharded.segment", Q=rows, X=B * self.graph.shape[1],
            D=self.data.shape[1], W=_num_words(self.n_local),
            n_dev=self.n_shards, score_itemsize=self.score_itemsize(),
            merge_bins=self.merge_bins_for(L, B) if L else 0, L=L,
            N=self.n_local, score_scale=self.score_scale)

    @staticmethod
    def _shard(state: dict, s: int) -> dict:
        """Shard `s`'s slice of a mesh state: tensors on its card."""
        return {key: None if v is None else v.parts[s]
                for key, v in state.items()}

    @staticmethod
    def _join(states: List[dict]) -> dict:
        return {key: (None if states[0].get(key) is None else
                      ShardSlices([st[key] for st in states]))
                for key in ("queries",) + _SHARDED_KEYS}

    def seed_state(self, queries: torch.Tensor, L: int,
                   seeds: Optional[torch.Tensor] = None) -> dict:
        """The batch seated on every shard's card (its copy of the
        queries, ``queries`` bytes between cards) and seeded there."""
        if seeds is not None:
            raise NotImplementedError(
                "the mesh scheduler seeds from per-shard pivots only")

        def seed(s):
            eng = self.engines[s]
            return eng.seed_state(to_card(queries, eng.device, "queries"), L)
        return self._join(self.mesh.map(seed))

    def run_segment(self, state: dict, t_limit: torch.Tensor, k_eff: int,
                    L: int, B: int, nbp_limit: int, S: int,
                    inject: int = 0, check_alive: bool = True
                    ) -> Tuple[dict, torch.Tensor]:
        """Every shard advances its rows by at most S iterations on its
        card (an eager segment checks convergence on each card in turn; a
        replayed one queues on every card before any wait); a query stays
        alive while any shard's row is.  Only `t_limit` goes out to the
        cards and the alive flags come back."""
        timer = self.segment_timer() if check_alive else None
        k_local = self._k_local(k_eff)

        def segment(s):
            eng = self.engines[s]
            return eng.run_segment(
                self._shard(state, s), to_card(t_limit, eng.device,
                                               "t_limit"),
                k_local, L, B, nbp_limit, S, inject=inject,
                check_alive=check_alive)
        outs = self.mesh.map(segment)
        new = self._join([o[0] for o in outs])
        any_alive = torch.stack(
            [to_card(a, self.device, "alive") for _, a in outs], 1).any(1)
        if timer is not None:
            self.publish_segment_sample(int(t_limit.shape[0]), B, L, S,
                                        timer())
        return new, any_alive

    def capture_segment(self, state: dict, t_limit: torch.Tensor,
                        k_eff: int, L: int, B: int, nbp_limit: int, S: int,
                        inject: int = 0):
        """The scheduler's captured segment as one CUDA graph a shard, each
        captured on its shard's card over static copies of its slice:
        (graph, state buffers, t_limit buffers, alive output on the first
        card); None while a profile runs."""
        k_local = self._k_local(k_eff)
        graphs, bufs, t_ins, alives = [], [], [], []
        for s, eng in enumerate(self.engines):
            got = eng.capture_segment(
                self._shard(state, s), to_card(t_limit, eng.device,
                                               "t_limit"),
                k_local, L, B, nbp_limit, S, inject=inject)
            if got is None:
                return None
            graph, buf, t_in, alive = got
            graphs.append(graph)
            bufs.append(buf)
            t_ins.append(t_in)
            alives.append(alive)
        alive_out = torch.zeros(t_limit.shape[0], dtype=torch.bool,
                                device=self.device)
        joined = {key: (None if state.get(key) is None else
                        ShardSlices([b[key] for b in bufs]))
                  for key in state}
        return (_MeshSegmentGraph(graphs, alives, alive_out, self.device),
                joined, ShardSlices(t_ins), alive_out)

    def finalize(self, state: dict, k_eff: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-shard re-rank / tombstone filter / top-k_local on each
        card, global ids, the merge (the candidates are what crosses):
        ((Q, k_eff) dists, (Q, k_eff) int32 ids)."""
        k_local = self._k_local(k_eff)

        def shard_top(s):
            eng = self.engines[s]
            sub = self._shard(state, s)
            d, ids = _finalize(
                eng, sub["queries"], sub["cand_ids"], sub["cand_d"],
                k_local, binned_bins=eng.finalize_bins_for(
                    k_local, int(sub["cand_ids"].shape[1])))
            return d, _global_ids(ids, s, self.n_local)
        d, ids = _gather_merge(self.mesh.map(shard_top), k_eff, self.device)
        return recompile_guard.device_get((d, ids))


costmodel.register("sharded.seed", MeshGraphEngine.seed_state,
                   _mesh_seed_cost)
costmodel.register("sharded.segment", MeshGraphEngine.run_segment,
                   _mesh_segment_cost)
costmodel.register("sharded.finalize", MeshGraphEngine.finalize,
                   _mesh_finalize_cost)
