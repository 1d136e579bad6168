"""Mesh-wide segment engine: continuous batching over a sharded index (port
of ``sptag_tpu/parallel/mesh_engine.py``).

`ShardedBKTIndex.search` walks every shard of a mesh to the end of the
batch.  This module gives the mesh the engine surface the slot scheduler
(algo/scheduler.py) drives — `walk_plan` / `seed_state` / `run_segment` /
`finalize` / `chunk_size` — over the shards' own engines:

* **seed**: every shard seeds the query batch from its own pivot set;
* **segment**: every shard advances its rows by at most S iterations of
  the single engine's walk body; shards converge independently, and a
  query stays resident until every shard's row is done;
* **finalize**: every shard re-ranks / tombstone-filters its pool to
  k_local, its ids become global, and the shards merge
  (parallel/sharded.py `_gather_merge`), the monolithic mesh search's
  merge.

State is QUERY-major with the shard axis second — ``cand_ids (Q,
n_shards, L)``, ``visited (Q, n_shards, N_local + 1)``, ``it (Q,
n_shards)`` ... — so the scheduler's slot bookkeeping (insert, blank,
compact and retire index axis 0) works unchanged: one slot row is one
query's residency across the whole mesh.  The state lives on the mesh's
first device; each shard's slice moves to its device for the segment (no
copy when the mesh repeats one card).
"""

from __future__ import annotations

from typing import Optional, Tuple

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
                                              _sharded_merge_cost)
from sptag_tpu_torch.utils import costmodel, recompile_guard, roofline

#: the loop-carried state keys with a shard axis (queries have none)
_SHARDED_KEYS = ("cand_ids", "cand_d", "expanded", "visited", "no_better",
                 "ptr", "it", "spare_ids", "spare_d")


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

    def seed_state(self, queries: torch.Tensor, L: int,
                   seeds: Optional[torch.Tensor] = None) -> dict:
        if seeds is not None:
            raise NotImplementedError(
                "the mesh scheduler seeds from per-shard pivots only")
        states = [eng.seed_state(queries.to(eng.device), L)
                  for eng in self.engines]
        return self._stack(queries, states)

    def _stack(self, queries, states) -> dict:
        out = {"queries": queries}
        for key in _SHARDED_KEYS:
            vals = [st.get(key) for st in states]
            out[key] = (None if vals[0] is None else
                        torch.stack([v.to(self.device) for v in vals], 1))
        return out

    def _shard_state(self, state: dict, s: int, dev) -> dict:
        sub = {"queries": state["queries"].to(dev)}
        for key in _SHARDED_KEYS:
            v = state.get(key)
            sub[key] = None if v is None else v[:, s].to(dev).contiguous()
        return sub

    def run_segment(self, state: dict, t_limit: torch.Tensor, k_eff: int,
                    L: int, B: int, nbp_limit: int, S: int,
                    inject: int = 0, check_alive: bool = True
                    ) -> Tuple[dict, torch.Tensor]:
        """Every shard advances its rows by at most S iterations; a query
        stays alive while any shard's row is."""
        timer = self.segment_timer() if check_alive else None
        k_local = self._k_local(k_eff)
        outs, alive = [], []
        for s, eng in enumerate(self.engines):
            new, a = eng.run_segment(
                self._shard_state(state, s, eng.device),
                t_limit.to(eng.device), k_local, L, B, nbp_limit, S,
                inject=inject, check_alive=check_alive)
            outs.append(new)
            alive.append(a.to(self.device))
        out = self._stack(state["queries"], outs)
        any_alive = torch.stack(alive, 1).any(1)
        if timer is not None:
            self.publish_segment_sample(int(state["queries"].shape[0]), B,
                                        L, S, timer())
        return out, any_alive

    def finalize(self, state: dict, k_eff: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-shard re-rank / tombstone filter / top-k_local, global ids,
        the merge: ((Q, k_eff) dists, (Q, k_eff) int32 ids)."""
        k_local = self._k_local(k_eff)
        parts = []
        for s, eng in enumerate(self.engines):
            dev = eng.device
            cand_ids = state["cand_ids"][:, s].to(dev).contiguous()
            d, ids = _finalize(
                eng, state["queries"].to(dev), cand_ids,
                state["cand_d"][:, s].to(dev).contiguous(), k_local,
                binned_bins=eng.finalize_bins_for(
                    k_local, int(cand_ids.shape[1])))
            parts.append((d, _global_ids(ids, s, self.n_local)))
        d, ids = _gather_merge(parts, k_eff, self.device)
        return recompile_guard.device_get((d, ids))


costmodel.register("sharded.seed", MeshGraphEngine.seed_state,
                   _mesh_seed_cost)
costmodel.register("sharded.segment", MeshGraphEngine.run_segment,
                   _mesh_segment_cost)
costmodel.register("sharded.finalize", MeshGraphEngine.finalize,
                   _mesh_finalize_cost)
