"""Multi-process deployment of the sharded graph index (port of
``sptag_tpu/parallel/multihost.py``).

The reference scales across machines with one server process a shard and
an aggregator fanning queries out over TCP.  The JAX package runs every
process under ``jax.distributed`` with one mesh over all of them.  Here
every process runs ``torch.distributed``:

* `initialize()` — ``torch.distributed.init_process_group`` with the JAX
  package's arguments and environment fallbacks (JAX_COORDINATOR_ADDRESS /
  JAX_NUM_PROCESSES / JAX_PROCESS_ID); the caller names the address, the
  world size and the rank, since nothing on a host tells a process of a
  cluster.
* `build_process_sharded()` — each process builds ONLY its own shards, a
  contiguous range of the global shard list (process p of P with a local
  mesh of L devices owns shards p·L ... p·L + L - 1), so no process holds
  the whole corpus.  Rows a shard follow from the corpus size; the graph
  width, the pivot pad and the dense layout's (C, P) are agreed with one
  host all-gather as the widest shard's, which is what the one-process
  mesh takes, so the two place the same arrays and return the same ids
  (the JAX package derives width and pad from the parameters instead).
* a search walks the local shards and merges every process's candidates:
  an ``all_gather`` of each process's (Q, L·k_local) distances and global
  ids, concatenated in process order (= global shard order) and one
  stable top-k, which is the one-process mesh's merge.

The backend is **gloo**: the candidates, a few KB a batch, are staged
through host memory.  NCCL needs a card per rank, so it waits for a
machine with several cards; two processes may share one card here.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from sptag_tpu_torch.core.index import MAX_DIST
from sptag_tpu_torch.core.types import DistCalcMethod
from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.parallel.sharded import (Mesh, ShardedBKTIndex,
                                              make_mesh, pack_shard_block)

def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "gloo") -> None:
    """``torch.distributed.init_process_group`` with environment
    fallbacks; a no-op for single-process runs (num_processes == 1 and no
    coordinator given).  `coordinator_address` is ``host:port`` or a
    ``tcp://`` URL."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if coordinator_address is None and num_processes == 1:
        return
    if coordinator_address is None:
        raise ValueError("a multi-process run needs a coordinator address "
                         "(JAX_COORDINATOR_ADDRESS or the argument)")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def _all_gather_host(t: torch.Tensor) -> torch.Tensor:
    """Every process's `t` (same shape and dtype on each), stacked in rank
    order, through host memory (gloo)."""
    import torch.distributed as dist

    host = t.detach().cpu().contiguous()
    out = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(out, host)
    return torch.stack(out)


class ProcessShardedBKTIndex(ShardedBKTIndex):
    """One process's part of a multi-process mesh: its local shards, and
    the merge over every process's candidates."""

    _cascade_ok = False

    def _merge(self, parts, k_final: int):
        dev = self.mesh.devices[0]
        local_d = torch.cat([d.to(dev, torch.float32) for d, _ in parts], 1)
        local_i = torch.cat([i.to(dev, torch.int64) for _, i in parts], 1)
        all_d = _all_gather_host(local_d)           # (P, Q, L * k_local)
        all_i = _all_gather_host(local_i)
        Q = local_d.shape[0]
        all_d = all_d.permute(1, 0, 2).reshape(Q, -1)
        all_i = all_i.permute(1, 0, 2).reshape(Q, -1)
        gd, gpos = dist_ops.smallest_k(all_d, k_final)
        gi = torch.gather(all_i, 1, gpos)
        return gd, torch.where(gd >= MAX_DIST, -1, gi).to(torch.int32)


def build_process_sharded(data_for_shard, n: int, dim: int,
                          metric: DistCalcMethod = DistCalcMethod.L2,
                          mesh: Optional[Mesh] = None, value_type=None,
                          params: Optional[dict] = None,
                          dense: bool = False,
                          algo: str = "BKT",
                          save_to: Optional[str] = None
                          ) -> ProcessShardedBKTIndex:
    """Build this process's shards of a mesh spanning every process.

    `mesh` is this process's LOCAL mesh (default: every CUDA card of the
    host; it may repeat a device); the global mesh has world_size x
    mesh.size shards.  `data_for_shard(s) -> (rows, D)` gives global shard
    `s`'s contiguous block ([s·n_local, min((s+1)·n_local, n))), a callable
    so each process loads only its own rows.  `n` / `dim` are the GLOBAL
    corpus rows and width.  `dense=True` also packs each local shard's
    dense layout, its (C, P) agreed over all processes.  `save_to` (a
    folder every process sees) receives each process's ``shard_NNN``
    folders and, once all are written, rank 0's ``sharded.json``: a mesh
    folder `ShardedBKTIndex.load` opens in one process."""
    import torch.distributed as dist

    from sptag_tpu_torch.core.index import create_instance
    from sptag_tpu_torch.core.types import (ErrorCode, dtype_of,
                                            value_type_of)

    if str(algo).upper() not in ("BKT", "KDT"):
        raise ValueError(
            f"sharded mesh indexes support BKT or KDT shards, not {algo!r}")
    mesh = mesh if mesh is not None else make_mesh()
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n_local_dev = mesh.size
    n_shards = world * n_local_dev
    if n < n_shards:
        raise ValueError(f"corpus ({n}) smaller than mesh ({n_shards})")
    n_local = -(-n // n_shards)

    self = ProcessShardedBKTIndex(mesh)
    self.metric = DistCalcMethod(metric)
    self.n, self.n_local, self.dim = n, n_local, dim
    self.n_shards = n_shards
    self._shard_base = rank * n_local_dev

    layouts, subs, empties = [], [], []
    for j in range(n_local_dev):
        s = self._shard_base + j
        block = np.asarray(data_for_shard(s))
        empty = block.shape[0] == 0
        if empty:
            # a ceil-division tail shard can be empty: a tombstoned
            # one-row placeholder keeps it in the mesh
            dt = (dtype_of(value_type) if value_type is not None
                  else block.dtype if block.dtype != np.float64
                  else np.float32)
            block = np.zeros((1, dim), dt)
        sub = create_instance(algo, value_type if value_type is not None
                              else value_type_of(block.dtype),
                              device=mesh.devices[j])
        sub.set_parameter("DistCalcMethod",
                          "Cosine" if self.metric == DistCalcMethod.Cosine
                          else "L2")
        for name, value in (params or {}).items():
            sub.set_parameter(name, str(value))
        rc = sub.build(block)
        if rc != ErrorCode.Success:
            raise ValueError(f"shard {s} build failed ({rc!r}) over "
                             f"{block.shape[0]} rows")
        subs.append(sub)
        empties.append(empty)
        if dense:
            from sptag_tpu_torch.algo.dense import DenseTreeSearcher

            _, clusters = sub._dense_clusters()
            layouts.append(DenseTreeSearcher.build_layout(
                sub._host[:sub._n], clusters, self.metric, replicas=1,
                device="cpu"))
    # one host all-gather agrees the geometry: the graph width and pivot
    # pad the one-process mesh takes (the widest shard's), so both meshes
    # place the same arrays and return the same ids, and the dense
    # layout's data-dependent (C, P)
    local = torch.tensor([
        max(sub._graph.shape[1] for sub in subs),
        max(len(sub._pivot_ids()) for sub in subs),
        max((l["perm"].shape[0] for l in layouts), default=0),
        max((l["perm"].shape[1] for l in layouts), default=0)],
        dtype=torch.int64)
    agreed = (_all_gather_host(local) if dist.is_initialized()
              else local[None]).amax(0).tolist()
    m_width, max_p, C, Pb = (int(v) for v in agreed)
    packed = []
    for sub, empty in zip(subs, empties):
        p = pack_shard_block(sub, n_local, dim, m_width, max_p)
        if empty:
            p["deleted"][:] = True    # the placeholder row never returns
        packed.append(p)
    first = subs[0]
    self.base = first.base
    self.params = first.params
    self.max_check = int(self.params.max_check)
    self.nbp_limit = int(self.params.no_better_propagation_limit)
    self.beam_width = int(getattr(self.params, "beam_width", 16))
    self._place(packed)
    if dense:
        from sptag_tpu_torch.algo.dense import DenseTreeSearcher

        self._place_dense_padded(
            [DenseTreeSearcher.pad_layout(l, C, Pb, dim) for l in layouts],
            C, Pb)
    if save_to is not None:
        from sptag_tpu_torch.parallel.sharded import (save_shards,
                                                      write_manifest)

        save_shards(save_to, subs, first=self._shard_base)
        empty = [self._shard_base + j for j, e in enumerate(empties) if e]
        if dist.is_initialized():
            gathered = [None] * world
            dist.all_gather_object(gathered, empty)    # also the barrier
            empty = sorted(s for part in gathered for s in part)
        if rank == 0:
            write_manifest(save_to, n_shards, n, dim, self.metric, empty)
        if dist.is_initialized():
            dist.barrier()
    return self
