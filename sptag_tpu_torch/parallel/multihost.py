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
  cluster.  Where the host has a card for every one of its processes,
  each process takes its own (``torch.cuda.set_device(local_rank)``,
  before the group exists) and the group runs NCCL for CUDA tensors and
  gloo for CPU tensors (``cpu:gloo,cuda:nccl``); otherwise, as on a
  one-card host or on the CPU, gloo alone.
* `build_process_sharded()` — each process builds ONLY its own shards, a
  contiguous range of the global shard list (process p of P with a local
  mesh of L devices owns shards p·L ... p·L + L - 1), so no process holds
  the whole corpus.  Rows a shard follow from the corpus size; the graph
  width, the pivot pad and the dense layout's (C, P) are agreed with one
  host all-gather as the widest shard's, which is what the one-process
  mesh takes, so the two place the same arrays and return the same ids
  (the JAX package derives width and pad from the parameters instead).
* `load_process_sharded()` — each process loads only its own shards of a
  mesh folder (one saved by either the one-process or the multi-process
  build), with the same agreement of the geometry.
* a search walks the local shards and merges every process's candidates:
  an all-gather of each process's (Q, L·k_local) distances and global
  ids, concatenated in process order (= global shard order) and one
  stable top-k, which is the one-process mesh's merge.  Where the process
  has a card of its own and NCCL, the all-gather runs on the card
  (``all_gather_into_tensor``) with no host staging; a mesh that repeats
  a card across processes (two processes on one card) or a CPU mesh
  gathers through host memory over gloo.  The choice follows the devices.
  A failed NCCL collective raises: nothing falls back to gloo.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import Optional

import numpy as np
import torch

from sptag_tpu_torch.core.index import MAX_DIST
from sptag_tpu_torch.core.types import DistCalcMethod
from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.parallel.sharded import (Mesh, ShardedBKTIndex,
                                              make_mesh, pack_shard_block,
                                              to_card)

def _card_per_process(num_processes: int) -> bool:
    """Whether this host has a card for each of its processes
    (LOCAL_WORLD_SIZE, else every process on this host)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return torch.cuda.is_available() and torch.cuda.device_count() >= local


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: Optional[float] = None) -> None:
    """``torch.distributed.init_process_group`` with environment
    fallbacks; a no-op for single-process runs (num_processes == 1 and no
    coordinator given).  `coordinator_address` is ``host:port`` or a
    ``tcp://`` URL.  With no `backend`, a host with a card for each of its
    processes sets this process's card (LOCAL_RANK, else the process id)
    and runs ``cpu:gloo,cuda:nccl``; any other host runs ``gloo``.
    `timeout_s` bounds every collective."""
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
    if backend is None:
        backend = "gloo"
        if _card_per_process(num_processes):
            # one card a process, current before the group (and NCCL's
            # communicator) exists
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                     process_id)))
            backend = "cpu:gloo,cuda:nccl"
    kw = {} if timeout_s is None else {"timeout": timedelta(
        seconds=timeout_s)}
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id, **kw)


def nccl_on_cards() -> bool:
    """Whether the default group carries CUDA tensors over NCCL."""
    import torch.distributed as dist

    return dist.is_initialized() and "nccl" in str(dist.get_backend())


def local_mesh() -> Mesh:
    """This process's mesh: its own card where the group runs NCCL (one
    rank a card), else every CUDA card of the host (`make_mesh`)."""
    if nccl_on_cards():
        return Mesh([torch.device("cuda", torch.cuda.current_device())])
    return make_mesh()


def _all_gather_host(t: torch.Tensor) -> torch.Tensor:
    """Every process's `t` (same shape and dtype on each), stacked in rank
    order, through host memory (gloo)."""
    import torch.distributed as dist

    host = t.detach().cpu().contiguous()
    out = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(out, host)
    return torch.stack(out)


def _all_gather_device(t: torch.Tensor) -> torch.Tensor:
    """Every process's `t` stacked in rank order, gathered where `t` lives
    (NCCL on a card; gloo takes the same call on CPU tensors)."""
    import torch.distributed as dist

    t = t.contiguous()
    world = dist.get_world_size()
    out = torch.empty((world * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t)
    return out.view((world,) + tuple(t.shape))


class ProcessShardedBKTIndex(ShardedBKTIndex):
    """One process's part of a multi-process mesh: its local shards, and
    the merge over every process's candidates.  `device_merge` (set at
    placement): the all-gather runs where the candidates are, NCCL on the
    process's own card; False gathers through the host over gloo.
    `last_all_gather_ms()` reads the last merge's all-gather."""

    _cascade_ok = False
    device_merge = False
    _gather_timer = None

    def _merge(self, parts, k_final: int):
        dev = self.mesh.devices[0]
        local_d = torch.cat([to_card(d, dev, "candidates").to(torch.float32)
                             for d, _ in parts], 1)
        local_i = torch.cat([to_card(i, dev, "candidates").to(torch.int64)
                             for _, i in parts], 1)
        gather = _all_gather_device if self.device_merge \
            else _all_gather_host
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
        else:
            t0 = time.perf_counter()
        all_d = gather(local_d)                     # (P, Q, L * k_local)
        all_i = gather(local_i)
        if dev.type == "cuda":
            end.record(torch.cuda.current_stream(dev))
            self._gather_timer = (start, end)
        else:
            self._gather_timer = (time.perf_counter() - t0) * 1e3
        Q = local_d.shape[0]
        all_d = all_d.permute(1, 0, 2).reshape(Q, -1)
        all_i = all_i.permute(1, 0, 2).reshape(Q, -1)
        gd, gpos = dist_ops.smallest_k(all_d, k_final)
        gi = torch.gather(all_i, 1, gpos)
        return gd, torch.where(gd >= MAX_DIST, -1, gi).to(torch.int32)

    def last_all_gather_ms(self) -> Optional[float]:
        """The last merge's all-gather in milliseconds: CUDA events on the
        process's card (read after the merge's readback), the host clock
        on the CPU."""
        timer = self._gather_timer
        if timer is None or isinstance(timer, float):
            return timer
        timer[1].synchronize()
        return float(timer[0].elapsed_time(timer[1]))


def _process_mesh(mesh: Optional[Mesh], n_shards: Optional[int] = None):
    """(local mesh, world, rank): the local mesh defaults to `local_mesh`;
    `n_shards`, when known, must split evenly over the processes."""
    import torch.distributed as dist

    mesh = mesh if mesh is not None else local_mesh()
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_shards is not None and n_shards != world * mesh.size:
        raise ValueError(
            f"{n_shards} shards do not split into {world} processes of "
            f"{mesh.size} local devices")
    return mesh, world, rank


def _place_process(self, subs, empties, dense: bool) -> None:
    """Agree the geometry over every process (one host all-gather: the
    graph width and pivot pad the one-process mesh takes, the widest
    shard's, so both meshes place the same arrays and return the same
    ids, and the dense layout's data-dependent (C, P)), then place this
    process's shards, each on its card."""
    import torch.distributed as dist

    layouts = self._dense_layouts(subs) if dense else []
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
        p = pack_shard_block(sub, self.n_local, self.dim, m_width, max_p)
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
            [DenseTreeSearcher.pad_layout(l, C, Pb, self.dim)
             for l in layouts], C, Pb)
    # the merge gathers on the card where this process has one of its own
    # and NCCL carries CUDA tensors
    devs = self.mesh.devices
    self.device_merge = (
        devs[0].type == "cuda" and nccl_on_cards()
        and len(set(devs)) == len(devs)
        and devs[0].index == torch.cuda.current_device())


def build_process_sharded(data_for_shard, n: int, dim: int,
                          metric: DistCalcMethod = DistCalcMethod.L2,
                          mesh: Optional[Mesh] = None, value_type=None,
                          params: Optional[dict] = None,
                          dense: bool = False,
                          algo: str = "BKT",
                          save_to: Optional[str] = None
                          ) -> ProcessShardedBKTIndex:
    """Build this process's shards of a mesh spanning every process.

    `mesh` is this process's LOCAL mesh (default `local_mesh`: its own card
    under NCCL, else every CUDA card of the host; it may repeat a device);
    the global mesh has world_size x mesh.size shards.
    `data_for_shard(s) -> (rows, D)` gives global shard `s`'s contiguous
    block ([s·n_local, min((s+1)·n_local, n))), a callable so each process
    loads only its own rows.  `n` / `dim` are the GLOBAL corpus rows and
    width.  `dense=True` also packs each local shard's dense layout, its
    (C, P) agreed over all processes.  `save_to` (a folder every process
    sees) receives each process's ``shard_NNN`` folders and, once all are
    written, rank 0's ``sharded.json``: a mesh folder
    `ShardedBKTIndex.load` opens in one process."""
    import torch.distributed as dist

    from sptag_tpu_torch.core.index import create_instance
    from sptag_tpu_torch.core.types import (ErrorCode, dtype_of,
                                            value_type_of)

    if str(algo).upper() not in ("BKT", "KDT"):
        raise ValueError(
            f"sharded mesh indexes support BKT or KDT shards, not {algo!r}")
    mesh, world, rank = _process_mesh(mesh)
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

    def build_shard(j):
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
        return sub, empty
    built = mesh.map(build_shard)
    subs = [sub for sub, _ in built]
    empties = [empty for _, empty in built]
    _place_process(self, subs, empties, dense)
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


def load_process_sharded(folder: str, mesh: Optional[Mesh] = None,
                         dense: bool = False) -> ProcessShardedBKTIndex:
    """Load this process's shards of a mesh folder (``sharded.json`` and
    one ``shard_NNN`` folder a shard, from either package's build): the
    local shards of process p of P with a local mesh of L devices are
    p·L ... p·L + L - 1, each loaded onto its device, the geometry agreed
    as `build_process_sharded` agrees it, so the processes together
    return the one-process mesh's ids."""
    import json

    from sptag_tpu_torch.core.index import load_index

    with open(os.path.join(folder, "sharded.json")) as f:
        meta = json.load(f)
    mesh, world, rank = _process_mesh(mesh, int(meta["n_shards"]))
    n, n_shards = int(meta["n"]), int(meta["n_shards"])
    self = ProcessShardedBKTIndex(mesh)
    self.metric = DistCalcMethod(meta["metric"])
    self.n, self.n_local, self.dim = n, -(-n // n_shards), int(meta["dim"])
    self.n_shards = n_shards
    self._shard_base = rank * mesh.size
    subs = mesh.map(lambda j: load_index(
        os.path.join(folder, f"shard_{self._shard_base + j:03d}"),
        device=mesh.devices[j]))
    empty = set(meta.get("empty_shards", []))
    _place_process(self, subs, [self._shard_base + j in empty
                                for j in range(mesh.size)], dense)
    return self
