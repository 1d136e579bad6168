"""The port's mesh with one shard a card (sptag_tpu_torch/parallel/), on
the CPU: the shards' results merged where they lie, the mesh scheduler's
shard-resident state, the per-shard segment graphs and the multi-process
merge's device-side all-gather, against the JAX mesh and against a merge
of the shards' host results.

On integer-valued rows every distance is an exact float32 integer, so ids
and distances are compared exactly.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from sptag_tpu.core.types import DistCalcMethod as JMetric
from sptag_tpu.parallel import sharded as js
from sptag_tpu_torch.algo import engine as teng
from sptag_tpu_torch.algo import scheduler as tsched
from sptag_tpu_torch.parallel import mesh_engine as tme
from sptag_tpu_torch.parallel import multihost
from sptag_tpu_torch.parallel import sharded as ts
from sptag_tpu_torch.utils import devmem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 8
PARAMS = {"TPTNumber": 2, "CEF": 32, "MaxCheckForRefineGraph": 64,
          "NeighborhoodSize": 16, "FinalRefineSearchMode": "same",
          "MaxCheck": 256, "BKTKmeansK": 8, "TPTLeafSize": 64,
          "RefineIterations": 1}


def _rows(n, seed):
    return np.random.default_rng(seed).integers(-8, 9, (n, D)).astype(
        np.float32)


DATA = _rows(640, 20)
QUERIES = _rows(20, 21)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[2, 4, 8])
def jax_folder(request, tmp_path_factory):
    n = request.param
    folder = str(tmp_path_factory.mktemp(f"cards{n}"))
    jm = js.make_mesh(jax.devices()[:n])
    js.ShardedBKTIndex.build(DATA, JMetric.L2, mesh=jm, params=PARAMS,
                             save_to=folder)
    return n, folder, js.ShardedBKTIndex.load(folder, mesh=jm, dense=True)


def _merge_inputs(monkeypatch):
    """The shard candidates each merge of the mesh took, and a flag set
    if a shard engine read its results back (`search`, the numpy form)."""
    merged, read_back = [], []
    orig = ts.ShardedBKTIndex._merge

    def spy(self, parts, k_final):
        merged.append([(d, i) for d, i in parts])
        return orig(self, parts, k_final)
    monkeypatch.setattr(ts.ShardedBKTIndex, "_merge", spy)
    search = teng.GraphSearchEngine.search

    def no_read_back(self, *a, **kw):
        read_back.append(self)
        return search(self, *a, **kw)
    monkeypatch.setattr(teng.GraphSearchEngine, "search", no_read_back)
    return merged, read_back


def test_mesh_merges_on_the_device_and_equals_the_jax_mesh(jax_folder,
                                                           monkeypatch):
    """Every shard's walk leaves its (Q, k_local) candidates as tensors on
    its device, none is read back before the merge, and beam (monolithic
    and scheduled), dense and FLAT give the JAX mesh's ids and
    distances."""
    n, folder, j = jax_folder
    t = ts.ShardedBKTIndex.load(folder, mesh=ts.Mesh(["cpu"] * n),
                                dense=True)
    merged, read_back = _merge_inputs(monkeypatch)
    jd, ji = j.search(QUERIES, 10)
    td, ti = t.search(QUERIES, 10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    assert not read_back
    assert len(merged) == 1 and len(merged[0]) == n
    for s, (d, i) in enumerate(merged[0]):
        assert isinstance(d, torch.Tensor) and isinstance(i, torch.Tensor)
        assert d.device == i.device == t.mesh.devices[s]
        assert d.shape == i.shape == (len(QUERIES), 10)
    jd, ji = j.search_dense(QUERIES, 10, max_check=128)
    td, ti = t.search_dense(QUERIES, 10, max_check=128)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-4)
    t.enable_continuous_batching(slots=8, segment_iters=2)
    try:
        futs = t.submit_batch(QUERIES, 10)
        got = [f.result(timeout=120) for f in futs]
    finally:
        t.retire_scheduler()
    np.testing.assert_array_equal(np.stack([g[1] for g in got]),
                                  j.search(QUERIES, 10)[1])
    assert not read_back
    fj = js.ShardedFlatIndex(DATA, JMetric.L2, 1, mesh=j.mesh)
    ft = ts.ShardedFlatIndex(DATA, 0, 1, mesh=ts.Mesh(["cpu"] * n))
    np.testing.assert_array_equal(ft.search(QUERIES, 10)[1],
                                  fj.search(QUERIES, 10)[1])


@pytest.mark.parametrize("binned", ["off", "on"])
def test_mesh_device_merge_is_the_host_merge_bit_for_bit(binned):
    """The mesh's merge of its shards' device results returns the bits of
    each shard engine's host results (`search`) concatenated in shard
    order and reduced by a stable sort, and the mesh scheduler returns the
    same bits."""
    from sptag_tpu_torch.core.index import MAX_DIST

    n, k = 4, 10
    m = ts.ShardedBKTIndex.build(DATA, 0, mesh=ts.Mesh(["cpu"] * n),
                                 params=dict(PARAMS, BinnedTopK=binned),
                                 dense=True)
    got_d, got_i = m.search(QUERIES, k)
    parts_d, parts_i = [], []
    for s, eng in enumerate(m.engines):
        d, ids = eng.search(QUERIES, m._merge_k_local(k), m.max_check,
                            m.beam_width, None, m.nbp_limit)
        parts_d.append(d)
        parts_i.append(np.where(ids >= 0, ids.astype(np.int64)
                                + s * m.n_local, -1))
    all_d = np.concatenate(parts_d, 1)
    all_i = np.concatenate(parts_i, 1)
    order = np.argsort(all_d, axis=1, kind="stable")[:, :k]
    want_d = np.take_along_axis(all_d, order, 1)
    want_i = np.where(want_d >= MAX_DIST, -1,
                      np.take_along_axis(all_i, order, 1)).astype(np.int32)
    np.testing.assert_array_equal(got_i, want_i)
    assert got_d.tobytes() == want_d.tobytes()
    m.enable_continuous_batching(slots=8, segment_iters=3)
    try:
        futs = m.submit_batch(QUERIES, k)
        sched = [f.result(timeout=120) for f in futs]
    finally:
        m.retire_scheduler()
    np.testing.assert_array_equal(np.stack([g[1] for g in sched]), got_i)
    assert np.stack([g[0] for g in sched]).tobytes() == got_d.tobytes()


def test_mesh_map_runs_every_shard_in_order():
    """`Mesh.map` runs its shards in order from the caller's thread and
    stops at the first shard that raises; a device without an index names
    the current card only where one exists."""
    mesh = ts.Mesh(["cpu"] * 4)
    seen = []
    assert mesh.map(lambda s: seen.append(s) or s * s) == [0, 1, 4, 9]
    assert seen == [0, 1, 2, 3]

    def shard(s):
        seen.append(s)
        if s == 1:
            raise KeyError("shard 1")
        return s
    seen.clear()
    with pytest.raises(KeyError, match="shard 1"):
        mesh.map(shard)
    assert seen == [0, 1]
    assert ts.Mesh(["cuda:1", "cpu"]).devices == (torch.device("cuda", 1),
                                                  torch.device("cpu"))
    with pytest.raises(ValueError, match="at least one device"):
        ts.Mesh([])


def test_mesh_scheduler_keeps_each_shard_state_on_its_card(tmp_path,
                                                           monkeypatch):
    """The mesh scheduler's slot state is a tensor a shard (ShardSlices),
    never stacked on one device, and only the seated queries, t_limit,
    the alive flags and the finalize's candidates would cross between
    cards: every other value stays in its shard's slice."""
    n = 4
    m = ts.ShardedBKTIndex.build(DATA, 0, mesh=ts.Mesh(["cpu"] * n),
                                 params=PARAMS)
    want = m.search(QUERIES, 10)
    crossings = []
    orig = tme.to_card

    def record(t, device, kind):
        crossings.append((kind, tuple(t.shape)))
        return orig(t, device, kind)
    monkeypatch.setattr(tme, "to_card", record)
    monkeypatch.setattr(ts, "to_card", record)
    sched = m.enable_continuous_batching(slots=8, segment_iters=2)
    seen_state = []
    cycle = tsched.BeamSlotScheduler._cycle

    def spy(self, pool, incoming):
        cycle(self, pool, incoming)
        if pool.state:
            seen_state.append({k: v for k, v in pool.state.items()})
    monkeypatch.setattr(tsched.BeamSlotScheduler, "_cycle", spy)
    try:
        futs = m.submit_batch(QUERIES, 10)
        got = [f.result(timeout=120) for f in futs]
        stats = sched.stats()
    finally:
        m.retire_scheduler()
    np.testing.assert_array_equal(np.stack([g[1] for g in got]), want[1])
    np.testing.assert_array_equal(np.stack([g[0] for g in got]), want[0])
    assert seen_state
    # a slice has the single engine's layout: no shard axis
    single = m.engines[0].seed_state(torch.zeros((1, D)), 8)
    for state in seen_state:
        for key, v in state.items():
            if v is None:
                continue
            assert isinstance(v, tme.ShardSlices), key
            assert len(v.parts) == n
            rows = v.parts[0].shape[0]
            for s, part in enumerate(v.parts):
                assert isinstance(part, torch.Tensor)
                assert part.device == m.mesh.devices[s]
                assert part.shape[0] == rows
                assert part.dim() == single[key].dim(), key
    kinds = {kind for kind, _ in crossings}
    assert kinds <= {"queries", "t_limit", "alive", "candidates"}, kinds
    segs = stats["segments_eager"] + stats["segments_replayed"]
    per_seg = [shape for kind, shape in crossings
               if kind in ("t_limit", "alive")]
    assert len(per_seg) == 2 * n * segs
    assert all(len(shape) == 1 for shape in per_seg)     # (slots,) flags
    assert all(shape[1:] == (D,) for kind, shape in crossings
               if kind == "queries")
    assert all(shape[1:] == (10,) for kind, shape in crossings
               if kind == "candidates")


class _FakeGraph:
    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def test_mesh_segment_graphs_are_one_a_shard(monkeypatch):
    """A replayed mesh segment is one captured graph a shard, each over
    static copies of its own slice, and the merged alive flags: replayed
    (with the card's capture rehearsed as a closure) it returns the
    monolithic mesh walk's ids and distances."""
    m = ts.ShardedBKTIndex.build(DATA, 0, mesh=ts.Mesh(["cpu"] * 2),
                                 params=PARAMS)
    want = m.search(QUERIES, 10)
    captured = []

    def fake_capture(self, state, t_limit, k_eff, L, B, nbp_limit, S,
                     inject=0):
        bufs = {k: v.clone() for k, v in state.items() if v is not None}
        t_in = t_limit.clone()
        alive_out = torch.zeros(t_limit.shape[0], dtype=torch.bool)

        def segment():
            st = {k: bufs.get(k) for k in state}
            new, alive = self.run_segment(st, t_in, k_eff, L, B, nbp_limit,
                                          S, inject=inject,
                                          check_alive=False)
            for k in teng.STATE_KEYS:
                if new[k] is not bufs[k]:
                    bufs[k].copy_(new[k])
            alive_out.copy_(alive)
        captured.append(self)
        return _FakeGraph(segment), bufs, t_in, alive_out
    monkeypatch.setattr(teng.GraphSearchEngine, "capture_segment",
                        fake_capture)
    sched = m.enable_continuous_batching(slots=8, segment_iters=2)
    sched._graph_max_slots = 256
    try:
        for _ in range(2):               # a key is captured at its second
            futs = m.submit_batch(QUERIES, 10)
            got = [f.result(timeout=120) for f in futs]
            np.testing.assert_array_equal(np.stack([g[1] for g in got]),
                                          want[1])
            np.testing.assert_array_equal(np.stack([g[0] for g in got]),
                                          want[0])
        stats = sched.stats()
    finally:
        m.retire_scheduler()
    assert stats["graphs_captured"] >= 1 and stats["segments_replayed"] > 0
    # every capture of the mesh captured both shards' engines
    assert len(captured) == 2 * stats["graphs_captured"]
    assert set(map(id, captured)) == set(map(id, m.engines))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a card (the transfer rules' rehearsal)."""

    card = torch.device("cuda", 1)

    @property
    def device(self):
        return self.card

    def to(self, *args, **kwargs):
        return self


def test_card_to_card_copies_count_and_need_peer_access(monkeypatch):
    t = torch.zeros(6, 10, dtype=torch.float32).as_subclass(_OnCard)
    ts.reset_card_transfer_bytes()
    monkeypatch.setattr(ts, "_peer", {})
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda dst, src: False)
    with pytest.raises(RuntimeError, match="no peer access"):
        ts.to_card(t, torch.device("cuda", 0), "candidates")
    monkeypatch.setattr(ts, "_peer", {})
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda dst, src: True)
    ts.to_card(t, torch.device("cuda", 0), "candidates")
    ts.to_card(t, torch.device("cuda", 1), "candidates")   # same card
    assert ts.card_transfer_bytes() == {"candidates": 240}
    ts.reset_card_transfer_bytes()
    cpu = torch.zeros(3)
    assert ts.to_card(cpu, torch.device("cpu"), "queries") is cpu
    assert ts.card_transfer_bytes() == {}


def test_mesh_device_bytes_by_card():
    devmem.reset()
    m = ts.ShardedBKTIndex.build(DATA, 0, mesh=ts.Mesh(["cpu"] * 2),
                                 params=PARAMS, dense=True)
    by_card = m.device_bytes()
    assert set(by_card) == {"cpu"}
    want = sum(sum(e.device_bytes().values()) for e in m.engines) + sum(
        t.nbytes for ds in m.dense_shards for t in ds.values())
    assert by_card["cpu"] == want
    assert devmem.card_bytes()["cpu"] > 0
    del m
    devmem.reset()


@pytest.mark.parametrize("seg", [None, 3])
def test_search_tensors_is_search_on_the_device(seg):
    m = ts.ShardedBKTIndex.build(DATA, 0, mesh=ts.Mesh(["cpu"]),
                                 params=PARAMS)
    eng = m.engines[0]
    d, ids = eng.search_tensors(QUERIES, 12, 256, segment_iters=seg)
    assert isinstance(d, torch.Tensor) and d.device == eng.device
    assert d.dtype == torch.float32 and ids.dtype == torch.int32
    want = eng.search(QUERIES, 12, 256, segment_iters=seg)
    np.testing.assert_array_equal(ids.numpy(), want[1])
    assert d.numpy().tobytes() == want[0].tobytes()


def test_initialize_takes_a_card_a_process_and_nccl(monkeypatch):
    """With a card for every process of the host, each process sets its
    card before the group exists and the group runs NCCL for CUDA
    tensors, gloo for CPU ones; with fewer cards, gloo alone."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls.append(("set_device", i)))
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    multihost.initialize("127.0.0.1:1", num_processes=4, process_id=2,
                         timeout_s=30)
    assert calls[0] == ("set_device", 2)
    assert calls[1][0] == "cpu:gloo,cuda:nccl"
    assert calls[1][1]["timeout"].total_seconds() == 30
    calls.clear()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    multihost.initialize("127.0.0.1:1", num_processes=2, process_id=1)
    assert calls == [("gloo", {"init_method": "tcp://127.0.0.1:1",
                               "world_size": 2, "rank": 1})]


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, port, folder, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                               sys.argv[4])
    params = eval(sys.argv[5])
    from sptag_tpu_torch.parallel import multihost
    from sptag_tpu_torch.parallel.sharded import Mesh
    multihost.initialize(f"127.0.0.1:{port}", num_processes=2,
                         process_id=rank, timeout_s=120)
    queries = np.random.default_rng(21).integers(-8, 9, (20, 8)).astype(
        np.float32)
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4) + 100 * rank
    host = multihost._all_gather_host(x)
    device = multihost._all_gather_device(x)
    assert torch.equal(host, device), (host, device)
    idx = multihost.load_process_sharded(folder, mesh=Mesh(["cpu", "cpu"]),
                                         dense=True)
    assert not idx.device_merge
    d, i = idx.search(queries, 10)
    dd, di = idx.search_dense(queries, 10, max_check=128)
    idx.device_merge = True
    d2, i2 = idx.search(queries, 10)
    dd2, di2 = idx.search_dense(queries, 10, max_check=128)
    assert idx.last_all_gather_ms() >= 0
    np.savez(out, d=d, i=i, dd=dd, di=di, d2=d2, i2=i2, dd2=dd2, di2=di2,
             base=idx._shard_base)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_device_all_gather_merge_equals_the_gloo_merge(tmp_path):
    """Two processes over gloo each load 2 of a 4-shard mesh folder
    (load_process_sharded): the merge's device-side all-gather
    (all_gather_into_tensor, NCCL's path on the cards) gives the host
    all-gather's answer, and both the one-process mesh's."""
    folder = str(tmp_path / "mesh4")
    one = ts.ShardedBKTIndex.build(DATA, 0, mesh=ts.Mesh(["cpu"] * 4),
                                   params=PARAMS, dense=True,
                                   save_to=folder)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(port), folder,
         str(tmp_path / f"r{r}.npz"), repr(PARAMS)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    r0, r1 = (np.load(tmp_path / f"r{r}.npz") for r in range(2))
    assert (int(r0["base"]), int(r1["base"])) == (0, 2)
    d, i = one.search(QUERIES, 10)
    dd, di = one.search_dense(QUERIES, 10, max_check=128)
    for r in (r0, r1):
        for suffix in ("", "2"):
            np.testing.assert_array_equal(r["i" + suffix], i)
            assert r["d" + suffix].tobytes() == d.tobytes()
            np.testing.assert_array_equal(r["di" + suffix], di)
            assert r["dd" + suffix].tobytes() == dd.tobytes()
