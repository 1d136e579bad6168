"""In-mesh sharded serving of the port: ``[Service] MeshServe=1`` over a
mesh folder (sptag_tpu_torch/parallel/sharded.py ServingAdapter, the mesh
scheduler of parallel/mesh_engine.py), against the JAX package's mesh.

A JAX-built 2-shard mesh folder (integer-valued rows: exact distances)
loads in the port on a CPU mesh through ``load_index``; a port server with
MeshServe armed streams every query through the mesh scheduler and answers
with the ids and distances of the JAX mesh's search_batch; the scheduler
publishes the shard-skew telemetry, and a placement swap bumps the epoch.
"""

import numpy as np
import pytest
import torch

import jax
import sptag_tpu_torch as tsp
from conftest import ServerThread
from sptag_tpu.core.types import DistCalcMethod as JMetric
from sptag_tpu.parallel import sharded as js
from sptag_tpu_torch.algo import scheduler as tsched
from sptag_tpu_torch.parallel import sharded as ts
from sptag_tpu_torch.serve import server as tserver
from sptag_tpu_torch.serve import service as tservice
from sptag_tpu_torch.serve.client import AnnClient
from sptag_tpu_torch.utils import flightrec
from sptag_tpu_torch.utils import metrics as tmetrics

D = 8
PARAMS = {"TPTNumber": 2, "CEF": 32, "MaxCheckForRefineGraph": 64,
          "NeighborhoodSize": 16, "FinalRefineSearchMode": "same",
          "MaxCheck": 256, "BKTKmeansK": 8, "SearchMode": "beam"}
DATA = np.random.default_rng(5).integers(-8, 9, (500, D)).astype(np.float32)
QUERIES = np.random.default_rng(6).integers(-8, 9, (16, D)).astype(
    np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh_folder(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("mesh"))
    js.ShardedBKTIndex.build(DATA, JMetric.L2,
                             mesh=js.make_mesh(jax.devices()[:2]),
                             params=PARAMS, save_to=folder)
    return folder


def _jax_answers(folder, k):
    from sptag_tpu.core.index import load_index

    adapter = load_index(folder)            # the JAX default mesh
    return adapter.search_batch(QUERIES, k)


def test_mesh_serve_server_answers_as_the_jax_mesh(mesh_folder, tmp_path):
    k = 5
    jd, ji = _jax_answers(mesh_folder, k)
    ini = tmp_path / "svc.ini"
    ini.write_text("[Service]\nListenPort=0\nMeshServe=1\n"
                   "MeshServeSlots=8\nMeshServeSegmentIters=2\n"
                   "DefaultMaxResultNumber=5\n[Index]\nList=main\n"
                   f"[Index_main]\nIndexFolder={mesh_folder}\n")
    ctx = tservice.ServiceContext.from_ini(str(ini), device="cpu")
    adapter = ctx.indexes["main"]
    assert isinstance(adapter, ts.ServingAdapter)
    before = tmetrics.counter_value("server.mesh_serve_indexes")
    t = ServerThread(tserver.SearchServer(ctx, batch_window_ms=1.0))
    t.start()
    try:
        host, port = t.wait_ready(30)
        assert tmetrics.counter_value("server.mesh_serve_indexes") \
            == before + 1
        state = adapter.mutation_state()
        assert state["mesh"] == {"shards": 2, "rows": len(DATA),
                                 "mesh_serve": True, "scheduler": True}
        cli = AnnClient(host, port, timeout_s=60.0)
        cli.connect()
        try:
            for i, q in enumerate(QUERIES):
                res = cli.search(f"$resultnum:{k} "
                                 + "|".join(str(int(v)) for v in q))
                r = res.results[0]
                np.testing.assert_array_equal(np.asarray(r.ids), ji[i])
                np.testing.assert_array_equal(
                    np.asarray(r.dists, np.float32), jd[i])
        finally:
            cli.close()
        stats = adapter._impl._scheduler.stats()
        assert stats["retired"] >= len(QUERIES) and stats["live"] == 0
        assert tmetrics.gauge_value("scheduler.mesh_shards") == 2
        fams = tsched._shard_iter_families()
        assert fams and {s[0]["shard"] for s in fams[0].samples} == \
            {"0", "1"}
    finally:
        t.stop()
        adapter._impl.retire_scheduler()


def test_submit_batch_streams_and_stats_carry_shard_skew(mesh_folder):
    k = 5
    jd, ji = _jax_answers(mesh_folder, k)
    adapter = tsp.load_index(mesh_folder, device="cpu")
    assert adapter.enable_mesh_serve(slots=8, segment_iters=2)
    flightrec.reset()
    try:
        futs = adapter.submit_batch(QUERIES, k,
                                    rids=[f"m{i}" for i in range(16)])
        got = [f.result(timeout=60) for f in futs]
        np.testing.assert_array_equal(np.stack([g[1] for g in got]), ji)
        np.testing.assert_array_equal(np.stack([g[0] for g in got]), jd)
        for i in range(16):
            st = flightrec.query_stats(f"m{i}")
            assert st["shard_imbalance"] >= 1.0
            assert st["slow_shard"] in (0, 1) and st["gflops"] >= 0
        # dense and synchronous requests still answer through the adapter
        d, ids = adapter.search_batch(QUERIES, k)
        np.testing.assert_array_equal(ids, ji)
    finally:
        adapter._impl.retire_scheduler()
    tsched.reset_shard_skew()
    assert tsched._shard_iter_families() == []


def test_swap_publishes_a_new_placement(mesh_folder):
    adapter = tsp.load_index(mesh_folder, device="cpu")
    adapter.enable_mesh_serve(slots=8, segment_iters=2)
    old = adapter._impl
    new = ts.ShardedBKTIndex.load(mesh_folder, mesh=ts.Mesh(["cpu", "cpu"]))
    try:
        assert adapter.swap_impl(new) == 1
        assert old._scheduler is None and new._scheduler is not None
        st = adapter.mutation_state()
        assert (st["epoch"], st["swap_count"]) == (1, 1)
        futs = adapter.submit_batch(QUERIES[:4], 3)
        assert all(f.result(timeout=60)[1][0] >= 0 for f in futs)
    finally:
        new.retire_scheduler()
    with pytest.raises(ValueError, match="unknown serving mode"):
        ts.ServingAdapter(new, D, mode="nope")
    with pytest.raises(RuntimeError, match="dense layout not packed"):
        ts.ServingAdapter(new, D, mode="dense")
