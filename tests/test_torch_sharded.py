"""The port's mesh indexes (sptag_tpu_torch/parallel/sharded.py and
mesh_engine.py) against the JAX package's (sptag_tpu/parallel/).

The JAX package builds and saves mesh folders on integer-valued rows over
its 8 virtual CPU devices at 2, 4 and 8 shards; the port loads each on an
explicit CPU mesh (one device repeated).  On integer rows every distance
is an exact float32 integer, so the port returns the JAX package's ids and
distances exactly: FLAT, the beam walk (monolithic and through the mesh
scheduler), the dense scan (the port scores through probe_block_dots, the
JAX mesh through a gathered einsum: the same function), KDT shards, the
proportional budget policy and MeshKLocal.

It also answers whether the JAX mesh's beam ids equal the merge of its
own shards searched one by one as single indexes (`search_batch`, beam):
they do when every shard has the same pivot count, as here.  A shard with
fewer pivots than the mesh's widest pads its list, and a padded pivot
scores row 0 and takes a beam slot, so a mesh can differ from its shards
searched alone (``test_padded_pivots_are_the_jax_mesh_rule`` holds the
port to that rule).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import sptag_tpu as jsp
import sptag_tpu_torch as tsp
from sptag_tpu.core.types import DistCalcMethod as JMetric
from sptag_tpu.parallel import sharded as js
from sptag_tpu_torch.parallel import sharded as ts

D = 8
PARAMS = {"TPTNumber": 2, "CEF": 32, "MaxCheckForRefineGraph": 64,
          "NeighborhoodSize": 16, "FinalRefineSearchMode": "same",
          "MaxCheck": 256, "BKTKmeansK": 8, "TPTLeafSize": 64,
          "RefineIterations": 1}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 9, (n, D)).astype(np.float32)


DATA = _rows(600, 0)
QUERIES = _rows(24, 1)


def _cpu_mesh(n):
    return ts.Mesh(["cpu"] * n)


@pytest.fixture(scope="module", params=[2, 4, 8])
def built(request, tmp_path_factory):
    """A JAX-built mesh folder (dense packed) and both packages' loads."""
    n = request.param
    folder = str(tmp_path_factory.mktemp(f"mesh{n}"))
    jm = js.make_mesh(jax.devices()[:n])
    js.ShardedBKTIndex.build(DATA, JMetric.L2, mesh=jm, params=PARAMS,
                             save_to=folder)
    j = js.ShardedBKTIndex.load(folder, mesh=jm, dense=True)
    t = ts.ShardedBKTIndex.load(folder, mesh=_cpu_mesh(n), dense=True)
    return n, folder, jm, j, t


def test_beam_monolithic_and_scheduled_equal_jax(built):
    n, _, _, j, t = built
    jd, ji = j.search(QUERIES, 10)
    td, ti = t.search(QUERIES, 10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    t.enable_continuous_batching(slots=8, segment_iters=2)
    try:
        futs = t.submit_batch(QUERIES, 10)
        sd = np.stack([f.result(timeout=60)[0] for f in futs])
        si = np.stack([f.result(timeout=60)[1] for f in futs])
        np.testing.assert_array_equal(si, ji)
        np.testing.assert_array_equal(sd, jd)
        stats = t._scheduler.stats()
        assert stats["live"] == 0 and stats["retired"] == len(QUERIES)
    finally:
        t.retire_scheduler()
    # the JAX mesh scheduler agrees with its own monolithic walk too
    j.enable_continuous_batching(slots=8, segment_iters=2)
    try:
        futs = j.submit_batch(QUERIES, 10)
        np.testing.assert_array_equal(
            np.stack([f.result(timeout=120)[1] for f in futs]), ji)
    finally:
        j.retire_scheduler()


def test_dense_equals_jax(built):
    n, _, _, j, t = built
    for mc in (64, 256):
        jd, ji = j.search_dense(QUERIES, 10, max_check=mc)
        td, ti = t.search_dense(QUERIES, 10, max_check=mc)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-4)


def test_flat_equals_jax(built):
    n, _, jm, _, _ = built
    deleted = np.zeros(len(DATA), bool)
    deleted[::7] = True
    for metric, base in ((JMetric.L2, 1), (JMetric.Cosine, 1)):
        fj = js.ShardedFlatIndex(DATA, metric, base, mesh=jm,
                                 deleted=deleted)
        ft = ts.ShardedFlatIndex(DATA, int(metric), base,
                                 mesh=_cpu_mesh(n), deleted=deleted)
        jd, ji = fj.search(QUERIES, 10)
        td, ti = ft.search(QUERIES, 10)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-4)


def test_budget_policy_and_mesh_k_local_equal_jax(built):
    n, _, _, j, t = built
    for policy in ("proportional", "guarded"):
        jd, ji = j.search(QUERIES, 10, budget_policy=policy)
        td, ti = t.search(QUERIES, 10, budget_policy=policy)
        np.testing.assert_array_equal(ti, ji)
        jd, ji = j.search_dense(QUERIES, 10, budget_policy=policy)
        td, ti = t.search_dense(QUERIES, 10, budget_policy=policy)
        np.testing.assert_array_equal(ti, ji)
    for obj in (j, t):
        obj.params.mesh_k_local = 3
    try:
        jd, ji = j.search(QUERIES, 10)
        td, ti = t.search(QUERIES, 10)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
        assert (ti[:, min(10, 3 * n):] == -1).all()
    finally:
        for obj in (j, t):
            obj.params.mesh_k_local = 0


def test_jax_mesh_equals_its_shards_searched_alone(built):
    """The question phase 15c of chip_smoke.py rests on: the JAX mesh's
    beam ids against the merge of each shard folder's own beam search
    (single index, search_batch at k_local), and the port's likewise."""
    n, folder, _, j, t = built
    k = 10
    jd, ji = j.search(QUERIES, k)
    parts_d, parts_i = [], []
    n_local = -(-len(DATA) // n)
    for s in range(n):
        sub = jsp.load_index(os.path.join(folder, f"shard_{s:03d}"))
        sub.set_parameter("SearchMode", "beam")
        d, ids = sub.search_batch(QUERIES, min(k, n_local))
        parts_d.append(d)
        parts_i.append(np.where(ids >= 0, ids + s * n_local, -1))
    all_d = np.concatenate(parts_d, 1)
    all_i = np.concatenate(parts_i, 1)
    order = np.argsort(all_d, axis=1, kind="stable")[:, :k]
    merged = np.take_along_axis(all_i, order, 1)
    pivots = {len(np.asarray(
        jsp.load_index(os.path.join(folder, f"shard_{s:03d}"))._pivot_ids()))
        for s in range(n)}
    assert len(pivots) == 1          # equal shards, equal pivot counts
    np.testing.assert_array_equal(ji, merged)
    np.testing.assert_array_equal(t.search(QUERIES, k)[1], merged)


def test_padded_pivots_are_the_jax_mesh_rule(tmp_path, monkeypatch):
    """A shard with fewer pivots than the mesh's widest pads its list with
    -1 pivots that score row 0 (pack_shard_block): the port walks the JAX
    mesh's padded seeding, so the ids stay equal."""
    from sptag_tpu.algo import bkt as jbkt
    from sptag_tpu_torch.algo import bkt as tbkt

    folder = str(tmp_path / "pad")
    jm = js.make_mesh(jax.devices()[:2])
    js.ShardedBKTIndex.build(DATA, JMetric.L2, mesh=jm, params=PARAMS,
                             save_to=folder)
    for cls in (jbkt.BKTIndex, tbkt.BKTIndex):
        orig = cls._pivot_ids

        def fewer(self, *a, _orig=orig, **kw):
            got = np.asarray(_orig(self, *a, **kw))
            # the second shard keeps 5 pivots only
            return got[:5] if np.array_equal(self._host[0], DATA[300]) \
                else got
        monkeypatch.setattr(cls, "_pivot_ids", fewer)
    j = js.ShardedBKTIndex.load(folder, mesh=jm)
    t = ts.ShardedBKTIndex.load(folder, mesh=_cpu_mesh(2))
    pids = [e.pivot_ids.numpy() for e in t.engines]
    assert pids[0].shape == pids[1].shape and (pids[1][5:] == -1).all()
    assert (pids[0] >= 0).all()
    jd, ji = j.search(QUERIES, 10)
    td, ti = t.search(QUERIES, 10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


def test_kdt_shards_equal_jax(tmp_path):
    folder = str(tmp_path / "kdt")
    jm = js.make_mesh(jax.devices()[:2])
    params = dict(PARAMS, KDTNumber=1)
    params.pop("BKTKmeansK")
    js.ShardedBKTIndex.build(DATA, JMetric.L2, mesh=jm, params=params,
                             save_to=folder, algo="KDT")
    j = js.ShardedBKTIndex.load(folder, mesh=jm, dense=True)
    t = ts.ShardedBKTIndex.load(folder, mesh=_cpu_mesh(2), dense=True)
    jd, ji = j.search(QUERIES, 10)
    td, ti = t.search(QUERIES, 10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    jd, ji = j.search_dense(QUERIES, 10)
    td, ti = t.search_dense(QUERIES, 10)
    np.testing.assert_array_equal(ti, ji)


def test_port_built_mesh_loads_in_jax(tmp_path):
    """A mesh the port builds and saves (shard_NNN + sharded.json) loads
    in the JAX package with the same ids."""
    folder = str(tmp_path / "port_mesh")
    t = ts.ShardedBKTIndex.build(DATA, 0, mesh=_cpu_mesh(2), params=PARAMS,
                                 save_to=folder, dense=True)
    with open(os.path.join(folder, "sharded.json")) as f:
        meta = json.load(f)
    assert meta == {"n_shards": 2, "n": 600, "dim": D, "metric": 0,
                    "empty_shards": []}
    j = js.ShardedBKTIndex.load(folder, mesh=js.make_mesh(jax.devices()[:2]))
    np.testing.assert_array_equal(t.search(QUERIES, 10)[1],
                                  j.search(QUERIES, 10)[1])
    with pytest.raises(NotImplementedError, match="save happens at build"):
        t.save(folder)


def test_default_mesh_needs_the_card_and_an_explicit_mesh_must_fit(
        built, monkeypatch):
    n, folder, *_ = built
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="exposes only 1 devices"):
        ts.ShardedBKTIndex.load(folder)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.ShardedBKTIndex.load(folder)
    with pytest.raises(ValueError, match="mesh has"):
        ts.ShardedBKTIndex.load(folder, mesh=_cpu_mesh(n + 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsp.load_index(folder)
    adapter = tsp.load_index(folder, device="cpu")
    assert isinstance(adapter, ts.ServingAdapter)
    assert adapter.num_samples == len(DATA) and adapter.feature_dim == D
    res = adapter.search(DATA[5], 3)
    assert res.ids[0] == 5 and res.dists[0] == 0.0


def test_cascade_shadow_equals_jax(tmp_path):
    """CascadeSearch on a float mesh: every shard walks the int8
    quantization of the whole mesh corpus (one scale) and re-ranks in
    float32, in both packages alike."""
    folder = str(tmp_path / "cascade")
    jm = js.make_mesh(jax.devices()[:2])
    js.ShardedBKTIndex.build(DATA, JMetric.L2, mesh=jm,
                             params=dict(PARAMS, CascadeSearch=1),
                             save_to=folder)
    j = js.ShardedBKTIndex.load(folder, mesh=jm)
    t = ts.ShardedBKTIndex.load(folder, mesh=_cpu_mesh(2))
    assert j.data_score is not None and t.score_scale == j.score_scale > 0
    assert all(e.data_score is not None and e.rerank for e in t.engines)
    jd, ji = j.search(QUERIES, 10)
    td, ti = t.search(QUERIES, 10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    t.enable_continuous_batching(slots=8, segment_iters=2)
    try:
        futs = t.submit_batch(QUERIES, 10)
        np.testing.assert_array_equal(
            np.stack([f.result(timeout=60)[1] for f in futs]), ji)
    finally:
        t.retire_scheduler()


def test_pad_layout_equals_jax():
    """DenseTreeSearcher.pad_layout pads a layout to the mesh's (C, P) as
    the JAX package's does."""
    from sptag_tpu.algo.dense import DenseTreeSearcher as JDense
    from sptag_tpu_torch.algo.dense import DenseTreeSearcher as TDense

    rng = np.random.default_rng(9)
    clusters = np.array_split(rng.permutation(len(DATA)), 7)
    jl = JDense.build_layout(DATA, clusters, JMetric.L2)
    tl = TDense.build_layout(DATA, clusters, 0, device="cpu")
    C, P = jl["perm"].shape[0] + 3, jl["perm"].shape[1] + 16
    jp = JDense.pad_layout(jl, C, P, D)
    tp = TDense.pad_layout(tl, C, P, D)
    assert set(jp) == set(tp)
    for name in jp:
        np.testing.assert_array_equal(tp[name], np.asarray(jp[name]), name)
        assert tp[name].dtype == np.asarray(jp[name]).dtype, name
