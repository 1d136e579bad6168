"""Host-side parity of the PyTorch port, SPTAG-built fixtures, and the
port's import rules.

Parameter registries, INI text, the binary file formats, metadata files
and the snapshot manifest must be byte-identical to the JAX package's.
The SPTAG-built fixtures (tests/fixtures/ref_built_bkt_*.tar.gz) must load
in the port and dense-search like the JAX package (comparison rule of
tests/test_torch_dense.py).
"""

import io
import os
import re
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch

import sptag_tpu as jsp
import sptag_tpu_torch as tsp
from sptag_tpu.core import params as jparams
from sptag_tpu.io import atomic as jatomic
from sptag_tpu.io import format as jfmt
from sptag_tpu.utils.ini import IniReader as JIni
from sptag_tpu_torch.core import params as tparams
from sptag_tpu_torch.io import atomic as tatomic
from sptag_tpu_torch.io import format as tfmt
from sptag_tpu_torch.utils.ini import IniReader as TIni
from test_torch_dense import assert_same_neighbors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def _specs(cls):
    return [(s.attr, s.py_type.__name__, s.default, s.name)
            for s in cls.SPECS]


@pytest.mark.parametrize("name", ["BKTParams", "KDTParams", "FlatParams"])
def test_param_registries_match_jax(name):
    assert _specs(getattr(tparams, name)) == _specs(getattr(jparams, name))


@pytest.mark.parametrize("with_meta", [False, True])
def test_index_config_is_byte_identical(with_meta):
    settings = [("DistCalcMethod", "L2"), ("BuildGraph", "0"),
                ("MaxCheck", "2048"), ("DenseQueryGroup", "32"),
                ("ApproxRecallTarget", "0.95"), ("SearchMode", "dense"),
                ("FlightDumpOnSlowQuery", "/x/y")]
    ref = jsp.create_instance("BKT", "Int8")
    got = tsp.create_instance("BKT", "Int8", device="cpu")
    for k, v in settings:
        assert ref.set_parameter(k, v) and got.set_parameter(k, v)
        assert got.get_parameter(k) == ref.get_parameter(k)
    if with_meta:
        ref.metadata = jsp.MetadataSet([b"a"])
        got.metadata = tsp.MetadataSet([b"a"])
        ref._meta_to_vec = got._meta_to_vec = {}
    assert got.save_index_config() == ref.save_index_config()
    assert not got.set_parameter("NoSuchParameter", "1")


def test_ini_reader_matches_jax():
    text = ("; comment\n[Index]\nIndexAlgoType=BKT\nvaluetype = Float\n"
            "[MetaData]\nMetaDataToVectorIndex=true\nbroken line\n"
            "[index]\nMaxCheck=128\n")
    a, b = TIni.loads(text), JIni.loads(text)
    assert a.sections() == b.sections()
    for sec in b.sections():
        assert a.section_items(sec) == b.section_items(sec)
    assert a.dumps() == b.dumps()
    assert a.get_parameter("INDEX", "maxcheck") == "128"


MATRICES = {
    "f32": np.random.default_rng(0).standard_normal((7, 5)).astype(np.float32),
    "i8": np.arange(-20, 15, dtype=np.int8).reshape(7, 5),
    "u8": np.arange(35, dtype=np.uint8).reshape(7, 5),
    "i16": (np.arange(35, dtype=np.int16) * 900).reshape(7, 5),
}


def _both(writer_t, writer_j, *args):
    bt, bj = io.BytesIO(), io.BytesIO()
    writer_t(bt, *args)
    writer_j(bj, *args)
    assert bt.getvalue() == bj.getvalue()
    return bj.getvalue()


@pytest.mark.parametrize("kind", list(MATRICES))
def test_matrix_files_are_byte_identical(kind):
    m = MATRICES[kind]
    raw = _both(tfmt.write_matrix, jfmt.write_matrix, m)
    np.testing.assert_array_equal(tfmt.read_matrix(io.BytesIO(raw), m.dtype), m)


def test_graph_deletes_and_tree_files_are_byte_identical():
    g = np.random.default_rng(1).integers(-1, 50, (9, 4)).astype(np.int32)
    raw = _both(tfmt.write_graph, jfmt.write_graph, g)
    np.testing.assert_array_equal(tfmt.read_graph(io.BytesIO(raw)), g)
    mask = np.zeros(11, bool)
    mask[[2, 7]] = True
    raw = _both(tfmt.write_deletes, jfmt.write_deletes, mask)
    np.testing.assert_array_equal(tfmt.read_deletes(io.BytesIO(raw)), mask)
    nodes = np.zeros(4, tfmt.BKT_NODE_DTYPE)
    nodes["centerid"] = [3, 0, 2, -1]
    nodes["childStart"] = [1, -1, -1, -1]
    nodes["childEnd"] = [3, -1, -1, -1]
    starts = np.asarray([0], np.int32)
    raw = _both(tfmt.write_tree_forest, jfmt.write_tree_forest, starts,
                nodes)
    s, n = tfmt.read_tree_forest(io.BytesIO(raw), tfmt.BKT_NODE_DTYPE)
    np.testing.assert_array_equal(s, starts)
    np.testing.assert_array_equal(n, nodes)


def test_metadata_files_interchange():
    metas = [b"alpha", b"", "été".encode(), b"x" * 300]
    bt, it, bj, ij = (io.BytesIO() for _ in range(4))
    tsp.MetadataSet(metas).save(bt, it)
    jsp.MetadataSet(metas).save(bj, ij)
    assert (bt.getvalue(), it.getvalue()) == (bj.getvalue(), ij.getvalue())
    back = tsp.MetadataSet.load(io.BytesIO(bj.getvalue()),
                                io.BytesIO(ij.getvalue()))
    assert [back.get_metadata(i) for i in range(back.count)] == metas
    assert back.get_metadata(99) == b""


def test_manifest_interchange_and_corruption(tmp_path):
    folder = str(tmp_path)
    for name, payload in [("a.bin", b"123"), ("b.bin", b"x" * 5000),
                          ("indexloader.ini", b"[Index]\n")]:
        with open(os.path.join(folder, name), "wb") as f:
            f.write(payload)
    tatomic.write_manifest(folder, exclude=("indexloader.ini",))
    mine = open(os.path.join(folder, "manifest.json"), "rb").read()
    jatomic.write_manifest(folder, exclude=("indexloader.ini",))
    assert open(os.path.join(folder, "manifest.json"), "rb").read() == mine
    assert tatomic.verify_manifest(folder) == 2
    with open(os.path.join(folder, "b.bin"), "r+b") as f:
        f.write(b"y")
    with pytest.raises(tatomic.ManifestError):
        tatomic.verify_manifest(folder)
    assert tatomic.verify_manifest(str(tmp_path / "nowhere")) is None


@pytest.mark.parametrize("fixture,value_type", [
    ("ref_built_bkt_2000x16", np.float32),
    ("ref_built_bkt_int8cos_2000x16", np.int8),
    ("ref_built_bkt_uint8cos_2000x16", np.uint8),
    ("ref_built_bkt_int16_2000x16", np.int16),
])
def test_sptag_built_fixture_dense_search_matches_jax(tmp_path, fixture,
                                                      value_type):
    """Folders written by SPTAG's own C++ tools (real graph.bin, no
    SearchMode in the ini: dense by default) load in both packages and
    give the same neighbours.  Integer corpora score exact integer
    distances in both, so those compare exactly."""
    with tarfile.open(os.path.join(FIXTURES, fixture + ".tar.gz")) as tf:
        tf.extractall(str(tmp_path), filter="data")
    folder = str(tmp_path / "fix_index")
    data = np.load(str(tmp_path / "fix_data.npy"))
    rng = np.random.default_rng(0)
    q = data[rng.choice(len(data), 64, replace=False)].astype(np.float64)
    if value_type == np.float32:
        q = q + rng.standard_normal(q.shape) * 0.3
    q = q.astype(value_type)
    ref = jsp.load_index(folder)
    got = tsp.load_index(folder, device="cpu")
    assert got.num_samples == ref.num_samples == len(data)
    for max_check in (256, 1024):
        d_ref, i_ref = ref.search_batch(q, 10, max_check=max_check)
        d_got, i_got = got.search_batch(q, 10, max_check=max_check)
        assert_same_neighbors(d_ref, i_ref, d_got, i_got,
                              exact=value_type != np.float32)
    # the beam walk over SPTAG's own graph: integer corpora exactly, the
    # float corpus by id overlap (near ties may steer the walks apart)
    d_ref, i_ref = ref.search_batch(q, 10, search_mode="beam")
    d_got, i_got = got.search_batch(q, 10, search_mode="beam")
    if value_type == np.float32:
        overlap = np.mean([len(set(a) & set(b)) / 10
                           for a, b in zip(i_got, i_ref)])
        assert overlap >= 0.99
    else:
        np.testing.assert_array_equal(i_got, i_ref)
        np.testing.assert_array_equal(d_got, d_ref)
    resave = str(tmp_path / "resaved")
    got.save_index(resave)
    for name in ("vectors.bin", "tree.bin", "graph.bin", "deletes.bin"):
        assert open(os.path.join(resave, name), "rb").read() == \
            open(os.path.join(folder, name), "rb").read(), name


# ---- the port's rules ------------------------------------------------------

def test_import_pulls_in_no_jax_and_no_sptag_tpu():
    code = ("import sys, sptag_tpu_torch, sptag_tpu_torch.state, "
            "sptag_tpu_torch.ops.block_dots, sptag_tpu_torch._build, "
            "sptag_tpu_torch.algo.engine, sptag_tpu_torch.algo.flat, "
            "sptag_tpu_torch.graph.rng, sptag_tpu_torch.graph.tptree, "
            "sptag_tpu_torch.ops.graph, sptag_tpu_torch.ops.topk_bins, "
            "sptag_tpu_torch.algo.kdt, sptag_tpu_torch.trees.kdtree, "
            "sptag_tpu_torch.core.delta, sptag_tpu_torch.io.wal, "
            "sptag_tpu_torch.utils.threadpool, "
            "sptag_tpu_torch.algo.scheduler, sptag_tpu_torch.io.reader, "
            "sptag_tpu_torch.native, sptag_tpu_torch.serve.server, "
            "sptag_tpu_torch.serve.service, sptag_tpu_torch.serve.client, "
            "sptag_tpu_torch.serve.wire, sptag_tpu_torch.serve.protocol, "
            "sptag_tpu_torch.utils.metrics, sptag_tpu_torch.utils.locksan, "
            "sptag_tpu_torch.utils.flightrec, "
            "sptag_tpu_torch.utils.faultinject, "
            "sptag_tpu_torch.utils.timeline, sptag_tpu_torch.utils.hostprof, "
            "sptag_tpu_torch.utils.trace, sptag_tpu_torch.utils.qualmon, "
            "sptag_tpu_torch.ops.walk_dots\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('jaxlib') "
            "or m == 'sptag_tpu' or m.startswith('sptag_tpu.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_import_no_jax_and_no_sptag_tpu():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|"
        r"from\s+jaxlib\b|import\s+sptag_tpu(\.|\s|$)|"
        r"from\s+sptag_tpu(\.|\s))", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "sptag_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    names = {os.path.relpath(f, REPO) for f in files}
    for new in ("algo/engine.py", "algo/flat.py", "graph/rng.py",
                "graph/tptree.py", "ops/graph.py", "ops/topk_bins.py",
                "algo/kdt.py", "trees/kdtree.py", "core/delta.py",
                "io/wal.py", "utils/threadpool.py", "algo/scheduler.py",
                "io/reader.py", "native.py", "serve/wire.py",
                "serve/protocol.py", "serve/service.py", "serve/server.py",
                "serve/client.py", "utils/metrics.py", "utils/locksan.py",
                "utils/flightrec.py", "utils/faultinject.py",
                "utils/timeline.py", "utils/hostprof.py", "utils/trace.py",
                "utils/qualmon.py", "ops/walk_dots.py", "utils/devmem.py",
                "utils/build_ckpt.py", "serve/ctlaudit.py",
                "serve/admission.py", "serve/slo.py", "serve/canary.py",
                "serve/controller.py", "serve/metrics_http.py",
                "serve/aggregator.py", "wrappers.py",
                "tools/index_builder.py", "tools/index_searcher.py",
                "tools/flight.py", "tools/timeline.py"):
        assert os.path.join("sptag_tpu_torch", new) in names
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert offenders == []


def test_no_device_means_the_card_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsp.create_instance("BKT", "Float")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsp.load_index(os.path.join(FIXTURES, "does-not-matter"))
    assert tsp.create_instance("BKT", "Float", device="cpu").device.type \
        == "cpu"


@pytest.mark.parametrize("make", ["searcher", "from_layout", "build_layout",
                                  "tree_build"])
def test_searcher_and_tree_without_device_need_the_card(monkeypatch, make):
    """The lower-level constructors follow the same policy: no device
    means the card, and without CUDA they raise."""
    from sptag_tpu_torch.algo.dense import DenseTreeSearcher
    from sptag_tpu_torch.core.types import DistCalcMethod
    from sptag_tpu_torch.trees.bktree import BKTree

    data = np.random.default_rng(0).standard_normal((64, 8)) \
        .astype(np.float32)
    clusters = [np.arange(0, 32), np.arange(32, 64)]
    lay = DenseTreeSearcher.build_layout(data, clusters, DistCalcMethod.L2,
                                         device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "searcher": lambda: DenseTreeSearcher(data, clusters, None,
                                              DistCalcMethod.L2, 1),
        "from_layout": lambda: DenseTreeSearcher.from_layout(
            lay, None, DistCalcMethod.L2, 1),
        "build_layout": lambda: DenseTreeSearcher.build_layout(
            data, clusters, DistCalcMethod.L2),
        "tree_build": lambda: BKTree(kmeans_k=4).build(data),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[make]()


def test_float32_matmul_stays_full_precision():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
