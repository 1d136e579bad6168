"""The port's CLIs and wrappers against the JAX package's.

`tools/index_builder` and `tools/index_searcher` run with ``--device cpu``
(no device flag means the CUDA card, an error here): the searcher on one
JAX-built folder prints the JAX CLI's recall and writes the same result
ids, and the builder writes a FLAT folder byte for byte the JAX CLI's.
The flight-dump merge and the timeline CLI render the same inputs alike.
`AnnIndex` builds and searches like the JAX wrapper on integer-valued
rows, and `AnnClient` sends the bytes the JAX client sends, in
tests/test_wrapper_bytes.py's layout.
"""

import base64
import contextlib
import io
import json
import os
import socket
import struct
import threading

import numpy as np
import pytest
import torch

import sptag_tpu as jsp
import sptag_tpu_torch as tsp
from sptag_tpu import wrappers as jwrappers
from sptag_tpu.serve import wire as jwire
from sptag_tpu.tools import flight as jflight
from sptag_tpu.tools import index_builder as jbuilder
from sptag_tpu.tools import index_searcher as jsearcher
from sptag_tpu.tools import timeline as jtimeline_cli
from sptag_tpu.utils import flightrec as jflightrec
from sptag_tpu.utils import timeline as jtimeline
from sptag_tpu_torch import wrappers as twrappers
from sptag_tpu_torch.serve import wire as twire
from sptag_tpu_torch.tools import flight as tflight
from sptag_tpu_torch.tools import index_builder as tbuilder
from sptag_tpu_torch.tools import index_searcher as tsearcher
from sptag_tpu_torch.tools import timeline as ttimeline_cli
from sptag_tpu_torch.utils import flightrec as tflightrec

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "wrapper_lifecycle.bytes")
N, D = 400, 12
BUILD_ARGS = ["Index.DistCalcMethod=L2", "Index.BKTKmeansK=8",
              "Index.TPTNumber=4", "Index.TPTLeafSize=64",
              "Index.NeighborhoodSize=16", "Index.CEF=64",
              "Index.MaxCheckForRefineGraph=128", "Index.RefineIterations=1",
              "Index.Samples=100", "Index.DenseClusterSize=64",
              "Index.FinalRefineSearchMode=same"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(n=N, seed=1):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, D)) * 4
    return np.round((centers[rng.integers(0, 8, n)]
                     + rng.standard_normal((n, D))) * 2).astype(np.float32)


def _write_tsv(path, data, metas):
    with open(path, "wb") as f:
        for row, meta in zip(data, metas):
            f.write(meta + b"\t" + "|".join(repr(float(x)) for x in row)
                    .encode() + b"\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A TSV corpus, a query file, an exact truth file and a BKT folder
    built by the JAX CLI."""
    root = tmp_path_factory.mktemp("cli")
    data = _rows()
    tsv = str(root / "corpus.tsv")
    _write_tsv(tsv, data, [f"m{i}".encode() for i in range(N)])
    qs = data[:40]
    qtsv = str(root / "queries.tsv")
    _write_tsv(qtsv, qs, [b""] * len(qs))
    d = ((qs[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    truth = str(root / "truth.txt")
    with open(truth, "w") as f:
        for row in np.argsort(d, axis=1, kind="stable")[:, :5]:
            f.write(" ".join(str(int(v)) for v in row) + "\n")
    folder = str(root / "bkt")
    assert jbuilder.main(["-d", str(D), "-v", "Float", "-i", tsv, "-o",
                          folder, "-a", "BKT", "-t", "2"] + BUILD_ARGS) == 0
    return {"root": root, "data": data, "tsv": tsv, "queries": qtsv,
            "truth": truth, "folder": folder}


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _sweep_rows(text):
    """(maxcheck, recall) of each row the searcher prints."""
    rows = []
    for line in text.splitlines():
        parts = line.split()
        if parts and parts[0].isdigit():
            rows.append((int(parts[0]), parts[4]))
    return rows


@pytest.mark.parametrize("mode", ["beam", "dense"])
def test_searcher_cli_equals_jax_on_one_folder(corpus, tmp_path, mode):
    outs = {}
    for name, main, extra in (("jax", jsearcher.main, []),
                              ("port", tsearcher.main,
                               ["--device", "cpu"])):
        res = str(tmp_path / f"{name}.txt")
        rc, text = _run(main, [
            "-x", corpus["folder"], "-q", corpus["queries"], "-r",
            corpus["truth"], "-k", "5", "-m", "128,256", "-b", "16", "-o",
            res, f"Index.SearchMode={mode}"] + extra)
        assert rc == 0
        with open(res) as f:
            outs[name] = (_sweep_rows(text), f.read())
    assert outs["port"] == outs["jax"]
    rows, ids = outs["port"]
    assert [mc for mc, _ in rows] == [128, 256]
    assert float(rows[-1][1]) > 0.8
    assert int(ids.splitlines()[0].split()[0]) == 0        # self-query


def test_builder_cli_writes_the_jax_flat_folder(corpus, tmp_path):
    """FLAT has no random structure, so the two CLIs write the same
    folder byte for byte."""
    folders = {}
    for name, main, extra in (("jax", jbuilder.main, []),
                              ("port", tbuilder.main, ["--device", "cpu"])):
        folders[name] = str(tmp_path / name)
        assert main(["-d", str(D), "-v", "Float", "-i", corpus["tsv"], "-o",
                     folders[name], "-a", "FLAT",
                     "Index.DistCalcMethod=L2"] + extra) == 0
    names = sorted(os.listdir(folders["jax"]))
    assert sorted(os.listdir(folders["port"])) == names
    for n in names:
        with open(os.path.join(folders["jax"], n), "rb") as a, \
                open(os.path.join(folders["port"], n), "rb") as b:
            assert a.read() == b.read(), n


def test_builder_cli_builds_a_graph_index_with_the_jax_options(
        corpus, tmp_path, caplog):
    """The port's builder takes the JAX CLI's flags and passthrough
    arguments, reports its device, and its folder loads and searches in
    both packages; --trace-report and --flight-dump write what the JAX
    CLI writes."""
    import logging

    folder = str(tmp_path / "bkt")
    flight = str(tmp_path / "flight.json")
    with caplog.at_level(logging.INFO):
        rc, text = _run(tbuilder.main, [
            "-d", str(D), "-v", "Float", "-i", corpus["tsv"], "-o", folder,
            "-a", "BKT", "-t", "2", "--device", "cpu", "--trace-report",
            "--flight-dump", flight] + BUILD_ARGS)
    assert rc == 0
    assert "device=cpu" in caplog.text
    assert isinstance(json.loads(text), dict)            # the span report
    with open(flight) as f:
        assert json.load(f)["otherData"]["tool"] == "index_builder"
    data = corpus["data"]
    for idx in (jsp.load_index(folder), tsp.load_index(folder,
                                                       device="cpu")):
        _, ids = idx.search_batch(data[:8], 3)
        assert (ids[:, 0] == np.arange(8)).all()
        assert idx.metadata.get_metadata(5) == b"m5"


@pytest.mark.parametrize("cli", ["builder", "searcher"])
def test_clis_without_a_device_need_the_card(corpus, tmp_path, monkeypatch,
                                             cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if cli == "builder":
        argv = ["-d", str(D), "-v", "Float", "-i", corpus["tsv"], "-o",
                str(tmp_path / "x"), "-a", "FLAT"]
        main = tbuilder.main
    else:
        argv = ["-x", corpus["folder"], "-q", corpus["queries"]]
        main = tsearcher.main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)


def test_flight_and_timeline_clis_render_alike(tmp_path):
    """The same dumps merge into the same trace, and the same timeline
    snapshot renders the same lines, through either package's CLI."""
    dumps = []
    for i, rec in enumerate((jflightrec, tflightrec)):
        rec.configure(enabled=True)
        rec.record("server", "decode", f"rid-{i}", dur_ns=1000)
        rec.record("server", "execute", f"rid-{i}", dur_ns=5000,
                   payload={"batch": 1})
        path = str(tmp_path / f"dump{i}.json")
        rec.write_trace(path, other_data={"tool": "test"})
        rec.configure(enabled=False)
        dumps.append(path)
    merged = []
    for main in (jflight.main, tflight.main):
        rc, text = _run(main, dumps)
        assert rc == 0
        merged.append(json.loads(text))
    assert merged[1] == merged[0]
    jtimeline.configure(enabled=True, capacity=64)
    for t in range(20):
        jtimeline.record("server.qps", float(t % 7), now=float(t))
    snap = str(tmp_path / "timeline.json")
    with open(snap, "w") as f:
        json.dump(jtimeline.snapshot(), f)
    outs = [_run(m, [snap, "--width", "20"]) for m in
            (jtimeline_cli.main, ttimeline_cli.main)]
    assert outs[1] == outs[0] and "server.qps" in outs[1][1]


# ---- the wrappers ---------------------------------------------------------

def _small_params(idx):
    for name, value in [("DistCalcMethod", "L2"), ("BKTKmeansK", "8"),
                        ("TPTNumber", "4"), ("TPTLeafSize", "64"),
                        ("NeighborhoodSize", "16"), ("CEF", "64"),
                        ("AddCEF", "32"), ("MaxCheckForRefineGraph", "128"),
                        ("MaxCheck", "512"), ("RefineIterations", "1"),
                        ("Samples", "100"), ("DenseClusterSize", "64"),
                        ("FinalRefineSearchMode", "same")]:
        idx.SetBuildParam(name, value)


def test_ann_index_lifecycle_equals_jax_on_one_folder(corpus, tmp_path):
    """Load one JAX-built folder through both wrappers: searches, adds,
    deletes and a save/load round trip give the same ids."""
    data = corpus["data"]
    out = {}
    for name, mod, kw in (("jax", jwrappers, {}),
                          ("port", twrappers, {"device": "cpu"})):
        idx = mod.AnnIndex.Load(corpus["folder"], **kw)
        rec = [list(idx.SearchWithMetaData(data[17].tobytes(), 5).ids),
               idx.SearchWithMetaData(data[17].tobytes(), 5).metas]
        rec.append([list(r.ids) for r in
                    idx.BatchSearch(data[:6].tobytes(), 6, 3, True)])
        assert idx.AddWithMetaData(data[:3] + 1.0, b"a0\na1\na2\n", 3)
        assert idx.DeleteByMetaData(b"m17")
        rec.append(list(idx.Search(data[17].tobytes(), 3).ids))
        rec.append(list(idx.Search((data[1] + 1.0).tobytes(), 1).ids))
        folder = str(tmp_path / name)
        assert idx.Save(folder)
        loaded = mod.AnnIndex.Load(folder, **kw)
        rec.append(list(loaded.Search(data[23].tobytes(), 3).ids))
        out[name] = rec
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == 17 and out["port"][1][0] == b"m17"
    assert out["port"][3][0] != 17 and out["port"][4] == [N + 1]


def test_ann_index_build_and_merge_equal_jax(tmp_path):
    """FLAT builds from raw bytes and merges alike; a BKT build on the
    CPU answers self-queries."""
    data = _rows(200, seed=4)
    res = {}
    for name, mod, kw in (("jax", jwrappers, {}),
                          ("port", twrappers, {"device": "cpu"})):
        a = mod.AnnIndex("FLAT", "Float", D, **kw)
        a.SetBuildParam("DistCalcMethod", "L2")
        assert a.Build(data[:100].tobytes(), 100)
        b = mod.AnnIndex("FLAT", "Float", D, **kw)
        b.SetBuildParam("DistCalcMethod", "L2")
        assert b.Build(data[100:], 100)
        fa, fb = str(tmp_path / f"{name}a"), str(tmp_path / f"{name}b")
        assert a.Save(fa) and b.Save(fb)
        merged = mod.AnnIndex.Merge(fa, fb, **kw)
        r = merged.Search(data[150].tobytes(), 3)
        res[name] = (merged.index.num_samples, list(r.ids),
                     [float(x) for x in r.dists])
    assert res["port"] == res["jax"]
    assert res["port"][0] == 200 and res["port"][1][0] == 150
    bkt = twrappers.AnnIndex("BKT", "Float", D, device="cpu")
    _small_params(bkt)
    metas = b"\n".join(f"m{i}".encode() for i in range(200)) + b"\n"
    assert bkt.BuildWithMetaData(data.tobytes(), metas, 200, True)
    assert bkt.ReadyToServe()
    r = bkt.SearchWithMetaData(data[9].tobytes(), 3)
    assert r.ids[0] == 9 and r.metas[0] == b"m9"


def test_ann_index_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        twrappers.AnnIndex("BKT", "Float", 4)
    assert twrappers.AnnIndex("FLAT", "Float", 4, device="cpu") \
        .index.device.type == "cpu"


class _Capture(threading.Thread):
    """Records every byte a client sends; answers the register handshake
    and each search with an empty Success result."""

    def __init__(self):
        super().__init__(daemon=True, name="test-capture-server")
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.addr = self.sock.getsockname()
        self.data = bytearray()

    def run(self):
        conn, _ = self.sock.accept()
        with conn:
            while True:
                head = conn.recv(16, socket.MSG_WAITALL)
                if len(head) < 16:
                    return
                h = jwire.PacketHeader.unpack(head)
                body = conn.recv(h.body_length, socket.MSG_WAITALL) \
                    if h.body_length else b""
                self.data += head + body
                if h.packet_type == jwire.PacketType.RegisterRequest:
                    conn.sendall(jwire.PacketHeader(
                        jwire.PacketType.RegisterResponse,
                        jwire.PacketProcessStatus.Ok, 0, 7,
                        h.resource_id).pack())
                elif h.packet_type == jwire.PacketType.SearchRequest:
                    res = jwire.RemoteSearchResult(
                        jwire.ResultStatus.Success, []).pack()
                    conn.sendall(jwire.PacketHeader(
                        jwire.PacketType.SearchResponse,
                        jwire.PacketProcessStatus.Ok, len(res), 7,
                        h.resource_id).pack() + res)

    def close(self):
        self.sock.close()


def test_ann_client_sends_the_jax_clients_bytes():
    """Both wrappers' clients put the same frames on the wire for the
    same calls: tests/test_wrapper_bytes.py's header layout, base64
    vectors and `$` options in the query text."""
    captured = []
    vec = np.asarray([0.5, -1.0, 2.0, 3.25], np.float32)
    for mod in (jwrappers, twrappers):
        cap = _Capture()
        cap.start()
        client = mod.AnnClient(*cap.addr)
        client.SetSearchParam("requestid", "fixed-rid")
        client.SetSearchParam("maxcheck", "256")
        assert client.IsConnected()
        res = client.Search(vec.tobytes(), 3, "Float", True)
        res2 = client.Search(vec, 5, "Float")
        assert res.status == res2.status == 0
        client._transport.close()
        cap.join(10)
        cap.close()
        captured.append(bytes(cap.data))
    assert captured[1] == captured[0]
    stream = captured[1]
    t, s, ln, cid, rid = struct.unpack_from("<BBIII", stream, 0)
    assert (t, ln) == (int(twire.PacketType.RegisterRequest), 0)
    off = 16
    texts = []
    while off < len(stream):
        h = twire.PacketHeader.unpack(stream[off:off + 16])
        q = twire.RemoteQuery.unpack(stream[off + 16:off + 16
                                            + h.body_length])
        texts.append(q.query)
        off += 16 + h.body_length
    b64 = base64.b64encode(vec.tobytes()).decode()
    assert texts[0] == ("$datatype:Float $resultnum:3 $extractmetadata:true "
                        f"$requestid:fixed-rid $maxcheck:256 #{b64}")


def test_lifecycle_fixture_is_the_port_wire_stream():
    """tests/test_wrapper_bytes.py's expected stream, built with the
    port's wire module, is the committed fixture."""
    from test_wrapper_bytes import CAPTURE_CONNECTION_ID, lifecycle_queries

    out = bytearray(twire.PacketHeader(
        twire.PacketType.RegisterRequest, 0, 0, 0, 0).pack())
    for rid, q in enumerate(lifecycle_queries(), start=1):
        body = twire.RemoteQuery(q).pack()
        out += twire.PacketHeader(twire.PacketType.SearchRequest, 0,
                                  len(body), CAPTURE_CONNECTION_ID,
                                  rid).pack() + body
    with open(FIXTURE, "rb") as f:
        assert bytes(out) == f.read()
