"""The port's socket search stack against the JAX package's.

The wire bodies pack and unpack byte-identically, the query parser agrees
on the strings of tests/test_serve.py and on its fuzz corpus, and the two
SearchServers, each in its own loop over the same BKT folder (integer-
valued rows, so every distance is exact in both packages), answer the same
request frames with byte-identical response frames: beam, dense,
``$resultnum``, ``$maxcheck``, metadata, the wrapper lifecycle fixture, a
malformed packet and heartbeats.  Each control-plane setting or argument
(admission, SLO objectives, the controller, the canary, the metrics
listener) arms the same feature in both servers, which then answer alike;
MeshServe and TraceSanitizer arm the port's mesh spine and trace sentinel
(their own tests: tests/test_torch_mesh_serve.py,
tests/test_torch_recompile.py).
"""

import base64
import io
import os
import random
import socket
import string

import numpy as np
import pytest
import torch

import sptag_tpu as jsp
import sptag_tpu_torch as tsp
from conftest import ServerThread
from sptag_tpu.serve import protocol as jprotocol
from sptag_tpu.serve import server as jserver
from sptag_tpu.serve import service as jservice
from sptag_tpu.serve import wire as jwire
from sptag_tpu_torch.serve import protocol as tprotocol
from sptag_tpu_torch.serve import server as tserver
from sptag_tpu_torch.serve import service as tservice
from sptag_tpu_torch.serve import wire as twire
from sptag_tpu_torch.utils import timeline as ttimeline
from sptag_tpu_torch.utils import metrics as tmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "wrapper_lifecycle.bytes")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    # an armed SLO, canary or controller starts the port's process-wide
    # timeline sampler; tests/conftest.py resets only the JAX package's,
    # and a later file in the same worker counts the threads left
    ttimeline.reset()


# ---- the wire bodies -------------------------------------------------------

HEADERS = [(3, 0, 123, 7, 99), (4, 2, 0, 1, 2 ** 32 - 1), (0x81, 1, 5, 0, 0)]


@pytest.mark.parametrize("fields", HEADERS)
def test_packet_header_bytes_equal_jax(fields):
    a = twire.PacketHeader(*fields).pack()
    b = jwire.PacketHeader(*fields).pack()
    assert a == b and len(a) == 16
    h = twire.PacketHeader.unpack(b)
    assert (int(h.packet_type), int(h.process_status), h.body_length,
            h.connection_id, h.resource_id) == fields


QUERIES = [("$resultnum:5 1|2|3", "", 0.0), ("#AAAA", "rid-7", 0.0),
           ("$indexname:a,b 0.5|0.25", "r", 250.0), ("", "", 0.0)]


@pytest.mark.parametrize("text,rid,deadline", QUERIES)
def test_remote_query_bytes_equal_jax(text, rid, deadline):
    a = twire.RemoteQuery(text, request_id=rid, deadline_ms=deadline).pack()
    b = jwire.RemoteQuery(text, request_id=rid, deadline_ms=deadline).pack()
    assert a == b
    q = twire.RemoteQuery.unpack(b)
    assert (q.query, q.request_id, q.deadline_ms) == (text, rid, deadline)


def _results(mod, markers):
    return mod.RemoteSearchResult(mod.ResultStatus.Success, [
        mod.IndexSearchResult("a", [1, 2, -1], [0.5, 1.0, 3.4e38], None),
        mod.IndexSearchResult("b", [7], [2.25], [b"meta7"])],
        request_id="rid-1" if markers else "", markers=list(markers))


@pytest.mark.parametrize("markers", [(), ("degraded",)])
def test_remote_search_result_bytes_equal_jax(markers):
    a = _results(twire, markers).pack()
    assert a == _results(jwire, markers).pack()
    r = twire.RemoteSearchResult.unpack(a)
    assert r.results[1].metas == [b"meta7"] and r.markers == list(markers)
    assert twire.RemoteSearchResult.unpack(a[:-3]) is None


# ---- the text protocol ---------------------------------------------

PARSE_STRINGS = ["$IndexName:foo,bar $resultnum:3 $extractmetadata:true "
                 "1|2.5|3",
                 "#" + base64.b64encode(
                     np.asarray([1.5, -2.0, 0.25], np.float32).tobytes())
                 .decode(),
                 "$maxcheck:300 $searchmode:dense $datatype:Int8 1|2|3",
                 "$requestid:abc $deadlinems:20 $searchmode:beam 4|5"]


def _fuzz_corpus():
    """tests/test_serve.py::test_parse_query_fuzz_never_raises's draws."""
    rng = random.Random(0)
    alphabet = string.printable + "\x00\xff$#|"
    return ["".join(rng.choice(alphabet)
                    for _ in range(rng.randrange(0, 80)))
            for _ in range(500)]


def _parsed(mod, text):
    p = mod.parse_query(text)
    vt = (jsp if mod is jprotocol else tsp).VectorValueType
    vecs = []
    for t in (vt.Float, vt.Int8):
        v = p.extract_vector(t)
        vecs.append(None if v is None else (str(v.dtype), v.tolist()))
    dt = p.data_type
    return (p.options, p.vector_text, p.vector_base64, p.index_names,
            None if dt is None else int(dt), p.extract_metadata,
            p.result_num, p.max_check, p.search_mode, vecs,
            mod.request_id_of(text), mod.deadline_of(text))


@pytest.mark.parametrize("corpus", ["strings", "fuzz"])
def test_parse_query_equals_jax(corpus):
    texts = PARSE_STRINGS if corpus == "strings" else _fuzz_corpus()
    for text in texts:
        assert repr(_parsed(tprotocol, text)) == \
            repr(_parsed(jprotocol, text)), text


# ---- the two servers on one folder ---------------------------------

N, D = 2000, 16
SETTINGS = [("DistCalcMethod", "L2"), ("TPTNumber", "4"),
            ("TPTLeafSize", "500"), ("CEF", "64"),
            ("MaxCheckForRefineGraph", "128"), ("NeighborhoodSize", "16"),
            ("BKTKmeansK", "8"), ("MaxCheck", "512"),
            ("RefineQueryGroup", "32"), ("FinalRefineSearchMode", "same"),
            ("DenseClusterSize", "128")]


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    cent = np.random.default_rng(5).standard_normal((24, D)) \
        .astype(np.float32) * 4.0
    x = cent[rng.integers(0, 24, n)] \
        + rng.standard_normal((n, D)).astype(np.float32)
    return np.round(x * 2).astype(np.float32)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    idx = jsp.create_instance("BKT", "Float")
    for name, value in SETTINGS:
        assert idx.set_parameter(name, value)
    idx.build(_rows(N, 1), jsp.MetadataSet(f"m{i}".encode()
                                           for i in range(N)))
    path = str(tmp_path_factory.mktemp("serve") / "bkt")
    assert idx.save_index(path) == jsp.ErrorCode.Success
    return path


def _settings(mod):
    return mod.ServiceSettings(default_max_result=5,
                               enable_remote_admin=True,
                               allow_search_mode_override="on")


@pytest.fixture(scope="module")
def servers(folder):
    jctx = jservice.ServiceContext(_settings(jservice))
    jctx.add_index("main", jsp.load_index(folder))
    tctx = tservice.ServiceContext(_settings(tservice), device="cpu")
    tctx.add_index("main", tsp.load_index(folder, device="cpu"))
    threads = [ServerThread(jserver.SearchServer(jctx, batch_window_ms=1.0)),
               ServerThread(tserver.SearchServer(tctx, batch_window_ms=1.0))]
    for t in threads:
        t.start()
    addrs = [t.wait_ready(30) for t in threads]
    yield addrs
    for t in threads:
        t.stop()


def _frame(ptype, body=b"", rid=1):
    return jwire.PacketHeader(ptype, 0, len(body), 0, rid).pack() + body


def _search(text, rid=1):
    return _frame(jwire.PacketType.SearchRequest,
                  jwire.RemoteQuery(text).pack(), rid)


def _exchange(addr, frames):
    """Send each frame and read one response frame for it; the raw
    response bytes, in order."""
    sock = socket.create_connection(addr, timeout=60)
    sock.settimeout(60)

    def read_exact(n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            assert chunk, "server closed early"
            buf += chunk
        return buf

    out = []
    try:
        for f in frames:
            sock.sendall(f)
            head = read_exact(jwire.HEADER_SIZE)
            h = jwire.PacketHeader.unpack(head)
            out.append(head + (read_exact(h.body_length)
                               if h.body_length else b""))
    finally:
        sock.close()
    return out


def _text(v):
    return "|".join(str(int(x)) for x in v)


def _request_frames():
    q = _rows(6, 2)
    frames = [_frame(jwire.PacketType.RegisterRequest),
              _frame(jwire.PacketType.HeartbeatRequest)]
    for i, v in enumerate(q):
        b64 = base64.b64encode(v.tobytes()).decode()
        frames += [
            _search(f"$searchmode:beam {_text(v)}", rid=10 + i),
            _search(f"$searchmode:dense $resultnum:7 #{b64}", rid=20 + i),
            _search(f"$indexname:main $maxcheck:256 $searchmode:beam "
                    f"$extractmetadata:true {_text(v)}", rid=30 + i),
            _search(f"$requestid:q{i} $searchmode:dense "
                    f"$extractmetadata:true {_text(v)}", rid=40 + i)]
    frames += [_search("$indexname:nope 1|2|3"),
               _search(f"$resultnum:3 {_text(q[0][:5])}"),   # bad width
               _frame(jwire.PacketType.SearchRequest, b"\x07garbage"),
               _frame(jwire.PacketType.HeartbeatRequest)]
    return frames


def test_servers_answer_search_frames_byte_identically(servers):
    frames = _request_frames()
    jax_out, port_out = (_exchange(a, frames) for a in servers)
    assert len(port_out) == len(frames)
    for i, (got, want) in enumerate(zip(port_out, jax_out)):
        assert got == want, i
    # the searches found something: the self-query of an indexed row
    row = _rows(N, 1)[17]
    again = [_exchange(a, [_search(f"$searchmode:beam {_text(row)}")])[0]
             for a in servers]
    assert again[0] == again[1]
    res = twire.RemoteSearchResult.unpack(again[1][16:])
    assert res.results[0].ids[0] == 17


def test_servers_replay_the_lifecycle_fixture_byte_identically(servers):
    with open(FIXTURE, "rb") as f:
        stream = f.read()
    frames, off = [], 0
    while off < len(stream):
        h = jwire.PacketHeader.unpack(stream[off:off + jwire.HEADER_SIZE])
        end = off + jwire.HEADER_SIZE + h.body_length
        frames.append(stream[off:end])
        off = end
    jax_out, port_out = (_exchange(a, frames) for a in servers)
    assert port_out == jax_out
    replies = [twire.RemoteSearchResult.unpack(r[16:]) for r in port_out
               if twire.PacketHeader.unpack(r[:16]).packet_type
               == twire.PacketType.SearchResponse]
    assert [r.results[0].index_name for r in replies[:2]] == [
        "admin:ok:built", "admin:ok:added"]
    assert replies[2].results[0].ids[0] == 0
    assert [r.results[0].index_name for r in replies[3:]] == [
        "admin:ok:deleted", "admin:ok:deleted"]


def test_servers_close_an_oversized_packet_alike(servers):
    bad = jwire.PacketHeader(jwire.PacketType.SearchRequest, 0,
                             jwire.MAX_BODY_LENGTH + 1, 0, 1).pack()
    for addr in servers:
        sock = socket.create_connection(addr, timeout=30)
        sock.sendall(bad)
        assert sock.recv(16) == b""        # the server hung up
        sock.close()


# ---- the control plane: armed, each server starts, answers, stops -------

UNPORTED = [("mesh_serve", True, "multi-GPU")]


@pytest.mark.parametrize("field,value,item", UNPORTED)
def test_armed_unported_settings_raise_naming_the_roadmap(field, value, item,
                                                          folder):
    """Once refused, MeshServe is ported: a server armed with it starts
    and answers over a single-index folder (no mesh index to arm, so the
    mesh-serve counter stays 0)."""
    s = tservice.ServiceSettings(**{field: value})
    ctx = tservice.ServiceContext(s, device="cpu")
    ctx.add_index("main", tsp.load_index(folder, device="cpu"))
    before = tmetrics.counter_value("server.mesh_serve_indexes")
    t = ServerThread(tserver.SearchServer(ctx, batch_window_ms=1.0))
    t.start()
    try:
        t.wait_ready(30)
        assert tmetrics.counter_value("server.mesh_serve_indexes") == before
    finally:
        t.stop()


def _armed_pair(folder, settings=(), args=None):
    """A JAX and a port SearchServer over `folder`, both armed with the
    same [Service] settings / constructor arguments (`args(mod)` builds
    the arguments from each package's control-plane modules)."""
    servers = []
    for svc, srv, pkg, kw in (
            (jservice, jserver, jsp, {}),
            (tservice, tserver, tsp, {"device": "cpu"})):
        st = svc.ServiceSettings(default_max_result=5,
                                 allow_search_mode_override="on",
                                 **dict(settings))
        ctx = svc.ServiceContext(st, **kw)
        ctx.add_index("main", pkg.load_index(folder, **kw))
        extra = args(srv) if args is not None else {}
        servers.append(srv.SearchServer(ctx, batch_window_ms=1.0, **extra))
    return servers


def _drive_pair(servers):
    """Start both servers, send the same frames to each, stop them; the
    two response streams and the port server's state while it ran."""
    import threading

    before = set(threading.enumerate())
    threads = [ServerThread(s) for s in servers]
    for t in threads:
        t.start()
    addrs = [t.wait_ready(30) for t in threads]
    q = _rows(3, 2)
    frames = [_frame(jwire.PacketType.RegisterRequest)]
    for i, v in enumerate(q):
        frames += [_search(f"$searchmode:beam {_text(v)}", rid=10 + i),
                   _search(f"$searchmode:dense $resultnum:7 {_text(v)}",
                           rid=20 + i)]
    outs = [_exchange(a, frames) for a in addrs]
    port = servers[1]
    state = {"admission": port.admission is not None,
             "slo": port._slo is not None,
             "controller": port._controller is not None,
             "canary": port._canary is not None,
             "metrics_http": port._metrics_http is not None,
             "jax": {"admission": servers[0].admission is not None,
                     "slo": servers[0]._slo is not None,
                     "controller": servers[0]._controller is not None,
                     "canary": servers[0]._canary is not None,
                     "metrics_http": servers[0]._metrics_http is not None}}
    if port._metrics_http is not None:
        import json
        import urllib.request

        url = f"http://127.0.0.1:{port._metrics_http.port}/healthz"
        with urllib.request.urlopen(url, timeout=30) as r:
            state["healthz"] = json.loads(r.read())
    if port._canary is not None:
        # one probe through the port server's own socket, on demand
        state["probe"] = port._canary.probe_once(port._canary.probes[0])
    for t in threads:
        t.stop()
    state["left"] = [th.name for th in set(threading.enumerate()) - before
                     if th.is_alive() and th.name.startswith(
                         ("sptag-serve", "metrics-http", "canary"))]
    return outs, state


ARMED_SETTINGS = {
    "admission_control": ({"admission_control": True}, "admission"),
    "metrics_port": ({"metrics_port": -1}, "metrics_http"),
    "slo_p99_ms": ({"slo_p99_ms": 5000.0}, "slo"),
    "slo_recall_floor": ({"slo_recall_floor": 0.5}, "slo"),
    "controller": ({"controller": True, "slo_p99_ms": 5000.0},
                   "controller"),
    "canary_interval_ms": ({"canary_interval_ms": 60000.0, "canary_k": 5},
                           "canary"),
}


@pytest.mark.parametrize("field", sorted(ARMED_SETTINGS))
def test_armed_settings_start_answer_and_stop_like_jax(folder, field):
    """Each control-plane setting arms the same feature in both servers;
    the armed servers answer the same frames with the same bytes and the
    port server leaves no thread behind."""
    settings, feature = ARMED_SETTINGS[field]
    (jax_out, port_out), state = _drive_pair(
        _armed_pair(folder, settings.items()))
    assert port_out == jax_out
    assert state[feature] and state["jax"][feature]
    assert {k: state[k] for k in state["jax"]} == state["jax"]
    assert state["left"] == []
    if feature == "metrics_http":
        assert state["healthz"]["status"] == "ok"
        assert state["healthz"]["indexes"]["main"]["samples"] == N
    if feature == "canary":
        assert state["probe"]["ok"] and state["probe"]["status"] == 0
        assert state["probe"]["recall"] == 1.0


def _armed_args(arg):
    def make(srv):
        mods = {"admission": srv.admission_mod, "slo": srv.slo_mod,
                "controller": srv.controller_mod}
        if arg == "admission":
            a = mods["admission"]
            return {"admission": a.AdmissionController(a.AdmissionConfig())}
        if arg == "slo_config":
            return {"slo_config": mods["slo"].SloConfig(p99_ms=5000.0)}
        if arg == "controller_config":
            return {"slo_config": mods["slo"].SloConfig(p99_ms=5000.0),
                    "controller_config":
                        mods["controller"].ControllerConfig(enabled=True)}
        if arg == "metrics_port":
            return {"metrics_port": -1}
        return {"canary_interval_ms": 60000.0}
    return make


ARMED_ARGS = {"admission": "admission", "slo_config": "slo",
              "controller_config": "controller",
              "metrics_port": "metrics_http", "canary_interval_ms": "canary"}


@pytest.mark.parametrize("arg", sorted(ARMED_ARGS))
def test_armed_arguments_start_answer_and_stop_like_jax(folder, arg):
    """The constructor arguments arm the same features as the settings."""
    (jax_out, port_out), state = _drive_pair(
        _armed_pair(folder, args=_armed_args(arg)))
    assert port_out == jax_out
    feature = ARMED_ARGS[arg]
    assert state[feature] and state["jax"][feature]
    assert state["left"] == []


def _ini(tmp_path, folder, extra=""):
    path = tmp_path / "service.ini"
    path.write_text("[Service]\nListenPort=0\n" + extra +
                    "[Index]\nList=main\n"
                    f"[Index_main]\nIndexFolder={folder}\n")
    return str(path)


def test_from_ini_loads_on_the_device_and_refuses_the_trace_sanitizer(
        tmp_path, folder, monkeypatch):
    ctx = tservice.ServiceContext.from_ini(_ini(tmp_path, folder),
                                           device="cpu")
    assert ctx.indexes["main"].device.type == "cpu"
    assert ctx.indexes["main"].num_samples == N
    # TraceSanitizer, once refused, arms the port's trace sentinel
    from sptag_tpu_torch.utils import recompile_guard as trg
    try:
        trg.reset_tracesan()
        monkeypatch.setenv("SPTAG_TRACESAN", "")
        assert not trg.tracesan_enabled()
        tservice.ServiceContext.from_ini(
            _ini(tmp_path, folder, "TraceSanitizer=1\n"), device="cpu")
        assert trg.tracesan_enabled()
    finally:
        trg.reset_tracesan()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tservice.ServiceContext.from_ini(_ini(tmp_path, folder))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserver.main(["-c", _ini(tmp_path, folder), "-m", "interactive"])
    assert tserver.main(["-c", _ini(tmp_path, folder), "-m", "interactive",
                         "--device", "cpu"]) == 0


def test_stop_joins_the_server_threads(folder):
    """A stopped server leaves no thread of its own behind."""
    import threading

    ctx = tservice.ServiceContext(device="cpu")
    ctx.add_index("main", tsp.load_index(folder, device="cpu"))
    before = set(threading.enumerate())
    t = ServerThread(tserver.SearchServer(ctx, batch_window_ms=1.0))
    t.start()
    addr = t.wait_ready(30)
    text = _text(_rows(1, 3)[0])
    out = _exchange(addr, [_search(f"$searchmode:beam {text}")])
    assert twire.RemoteSearchResult.unpack(out[0][16:]).status == \
        twire.ResultStatus.Success
    t.stop()
    left = [th.name for th in set(threading.enumerate()) - before
            if th.is_alive()]
    assert not [n for n in left if n.startswith("sptag-serve")], left
