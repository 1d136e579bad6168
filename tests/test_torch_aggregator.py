"""The port's aggregator and metrics listener against the JAX package's.

Two port SearchServers behind the port's aggregator, and two JAX
SearchServers behind the JAX aggregator, serve one pair of JAX-built
shard folders (integer-valued rows, so every distance is exact in both
packages), each in tests/conftest.py's ServerThread on port 0.  The same
request frames must give byte-identical response frames with MergeTopK
off and on, and with one backend down (a closed address, and a backend
that never answers, which gives the partial Timeout status).  The
metrics listener serves the JAX package's routes, and a device trace
that overlaps another profiler trace answers 409.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import sptag_tpu as jsp
import sptag_tpu_torch as tsp
from conftest import ServerThread
from sptag_tpu.serve import aggregator as jagg
from sptag_tpu.serve import metrics_http as jmh
from sptag_tpu.serve import server as jserver
from sptag_tpu.serve import service as jservice
from sptag_tpu.serve import wire as jwire
from sptag_tpu_torch.serve import aggregator as tagg
from sptag_tpu_torch.serve import metrics_http as tmh
from sptag_tpu_torch.serve import server as tserver
from sptag_tpu_torch.serve import service as tservice
from sptag_tpu_torch.serve import wire as twire
from sptag_tpu_torch.utils import metrics as tmetrics
from sptag_tpu_torch.utils import trace as ttrace

N, D = 1200, 16
SETTINGS = [("DistCalcMethod", "L2"), ("TPTNumber", "4"),
            ("TPTLeafSize", "300"), ("CEF", "64"),
            ("MaxCheckForRefineGraph", "128"), ("NeighborhoodSize", "16"),
            ("BKTKmeansK", "8"), ("MaxCheck", "256"),
            ("FinalRefineSearchMode", "same"), ("DenseClusterSize", "64")]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    cent = np.random.default_rng(5).standard_normal((24, D)) \
        .astype(np.float32) * 4.0
    x = cent[rng.integers(0, 24, n)] \
        + rng.standard_normal((n, D)).astype(np.float32)
    return np.round(x * 2).astype(np.float32)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Two JAX-built BKT shard folders over halves of one corpus, each
    row's metadata its global id."""
    data = _rows(N, 1)
    out = []
    for s, (lo, hi) in enumerate(((0, N // 2), (N // 2, N))):
        idx = jsp.create_instance("BKT", "Float")
        for name, value in SETTINGS:
            assert idx.set_parameter(name, value)
        idx.build(data[lo:hi], jsp.MetadataSet(
            str(i).encode() for i in range(lo, hi)), with_meta_index=True)
        path = str(tmp_path_factory.mktemp("agg") / f"shard{s}")
        assert idx.save_index(path) == jsp.ErrorCode.Success
        out.append(path)
    return out


@pytest.fixture(scope="module")
def backends(shards):
    """(JAX server addresses, port server addresses), one per shard."""
    threads, addrs = [], {"jax": [], "port": []}
    for path in shards:
        jctx = jservice.ServiceContext(jservice.ServiceSettings(
            default_max_result=5, allow_search_mode_override="on"))
        jctx.add_index("main", jsp.load_index(path))
        tctx = tservice.ServiceContext(tservice.ServiceSettings(
            default_max_result=5, allow_search_mode_override="on"),
            device="cpu")
        tctx.add_index("main", tsp.load_index(path, device="cpu"))
        for key, srv in (("jax", jserver.SearchServer(jctx,
                                                      batch_window_ms=1.0)),
                         ("port", tserver.SearchServer(tctx,
                                                       batch_window_ms=1.0))):
            t = ServerThread(srv)
            t.start()
            threads.append(t)
            addrs[key].append(t.wait_ready(30))
    yield addrs
    for t in threads:
        t.stop()


class _MuteBackend(threading.Thread):
    """Answers the register handshake, then never answers a search."""

    def __init__(self):
        super().__init__(daemon=True, name="test-mute-backend")
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.addr = self.sock.getsockname()
        self.conns = []

    def run(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name="test-mute-conn").start()

    def _serve(self, conn):
        try:
            while True:
                head = b""
                while len(head) < 16:
                    chunk = conn.recv(16 - len(head))
                    if not chunk:
                        return
                    head += chunk
                h = jwire.PacketHeader.unpack(head)
                left = h.body_length
                while left:
                    chunk = conn.recv(left)
                    if not chunk:
                        return
                    left -= len(chunk)
                if h.packet_type == jwire.PacketType.RegisterRequest:
                    conn.sendall(jwire.PacketHeader(
                        jwire.PacketType.RegisterResponse,
                        jwire.PacketProcessStatus.Ok, 0, 1,
                        h.resource_id).pack())
        except OSError:
            return

    def close(self):
        self.sock.close()
        for c in self.conns:
            c.close()


def _closed_addr():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = s.getsockname()
    s.close()
    return addr


def _start_aggregators(backend_addrs, **ctx_kw):
    """One JAX and one port aggregator over the given backends."""
    threads = []
    for mod, key in ((jagg, "jax"), (tagg, "port")):
        ctx = mod.AggregatorContext(**ctx_kw)
        ctx.servers = [mod.RemoteServer(h, p) for h, p in backend_addrs[key]]
        t = ServerThread(mod.AggregatorService(ctx))
        t.start()
        threads.append(t)
    return threads, [t.wait_ready(30) for t in threads]


def _frame(ptype, body=b"", rid=1):
    return jwire.PacketHeader(ptype, 0, len(body), 0, rid).pack() + body


def _search(text, rid, request_id):
    return _frame(jwire.PacketType.SearchRequest,
                  jwire.RemoteQuery(text, request_id=request_id).pack(), rid)


def _exchange(addr, frames):
    sock = socket.create_connection(addr, timeout=60)
    sock.settimeout(60)

    def read_exact(n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            assert chunk, "closed early"
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


def _frames(n=4):
    q = _rows(n, 2)
    frames = [_frame(jwire.PacketType.RegisterRequest),
              _frame(jwire.PacketType.HeartbeatRequest)]
    for i, v in enumerate(q):
        frames += [
            _search(f"$searchmode:beam $resultnum:5 {_text(v)}", 10 + i,
                    f"b{i}"),
            _search(f"$searchmode:dense $extractmetadata:true "
                    f"$resultnum:7 {_text(v)}", 20 + i, f"d{i}"),
            _search(f"$indexname:main $maxcheck:128 $extractmetadata:true "
                    f"{_text(v)}", 30 + i, f"m{i}")]
    frames.append(_search("$indexname:nope 1|2|3", 99, "bad"))
    return frames


@pytest.mark.parametrize("merge", [False, True], ids=["concat", "merge"])
def test_aggregators_answer_frames_byte_identically(backends, merge):
    threads, addrs = _start_aggregators(backends, search_timeout_s=30.0,
                                        merge_top_k=merge)
    try:
        frames = _frames()
        jax_out, port_out = (_exchange(a, frames) for a in addrs)
    finally:
        for t in threads:
            t.stop()
    assert len(port_out) == len(frames)
    for i, (got, want) in enumerate(zip(port_out, jax_out)):
        assert got == want, i
    res = twire.RemoteSearchResult.unpack(port_out[3][16:])
    assert res.status == twire.ResultStatus.Success
    # one merged list, or one list per shard
    assert len(res.results) == (1 if merge else 2)
    if merge:
        d = res.results[0].dists
        assert d == sorted(d) and len(res.results[0].metas) == 7


@pytest.mark.parametrize("down", ["closed", "mute"])
def test_aggregators_with_a_backend_down_answer_alike(backends, down):
    """A closed backend is skipped (Success from the live shard); a
    backend that never answers times out (the partial Timeout status,
    the live shard's lists kept)."""
    frames = _frames(1)
    for key in ("jax", "port"):
        # warm the live shard (the JAX walk compiles at a new shape),
        # so its answer beats the 1 s fan-out timeout
        _exchange(backends[key][0], frames)
    mute = None
    if down == "mute":
        mute = _MuteBackend()
        mute.start()
        dead = mute.addr
    else:
        dead = _closed_addr()
    addrs_in = {k: [v[0], dead] for k, v in backends.items()}
    threads, addrs = _start_aggregators(addrs_in, search_timeout_s=1.0,
                                        merge_top_k=True,
                                        reconnect_base_ms=60000.0,
                                        reconnect_cap_s=600.0)
    try:
        jax_out, port_out = (_exchange(a, frames) for a in addrs)
    finally:
        for t in threads:
            t.stop()
        if mute is not None:
            mute.close()
    assert port_out == jax_out
    res = twire.RemoteSearchResult.unpack(port_out[3][16:])
    want = (twire.ResultStatus.Timeout if down == "mute"
            else twire.ResultStatus.Success)
    assert res.status == want
    # only the live shard (rows below N / 2) answered
    metas = res.results[0].metas
    assert metas and all(int(m) < N // 2 for m in metas)


def test_aggregator_trace_sanitizer_is_refused(tmp_path, monkeypatch):
    """Once refused, [Service] TraceSanitizer arms the port's trace
    sentinel at the aggregator, from the ini and at start()."""
    from sptag_tpu_torch.utils import recompile_guard as trg

    path = tmp_path / "agg.ini"
    path.write_text("[Service]\nListenPort=0\nTraceSanitizer=1\n"
                    "TraceSanCompileBudget=3\n[Servers]\nNumber=0\n")
    monkeypatch.setenv("SPTAG_TRACESAN", "")
    try:
        trg.reset_tracesan()
        ctx = tagg.AggregatorContext.from_ini(str(path))
        assert ctx.trace_sanitizer and ctx.tracesan_compile_budget == 3
        assert trg.tracesan_enabled()
        trg.reset_tracesan()
        t = ServerThread(tagg.AggregatorService(
            tagg.AggregatorContext(trace_sanitizer=True)))
        t.start()
        try:
            t.wait_ready(30)
            assert trg.tracesan_enabled()
        finally:
            t.stop()
    finally:
        trg.reset_tracesan()


# ---- the metrics listener ---------------------------------------------------

def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_metrics_listener_routes_equal_jax():
    """Every route of the JAX listener answers on the port's with the
    same code and content type (the device trace aside: it is the next
    test's)."""
    servers = [jmh.MetricsHttpServer(-1), tmh.MetricsHttpServer(-1)]
    ports = [s.start() for s in servers]
    try:
        assert servers[1].routes() == servers[0].routes()
        for route in servers[0].routes():
            if route == "/debug/devicetrace":
                continue
            got = [_get(p, route)[:2] for p in ports]
            assert got[1] == got[0], route
        assert _get(ports[1], "/nope")[0] == 404
        mem = json.loads(_get(ports[1], "/debug/memory")[2])
        jmem = json.loads(_get(ports[0], "/debug/memory")[2])
        assert set(mem) <= set(jmem)
        assert {"enabled", "components", "ledger_total_bytes",
                "ledger_device_bytes"} <= set(mem)
    finally:
        for s in servers:
            s.shutdown()


def test_device_trace_answers_409_while_another_trace_runs(tmp_path):
    """One torch.profiler trace at a time in the process: a device trace
    overlapping another one (or a CLI's trace.start_trace) answers 409,
    no scrape thread raises, and a later request traces again."""
    srv = tmh.MetricsHttpServer(-1)
    port = srv.start()
    errors_before = tmetrics.counter_value("metrics_http.handler_errors")
    try:
        ttrace.start_trace(str(tmp_path / "cli"))
        try:
            code, _, body = _get(port, "/debug/devicetrace?duration_ms=10")
            assert code == 409, body
        finally:
            ttrace.stop_trace()
        first = {}

        def long_trace():
            first["out"] = _get(port, "/debug/devicetrace?duration_ms=1500"
                                f"&dir={tmp_path / 'long'}")

        t = threading.Thread(target=long_trace, name="test-devicetrace")
        t.start()
        deadline = time.time() + 10
        while not ttrace.tracing() and time.time() < deadline:
            time.sleep(0.01)
        code, _, _ = _get(port, "/debug/devicetrace?duration_ms=10")
        assert code == 409
        with pytest.raises(ttrace.TraceBusy):
            ttrace.start_trace(str(tmp_path / "other"))
        t.join(30)
        code, _, body = first["out"]
        assert code == 200, body
        out = json.loads(body)
        assert (tmp_path / "long" / "trace.json").exists()
        assert out["dir"] == str(tmp_path / "long")
        code, _, body = _get(port, "/debug/devicetrace?duration_ms=5")
        assert code == 200
        assert not ttrace.tracing()
        assert tmetrics.counter_value("metrics_http.handler_errors") == \
            errors_before
    finally:
        srv.shutdown()


@pytest.mark.parametrize("tier", ["server", "aggregator"])
def test_serving_processes_exit_0_on_sigterm(shards, tmp_path, tier):
    """`python -m sptag_tpu_torch.serve.server -m socket` and
    `python -m sptag_tpu_torch.serve.aggregator` stop cleanly on SIGTERM
    (the JAX package's mains wait forever): the process answers, then
    exits 0."""
    import os
    import signal
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ini = tmp_path / f"{tier}.ini"
    if tier == "server":
        ini.write_text(f"[Service]\nListenAddr=127.0.0.1\nListenPort={port}\n"
                       "[Index]\nList=main\n"
                       f"[Index_main]\nIndexFolder={shards[0]}\n")
        cmd = ["-m", "sptag_tpu_torch.serve.server", "-m", "socket", "-c",
               str(ini), "--device", "cpu"]
    else:
        ini.write_text(f"[Service]\nListenAddr=127.0.0.1\nListenPort={port}\n"
                       "[Servers]\nNumber=0\n")
        cmd = ["-m", "sptag_tpu_torch.serve.aggregator", "-c", str(ini)]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable] + cmd, cwd=repo,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, proc.stderr.read()
            try:
                out = _exchange(("127.0.0.1", port),
                                [_frame(jwire.PacketType.RegisterRequest)])
                break
            except OSError:
                assert time.time() < deadline
                time.sleep(0.2)
        assert jwire.PacketHeader.unpack(out[0][:16]).packet_type == \
            jwire.PacketType.RegisterResponse
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
