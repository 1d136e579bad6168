"""Metrics exposition endpoint — a tiny stdlib HTTP listener (copy of
``sptag_tpu/serve/metrics_http.py`` over the port's utils).

Both serving front-ends (serve/server.py, serve/aggregator.py) own one of
these when their `MetricsPort` is set:

* ``GET /metrics`` — the process-wide registry (utils/metrics.py) in
  Prometheus text format 0.0.4: request/error counters, queue gauges, and
  every trace-span latency as a log-bucketed histogram; plus the
  self-rendered labeled series the shared registry can't express — the
  device-memory ledger, the quality windows and (when the contention
  ledger is on) ``lock_wait_ms{name=}`` / ``lock_hold_ms{name=}`` per-lock
  gauges (utils/locksan.py).
* ``GET /healthz`` — JSON from the owner's health callback (loaded
  indexes + sample counts for a server, backend connectivity for an
  aggregator); HTTP 200 when ``status`` is ``ok``, 503 otherwise, so load
  balancers can act on the code alone.
* ``GET /debug/flight`` — the flight recorder's ring
  (utils/flightrec.py) as Chrome trace-event JSON.
* ``GET /debug/memory`` — the card-memory ledger (utils/devmem.py),
  held against ``torch.cuda.memory_allocated``.
* ``GET /debug/admission`` — the overload-defense subsystem
  (serve/admission.py).
* ``GET /debug/mutation`` — the live-mutation subsystem.
* ``GET /debug/quality`` — the search-quality observatory
  (utils/qualmon.py).
* ``GET /debug/prof`` — the host sampling profiler (utils/hostprof.py).
  ``?action=`` selects ``snapshot`` (default; JSON state),
  ``start`` (optionally ``&hz=``/``&events=`` — arms and launches the
  sampler on demand even when ``HostProfHz`` was 0), ``stop``,
  ``flamegraph`` (collapsed-stack text/plain for flamegraph.pl /
  speedscope) and ``chrome`` (the sample ring as Chrome-trace JSON the
  flight merge CLI can overlay on device timelines).
* ``GET /debug/devicetrace`` — on-demand BOUNDED device trace: reuses
  ``trace.start_trace``/``stop_trace`` (``torch.profiler``) for
  ``?duration_ms=`` (default 500, capped at ``DEVICE_TRACE_MAX_MS``)
  and returns the trace directory (``trace.json`` inside).  One trace at
  a time in the process: while this route's or any other
  ``trace.start_trace`` trace runs (a CLI's ``--trace-report``), the
  request answers 409.

Routing is a REGISTRY (`_routes`): every endpoint is a callable
``params -> (body, content-type, status)`` and `routes()` lists the
registered paths — the surface tests/test_hostprof.py parameterizes
over.  Error paths are uniform: unknown paths answer 404 WITH a body, a
route that raises answers 500 with a text body (counted as
``metrics_http.handler_errors``) and the listener keeps serving — one
broken callback must never kill the scrape endpoint.

Port semantics: 0 = disabled (the owner never constructs this), a
negative port binds OS-ephemeral (tests read the bound port back from
``.port``).  The bind host defaults to LOOPBACK — the endpoint is
unauthenticated and /healthz discloses index configuration, so exposing
it beyond the machine is an explicit operator decision (`MetricsHost`).
The listener runs on a daemon thread (ThreadingHTTPServer — a stalled
scrape must not block the next one) and serves GETs only; it is an
operator surface, deliberately outside the wire protocol's
attack-hardened framing.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

from sptag_tpu_torch.utils import (devmem, flightrec, hostprof,  # noqa: F401
                                   locksan, metrics, qualmon, timeline)
from sptag_tpu_torch.utils import trace as trace_mod

# importing devmem/qualmon/locksan above registered their labeled-series
# providers with the metrics registry — /metrics below
# renders metrics.render_provider_families() instead of four hand-rolled
# expositions, and utils/timeline.py samples the same provider surface

log = logging.getLogger(__name__)

_JSON = "application/json"
_TEXT = "text/plain; charset=utf-8"
_PROM = "text/plain; version=0.0.4; charset=utf-8"

#: hard ceiling on one on-demand device trace (ms) — the endpoint must
#: never wedge a scrape thread on an unbounded profiling session
DEVICE_TRACE_MAX_MS = 10_000.0

#: flight-recorder / host-profiler health blocks exposed at scrape time
#: — gauges rather than counters because both subsystems' numbers reset
#: with configure()/reset() and a Prometheus counter must never go
#: backwards.  One provider per subsystem through the shared
#: labeled-series surface (the timeline sampler sees the same
#: families).  Keys are literal and bounded.
_FLIGHT_KEYS = ("enabled", "recorded", "dropped", "threads",
                "dump_errors", "dump_ratelimited")
_HOSTPROF_KEYS = ("enabled", "running", "samples", "overruns",
                  "folded_overflow")


def flight_families() -> List[metrics.Family]:
    c = flightrec.counters()
    return [metrics.Family("flight." + key).add(c.get(key, 0))
            for key in _FLIGHT_KEYS]


def hostprof_families() -> List[metrics.Family]:
    c = hostprof.counters()
    return [metrics.Family("hostprof." + key).add(c.get(key, 0))
            for key in _HOSTPROF_KEYS]


metrics.register_family_provider("flight", flight_families)
metrics.register_family_provider("hostprof", hostprof_families)


_Route = Callable[[Dict[str, str]], Tuple[bytes, str, int]]


class MetricsHttpServer:
    def __init__(self, port: int, health: Optional[Callable[[], Dict]] = None,
                 host: str = "127.0.0.1",
                 admission: Optional[Callable[[], Dict]] = None,
                 mutation: Optional[Callable[[], Dict]] = None,
                 slo: Optional[Callable[[], Dict]] = None,
                 controller: Optional[Callable[[], Dict]] = None):
        self.requested_port = port
        self.host = host
        self.health = health
        # GET /debug/admission callback (serve/admission.py): overload-
        # defense state, hedge/backoff accounting, fault-injection plan
        self.admission = admission
        # GET /debug/mutation callback: per-index swap +
        # durability state (epoch, WAL accounting, delta occupancy)
        self.mutation = mutation
        # GET /debug/slo callback (serve/slo.py): declared
        # objectives, burn rates and state per objective
        self.slo = slo
        # GET /debug/controller callback (serve/controller.py): the
        # control loop's inputs, actuator positions and the
        # bounded decision-audit ring
        self.controller = controller
        self.port: Optional[int] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._routes: Dict[str, _Route] = {
            "/metrics": self._route_metrics,
            "/healthz": self._route_healthz,
            "/debug/flight": self._route_flight,
            "/debug/memory": self._route_memory,
            "/debug/quality": self._route_quality,
            "/debug/admission": self._route_admission,
            "/debug/mutation": self._route_mutation,
            "/debug/prof": self._route_prof,
            "/debug/devicetrace": self._route_devicetrace,
            "/debug/timeline": self._route_timeline,
            "/debug/slo": self._route_slo,
            "/debug/controller": self._route_controller,
        }

    def routes(self) -> List[str]:
        """Registered paths — the parameterized-test surface: every
        entry answers a GET with its declared content-type and a body,
        and never kills the listener."""
        return sorted(self._routes)

    # ------------------------------------------------------------- routes

    @staticmethod
    def _route_metrics(params: Dict[str, str]) -> Tuple[bytes, str, int]:
        # the shared registry plus EVERY registered labeled-series
        # provider (devmem / qualmon / locksan / flight / hostprof /
        # slo / mesh-skew …) through the one formatter; an idle
        # provider renders nothing, so the off-path exposition is
        # unchanged
        body = (metrics.render_prometheus()
                + metrics.render_provider_families()).encode()
        return body, _PROM, 200

    def _route_healthz(self, params: Dict[str, str]
                       ) -> Tuple[bytes, str, int]:
        try:
            state = self.health() if self.health else {"status": "ok"}
        except Exception:                                # noqa: BLE001
            # a broken health callback must answer 500, not reset the
            # probe's connection — a load balancer reads a reset as
            # process death
            log.exception("health callback failed")
            state = {"status": "error"}
        code = (200 if state.get("status") == "ok"
                else 500 if state.get("status") == "error"
                else 503)
        return json.dumps(state).encode(), _JSON, code

    @staticmethod
    def _route_flight(params: Dict[str, str]) -> Tuple[bytes, str, int]:
        body = json.dumps(flightrec.export_chrome_trace()).encode()
        return body, _JSON, 200

    @staticmethod
    def _route_memory(params: Dict[str, str]) -> Tuple[bytes, str, int]:
        return json.dumps(devmem.snapshot()).encode(), _JSON, 200

    @staticmethod
    def _route_quality(params: Dict[str, str]) -> Tuple[bytes, str, int]:
        return json.dumps(qualmon.snapshot()).encode(), _JSON, 200

    def _route_admission(self, params: Dict[str, str]
                         ) -> Tuple[bytes, str, int]:
        try:
            state = (self.admission() if self.admission
                     else {"enabled": False})
        except Exception:                                # noqa: BLE001
            log.exception("admission callback failed")
            state = {"enabled": False, "error": True}
        return json.dumps(state).encode(), _JSON, 200

    def _route_mutation(self, params: Dict[str, str]
                        ) -> Tuple[bytes, str, int]:
        try:
            state = (self.mutation() if self.mutation
                     else {"enabled": False})
        except Exception:                                # noqa: BLE001
            log.exception("mutation callback failed")
            state = {"enabled": False, "error": True}
        return json.dumps(state).encode(), _JSON, 200

    @staticmethod
    def _route_timeline(params: Dict[str, str]) -> Tuple[bytes, str, int]:
        """GET /debug/timeline — the in-process time-series store
        (utils/timeline.py).  ``?window_s=`` bounds the
        returned points to the trailing window; ``?series=`` filters
        series by substring; ``?coarse=1`` returns the downsampled
        long-horizon rings instead of the fine ones."""
        window_s = None
        if params.get("window_s"):
            try:
                window_s = float(params["window_s"])
            except ValueError:
                return (b'{"error": "window_s must be a number"}\n',
                        _JSON, 400)
        snap = timeline.snapshot(
            window_s=window_s,
            series_filter=params.get("series") or None,
            coarse=params.get("coarse", "") in ("1", "true", "yes"))
        return json.dumps(snap).encode(), _JSON, 200

    def _route_slo(self, params: Dict[str, str]
                   ) -> Tuple[bytes, str, int]:
        try:
            state = self.slo() if self.slo else {"enabled": False}
        except Exception:                                # noqa: BLE001
            log.exception("slo callback failed")
            state = {"enabled": False, "error": True}
        return json.dumps(state).encode(), _JSON, 200

    def _route_controller(self, params: Dict[str, str]
                          ) -> Tuple[bytes, str, int]:
        try:
            state = (self.controller() if self.controller
                     else {"enabled": False})
        except Exception:                                # noqa: BLE001
            log.exception("controller callback failed")
            state = {"enabled": False, "error": True}
        return json.dumps(state).encode(), _JSON, 200

    @staticmethod
    def _route_prof(params: Dict[str, str]) -> Tuple[bytes, str, int]:
        """GET /debug/prof — host-profiler control + export surface
        (utils/hostprof.py): start/stop/snapshot/flamegraph/chrome."""
        action = params.get("action", "snapshot")
        if action == "start":
            hz = None
            if params.get("hz"):
                try:
                    hz = float(params["hz"])
                except ValueError:
                    return (b'{"error": "hz must be a number"}\n',
                            _JSON, 400)
            if params.get("events"):
                try:
                    hostprof.configure(max_samples=int(params["events"]))
                except ValueError:
                    return (b'{"error": "events must be an integer"}\n',
                            _JSON, 400)
            started = hostprof.start(
                hz_override=hz if hz is not None
                else (hostprof.hz() or hostprof.DEFAULT_HZ))
            return (json.dumps({"running": started,
                                "hz": hostprof.hz()}).encode(),
                    _JSON, 200)
        if action == "stop":
            hostprof.stop()
            return (json.dumps(hostprof.counters()).encode(), _JSON, 200)
        if action == "flamegraph":
            return hostprof.flamegraph().encode(), _TEXT, 200
        if action == "chrome":
            return (json.dumps(hostprof.export_chrome_trace()).encode(),
                    _JSON, 200)
        if action == "snapshot":
            return json.dumps(hostprof.snapshot()).encode(), _JSON, 200
        return (json.dumps({"error": f"unknown action {action!r}",
                            "actions": ["start", "stop", "snapshot",
                                        "flamegraph", "chrome"]}).encode(),
                _JSON, 400)

    @staticmethod
    def _route_devicetrace(params: Dict[str, str]
                           ) -> Tuple[bytes, str, int]:
        """GET /debug/devicetrace — one bounded ``torch.profiler`` trace
        via trace.start_trace/stop_trace; blocks THIS scrape thread for
        the (capped) duration and returns the trace dir.  409 while
        another trace runs: ``torch.profiler`` is process-global, and
        trace.start_trace holds the one process-wide trace lock."""
        try:
            duration_ms = float(params.get("duration_ms", "500"))
        except ValueError:
            return (b'{"error": "duration_ms must be a number"}\n',
                    _JSON, 400)
        duration_ms = max(1.0, min(duration_ms, DEVICE_TRACE_MAX_MS))
        made = not params.get("dir")
        logdir = params.get("dir") or tempfile.mkdtemp(
            prefix="sptag-devicetrace-")
        try:
            trace_mod.start_trace(logdir)
        except trace_mod.TraceBusy:
            if made:
                os.rmdir(logdir)
            return (b'{"error": "a device trace is already running"}\n',
                    _JSON, 409)
        try:
            time.sleep(duration_ms / 1000.0)
        finally:
            trace_mod.stop_trace()
        metrics.inc("metrics_http.device_traces")
        return (json.dumps({"dir": logdir,
                            "duration_ms": duration_ms}).encode(),
                _JSON, 200)

    # ---------------------------------------------------------- lifecycle

    def start(self) -> int:
        """Bind and serve on a daemon thread; returns the bound port."""
        owner = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                            # noqa: N802
                # ThreadingHTTPServer mints anonymous "Thread-N" workers;
                # name them so profiler samples and thread dumps read
                # (the no-anonymous-threads contract)
                cur = threading.current_thread()
                if cur.name.startswith("Thread-"):
                    cur.name = "metrics-http-conn"
                path, _, qs = self.path.partition("?")
                params = {k: v[-1] for k, v in
                          urllib.parse.parse_qs(qs).items()}
                route = owner._routes.get(path)
                try:
                    if route is None:
                        body = (f"not found: {path}\n"
                                f"routes: {', '.join(owner.routes())}\n"
                                ).encode()
                        ctype, code = _TEXT, 404
                    else:
                        body, ctype, code = route(params)
                except Exception:                        # noqa: BLE001
                    # a broken route answers 500 and the listener keeps
                    # serving — counted so a flapping callback is visible
                    metrics.inc("metrics_http.handler_errors")
                    log.exception("debug route %s failed", path)
                    body = b"internal error; see server log\n"
                    ctype, code = _TEXT, 500
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except OSError:
                    # scraper hung up mid-response — its problem, not ours
                    log.debug("metrics scrape aborted by peer")

            def log_message(self, fmt, *args):           # noqa: A002
                log.debug("metrics http: " + fmt, *args)

        self._httpd = ThreadingHTTPServer(
            (self.host, max(self.requested_port, 0)), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-http", daemon=True)
        self._thread.start()
        log.info("metrics endpoint on %s:%d (/metrics, /healthz)",
                 self.host, self.port)
        return self.port

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
