"""Pull-based live-metrics surface: a tiny stdlib HTTP endpoint over a
:class:`obs.metrics.MetricsHub`.

A copy of the JAX package's ``obs/export.py`` (stdlib), so the port never
imports that package, with one statement added: a draining listener
closes right after its backlog sweep (``_ReusePortHTTPServer``).

Reference counterpart: the Spark UI's REST endpoint — you point a browser
(or ``tools/slo_watch.py``, or a Prometheus scraper) at a *running*
application and read its live stage/SLA numbers without touching the run.
Here:

- ``GET /snapshot.json`` — the hub's full JSON snapshot (rolling-window
  latency quantiles, counters/rates, gauges, error budgets);
- ``GET /metrics`` — the same state as Prometheus text exposition;
- ``GET /healthz`` — liveness (``ok``).

The port comes from the ``GRAFT_METRICS_PORT`` env knob (declared in
``utils/config.GRAFT_ENV_KNOBS``; ``cli.serve`` and ``serving/soak.py``
read it): unset/empty means "no exporter" for
the from-env helpers; ``0`` binds an ephemeral port (the soak harness
uses this so parallel runs never collide — the bound port is published in
the ``metrics_export`` event and the SLO record).  The server binds
127.0.0.1 only: this is an operator's inspection hatch, not a public
listener.

Wiring is one call::

    hub = obs.metrics.MetricsHub(window_s=60)
    obs.bus().attach(obs.metrics.TelemetrySink(hub))   # live fold-in
    exporter = obs.export.MetricsExporter(hub, port=9109).start()
    ...
    exporter.stop()

or, for the common "serve the process-default hub when the knob is set"
case, :func:`serve_metrics_from_env`.
"""

from __future__ import annotations

import json
import os
import selectors
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs import runtime as _rt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.metrics import (
    MetricsHub,
    TelemetrySink,
)


def _make_handler(hub: MetricsHub, *, routes=None, ready=None):
    """The handler class behind :class:`MetricsExporter`.

    ``routes`` extends the surface without forking the endpoint: a dict
    mapping ``(method, path)`` (e.g. ``("POST", "/query")``) to a
    callable ``body_bytes -> (status, content_type, body_str)`` — the
    serving-fabric replica rides its query/status API on the same server
    (and the same ``graft-metrics-http`` thread) as its health checks.
    ``ready`` is an optional zero-arg readiness predicate: when it
    returns False, ``/healthz`` answers 503 — a replica that is still
    warming, or is held below the fleet's committed generation floor,
    reports itself unroutable through the SAME endpoint the router
    health-checks."""
    routes = routes or {}

    class Handler(BaseHTTPRequestHandler):
        server_version = "graft-metrics/1"

        def log_message(self, *args) -> None:  # quiet: stderr is the run's
            pass

        def _send(self, code: int, body: str, ctype: str) -> None:
            data = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _dispatch(self, method: str, body: bytes) -> None:
            path = self.path.split("?", 1)[0]
            try:
                fn = routes.get((method, path))
                if fn is not None:
                    code, ctype, payload = fn(body)
                    self._send(code, payload, ctype)
                elif method == "GET" and path in ("/snapshot.json",
                                                  "/snapshot", "/json"):
                    self._send(200, json.dumps(hub.snapshot(), default=float),
                               "application/json")
                elif method == "GET" and path == "/metrics":
                    self._send(200, hub.prometheus(),
                               "text/plain; version=0.0.4")
                elif method == "GET" and path in ("/", "/healthz"):
                    if ready is not None and not ready():
                        self._send(503, "unready\n", "text/plain")
                    else:
                        self._send(200, "ok\n", "text/plain")
                else:
                    self._send(404, "not found\n", "text/plain")
            except Exception as exc:  # noqa: BLE001 — never kill the server
                try:
                    self._send(500, f"{type(exc).__name__}: {exc}\n",
                               "text/plain")
                except Exception:  # noqa: BLE001 — client already gone
                    pass

        def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
            self._dispatch("GET", b"")

        def do_POST(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
            n = int(self.headers.get("Content-Length") or 0)
            self._dispatch("POST", self.rfile.read(n) if n else b"")

    return Handler


def reuse_port_supported() -> bool:
    """Whether this platform exposes ``SO_REUSEPORT`` — the kernel-level
    listener-group steering the fabric's drain handoff rides on.  Where
    it is missing (some non-Linux platforms) callers fall back to the
    retry-carried roll."""
    return hasattr(socket, "SO_REUSEPORT")


class _ReusePortHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that joins an ``SO_REUSEPORT`` listener group
    before binding: a successor process can bind the SAME port while the
    predecessor still serves, and the kernel steers each new connection
    to exactly one of them — the zero-downtime drain-handoff transport
    (serving/fabric.py rolling_restart)."""

    def server_bind(self) -> None:
        if reuse_port_supported():
            self.socket.setsockopt(
                socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()

    def serve_forever(self, poll_interval: float = 0.5) -> None:
        """socketserver's loop checks the shutdown flag BEFORE accepting
        a ready connection, so a handshake already queued in this
        listener's backlog when shutdown() lands is abandoned and RST on
        close — in a reuseport group that is one spurious client reset
        per drain, i.e. one roll-attributed retry.  Reorder to
        accept-then-check and sweep the backlog dry with a zero-timeout
        select before exiting, so the socket closes empty and the drain
        truly hands every steered connection off.

        The port closes the listening socket on this thread right after
        the sweep (the reference leaves it to ``server_close()`` after
        ``shutdown()`` returns), where the kernel can still queue a
        connection that the later close resets: a roll-attributed retry
        under load (ROADMAP Queue 3;
        ``tests/test_torch_drain_cache.py``, the 16-client rolls)."""
        self._BaseServer__is_shut_down.clear()  # graftlint: disable=unsynced-thread-state (threading.Event is internally locked; stdlib serve_forever mutates the same pair lock-free)
        try:
            with selectors.SelectSelector() as selector:
                selector.register(self, selectors.EVENT_READ)
                while not self._BaseServer__shutdown_request:
                    if selector.select(poll_interval):
                        self._handle_request_noblock()
                    self.service_actions()
                while selector.select(0):
                    self._handle_request_noblock()
                self.socket.close()  # leave the group now (docstring)
        finally:
            self._BaseServer__shutdown_request = False  # graftlint: disable=unsynced-thread-state (single-writer handshake flag; shutdown() only ever sets it True and blocks on the event below)
            self._BaseServer__is_shut_down.set()  # graftlint: disable=unsynced-thread-state (threading.Event is internally locked)


class MetricsExporter:
    """Background HTTP server publishing one hub's live snapshot.

    ``port=0`` binds an ephemeral port; read :attr:`port` after
    :meth:`start`.  The serve loop runs on a daemon thread
    (``graft-metrics-http``); handler threads mutate nothing — every read
    goes through the hub's own locks (the ``unsynced-thread-state``
    audit surface is the hub, not the exporter)."""

    def __init__(self, hub: MetricsHub, *, port: int = 0,
                 host: str = "127.0.0.1", routes=None, ready=None,
                 reuse_port: bool = False, drain: bool = False):
        self.hub = hub
        self.host = host
        self.port = int(port)
        self.routes = routes
        self.ready = ready
        # reuse_port: bind into an SO_REUSEPORT listener group so a
        # successor can share the port during a drain handoff.  drain:
        # handler threads become non-daemon and stop() blocks until every
        # in-flight request has been answered (ThreadingMixIn's
        # block_on_close join) — the predecessor side of the handoff.
        self.reuse_port = bool(reuse_port)
        self.drain = bool(drain)
        self._srv: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> "MetricsExporter":
        if self._srv is not None:
            return self
        server_cls = (_ReusePortHTTPServer if self.reuse_port
                      else ThreadingHTTPServer)
        self._srv = server_cls(
            (self.host, self.port),
            _make_handler(self.hub, routes=self.routes, ready=self.ready),
        )
        self._srv.daemon_threads = not self.drain
        self.port = int(self._srv.server_address[1])
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="graft-metrics-http",
            daemon=True,
        )
        self._thread.start()
        _rt.emit("metrics_export", host=self.host, port=self.port)
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        srv, self._srv = self._srv, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()


# ------------------------------------------------------- process default hub

_default_lock = threading.Lock()
_default_hub: MetricsHub | None = None
_default_sink: TelemetrySink | None = None


def default_hub() -> MetricsHub:
    """The process's shared hub, lazily created and bus-attached on first
    use — any long-lived entry point (cli.serve, the soak harness) that
    calls :func:`serve_metrics_from_env` starts folding the event stream
    into it with zero publisher changes."""
    global _default_hub, _default_sink
    with _default_lock:
        if _default_hub is None:
            _default_hub = MetricsHub()
            _default_sink = TelemetrySink(_default_hub)
            _rt.bus().attach(_default_sink)
        return _default_hub


def metrics_port_from_env() -> int | None:
    """The GRAFT_METRICS_PORT knob: None = exporter disabled (unset or
    empty), 0 = ephemeral port, else the literal port."""
    raw = os.environ.get("GRAFT_METRICS_PORT")
    if raw is None or raw.strip() == "":
        return None
    return int(raw)


def serve_metrics_from_env(
    hub: MetricsHub | None = None,
) -> MetricsExporter | None:
    """Start an exporter when GRAFT_METRICS_PORT is set; None otherwise.
    With no explicit hub, serves (and implicitly bus-attaches) the
    process-default one."""
    port = metrics_port_from_env()
    if port is None:
        return None
    return MetricsExporter(hub or default_hub(), port=port).start()
