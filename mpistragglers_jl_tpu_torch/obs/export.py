"""Live telemetry endpoint: scrape the running coordinator over HTTP.

The registry and timeline exist only in coordinator memory until
someone calls a ``dump_*`` at end-of-run — useless for a production
coordinator, which is operated while it runs. This module is
the serving side of the observability subsystem: a
``ThreadingHTTPServer`` on its own daemon threads (the pool / scheduler
hot path never blocks on a scrape) exposing

==================  ====================================================
``GET /metrics``    live Prometheus 0.0.4 exposition of the registry
                    (cross-process series included — the aggregation
                    layer merges worker frames into the SAME registry)
``/metrics.json``   the registry's JSON snapshot
``/healthz``        pluggable health checks, per-check status + age;
                    HTTP 200 when all pass, 503 otherwise
``/trace``          on-demand merged Chrome/Perfetto trace of every
                    registered tracer/recorder (plus the per-worker
                    recorders of registered aggregators and the
                    request-cohort tracks of registered trace books)
``/trace/<id>``     one request's causal waterfall (JSON): every typed
                    lifecycle event with door-relative ``dt``, derived
                    ttft/latency, cohort, retry lineage
``/audit``          the conservation audit over every registered trace
                    book — invariant pass/fail with offending ids
``/flight``         the flight recorder's ring as a Chrome trace
==================  ====================================================

Binding defaults to loopback + port 0 (ephemeral): telemetry must never
accidentally become an open network listener — exposing it beyond the
host is an explicit ``host=`` decision, exactly the native transport's
auth posture.

Stdlib-only (``http.server`` + ``json``), and opt-in like everything
else in ``obs/``: layers take ``exporter=None`` and a dark construction
pays only the ``is None`` check. Passing ``exporter=`` to
``ProcessBackend`` / ``ServingScheduler`` / ``HedgedServer`` /
``RequestRouter`` registers the standard health checks and trace
sources automatically (the router's is the aggregate fleet check:
per-replica status in the detail, 503 only when no replica is
admittable); anything else uses :meth:`ObsServer.add_health` /
:meth:`~ObsServer.add_recorder` directly.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

from .timeline import merged_chrome_trace

__all__ = ["ObsServer", "HealthCheck"]

# fn() -> (ok, detail)
HealthFn = Callable[[], "tuple[bool, str]"]


class HealthCheck:
    """One named liveness probe with status history.

    ``age_s`` in the ``/healthz`` payload is how long the check has
    been in its CURRENT status (seconds since the last ok<->fail
    flip) — an operator reading ``ok: false, age_s: 412`` knows the
    pool has been degraded for ~7 minutes, not just that it is now.
    """

    def __init__(self, name: str, fn: HealthFn):
        self.name = str(name)
        self.fn = fn
        self._lock = threading.Lock()
        self._status: bool | None = None
        self._since = time.perf_counter()

    def probe(self) -> dict[str, Any]:
        try:
            ok, detail = self.fn()
            ok = bool(ok)
        except Exception as e:  # a raising probe IS a failing probe
            ok, detail = False, f"probe raised: {type(e).__name__}: {e}"
        now = time.perf_counter()
        with self._lock:
            if ok != self._status:
                self._status = ok
                self._since = now
            age = now - self._since
        return {"ok": ok, "detail": str(detail),
                "age_s": round(age, 3)}


class ObsServer:
    """The telemetry plane: one HTTP endpoint over live registries,
    timelines, health checks, and the flight recorder.

    >>> srv = ObsServer(registry).start()          # 127.0.0.1, port 0
    >>> print(srv.url)                             # http://127.0.0.1:NNNNN
    >>> # curl $url/metrics | curl $url/healthz | curl $url/trace
    >>> srv.close()

    Everything is registered by reference — a scrape reads the CURRENT
    state (the registry's instruments are individually locked; span
    recorder lists are append-only), so ``/metrics`` mid-run shows the
    run so far, not a stale snapshot. ``start()`` is idempotent and
    returns self; the server is also a context manager.
    """

    def __init__(self, registry=None, *, host: str = "127.0.0.1",
                 port: int = 0, flight=None):
        self.registry = registry
        self.host = str(host)
        self._want_port = int(port)
        self.flight = flight
        self._tracers: list = []
        self._recorders: list = []
        self._aggregators: list = []
        self._books: list = []
        self._series: list = []
        self._slos: list = []
        self._checks: dict[str, HealthCheck] = {}
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- sources ----------------------------------------------------------
    def add_health(self, name: str, fn: HealthFn) -> "ObsServer":
        """Register (or replace) probe ``name``; ``fn() -> (ok,
        detail)`` runs on scrape threads, so it must only READ shared
        state."""
        self._checks[str(name)] = HealthCheck(name, fn)
        return self

    def add_tracer(self, tracer) -> "ObsServer":
        """An :class:`~..utils.trace.EpochTracer` for ``/trace``."""
        self._tracers.append(tracer)
        return self

    def add_recorder(self, recorder) -> "ObsServer":
        """A :class:`~.timeline.SpanRecorder` for ``/trace``."""
        self._recorders.append(recorder)
        return self

    def add_aggregator(self, agg) -> "ObsServer":
        """A :class:`~.aggregate.TelemetryAggregator` whose per-worker
        recorders join ``/trace`` (one pid per worker process)."""
        self._aggregators.append(agg)
        return self

    def add_tracebook(self, book) -> "ObsServer":
        """A :class:`~.tracing.TraceBook`: its request-cohort tracks
        join ``/trace``, its waterfalls serve ``/trace/<id>``, and the
        conservation audit over it serves ``/audit``."""
        self._books.append(book)
        return self

    def add_series(self, store) -> "ObsServer":
        """A :class:`~.series.SeriesStore`: its windows serve
        ``/series`` and its per-window counter tracks join ``/trace``
        (the recorder contract — one Perfetto pid per store)."""
        self._series.append(store)
        return self

    def add_slo(self, policy) -> "ObsServer":
        """A :class:`~.slo.SloPolicy`: objectives, burn rates, the
        alert timeline, and the cost ledger serve ``/slo`` — 503 while
        any fast-burn alert is firing, the paging contract. The
        policy's store also joins ``/series`` (once)."""
        self._slos.append(policy)
        if policy.series not in self._series:
            self.add_series(policy.series)
        return self

    def _unique_name(self, base: str) -> str:
        """``base``, suffixed if taken: two backends sharing one
        server must yield TWO checks ('pool', 'pool-2'), never one
        silently replacing the other's monitoring."""
        if base not in self._checks:
            return base
        i = 2
        while f"{base}-{i}" in self._checks:
            i += 1
        return f"{base}-{i}"

    # -- standard registrations (the exporter= kwarg protocol) ------------
    def register_backend(self, backend, name: str = "pool") -> None:
        """Wire a process backend in: a worker-deadness health check
        (``ok`` iff no rank is currently dead — flips on kill, recovers
        on ``respawn``) plus its aggregator's trace sources. The check
        name is uniquified (``pool``, ``pool-2``, ...) so several
        backends on one server all stay monitored."""
        name = self._unique_name(name)

        def check():
            dead = sorted(backend.dead_workers())
            n = backend.n_workers
            if dead:
                return False, f"dead workers {dead} of {n}"
            return True, f"{n}/{n} workers alive"

        self.add_health(name, check)
        agg = getattr(backend, "aggregator", None)
        if agg is not None:
            self.add_aggregator(agg)

    def register_scheduler(
        self, sched, name: str = "scheduler",
        max_tick_age_s: float = 30.0,
    ) -> None:
        """Wire a :class:`~..models.serving.ServingScheduler` in: a
        tick-freshness health check (unhealthy when work is pending but
        the last tick is older than ``max_tick_age_s`` — the stuck-
        scheduler signature) and its span recorder, if any. Also turns
        the scheduler's tick stamping ON: registering a previously dark
        scheduler must make ``last_tick_at`` live, or this very check
        would report an actively-ticking scheduler as stuck forever.
        The check name is uniquified like ``register_backend``'s."""
        name = self._unique_name(name)
        # deliberately unguarded: a scheduler that cannot stamp ticks
        # cannot honor this health check — better an AttributeError at
        # registration than a permanent false 503 at scrape time
        sched.enable_tick_stamping()

        def check():
            last = sched.last_tick_at
            busy = sched.active > 0 or sched.pending > 0
            if last is None:
                if busy:
                    return False, "work queued but never ticked"
                return True, "no ticks yet (idle)"
            age = time.perf_counter() - last
            if busy and age > max_tick_age_s:
                return False, (
                    f"last tick {age:.1f}s ago with {sched.pending} "
                    f"queued / {sched.active} active"
                )
            return True, f"tick {sched.tick_count}, {age:.1f}s ago"

        self.add_health(name, check)
        obs = getattr(sched, "_obs", None)
        spans = getattr(obs, "spans", None)
        if spans is not None:
            self.add_recorder(spans)

    def register_router(
        self, router, name: str = "router",
        max_tick_age_s: float = 30.0,
    ) -> None:
        """Wire a :class:`~..models.router.RequestRouter` in: ONE
        aggregate fleet check that reports every replica's status in
        its detail (routable / ejected / tick-staleness via the
        replica's ``last_tick_at``, the ``register_scheduler``
        freshness signal) but goes 503 ONLY when no replica is
        admittable — a fleet that lost one replica of four is degraded
        detail, not an outage (the router is already routing around
        it; per-replica 503s would page an operator for a condition
        the system self-heals). The check name is uniquified like
        ``register_backend``'s."""
        name = self._unique_name(name)

        def check():
            statuses = router.replica_statuses(
                max_tick_age_s=max_tick_age_s
            )
            up = sum(ok for ok, _ in statuses)
            detail = "; ".join(
                f"replica {i}: {d}"
                for i, (_, d) in enumerate(statuses)
            )
            if up == 0:
                return False, (
                    f"0/{len(statuses)} replicas routable — {detail}"
                )
            return True, (
                f"{up}/{len(statuses)} replicas routable — {detail}"
            )

        self.add_health(name, check)
        book = getattr(router, "_trace", None)
        if book is not None:
            self.add_tracebook(book)

    def register_hedge(self, srv, name: str = "hedge") -> None:
        """Wire a :class:`~..utils.hedge.HedgedServer` in: replica
        health (unhealthy while any rank is benched dead — repair with
        ``backend.respawn`` + ``reset_dead`` recovers it). The check
        name is uniquified like ``register_backend``'s."""
        name = self._unique_name(name)

        def check():
            dead = sorted(srv.dead_replicas)
            n = srv.backend.n_workers
            if dead:
                return False, f"replicas {dead} of {n} benched dead"
            return True, f"{n}/{n} replicas in rotation"

        self.add_health(name, check)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ObsServer":
        if self._httpd is not None:
            return self
        self._httpd = ThreadingHTTPServer(
            (self.host, self._want_port), _Handler
        )
        self._httpd.daemon_threads = True
        self._httpd.obs = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="obs-server",
        )
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        """The bound port (resolves port-0 binds); 0 before start()."""
        return 0 if self._httpd is None else self._httpd.server_port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "ObsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- endpoint payloads (shared by the handler and direct callers) -----
    def healthz(self) -> tuple[bool, dict[str, Any]]:
        # snapshot first (GIL-atomic): layers register checks from the
        # main thread while scrape threads evaluate — iterating the
        # live dict would raise mid-registration and 500 a healthy
        # system
        checks = {
            name: chk.probe()
            for name, chk in list(self._checks.items())
        }
        ok = all(c["ok"] for c in checks.values())
        return ok, {"ok": ok, "checks": checks}

    def trace_doc(self) -> dict[str, Any]:
        # same snapshot discipline as healthz: sources register while
        # scrapes run. TraceBook satisfies the recorder contract
        # (chrome_events(pid) -> (meta, events)), so books merge as
        # one more process each — request-cohort tracks alongside the
        # component spans.
        recorders = list(self._recorders)
        for agg in list(self._aggregators):
            recorders.extend(agg.recorders())
        recorders.extend(self._books)
        recorders.extend(self._series)
        doc, _ = merged_chrome_trace(
            tracers=list(self._tracers), recorders=recorders
        )
        return doc

    def trace_waterfall(self, tid: int) -> dict[str, Any] | None:
        """The ``GET /trace/<id>`` body: the waterfall from the first
        registered book holding ``tid`` (books partition id spaces by
        serving plane; None when no book knows the id)."""
        for book in list(self._books):
            if tid in book:
                return book.waterfall(tid)
        return None

    def audit_doc(self) -> dict[str, Any]:
        """The ``GET /audit`` body: the conservation audit over every
        registered book, against the attached registry."""
        from .audit import audit

        books = list(self._books)
        if not books:
            return {"error": "no trace book registered"}
        out = {
            "ok": True,
            "books": [],
        }
        for book in books:
            res = audit(book, None, self.registry)
            doc = res.to_dict()
            doc["book"] = book.name
            doc["view"] = book.audit_view()
            out["books"].append(doc)
            out["ok"] = out["ok"] and res.ok
        return out

    def series_doc(self) -> dict[str, Any]:
        """The ``GET /series`` body: every registered store's window
        ring (module-level JSON export, one entry per store)."""
        stores = list(self._series)
        if not stores:
            return {"error": "no series store registered"}
        return {"stores": [s.to_doc() for s in stores]}

    def slo_doc(self) -> tuple[bool, dict[str, Any]]:
        """The ``GET /slo`` body: ``ok`` is False — and the endpoint
        503s — while ANY registered policy has a fast-burn alert
        firing (mirrors ``/healthz``/``/audit`` degradation)."""
        policies = list(self._slos)
        if not policies:
            return True, {"error": "no slo policy registered"}
        docs = [p.to_doc() for p in policies]
        ok = all(d["ok"] for d in docs)
        return ok, {"ok": ok, "policies": docs}

    def __repr__(self) -> str:
        state = self.url if self._httpd is not None else "stopped"
        return (
            f"ObsServer({state}, {len(self._checks)} health checks, "
            f"{len(self._tracers) + len(self._recorders)} trace "
            "sources)"
        )


class _Handler(BaseHTTPRequestHandler):
    """Route table for one scrape. Runs on the server's daemon threads;
    every handler only READS registered objects."""

    server_version = "mpistragglers-obs/1.0"

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200) -> None:
        # default=repr: flight/trace span args are arbitrary user
        # objects — one unserializable value must degrade to its repr,
        # not 500 the whole scrape
        self._send(code, json.dumps(obj, default=repr).encode(),
                   "application/json; charset=utf-8")

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        obs: ObsServer = self.server.obs  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                if obs.registry is None:
                    self._send(404, b"no registry attached\n",
                               "text/plain")
                    return
                self._send(
                    200, obs.registry.to_prometheus().encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            elif path == "/metrics.json":
                if obs.registry is None:
                    self._json({"error": "no registry attached"}, 404)
                    return
                self._json(obs.registry.snapshot())
            elif path in ("/healthz", "/health"):
                ok, doc = obs.healthz()
                self._json(doc, 200 if ok else 503)
            elif path == "/trace":
                self._json(obs.trace_doc())
            elif path.startswith("/trace/"):
                raw = path[len("/trace/"):]
                try:
                    tid = int(raw)
                except ValueError:
                    self._json(
                        {"error": f"bad trace id {raw!r}"}, 400
                    )
                    return
                doc = obs.trace_waterfall(tid)
                if doc is None:
                    self._json(
                        {"error": f"unknown trace id {tid}"}, 404
                    )
                    return
                self._json(doc)
            elif path == "/audit":
                doc = obs.audit_doc()
                if "error" in doc:
                    self._json(doc, 404)
                    return
                self._json(doc, 200 if doc["ok"] else 503)
            elif path == "/flight":
                if obs.flight is None:
                    self._json({"error": "no flight recorder"}, 404)
                    return
                self._json(obs.flight.snapshot())
            elif path == "/series":
                doc = obs.series_doc()
                if "error" in doc:
                    self._json(doc, 404)
                    return
                self._json(doc)
            elif path == "/slo":
                ok, doc = obs.slo_doc()
                if "error" in doc:
                    self._json(doc, 404)
                    return
                self._json(doc, 200 if ok else 503)
            elif path == "/":
                self._json({
                    "endpoints": ["/metrics", "/metrics.json",
                                  "/healthz", "/trace", "/trace/<id>",
                                  "/audit", "/flight", "/series",
                                  "/slo"],
                })
            else:
                self._send(404, b"not found\n", "text/plain")
        except BrokenPipeError:  # scraper went away mid-write
            pass
        except Exception as e:  # telemetry must never take the run down
            try:
                self._json(
                    {"error": f"{type(e).__name__}: {e}"}, 500
                )
            except Exception:
                pass

    def log_message(self, *args) -> None:  # silence per-scrape stderr
        pass
