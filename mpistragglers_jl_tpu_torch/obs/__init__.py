"""Runtime observability: registry, timeline, causal tracing, the SLO
plane and the live telemetry endpoint.

Copies of the JAX package's ``obs/`` modules (the port imports nothing
of it), with byte-identical output formats: Prometheus text, JSON and
Chrome/Perfetto trace dicts.

* :mod:`.metrics`: a thread-safe series store (counters, gauges, fixed
  log-bucket histograms) with JSON and Prometheus text exports.
* :mod:`.timeline`: host-side spans (scheduler ticks, training steps)
  merged with :class:`~..utils.trace.EpochTracer` pool timelines into
  one Chrome/Perfetto trace; :func:`annotate` is the port's own, a
  ``torch.profiler.record_function`` (and NVTX) range.
* :mod:`.flight`: a bounded ring of recent spans, events and counters,
  dumped on watchdog stalls, deadline expiries and exit.
* :mod:`.tracing` and :mod:`.audit`: one typed event list per request
  (:class:`TraceBook`) and the conservation audit over it.
* :mod:`.series` and :mod:`.slo`: windowed time series of a registry
  and error-budget burn-rate alerting over them.
* :mod:`.export`: :class:`ObsServer`, the registry, health checks,
  merged trace, audit, series, SLOs and flight ring over HTTP.

* :mod:`.aggregate`: worker-local telemetry (:class:`WorkerTelemetry`)
  of OS worker processes, merged coordinator-side under a ``worker``
  label with clock-aligned spans (:class:`TelemetryAggregator`).

Everything is opt-in: the instrumented layers (``ServingScheduler``,
``CodedGradTrainer``, ``CodedGemm``) take ``registry=`` / ``spans=`` /
``exporter=`` / ``flight=`` / ``trace=`` and do no work beyond
``is None`` checks when none is passed. Stdlib-only at import.
"""

from .aggregate import OBS_TAG, TelemetryAggregator, WorkerTelemetry
from .audit import AuditFailure, AuditResult, audit
from .export import HealthCheck, ObsServer
from .flight import FlightRecorder, FlightWatchdog
from .metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from .series import SeriesStore
from .slo import SloObjective, SloPolicy
from .timeline import (
    SpanRecorder,
    annotate,
    dump_merged_chrome_trace,
    merged_chrome_trace,
)
from .tracing import TERMINAL_KINDS, TraceBook

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_BUCKETS",
    "SpanRecorder",
    "annotate",
    "dump_merged_chrome_trace",
    "merged_chrome_trace",
    "ObsServer",
    "HealthCheck",
    "FlightRecorder",
    "FlightWatchdog",
    "SeriesStore",
    "SloObjective",
    "SloPolicy",
    "TraceBook",
    "TERMINAL_KINDS",
    "audit",
    "AuditResult",
    "AuditFailure",
    "OBS_TAG",
    "WorkerTelemetry",
    "TelemetryAggregator",
]
