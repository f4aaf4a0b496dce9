"""obs/ — unified run telemetry.

The Spark-UI/event-log counterpart: every long path publishes structured
events onto one process-global bus (:mod:`obs.events`), host phases open
context-propagated spans bridged to ``torch.profiler.record_function``
(:mod:`obs.trace`), and a traced run writes a crash-safe per-event-flushed
JSONL trace plus a startup/exit manifest (:mod:`obs.runtime`,
:mod:`obs.manifest`).  ``tools/trace_report.py`` (stdlib-only) reconstructs
per-phase wall-time breakdowns, retry tallies per site and the last
incomplete span from a trace file.

Counterpart of the JAX package's ``obs/``, with the same surface and the
same event and span names, so one trace reader serves both.
``events``, ``runtime``, ``metrics``, ``export`` and ``federation`` are
copies of the JAX package's stdlib modules; ``trace`` and ``manifest``
read ``torch`` where those read ``jax``.

Spark-UI correspondence:

==========================  =============================================
Spark                       here
==========================  =============================================
event log                   ``<name>.<pid>.trace.jsonl`` (JSONL sink)
application page / conf     ``<name>.<pid>.manifest.json``
stage/task timeline         spans (``obs.span("tfidf.pipeline")``)
stage counters              ``obs.counter/gauge/histogram`` + run summary
==========================  =============================================

Env knobs: ``GRAFT_TRACE_DIR`` (default trace directory — a run started
with no explicit dir writes here; unset = in-memory only) and
``GRAFT_LOG_LEVEL`` (stderr log level, utils/metrics.py).  Both declared
in ``utils/config.GRAFT_ENV_KNOBS``.
"""

from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.events import (
    Aggregates,
    EventBus,
    JsonlSink,
    MemorySink,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.manifest import knob_snapshot
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.runtime import (
    Run,
    bus,
    counter,
    current_run,
    emit,
    end_run,
    gauge,
    histogram,
    run,
    span,
    start_run,
    tracer,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.trace import SpanTracer

# Live SLO instruments: rolling-window histograms / error budgets
# (obs.metrics) and the pull-based HTTP snapshot surface (obs.export).  Imported after runtime so their obs-package imports see
# a fully-initialized module.
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs import export  # noqa: E402
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs import federation  # noqa: E402
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs import metrics  # noqa: E402
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.federation import (  # noqa: E402
    FleetHub,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.metrics import (  # noqa: E402
    ErrorBudget,
    MetricsHub,
    RollingHistogram,
    StreamingHistogram,
    TelemetrySink,
    WindowedCounter,
)

__all__ = [
    "Aggregates",
    "ErrorBudget",
    "EventBus",
    "FleetHub",
    "JsonlSink",
    "MemorySink",
    "MetricsHub",
    "RollingHistogram",
    "Run",
    "SpanTracer",
    "StreamingHistogram",
    "TelemetrySink",
    "WindowedCounter",
    "export",
    "federation",
    "metrics",
    "bus",
    "counter",
    "current_run",
    "emit",
    "end_run",
    "gauge",
    "histogram",
    "knob_snapshot",
    "run",
    "span",
    "start_run",
    "tracer",
]
