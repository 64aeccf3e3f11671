"""repro_torch.obs: tracing, metrics and the drift ledger, the port of
``repro/obs``.

Three planes, one ambient context:

* :class:`Tracer` (``trace.py``): typed span and instant events over the
  execution taxonomy, an injectable clock, JSON lines and Chrome
  trace-event export. Disabled by default (:class:`NullTracer`).
* :class:`MetricsRegistry` (``metrics.py``): counters, gauges and
  histograms behind ``SolverService.stats()`` and the executor's counters,
  with Prometheus text exposition
  (``repro_torch.runtime.server.start_metrics_server``).
* :class:`DriftLedger` (``ledger.py``): the persisted
  ``(problem, device, torch) -> plan -> predicted/measured`` database
  that ``autotune`` reads to skip re-measurement and ``plan_candidates``
  consults to re-rank.

The ambient context (``get_tracer``/``use_tracer`` and friends) is how
the instrumentation reaches the executor without threading arguments
through every call: the default tracer is a null object and the default
ledger is None, so an uninstrumented process pays one attribute check a
site.
"""
from __future__ import annotations

import contextlib
from typing import Optional

from repro_torch.obs.ledger import (
    DEFAULT_DRIFT_THRESHOLD,
    DriftLedger,
    LedgerRecord,
    device_name,
    plan_signature,
    prediction_ratio,
    problem_key,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import (
    CATEGORIES,
    NullTracer,
    TraceEvent,
    Tracer,
)

# -- ambient observability context --------------------------------------------

_NULL_TRACER = NullTracer()
_tracer: Tracer = _NULL_TRACER
_metrics: MetricsRegistry = MetricsRegistry()
_ledger: Optional[DriftLedger] = None


def get_tracer() -> Tracer:
    """The ambient tracer (a no-op :class:`NullTracer` unless installed)."""
    return _tracer


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install ``tracer`` as the ambient tracer (None restores the null
    tracer); returns the previous one."""
    global _tracer
    prev = _tracer
    _tracer = tracer if tracer is not None else _NULL_TRACER
    return prev


def get_metrics() -> MetricsRegistry:
    """The ambient metrics registry (a real, process-global registry:
    counters are cheap; scope one with :func:`use_metrics` where isolation
    matters, as in the determinism tests)."""
    return _metrics


def set_metrics(registry: Optional[MetricsRegistry]) -> MetricsRegistry:
    global _metrics
    prev = _metrics
    _metrics = registry if registry is not None else MetricsRegistry()
    return prev


def get_ledger() -> Optional[DriftLedger]:
    """The ambient drift ledger, or None (recording disabled)."""
    return _ledger


def set_ledger(ledger: Optional[DriftLedger]) -> Optional[DriftLedger]:
    global _ledger
    prev = _ledger
    _ledger = ledger
    return prev


@contextlib.contextmanager
def use_tracer(tracer: Tracer):
    """Scope an ambient tracer: ``with use_tracer(tr): execute(...)``."""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


@contextlib.contextmanager
def use_metrics(registry: MetricsRegistry):
    prev = set_metrics(registry)
    try:
        yield registry
    finally:
        set_metrics(prev)


@contextlib.contextmanager
def use_ledger(ledger: DriftLedger):
    prev = set_ledger(ledger)
    try:
        yield ledger
    finally:
        set_ledger(prev)


__all__ = [
    "CATEGORIES",
    "Counter",
    "DEFAULT_DRIFT_THRESHOLD",
    "DriftLedger",
    "Gauge",
    "Histogram",
    "LedgerRecord",
    "MetricsRegistry",
    "NullTracer",
    "TraceEvent",
    "Tracer",
    "device_name",
    "get_ledger",
    "get_metrics",
    "get_tracer",
    "plan_signature",
    "prediction_ratio",
    "problem_key",
    "set_ledger",
    "set_metrics",
    "set_tracer",
    "use_ledger",
    "use_metrics",
    "use_tracer",
]
