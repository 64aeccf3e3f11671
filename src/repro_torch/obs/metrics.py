"""Counter/gauge/histogram registry and Prometheus text exposition: the
port of ``repro/obs/metrics.py``.

``SolverService.stats()`` is a thin view over a registry, and the
executor records what the service layer cannot see there: executions,
barriers, fused steps per pass, bytes cached against streamed per
``CacheDecision``, runner rebuilds.

Metrics are identified by ``(name, labels)``; values are plain Python
numbers, so a :meth:`MetricsRegistry.snapshot` is a deterministic dict.
:meth:`MetricsRegistry.prometheus_text` renders the text exposition format
(version 0.0.4), the reference's byte for byte for the same calls, served
by ``repro_torch.runtime.server.start_metrics_server``.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional


def _label_key(labels: Optional[dict]) -> tuple:
    return tuple(sorted((labels or {}).items()))


def _label_str(labelkey: tuple) -> str:
    if not labelkey:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labelkey)
    return "{" + inner + "}"


class Counter:
    """Monotonically increasing value."""

    kind = "counter"

    def __init__(self):
        self.value: float = 0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up; got inc({n})")
        self.value += n


class Gauge:
    """A value that can go anywhere."""

    kind = "gauge"

    def __init__(self):
        self.value: float = 0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n

    def dec(self, n: float = 1) -> None:
        self.value -= n


class Histogram:
    """Sample accumulator reporting count/sum/mean and nearest-rank
    percentiles (the reference's rule, so p50/p99 are the same numbers
    under an injected clock)."""

    kind = "histogram"

    def __init__(self):
        self.samples: list[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self) -> float:
        return math.fsum(self.samples)

    @property
    def mean(self) -> float:
        return self.sum / max(1, self.count)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile; 0.0 for an empty sample."""
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        rank = max(1, math.ceil(q * len(xs)))
        return xs[min(len(xs), rank) - 1]


class MetricsRegistry:
    """Named metrics, created on first use and shared thereafter.

    >>> reg = MetricsRegistry()
    >>> reg.counter("executor_barriers_total", tier="resident").inc(8)
    >>> reg.histogram("service_latency_s").observe(0.012)
    >>> reg.snapshot()["executor_barriers_total{tier=\\"resident\\"}"]
    8
    """

    def __init__(self):
        self._metrics: dict[tuple, object] = {}
        self._help: dict[str, str] = {}

    def _get(self, cls, name: str, labels: Optional[dict], help: str):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls()
            self._metrics[key] = m
            if help:
                self._help[name] = help
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, labels, help)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, labels, help)

    def histogram(self, name: str, help: str = "", **labels) -> Histogram:
        return self._get(Histogram, name, labels, help)

    # -- reading --------------------------------------------------------------

    def value(self, name: str, **labels) -> float:
        """Current value of a counter/gauge (0 if never touched)."""
        m = self._metrics.get((name, _label_key(labels)))
        return 0 if m is None else m.value

    def total(self, name: str) -> float:
        """Sum of a counter/gauge over every label combination."""
        return sum(m.value for (n, _), m in self._metrics.items()
                   if n == name and not isinstance(m, Histogram))

    def names(self) -> Iterable[str]:
        return sorted({n for n, _ in self._metrics})

    def snapshot(self) -> dict[str, float]:
        """Flat deterministic dict of every metric's current value;
        histograms expand to ``_count``/``_sum``/``_p50``/``_p99``."""
        out: dict[str, float] = {}
        for (name, lk) in sorted(self._metrics):
            m = self._metrics[(name, lk)]
            tag = name + _label_str(lk)
            if isinstance(m, Histogram):
                out[tag + "_count"] = m.count
                out[tag + "_sum"] = m.sum
                out[tag + "_p50"] = m.percentile(0.50)
                out[tag + "_p99"] = m.percentile(0.99)
            else:
                out[tag] = m.value
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (version 0.0.4). Histograms render
        as summaries (count/sum + p50/p99 quantile series)."""
        by_name: dict[str, list[tuple[tuple, object]]] = {}
        for (name, lk), m in self._metrics.items():
            by_name.setdefault(name, []).append((lk, m))
        lines: list[str] = []
        for name in sorted(by_name):
            series = sorted(by_name[name], key=lambda t: t[0])
            kind = series[0][1].kind
            if self._help.get(name):
                lines.append(f"# HELP {name} {self._help[name]}")
            lines.append(f"# TYPE {name} "
                         f"{'summary' if kind == 'histogram' else kind}")
            for lk, m in series:
                if isinstance(m, Histogram):
                    for q in (0.5, 0.99):
                        qlk = lk + (("quantile", str(q)),)
                        lines.append(f"{name}{_label_str(qlk)} "
                                     f"{m.percentile(q)}")
                    lines.append(f"{name}_count{_label_str(lk)} {m.count}")
                    lines.append(f"{name}_sum{_label_str(lk)} {m.sum}")
                else:
                    lines.append(f"{name}{_label_str(lk)} {m.value}")
        return "\n".join(lines) + ("\n" if lines else "")
