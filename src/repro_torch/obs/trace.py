"""Structured tracing of the PERKS execution layers: the port of
``repro/obs/trace.py``.

A :class:`Tracer` records typed span and instant events over the taxonomy
the executor and the service agree on (``CATEGORIES``): plan, compile
(a runner or lane group built), dispatch (one ``execute`` or batch),
chunk and barrier (a loop tier's host-sync points), dma, collective, lane,
cache (one ``CacheDecision``) and measure (an autotune sample).

* Spans read the host's clock, as the reference's do. A span never waits
  for the card (no ``torch.cuda.synchronize()``): a traced run makes the
  same launches as an untraced one, computes the same bits and stalls
  nowhere more. A span around asynchronous launches therefore measures
  the host's time to enqueue them.
* The clock is injectable (``Tracer(clock=...)``, seconds): with a fake
  clock two identical runs export byte-identical JSON lines.
* The ambient default is a :class:`NullTracer`, whose ``event``/``span``
  do nothing; call sites that build arguments guard on ``enabled``.
* Exporters: JSON lines (one event a line, sorted keys) and Chrome
  trace-event JSON for Perfetto, one named track per ``track`` string.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable

#: The event taxonomy. Free-form categories are allowed but everything the
#: port emits uses these.
CATEGORIES = ("plan", "compile", "dispatch", "chunk", "dma", "barrier",
              "collective", "lane", "cache", "measure")


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One typed trace record.

    ``ph`` follows the Chrome trace-event phase alphabet: ``"X"`` is a
    complete span (``ts_us`` start + ``dur_us``), ``"i"`` an instant
    event. ``track`` names the horizontal track the event renders on —
    one per tier or lane group — and ``args`` is a flat, JSON-safe dict.
    """

    name: str
    cat: str
    ph: str                       # "X" span | "i" instant
    ts_us: float
    dur_us: float = 0.0
    track: str = "main"
    args: tuple = ()              # sorted (key, value) pairs — hashable

    def to_dict(self) -> dict[str, Any]:
        d = {"name": self.name, "cat": self.cat, "ph": self.ph,
             "ts_us": self.ts_us, "track": self.track,
             "args": dict(self.args)}
        if self.ph == "X":
            d["dur_us"] = self.dur_us
        return d


def _freeze_args(kw: dict) -> tuple:
    """Args as sorted (key, value) pairs with JSON-safe values only —
    deterministic export order, no id()s/addresses leaking in."""
    out = []
    for k in sorted(kw):
        v = kw[k]
        if not isinstance(v, (str, int, float, bool, type(None))):
            v = str(v)
        out.append((k, v))
    return tuple(out)


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_track", "_args", "_t0")

    def __init__(self, tracer, name, cat, track, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._track = track
        self._args = args

    def __enter__(self):
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer._clock()
        self._tracer._record(TraceEvent(
            name=self._name, cat=self._cat, ph="X",
            ts_us=self._t0 * 1e6, dur_us=(t1 - self._t0) * 1e6,
            track=self._track, args=self._args))
        return False


class Tracer:
    """Collects typed :class:`TraceEvent` records with an injectable clock.

    >>> tr = Tracer()
    >>> with tr.span("execute:stencil", cat="dispatch", track="resident"):
    ...     run()
    >>> tr.event("barrier", cat="barrier", track="lanes", occupied=3)
    >>> tr.write_chrome("trace.json")     # open in Perfetto
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self.events: list[TraceEvent] = []

    # -- recording ------------------------------------------------------------

    def _record(self, ev: TraceEvent) -> None:
        self.events.append(ev)

    def event(self, name: str, *, cat: str, track: str = "main",
              **args) -> None:
        """Record one instant event."""
        self._record(TraceEvent(name=name, cat=cat, ph="i",
                                ts_us=self._clock() * 1e6, track=track,
                                args=_freeze_args(args)))

    def span(self, name: str, *, cat: str, track: str = "main", **args):
        """Context manager: a complete event spanning the ``with`` body."""
        return _Span(self, name, cat, track, _freeze_args(args))

    def clear(self) -> None:
        self.events.clear()

    def __len__(self) -> int:
        return len(self.events)

    # -- queries --------------------------------------------------------------

    def by_cat(self, cat: str) -> list[TraceEvent]:
        return [e for e in self.events if e.cat == cat]

    def tracks(self) -> list[str]:
        """Distinct track names, in first-appearance order."""
        seen: dict[str, None] = {}
        for e in self.events:
            seen.setdefault(e.track, None)
        return list(seen)

    # -- exporters ------------------------------------------------------------

    def to_jsonl(self) -> str:
        """One event per line, keys sorted — byte-stable given the same
        clock readings (the determinism tests diff this)."""
        return "".join(json.dumps(e.to_dict(), sort_keys=True) + "\n"
                       for e in self.events)

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (dict form): loads in Perfetto with one
        named track (tid) per distinct ``track`` string. Spans become
        complete ("X") events; instants render as thread instants."""
        tids = {t: i for i, t in enumerate(self.tracks())}
        out: list[dict] = [
            {"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
             "args": {"name": track}}
            for track, tid in tids.items()
        ]
        for e in self.events:
            d: dict[str, Any] = {
                "name": e.name, "cat": e.cat, "ph": e.ph, "pid": 0,
                "tid": tids[e.track], "ts": e.ts_us, "args": dict(e.args),
            }
            if e.ph == "X":
                d["dur"] = e.dur_us
            else:
                d["s"] = "t"          # instant scope: thread
            out.append(d)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, sort_keys=True)
            f.write("\n")


class _NullSpan:
    """Reusable no-op context manager (no per-call allocation)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer(Tracer):
    """The disabled tracer: records nothing, allocates nothing per call.

    This is the ambient default — instrumentation is free unless a real
    tracer is installed (``repro_torch.obs.use_tracer``). Call sites that build
    expensive args should guard on ``tracer.enabled``.
    """

    enabled = False

    def __init__(self):
        super().__init__(clock=lambda: 0.0)

    def event(self, name: str, *, cat: str, track: str = "main",
              **args) -> None:
        pass

    def span(self, name: str, *, cat: str, track: str = "main", **args):
        return _NULL_SPAN

    def _record(self, ev: TraceEvent) -> None:
        pass
