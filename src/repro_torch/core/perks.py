"""PERKS: the persistent execution model as loop combinators over torch
tensors — the port of ``repro/core/perks.py``.

Take an iterative method ``x_{k+1} = F(x_k)`` and choose where its time
loop lives:

``HOST_LOOP``
    The baseline: one kernel launch per step from the host; the state goes
    through device memory between launches (the paper's Fig. 3, left).

``DEVICE_LOOP``
    All N steps in one dispatch. On a CUDA tensor the N step launches are
    captured into a CUDA graph on the first run and the graph is kept, so
    every later run of the same step function on a state of the same
    shapes replays it: the state is copied into the graph's own input
    buffers and the host issues one launch for the whole loop. On a CPU
    tensor it is the same loop as HOST_LOOP.

``RESIDENT``
    The time loop inside one persistent kernel with (part of) the domain
    kept on chip; kernel-specific, so the problem's ``run_resident`` hook
    implements it (``repro_torch.kernels``).

A state is a tensor or a tuple of tensors (CG's is ``(x, r, p, rr)``). A
step function here is ``step_fn(state, out) -> state``: it writes the next
state into ``out`` (buffers like ``state``, never aliasing it) and returns
it; an element it cannot write in place (a reduction's fresh result) it
may return as a new tensor instead. Where JAX donates buffers, these
runners ping-pong two sets of buffers they allocate themselves; the first
step reads the caller's tensors, so they are never written. Every tier
runs the same step function, so the loop tiers agree bit for bit.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import weakref
from typing import Callable, Optional, Union

import torch


class Execution(enum.Enum):
    HOST_LOOP = "host_loop"      # paper's baseline (one launch per step)
    DEVICE_LOOP = "device_loop"  # one dispatch for all steps (CUDA graph)
    RESIDENT = "resident"        # persistent kernel, domain on chip


@dataclasses.dataclass(frozen=True)
class PerksConfig:
    """Knobs of the persistent execution scheme.

    Attributes:
      execution: which tier to run (see module docstring).
      sync_every: steps per dispatch, returning to the host in between
        (``None`` fuses all steps).
      fuse_steps: steps per barrier. Under HOST_LOOP the dispatch is the
        barrier, so ``fuse_steps > 1`` runs chunks of that many steps per
        dispatch; DEVICE_LOOP is already one dispatch.
    """

    execution: Execution = Execution.DEVICE_LOOP
    sync_every: Optional[int] = None
    fuse_steps: int = 1

    def __post_init__(self):
        if self.fuse_steps < 1:
            raise ValueError(f"fuse_steps must be >= 1, got {self.fuse_steps}")
        if self.sync_every is not None and self.sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {self.sync_every}")


State = Union[torch.Tensor, tuple[torch.Tensor, ...]]
StepFn = Callable[[State, State], State]
Runner = Callable[[State], State]


def _tensors(x: State) -> tuple[torch.Tensor, ...]:
    return x if isinstance(x, tuple) else (x,)


def _each(fn, x: State) -> State:
    """``fn`` applied to the tensor ``x`` or to every element of it."""
    return tuple(fn(t) for t in x) if isinstance(x, tuple) else fn(x)


def _clone(x: State) -> State:
    return _each(torch.Tensor.clone, x)


def _buffers(x: State) -> list[State]:
    return [_each(torch.empty_like, x), _each(torch.empty_like, x)]


def _device(x: State) -> torch.device:
    return _tensors(x)[0].device


def host_loop(
    step_fn: StepFn,
    n_steps: int,
    *,
    on_sync: Optional[Callable[[State, int], bool]] = None,
) -> Runner:
    """Baseline execution: one launch per time step. ``on_sync(state, k)``,
    if given, is evaluated after each step; returning True stops early."""

    def run(x):
        if n_steps == 0:
            return _clone(x)
        bufs = _buffers(x)
        cur = x
        for k in range(n_steps):
            cur = step_fn(cur, bufs[k % 2])
            if on_sync is not None and on_sync(cur, k + 1):
                break
        return cur

    return run


def capture(step_fn: StepFn, x: State, n_steps: int
            ) -> tuple[torch.cuda.CUDAGraph, list[State], State]:
    """Capture ``n_steps`` launches of ``step_fn`` on the CUDA state ``x``
    into a CUDA graph: one warm-up step on a side stream first, on a copy
    of ``x`` (its result is discarded, and a step that advances a state
    tensor in place — a decode's SSM state — leaves ``x`` as it was), both
    sets of ping-pong buffers allocated before capture. Returns the graph,
    the buffers (the graph writes them, so they must live as long as it
    does) and the state its last step writes; nothing has run until the
    graph is replayed."""
    capture.count += 1
    bufs = _buffers(x)
    dev = _device(x)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step_fn(_clone(x), bufs[0])
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cur = x
        for k in range(n_steps):
            cur = step_fn(cur, bufs[k % 2])
    return graph, bufs, cur


#: Graphs captured in this process (a kept graph's replay adds none).
capture.count = 0

#: Captured device loops, least recently used first: (the step function's
#: id, each state tensor's shape and dtype, device, steps) -> (graph, its
#: input buffers, its ping-pong buffers, the state its last step writes).
#: A graph reads its state from its own input buffers, into which every run
#: copies the state it is given, so any state of those shapes may replay
#: it. Everything else the step reads (operands it closes over: a matrix,
#: a spec) is part of the step function, which is why the key is that
#: function and not the problem: a copy of a problem that shares its step
#: function (``with_rhs``) shares its graph. An entry goes when its step
#: function is collected, so it keeps no problem's operands alive.
_GRAPHS: collections.OrderedDict = collections.OrderedDict()
#: Graphs kept at once; each holds three buffers the size of its state.
GRAPH_CACHE_SIZE = 4


def _graph_key(step_fn: StepFn, x: State, n_steps: int) -> tuple:
    return (id(step_fn), tuple((tuple(t.shape), t.dtype)
                               for t in _tensors(x)), _device(x), n_steps)


def _drop(key: tuple) -> None:
    """Forget a kept graph, once no replay of it still runs."""
    entry = _GRAPHS.pop(key, None)
    if entry is not None and key[2].type == "cuda":
        torch.cuda.synchronize(key[2])


def graph_cached(step_fn: StepFn, x: State, n_steps: int) -> bool:
    """Whether ``device_loop(step_fn, n_steps)(x)`` would replay a kept
    graph rather than capture one (always False off the card)."""
    return _device(x).type == "cuda" and _graph_key(step_fn, x,
                                                    n_steps) in _GRAPHS


def clear_graphs() -> None:
    """Drop every kept device-loop graph and its buffers."""
    if _GRAPHS:
        torch.cuda.synchronize()
    _GRAPHS.clear()


def _copy_into(dst: State, src: State) -> None:
    for d, s in zip(_tensors(dst), _tensors(src)):
        d.copy_(s)


def _kept(step_fn: StepFn, x: State, n_steps: int) -> State:
    """Run ``n_steps`` of ``step_fn`` from ``x`` through the kept graph of
    the step function at these shapes, capturing it first if there is
    none: a hit copies ``x`` into the graph's input buffers, so the replay
    starts from ``x`` whatever addresses it lies at."""
    key = _graph_key(step_fn, x, n_steps)
    entry = _GRAPHS.get(key)
    if entry is None:
        inputs = _clone(x)
        graph, bufs, out = capture(step_fn, inputs, n_steps)
        entry = (graph, out, inputs, bufs)   # the graph writes bufs
        _GRAPHS[key] = entry
        weakref.finalize(step_fn, _drop, key)
        if len(_GRAPHS) > GRAPH_CACHE_SIZE:
            _drop(next(iter(_GRAPHS)))
    else:
        _copy_into(entry[2], x)
        _GRAPHS.move_to_end(key)
    graph, out = entry[:2]
    graph.replay()
    return _clone(out)


def device_loop(step_fn: StepFn, n_steps: int, *, keep: bool = True) -> Runner:
    """PERKS control-flow transform: the whole time loop in one dispatch.

    On CUDA the first run captures the ``n_steps`` launches into one CUDA
    graph (``capture``) and keeps it (at most ``GRAPH_CACHE_SIZE`` graphs,
    least recently used dropped first); that run and every later one with
    the same step function on a state of the same shapes replays the graph
    once (``_kept``). The result is copied out of the graph's buffer, which
    the next replay overwrites. With ``keep=False`` the graph is replayed
    once, waited for and dropped (for inputs that never recur). On the CPU
    it is the host loop.
    """

    def run(x):
        if n_steps == 0:
            return _clone(x)
        dev = _device(x)
        if dev.type != "cuda":
            bufs = _buffers(x)
            cur = x
            for k in range(n_steps):
                cur = step_fn(cur, bufs[k % 2])
            return cur
        if not keep:
            graph, _, out = capture(step_fn, x, n_steps)
            graph.replay()
            torch.cuda.current_stream(dev).synchronize()
            return out
        return _kept(step_fn, x, n_steps)

    return run


class InPlaceChunk:
    """``steps`` applications of ``step_fn`` that advance a state in place:
    the first step reads the state's tensors, the last writes into them
    (with ``steps`` = 1 the one step writes a buffer that is copied back),
    and an element the last step returns as a new tensor is copied into
    its place. On a CUDA state the chunk is captured into a CUDA graph on
    the first call and the graph is kept by this object: every later call
    on the same tensors (the same addresses, shapes and dtypes) replays it,
    so the state crosses no copy between chunks. A call on other tensors
    captures anew (``captures`` counts them, as ``capture.count`` does);
    ``release`` drops the graph. On a CPU state it runs the steps."""

    def __init__(self, step_fn: StepFn, steps: int):
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        self.step_fn = step_fn
        self.steps = steps
        self.captures = 0
        self._key = None
        self._graph = None
        self._bufs = None

    def _advance(self, x: State, bufs: list[State]) -> None:
        cur = x
        for k in range(self.steps):
            cur = self.step_fn(cur, x if 0 < k == self.steps - 1
                               else bufs[k % 2])
        for dst, src in zip(_tensors(x), _tensors(cur)):
            if src is not dst:
                dst.copy_(src)

    def __call__(self, x: State) -> State:
        dev = _device(x)
        if dev.type != "cuda":
            self._advance(x, _buffers(x))
            return x
        key = tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                    for t in _tensors(x))
        if key != self._key:
            self.release()
            bufs = _buffers(x)
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):     # warm-up; its result is
                self.step_fn(x, bufs[0])      # discarded
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._advance(x, bufs)
            capture.count += 1
            self.captures += 1
            self._key, self._graph, self._bufs = key, graph, bufs
        self._graph.replay()
        return x

    def release(self) -> None:
        """Drop the kept graph and its buffers, once no replay still
        runs."""
        if self._graph is not None:
            torch.cuda.synchronize()
        self._key = self._graph = self._bufs = None


def chunked_loop(
    step_fn: StepFn,
    n_steps: Optional[int],
    *,
    sync_every: int,
    on_sync: Optional[Callable[[State, int], bool]] = None,
    on_barrier: Optional[Callable[[State, int], tuple[State, bool]]] = None,
) -> Runner:
    """PERKS with periodic host synchronisation: ``sync_every`` steps per
    dispatch, ``on_sync(state, k)`` between dispatches; returning True
    stops early. A non-dividing tail runs as one shorter chunk, so the
    total is exactly ``n_steps``. Each chunk is a ``device_loop`` whose
    graph is not kept (each chunk starts from a new tensor).

    ``on_barrier(state, k) -> (state, stop)`` is the scheduler hook:
    unlike ``on_sync`` it may replace the state at the barrier (the
    continuous-batching engine admits and retires lanes there), and it runs
    before ``on_sync``. With ``n_steps=None`` the loop is open-ended, and
    ``on_barrier`` is required: one chunk of ``sync_every`` steps a barrier
    until it says stop. The open-ended loop advances the tensors it is
    given in place through one :class:`InPlaceChunk`, which the runner
    keeps (``run.chunk``): on the card the chunk's graph is captured once
    and replayed at every barrier, for as long as ``on_barrier`` hands back
    the same tensors (the engine writes admissions into them), and across
    calls of the runner on them."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")

    if n_steps is None:
        if on_barrier is None:
            raise ValueError(
                "open-ended chunked_loop (n_steps=None) needs an on_barrier "
                "scheduler callback to terminate it")
        chunk = InPlaceChunk(step_fn, sync_every)

        def run_open(x):
            done = 0
            while True:
                x = chunk(x)
                done += sync_every
                x, stop = on_barrier(x, done)
                if stop or (on_sync is not None and on_sync(x, done)):
                    return x

        run_open.chunk = chunk
        return run_open

    def run(x):
        if n_steps == 0:
            return _clone(x)
        cur, done = x, 0
        while done < n_steps:
            chunk = min(sync_every, n_steps - done)
            cur = device_loop(step_fn, chunk, keep=False)(cur)
            done += chunk
            if on_barrier is not None:
                cur, stop = on_barrier(cur, done)
                if stop:
                    break
            if on_sync is not None and on_sync(cur, done):
                break
        return cur

    return run


def persistent(
    step_fn: StepFn,
    n_steps: int,
    config: PerksConfig = PerksConfig(),
    *,
    on_sync: Optional[Callable[[State, int], bool]] = None,
) -> Runner:
    """Build a runner for ``n_steps`` applications of ``step_fn`` under the
    requested loop tier (RESIDENT is the problem's own hook)."""
    if config.execution == Execution.HOST_LOOP:
        if config.fuse_steps > 1:
            return chunked_loop(step_fn, n_steps,
                                sync_every=config.fuse_steps, on_sync=on_sync)
        return host_loop(step_fn, n_steps, on_sync=on_sync)
    if config.sync_every is not None and config.sync_every < n_steps:
        return chunked_loop(step_fn, n_steps, sync_every=config.sync_every,
                            on_sync=on_sync)
    return device_loop(step_fn, n_steps)
