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
    every later run on the same input replays it: the host issues one
    launch for the whole loop. On a CPU tensor it is the same loop as
    HOST_LOOP.

``RESIDENT``
    The time loop inside one persistent kernel with (part of) the domain
    kept on chip; kernel-specific, so the problem's ``run_resident`` hook
    implements it (``repro_torch.kernels``).

A step function here is ``step_fn(state, out) -> state``: it writes the
next state into ``out`` (which never aliases ``state``) and returns it.
Where JAX donates buffers, these runners ping-pong two buffers they
allocate themselves; the first step reads the caller's tensor, so the
caller's tensor is never written. Every tier runs the same step function,
so the loop tiers agree bit for bit.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Callable, Optional

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


StepFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Runner = Callable[[torch.Tensor], torch.Tensor]


def _buffers(x: torch.Tensor) -> list[torch.Tensor]:
    return [torch.empty_like(x), torch.empty_like(x)]


def host_loop(
    step_fn: StepFn,
    n_steps: int,
    *,
    on_sync: Optional[Callable[[torch.Tensor, int], bool]] = None,
) -> Runner:
    """Baseline execution: one launch per time step. ``on_sync(state, k)``,
    if given, is evaluated after each step; returning True stops early."""

    def run(x):
        if n_steps == 0:
            return x.clone()
        bufs = _buffers(x)
        cur = x
        for k in range(n_steps):
            cur = step_fn(cur, bufs[k % 2])
            if on_sync is not None and on_sync(cur, k + 1):
                break
        return cur

    return run


def capture(step_fn: StepFn, x: torch.Tensor, n_steps: int
            ) -> tuple[torch.cuda.CUDAGraph, list[torch.Tensor], torch.Tensor]:
    """Capture ``n_steps`` launches of ``step_fn`` on the CUDA tensor ``x``
    into a CUDA graph: one warm-up step on a side stream first (its result
    is discarded), both ping-pong buffers allocated before capture. Returns
    the graph, the two buffers (the graph writes them, so they must live as
    long as it does) and the one its last step writes (the second when
    ``n_steps`` is even); nothing has run until the graph is replayed."""
    bufs = _buffers(x)
    side = torch.cuda.Stream(device=x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):
        step_fn(x, bufs[0])
    torch.cuda.current_stream(x.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cur = x
        for k in range(n_steps):
            cur = step_fn(cur, bufs[k % 2])
    return graph, bufs, cur


#: Captured device loops, least recently used first: (step function,
#: input address, shape, dtype, device, steps) -> ``capture``'s result. A
#: graph reads its input from the captured address, so a hit is any tensor
#: of that shape and type at that address, whatever it holds now.
_GRAPHS: collections.OrderedDict = collections.OrderedDict()
#: Graphs kept at once; each holds two buffers the size of its domain.
GRAPH_CACHE_SIZE = 4


def _graph_key(step_fn: StepFn, x: torch.Tensor, n_steps: int) -> tuple:
    return (step_fn, x.data_ptr(), tuple(x.shape), x.dtype, x.device,
            n_steps)


def graph_cached(step_fn: StepFn, x: torch.Tensor, n_steps: int) -> bool:
    """Whether ``device_loop(step_fn, n_steps)(x)`` would replay a kept
    graph rather than capture one (always False off the card)."""
    return x.device.type == "cuda" and _graph_key(step_fn, x,
                                                  n_steps) in _GRAPHS


def clear_graphs() -> None:
    """Drop every kept device-loop graph and its buffers."""
    if _GRAPHS:
        torch.cuda.synchronize()
    _GRAPHS.clear()


def device_loop(step_fn: StepFn, n_steps: int, *, keep: bool = True) -> Runner:
    """PERKS control-flow transform: the whole time loop in one dispatch.

    On CUDA the first run captures the ``n_steps`` launches into one CUDA
    graph (``capture``) and keeps it (at most ``GRAPH_CACHE_SIZE`` graphs,
    least recently used dropped first); that run and every later one with
    the same step function on a tensor at the same address replays the
    graph once. The result is copied out of the graph's buffer, which the
    next replay overwrites. With ``keep=False`` the graph is replayed once,
    waited for and dropped (for inputs that never recur). On the CPU it is
    the host loop.
    """

    def run(x):
        if n_steps == 0:
            return x.clone()
        if x.device.type != "cuda":
            bufs = _buffers(x)
            cur = x
            for k in range(n_steps):
                cur = step_fn(cur, bufs[k % 2])
            return cur
        if not keep:
            graph, _, out = capture(step_fn, x, n_steps)
            graph.replay()
            torch.cuda.current_stream(x.device).synchronize()
            return out
        key = _graph_key(step_fn, x, n_steps)
        entry = _GRAPHS.get(key)
        if entry is None:
            entry = capture(step_fn, x, n_steps)
            _GRAPHS[key] = entry
            if len(_GRAPHS) > GRAPH_CACHE_SIZE:
                torch.cuda.synchronize(x.device)   # no replay still reads it
                _GRAPHS.popitem(last=False)
        else:
            _GRAPHS.move_to_end(key)
        graph, _, out = entry
        graph.replay()
        return out.clone()

    return run


def chunked_loop(
    step_fn: StepFn,
    n_steps: int,
    *,
    sync_every: int,
    on_sync: Optional[Callable[[torch.Tensor, int], bool]] = None,
) -> Runner:
    """PERKS with periodic host synchronisation: ``sync_every`` steps per
    dispatch (a ``device_loop`` whose graph is not kept: each chunk starts
    from a new tensor), ``on_sync(state, k)`` between dispatches; returning
    True stops early. A non-dividing tail runs as one shorter chunk, so the
    total is exactly ``n_steps``."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")

    def run(x):
        if n_steps == 0:
            return x.clone()
        cur, done = x, 0
        while done < n_steps:
            chunk = min(sync_every, n_steps - done)
            cur = device_loop(step_fn, chunk, keep=False)(cur)
            done += chunk
            if on_sync is not None and on_sync(cur, done):
                break
        return cur

    return run


def persistent(
    step_fn: StepFn,
    n_steps: int,
    config: PerksConfig = PerksConfig(),
    *,
    on_sync: Optional[Callable[[torch.Tensor, int], bool]] = None,
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
