"""The device-memory schedule of the fused CG and BiCGStab kernels
(``csrc/cg_fused.cu``, ``csrc/bicgstab_fused.cu``), checked on the CPU.

Each kernel's phases are modelled in pure Python: g CTAs, each owning a
contiguous range of rows as the kernel splits them, the buffers each phase
gathers (other CTAs' rows, at the ELL matrix's columns, padding included)
and writes (its own rows), the tagged reduction rounds that end the phases
(64-bit words of two parities, as ``krylov_common.cuh`` has them) and
buffers chosen by an iteration's parity. Every buffer entry carries the
label of the vector, iteration and phase that wrote it; every gather
asserts that it sees the value the plain recurrence
(``ref.cg_iteration_matvec``, ``ref.bicgstab_iteration_matvec``) needs
there. The model runs under adversarial interleavings: any CTA runs ahead
until it must wait on a round, events within a phase in any order.

BiCGStab publishes d = p - omega v for the next p gather. The other form
of the same schedule, gathering the last p and v, needs v in two buffers
by the iteration's parity: it passes, and reads a stale v with one
buffer. The parent kernels' schedules (a single published vector behind
publish-only grid barriers) pass too, and fail with any one publish
barrier removed, so the model can see a stale read. The last cases show
the traps the tagged rounds design out: tag words of one parity, and tags
left by an earlier launch.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
import re
from pathlib import Path
from typing import Optional

import numpy as np
import pytest

from repro_torch.sparse.generate import poisson2d, skew_shifted_random

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
ITERS = 4


@dataclasses.dataclass(frozen=True)
class Access:
    """A vector of the recurrence in device memory: ``vec`` at iteration
    it + ``lag``, in buffer ``buf`` (default: its own), one buffer per
    parity of that iteration where ``parity``."""
    vec: str
    lag: int = 0
    buf: Optional[str] = None
    parity: bool = False

    def buffer(self, it: int) -> str:
        name = self.buf or self.vec
        return f"{name}[{(it + self.lag) & 1}]" if self.parity else name

    def label(self, it: int) -> tuple[str, int]:
        return (self.vec, it + self.lag)


@dataclasses.dataclass(frozen=True)
class Phase:
    """What a CTA does between two grid-wide points: gathers (other CTAs'
    rows; ``first`` in iteration 0 where it differs), writes (its own
    rows), and how the phase ends: a reduction round, a grid barrier that
    only publishes, or nothing."""
    name: str
    gathers: tuple[Access, ...] = ()
    writes: tuple[Access, ...] = ()
    sync: Optional[str] = "round"
    first: Optional[tuple[Access, ...]] = None


@dataclasses.dataclass(frozen=True)
class Schedule:
    prologue: tuple[Phase, ...]
    body: tuple[Phase, ...]

    def per_iteration(self, sync: str) -> int:
        return sum(p.sync == sync for p in self.body)

    def without_barrier(self, name: str) -> "Schedule":
        body = tuple(dataclasses.replace(p, sync=None) if p.name == name
                     else p for p in self.body)
        assert body != self.body, name
        return Schedule(self.prologue, body)


# cg_fused.cu: p formed at the gather from r_glob and p_glob
CG = Schedule(
    prologue=(Phase("prologue", writes=(Access("p"),)),),
    body=(Phase("spmv", gathers=(Access("r"), Access("p", -1)),
                first=(Access("p"),)),
          Phase("update", writes=(Access("r", 1), Access("p")))))

# bicgstab_fused.cu: p formed at the gather from r_glob and d_glob (d =
# p - omega v, published by the update), s from r_glob and v_glob
BICGSTAB = Schedule(
    prologue=(Phase("prologue", writes=(Access("r"), Access("d"))),),
    body=(Phase("p-spmv", gathers=(Access("r"), Access("d")),
                writes=(Access("v"),)),
          Phase("s-spmv", gathers=(Access("r"), Access("v"))),
          Phase("update", writes=(Access("r", 1), Access("d", 1)))))

# the same rounds gathering the last p and v (v by the iteration's parity)
BICGSTAB_PARITY = Schedule(
    prologue=(Phase("prologue", writes=(Access("r"), Access("p", -1),
                                        Access("v", -1, parity=True))),),
    body=(Phase("p-spmv", gathers=(Access("r"), Access("p", -1),
                                   Access("v", -1, parity=True)),
                writes=(Access("v", parity=True),)),
          Phase("s-spmv", gathers=(Access("r"), Access("v", parity=True)),
                writes=(Access("p"),)),
          Phase("update", writes=(Access("r", 1),))))

# the parent kernels: p (and s) published to one buffer behind grid.sync()
CG_PARENT = Schedule(
    prologue=(Phase("prologue", writes=(Access("p"),)),),
    body=(Phase("spmv", gathers=(Access("p"),)),
          Phase("update"),
          Phase("publish p", writes=(Access("p", 1),), sync="barrier")))

BICGSTAB_PARENT = Schedule(
    prologue=(Phase("prologue"),),
    body=(Phase("publish p", writes=(Access("p", buf="q"),), sync="barrier"),
          Phase("v-spmv", gathers=(Access("p", buf="q"),)),
          Phase("publish s", writes=(Access("s", buf="q"),), sync="barrier"),
          Phase("t-spmv", gathers=(Access("s", buf="q"),)),
          Phase("update")))


class Deadlock(Exception):
    pass


def _rows(n: int, g: int, bid: int) -> range:
    """The kernel's row range of CTA ``bid``: [bid n / g, (bid + 1) n / g)."""
    return range(bid * n // g, (bid + 1) * n // g)


def _events(schedule: Schedule, cols: np.ndarray, g: int, bid: int,
            iters: int, rng) -> list[tuple]:
    """CTA ``bid``'s events in program order: each phase's gathers at the
    columns of its rows outside its range and writes of its rows, in a
    random order within the phase, then the phase's sync point."""
    n = cols.shape[0]
    own = _rows(n, g, bid)
    remote = sorted({int(c) for c in cols[own.start:own.stop].ravel()
                     if not own.start <= c < own.stop})
    out = []
    phases = [(p, 0) for p in schedule.prologue] + [
        (p, it) for it in range(iters) for p in schedule.body]
    for p, it in phases:
        gathers = p.first if (p.first is not None and it == 0) else p.gathers
        ev = [("read", p.name, it, a, c) for a in gathers for c in remote]
        ev += [("write", p.name, it, a, r) for a in p.writes for r in own]
        rng.shuffle(ev)
        out += ev
        if p.sync is not None:
            out.append(("sync", p.name, it))
    return out


def _pick(strategy: str, runnable: list[int], pc: list[int], g: int, rng):
    if strategy == "ahead":       # one CTA runs until it must wait
        return max(runnable, key=lambda b: (pc[b], b))
    if strategy == "behind":
        return min(runnable, key=lambda b: (pc[b], -b))
    if strategy == "laggard":     # the last CTA only when nothing else can
        rest = [b for b in runnable if b != g - 1]
        return rng.choice(rest) if rest else runnable[0]
    return rng.choice(runnable)


#: (strategy, seed): the random ones under three seeds
STRATEGIES = (("ahead", 0), ("behind", 0), ("laggard", 0), ("random", 0),
              ("random", 1), ("random", 2))


def run(schedule: Schedule, cols: np.ndarray, g: int, strategy: str, *,
        iters: int = ITERS, parities: int = 2, launches: int = 1,
        zero_tags: bool = True, seed: int = 0) -> dict:
    """Run ``launches`` launches of the schedule on ``g`` CTAs, the
    events interleaved by ``strategy``. Returns the stale reads (gathers
    that saw another label than the recurrence needs), the stale rounds
    (a CTA past a round that some CTA had not reached in this launch) and
    the count of gathers checked. Raises Deadlock when no CTA can run."""
    rng = random.Random(seed)
    mem: dict[tuple[str, int], tuple] = {}
    tags = [[0] * g for _ in range(parities)]
    stale, stale_rounds, checked = [], [], 0
    for _ in range(launches):
        if zero_tags:
            tags = [[0] * g for _ in range(parities)]
        evs = [_events(schedule, cols, g, b, iters, rng) for b in range(g)]
        pc = [0] * g
        rnd = [0] * g          # rounds each CTA has arrived at this launch
        arrived = [False] * g  # at its current sync point, tag written
        while True:
            runnable = []
            for b in range(g):
                if pc[b] == len(evs[b]):
                    continue
                ev = evs[b][pc[b]]
                if ev[0] == "sync" and arrived[b]:
                    k = rnd[b]
                    if any(w != k for w in tags[k % parities]):
                        continue
                runnable.append(b)
            if not runnable:
                if all(pc[b] == len(evs[b]) for b in range(g)):
                    break
                raise Deadlock(f"{[evs[b][pc[b]] for b in range(g)]}")
            b = _pick(strategy, runnable, pc, g, rng)
            kind, phase, it = evs[b][pc[b]][:3]
            if kind == "sync":
                if not arrived[b]:        # write the tagged partial
                    rnd[b] += 1
                    tags[rnd[b] % parities][b] = rnd[b]
                    arrived[b] = True
                    continue
                if min(rnd) < rnd[b]:     # passed before every CTA arrived
                    stale_rounds.append((b, phase, it, rnd[b]))
                arrived[b] = False
            elif kind == "read":
                a, c = evs[b][pc[b]][3:]
                got = mem.get((a.buffer(it), c))
                checked += 1
                if got is None or got[:2] != a.label(it):
                    stale.append(dict(cta=b, phase=phase, iteration=it,
                                      buffer=a.buffer(it), column=c,
                                      want=a.label(it), got=got))
            else:
                a, r = evs[b][pc[b]][3:]
                mem[a.buffer(it), r] = a.label(it) + (phase,)
            pc[b] += 1
    return dict(stale=stale, stale_rounds=stale_rounds, checked=checked)


MATRICES = {
    "banded": lambda: poisson2d(6).to_ell().cols,
    "scattered": lambda: skew_shifted_random(40, row_nnz=4).to_ell().cols,
}
SCHEDULES = {"cg": CG, "bicgstab": BICGSTAB}
PARENTS = {"cg": CG_PARENT, "bicgstab": BICGSTAB_PARENT}


@pytest.mark.parametrize("g", [1, 3, 7])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_every_gather_sees_the_value_the_recurrence_needs(kind, matrix, g):
    cols = MATRICES[matrix]()
    for strategy, seed in STRATEGIES:
        out = run(SCHEDULES[kind], cols, g, strategy, seed=seed)
        assert out["stale"] == [], (strategy, seed, out["stale"][:3])
        assert out["stale_rounds"] == [], (strategy, seed)
        assert (out["checked"] > 0) == (g > 1)


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_rounds_an_iteration_and_no_publish_barrier(kind):
    """Two rounds an iteration for CG, three for BiCGStab, no barrier that
    only publishes, and the kernel's source has one tagged_round call for
    each round of the schedule, prologue included, and no grid.sync()."""
    schedule = SCHEDULES[kind]
    assert schedule.per_iteration("round") == {"cg": 2, "bicgstab": 3}[kind]
    assert schedule.per_iteration("barrier") == 0
    assert all(p.sync == "round" for p in schedule.prologue + schedule.body)
    code = "\n".join(ln.split("//")[0] for ln in
                     (CSRC / f"{kind}_fused.cu").read_text().splitlines())
    calls = len(re.findall(r"\btagged_round\(", code))
    assert calls == len(schedule.prologue) + schedule.per_iteration("round")
    assert "grid.sync" not in code and "this_grid" not in code


@pytest.mark.parametrize("g", [3, 7])
@pytest.mark.parametrize("kind", sorted(PARENTS))
def test_the_parent_schedule_needs_each_publish_barrier(kind, g):
    """The parent's schedule is clean with its barriers and reads a stale
    value with any one publish barrier removed."""
    parent = PARENTS[kind]
    barriers = [p.name for p in parent.body if p.sync == "barrier"]
    assert len(barriers) == {"cg": 1, "bicgstab": 2}[kind]
    for matrix, make in MATRICES.items():
        cols = make()
        for strategy, seed in STRATEGIES:
            assert run(parent, cols, g, strategy, seed=seed)["stale"] == []
        for name in barriers:
            cut = parent.without_barrier(name)
            stale = list(itertools.chain.from_iterable(
                run(cut, cols, g, s, seed=seed)["stale"]
                for s, seed in STRATEGIES))
            assert stale, (matrix, name)


@pytest.mark.parametrize("g", [3, 7])
def test_gathering_the_last_v_needs_two_buffers(g):
    """BiCGStab's p gather formed from the last p and v: clean with v in
    two buffers by the iteration's parity, stale with one (the p-spmv of
    iteration i + 1 reads v_i beside CTAs writing v_{i+1})."""
    def one_buffer(a):
        return dataclasses.replace(a, parity=False)

    single = Schedule(
        tuple(dataclasses.replace(p, writes=tuple(map(one_buffer, p.writes)))
              for p in BICGSTAB_PARITY.prologue),
        tuple(dataclasses.replace(
            p, gathers=tuple(map(one_buffer, p.gathers)),
            writes=tuple(map(one_buffer, p.writes)))
            for p in BICGSTAB_PARITY.body))
    for make in MATRICES.values():
        cols = make()
        for strategy, seed in STRATEGIES:
            assert run(BICGSTAB_PARITY, cols, g, strategy,
                       seed=seed)["stale"] == []
        assert any(run(single, cols, g, s, seed=seed)["stale"]
                   for s, seed in STRATEGIES)


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_tag_words_of_one_parity_deadlock(kind):
    """A round writing the words of the round before it: a CTA that ran on
    overwrites its tag before a slower one has seen it."""
    with pytest.raises(Deadlock):
        run(SCHEDULES[kind], MATRICES["banded"](), 3, "ahead", parities=1)


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_tags_of_an_earlier_launch_are_never_taken(kind):
    """Two launches in a row (a repeated call, a graph replay): with the
    words zeroed before each launch no round passes early; left as the
    last launch wrote them, a short launch's first round matches the old
    tags and a CTA passes it alone."""
    cols = MATRICES["banded"]()
    for iters in (0, 1, ITERS):
        out = run(SCHEDULES[kind], cols, 3, "ahead", iters=iters, launches=2)
        assert out["stale_rounds"] == [] and out["stale"] == []
    out = run(SCHEDULES[kind], cols, 3, "ahead", iters=0, launches=2,
              zero_tags=False)
    assert out["stale_rounds"]
