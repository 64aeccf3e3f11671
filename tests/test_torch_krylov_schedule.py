"""The device-memory schedule of the fused Krylov kernels
(``csrc/cg_fused.cu``, ``csrc/bicgstab_fused.cu``,
``csrc/gmres_cycle_fused.cu``), checked on the CPU.

Each kernel's phases are modelled in pure Python: g CTAs, each owning a
contiguous range of rows as the kernel splits them, the buffers each phase
gathers (other CTAs' rows, at the ELL matrix's columns, padding included)
and writes (its own rows), the tagged reduction rounds that end the phases
(64-bit words of two parities, as ``krylov_common.cuh`` has them: one word
a value a CTA, a warp writing each, the CTA passing once every CTA's word
of every value it sums carries the round) and buffers chosen by an
iteration's parity. Every buffer entry carries the label of the vector,
iteration and phase that wrote it; every gather asserts that it sees the
value the plain recurrence (``ref.cg_iteration_matvec``,
``ref.bicgstab_iteration_matvec``, ``ref.gmres_cycle_update``) needs
there, and, where it forms its operand with a round's sum (GMRES's
w[c] * (1 / hn)), that the CTA holds that round's sum of the right step;
every round's sums must come from that round's words. The model runs
under adversarial interleavings: any CTA runs ahead until it must wait on
a round, events within a phase in any order.

BiCGStab publishes d = p - omega v for the next p gather. The other form
of the same schedule, gathering the last p and v, needs v in two buffers
by the iteration's parity: it passes, and reads a stale v with one
buffer. GMRES publishes w before the ||w|| round and forms v at the next
SpMV's gather. With every round ordered, one buffer passes, and the model
fails with the publish moved after its round or before the h1 round, or
with ||w|| summed in the next step's h1 round; the kernel's h1 and h2
rounds carry only their sums (stored relaxed, so memory accesses may
cross them), and there one buffer reads stale and two, by the step's
parity, pass. The parent kernels' schedules (a single published vector
behind publish-only grid barriers) pass too, and fail with any one
publish barrier removed, so the model can see a stale read. The last
cases show the traps the tagged rounds design out: tag words of one
parity, and tags left by an earlier launch.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
import re
from pathlib import Path
from typing import Callable, Optional

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
    parity of that iteration where ``parity``, or one per iteration, each
    written once, where ``indexed`` (GMRES's rows of V). A gather that
    forms its operand with the sum of the round ending phase ``scale[0]``
    of iteration it + ``scale[1]`` checks that the CTA holds that sum."""
    vec: str
    lag: int = 0
    buf: Optional[str] = None
    parity: bool = False
    indexed: bool = False
    scale: Optional[tuple[str, int]] = None

    def buffer(self, it: int) -> str:
        name = self.buf or self.vec
        if self.indexed:
            return f"{name}{it + self.lag}"
        return f"{name}[{(it + self.lag) & 1}]" if self.parity else name

    def label(self, it: int) -> tuple[str, int]:
        return (self.vec, it + self.lag)


@dataclasses.dataclass(frozen=True)
class Phase:
    """What a CTA does between two grid-wide points: gathers (other CTAs'
    rows; ``first`` in iteration 0 where it differs), writes (its own
    rows), and how the phase ends: a reduction round (of ``values(it)``
    values, default one) that orders device memory ("round": its words
    released), one that carries only its sums ("sums": stored relaxed, so
    the phase's reads and writes may cross it, up to the next ordered
    round), a grid barrier that only publishes, or nothing."""
    name: str
    gathers: tuple[Access, ...] = ()
    writes: tuple[Access, ...] = ()
    sync: Optional[str] = "round"
    first: Optional[tuple[Access, ...]] = None
    values: Optional[Callable[[int], int]] = None

    def round_values(self, it: int) -> int:
        return 1 if self.values is None else self.values(it)


@dataclasses.dataclass(frozen=True)
class Schedule:
    prologue: tuple[Phase, ...]
    body: tuple[Phase, ...]
    epilogue: tuple[Phase, ...] = ()

    def per_iteration(self, sync: str) -> int:
        return sum(p.sync == sync for p in self.body)

    def phases(self, iters: int) -> list[tuple[Phase, int]]:
        """Every phase of a launch with its iteration, in program order."""
        return ([(p, 0) for p in self.prologue]
                + [(p, it) for it in range(iters) for p in self.body]
                + [(p, iters) for p in self.epilogue])

    def rounds(self, iters: int) -> int:
        """Grid-wide sync points of a launch of ``iters`` iterations."""
        return sum(p.sync is not None for p, _ in self.phases(iters))

    def without_barrier(self, name: str) -> "Schedule":
        body = tuple(dataclasses.replace(p, sync=None) if p.name == name
                     else p for p in self.body)
        assert body != self.body, name
        return dataclasses.replace(self, body=body)


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

# gmres_cycle_fused.cu: u_j, what step j's SpMV forms v_j from (u_0 = r,
# u_{j+1} = the w of step j), published in buffer u[j & 1] before the
# ordered round that ends its phase (beta, ||w||) and gathered as
# u[c] * inv with inv from that round's sum; h1 and h2 carry only their
# sums. V_out's row j written once, when v_j is formed at the start of
# step j (v_m after the last step), and never gathered. The projections'
# rounds sum j + 1 values.
GMRES = Schedule(
    prologue=(Phase("prologue", writes=(Access("u", parity=True),)),),
    body=(Phase("spmv", gathers=(Access("u", parity=True,
                                        scale=("norm", -1)),),
                first=(Access("u", parity=True, scale=("prologue", 0)),),
                writes=(Access("V", indexed=True),), sync="sums",
                values=lambda it: it + 1),
          Phase("update", sync="sums", values=lambda it: it + 1),
          Phase("norm", writes=(Access("u", 1, parity=True),))),
    epilogue=(Phase("v_m", writes=(Access("V", indexed=True),), sync=None),))


def _one_buffer(schedule: Schedule) -> Schedule:
    """The schedule with every parity-buffered vector in one buffer."""
    def one(phases):
        return tuple(dataclasses.replace(
            p, gathers=tuple(dataclasses.replace(a, parity=False)
                             for a in p.gathers),
            first=None if p.first is None else tuple(
                dataclasses.replace(a, parity=False) for a in p.first),
            writes=tuple(dataclasses.replace(a, parity=False)
                         for a in p.writes)) for p in phases)
    return Schedule(one(schedule.prologue), one(schedule.body),
                    one(schedule.epilogue))


def _ordered(schedule: Schedule) -> Schedule:
    """The schedule with every round of sums made an ordered round."""
    return dataclasses.replace(schedule, body=tuple(
        dataclasses.replace(p, sync="round") if p.sync == "sums" else p
        for p in schedule.body))


# the design with every round ordered: one buffer of u is enough
GMRES_ORDERED = _ordered(_one_buffer(GMRES))

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

# v_{j+1} written to V_out's row j+1 behind a fourth grid.sync() a step,
# and the SpMV gathering V_out's row j: 4m + 2 barriers a cycle
GMRES_PARENT = Schedule(
    prologue=(Phase("prologue"),
              Phase("publish v", writes=(Access("V", indexed=True),),
                    sync="barrier")),
    body=(Phase("spmv", gathers=(Access("V", indexed=True),),
                values=lambda it: it + 1),
          Phase("update", values=lambda it: it + 1),
          Phase("norm"),
          Phase("publish v", writes=(Access("V", 1, indexed=True),),
                sync="barrier")))


class Deadlock(Exception):
    pass


def _rows(n: int, g: int, bid: int) -> range:
    """The kernel's row range of CTA ``bid``: [bid n / g, (bid + 1) n / g)."""
    return range(bid * n // g, (bid + 1) * n // g)


def _merge(events: list, blocks: list, rng) -> list:
    """``events`` in any order, with the ``blocks`` (unordered rounds) kept
    whole and in order among them."""
    if not blocks:
        return events
    rng.shuffle(events)
    cuts = sorted(rng.randrange(len(events) + 1) for _ in blocks)
    out, i = [], 0
    for cut, block in zip(cuts, blocks):
        out += events[i:cut] + block
        i = cut
    return out + events[i:]


def _events(schedule: Schedule, cols: np.ndarray, g: int, bid: int,
            iters: int, rng) -> list[tuple]:
    """CTA ``bid``'s events in program order: each phase's gathers at the
    columns of its rows outside its range and writes of its rows, in a
    random order within the phase, then the phase's round k: the tagged
    word of each value it sums (its warps, in any order), then passing the
    round. A round of sums orders nothing: the reads and writes of the
    phases from the last ordered round to the next are shuffled together
    and its events fall anywhere among them."""
    n = cols.shape[0]
    own = _rows(n, g, bid)
    remote = sorted({int(c) for c in cols[own.start:own.stop].ravel()
                     if not own.start <= c < own.stop})
    out, pending, floating = [], [], []
    k = 0
    for p, it in schedule.phases(iters):
        gathers = p.first if (p.first is not None and it == 0) else p.gathers
        ev = [("read", p.name, it, a, c) for a in gathers for c in remote]
        ev += [("write", p.name, it, a, r) for a in p.writes for r in own]
        rng.shuffle(ev)
        pending += ev
        if p.sync is not None:
            k += 1
            nv = p.round_values(it)
            tags = [("tag", p.name, it, k, nv, v) for v in range(nv)]
            rng.shuffle(tags)
            block = tags + [("pass", p.name, it, k, nv)]
            if p.sync == "sums":
                floating.append(block)
            else:
                out += _merge(pending, floating, rng) + block
                pending, floating = [], []
    return out + _merge(pending, floating, rng)


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
    that saw another label than the recurrence needs, or formed it with a
    sum of another round than it needs), the stale rounds (a CTA past a
    round that some CTA had not reached in this launch), the stale sums (a
    round's sums taken from words another round wrote), the entries of a
    written-once buffer written twice in a launch, the buffers written and
    the count of gathers checked. Raises Deadlock when no CTA can run."""
    rng = random.Random(seed)
    width = max([p.round_values(it) for p, it in schedule.phases(iters)]
                + [1])
    mem: dict[tuple[str, int], tuple] = {}

    def zeroed():
        return [[[(0, None)] * g for _ in range(width)]
                for _ in range(parities)]

    tags = zeroed()
    stale, stale_rounds, stale_sums, rewrites = [], [], [], []
    checked = 0
    for _ in range(launches):
        if zero_tags:
            tags = zeroed()
        evs = [_events(schedule, cols, g, b, iters, rng) for b in range(g)]
        pc = [0] * g
        done = [0] * g         # the last round each CTA has tagged in full
        tagged = [0] * g       # its words of that round written so far
        held = [{} for _ in range(g)]  # round -> the iteration of its sums
        once = set()           # written-once entries written this launch

        def ready(k, nv):
            return all(tags[k % parities][v][c][0] == k
                       for v in range(nv) for c in range(g))

        while True:
            runnable = []
            for b in range(g):
                if pc[b] == len(evs[b]):
                    continue
                ev = evs[b][pc[b]]
                if ev[0] == "pass" and not ready(*ev[3:5]):
                    continue
                runnable.append(b)
            if not runnable:
                if all(pc[b] == len(evs[b]) for b in range(g)):
                    break
                raise Deadlock(f"{[evs[b][pc[b]] for b in range(g)]}")
            b = _pick(strategy, runnable, pc, g, rng)
            kind, phase, it = evs[b][pc[b]][:3]
            if kind == "tag":          # a warp releases its partial
                k, nv, v = evs[b][pc[b]][3:]
                tags[k % parities][v][b] = (k, (phase, it))
                tagged[b] += 1
                if tagged[b] == nv:
                    done[b], tagged[b] = k, 0
            elif kind == "pass":
                k, nv = evs[b][pc[b]][3:]
                if min(done) < k:     # passed before every CTA arrived
                    stale_rounds.append((b, phase, it, k))
                got = {tags[k % parities][v][c][1]
                       for v in range(nv) for c in range(g)}
                if got != {(phase, it)}:
                    stale_sums.append((b, phase, it, got))
                held[b][phase] = it
            elif kind == "read":
                a, c = evs[b][pc[b]][3:]
                got = mem.get((a.buffer(it), c))
                checked += 1
                want_sum = None if a.scale is None else it + a.scale[1]
                if (got is None or got[:2] != a.label(it)
                        or (a.scale is not None
                            and held[b].get(a.scale[0]) != want_sum)):
                    stale.append(dict(cta=b, phase=phase, iteration=it,
                                      buffer=a.buffer(it), column=c,
                                      want=a.label(it), got=got,
                                      scale=a.scale, want_sum=want_sum,
                                      held=dict(held[b])))
            else:
                a, r = evs[b][pc[b]][3:]
                key = (a.buffer(it), r)
                if a.indexed:
                    if key in once:
                        rewrites.append(key)
                    once.add(key)
                mem[key] = a.label(it) + (phase,)
            pc[b] += 1
    return dict(stale=stale, stale_rounds=stale_rounds,
                stale_sums=stale_sums, rewrites=rewrites,
                written={name for name, _ in mem}, checked=checked)


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
    calls = len(re.findall(r"\btagged_round(?:<[^>]*>)?\(", code))
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


# -- GMRES(m): the cycle kernel's schedule -------------------------------------


def _gmres_clean(out: dict) -> bool:
    return not (out["stale"] or out["stale_rounds"] or out["stale_sums"]
                or out["rewrites"])


@pytest.mark.parametrize("m", [1, 16, 31])
@pytest.mark.parametrize("g", [1, 3, 7])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_gmres_gathers_see_step_js_w_scaled_by_its_hn(matrix, g, m):
    """Every gather of step j sees u_j (r, or the w of step j - 1) from one
    published buffer and forms v_j with the sum of the round that ended
    the phase writing it (beta, or step j - 1's ||w||); every round's sums
    come from its own words, up to m values at m = 31 in words laid out
    for 32; V_out's rows 0..m are each written once and never gathered."""
    cols = MATRICES[matrix]()
    for strategy, seed in STRATEGIES:
        out = run(GMRES, cols, g, strategy, iters=m, seed=seed)
        assert _gmres_clean(out), (strategy, seed, out["stale"][:3],
                                   out["stale_sums"][:3], out["rewrites"][:3])
        assert (out["checked"] > 0) == (g > 1)
        assert {f"V{j}" for j in range(m + 1)} <= out["written"]
    assert max(p.round_values(it) for p, it in GMRES.phases(m)) == m
    assert all(a.vec != "V" for p, _ in GMRES.phases(m)
               for a in p.gathers + (p.first or ()))


@pytest.mark.parametrize("m", [1, 16, 31])
def test_gmres_rounds_a_cycle_and_no_grid_sync(m):
    """1 + 3m tagged rounds a cycle (49 at m = 16, against the parent's
    4m + 2 = 66 grid barriers), none that only publishes, as many as the
    wrapper documents; the kernel's source has one tagged_round call for
    the prologue's and each of a step's, over words of 32 values, relaxed
    (``false``) where the schedule's round carries only sums, u in two
    buffers by the step's parity as the schedule has it, and no
    grid.sync()."""
    from repro_torch.kernels import krylov_fused
    assert GMRES.rounds(m) == 1 + 3 * m == krylov_fused.gmres_cycle_rounds(m)
    assert GMRES_PARENT.rounds(m) == 4 * m + 2
    assert GMRES.per_iteration("barrier") == 0
    assert m + 1 <= krylov_fused.GMRES_ROUND_VALUES == 32
    code = "\n".join(ln.split("//")[0] for ln in
                     (CSRC / "gmres_cycle_fused.cu").read_text().splitlines())
    calls = re.findall(r"\btagged_round<([\w, ]+)>\(", code)
    assert calls == [{"round": "GMRES_MAX_V", "sums": "GMRES_MAX_V, false"}[
        p.sync] for p in GMRES.prologue + GMRES.body]
    assert re.search(r"#define GMRES_MAX_V KRY_WARPS\b", code)
    assert "grid.sync" not in code and "this_grid" not in code
    # u_j gathered from u[j & 1], u_{j+1} written to u[(j + 1) & 1]
    assert "u + (size_t)(j & 1) * n" in code
    assert "u + (size_t)((j + 1) & 1) * n" in code


@pytest.mark.parametrize("g", [3, 7])
def test_gmres_buffers_and_each_move_of_them_are_caught(g):
    """With every round ordered one u buffer is clean, and the model fails
    when u is published after the round that ends its phase (at the next
    SpMV), when it is published before this step's h1 round (over the u
    other CTAs still gather), or when ||w|| is summed with the next step's
    h1 (the gather scales by the step before's hn). With h1 and h2
    carrying only sums, as the kernel has them, one buffer reads stale
    and the kernel's two (by the step's parity) are clean, unless the
    ||w|| round orders nothing either. The parent's schedule needs its
    publish barrier."""
    def moved(spmv_writes, norm_sync="round"):
        spmv, update, norm = GMRES_ORDERED.body
        prologue = GMRES_ORDERED.prologue
        if spmv_writes[0].lag == 0:
            prologue = (dataclasses.replace(prologue[0], writes=()),)
        return dataclasses.replace(
            GMRES_ORDERED, prologue=prologue,
            body=(dataclasses.replace(spmv, writes=spmv.writes + spmv_writes),
                  update,
                  dataclasses.replace(norm, writes=(), sync=norm_sync)))

    late = moved((Access("u"),))               # u_j written as j gathers
    early = moved((Access("u", 1),))           # u_{j+1} before round h1
    folded = GMRES_ORDERED.without_barrier("norm")   # hn with the next h1
    unordered_norm = dataclasses.replace(GMRES, body=tuple(
        dataclasses.replace(p, sync="sums") if p.name == "norm" else p
        for p in GMRES.body))
    for make in MATRICES.values():
        cols = make()
        for m in (1, 4):
            for strategy, seed in STRATEGIES:
                for clean in (GMRES, GMRES_ORDERED):
                    assert _gmres_clean(run(clean, cols, g, strategy,
                                            iters=m, seed=seed))
                assert run(GMRES_PARENT, cols, g, strategy, iters=m,
                           seed=seed)["stale"] == []
        for bad in (late, early, folded, _one_buffer(GMRES), unordered_norm,
                    GMRES_PARENT.without_barrier("publish v")):
            assert any(run(bad, cols, g, s, iters=4, seed=seed)["stale"]
                       for s, seed in STRATEGIES), bad
    out = run(folded, MATRICES["banded"](), g, "random", iters=2)
    assert any(e["scale"] == ("norm", -1) and e["got"][:2] == e["want"]
               for e in out["stale"])


@pytest.mark.parametrize("m", [1, 16])
def test_gmres_tag_words_of_one_parity_deadlock(m):
    with pytest.raises(Deadlock):
        run(GMRES, MATRICES["banded"](), 3, "ahead", iters=m, parities=1)


def test_gmres_tags_of_an_earlier_launch_are_never_taken():
    """A replayed cycle: with zeroed words no round passes early; with the
    words the last launch left, a value that the round before did not sum
    (h1's second value at m = 2) still holds the last launch's tag of the
    same round, and CTAs pass that round before every CTA has written its
    words."""
    cols = MATRICES["banded"]()
    for m in (1, 2, 16):
        out = run(GMRES, cols, 3, "ahead", iters=m, launches=2)
        assert _gmres_clean(out)
    assert any(run(GMRES, cols, 3, s, iters=2, launches=2, zero_tags=False,
                   seed=seed)["stale_rounds"] for s, seed in STRATEGIES)
