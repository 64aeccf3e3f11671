"""Problem adapters: the stencil and conjugate gradient described for the
executor — the single-device part of ``repro/exec/adapters.py``, with
their batching surface (``exec/batch.py``): a batch of stencils steps in
one ``stencil_step`` launch a step, and its resident tier is one launch of
the kernel its plan names with a lane of CTAs a domain; a batch of CG
right-hand sides on one ELL operator steps in one ``spmv_ell`` and one
``vdot`` launch for each SpMV and dot, and its resident tier is one
``cg_fused`` launch. BiCGStab and GMRES(m) are in ``krylov.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core.cache_policy import (
    CacheableArray,
    cg_arrays,
    cg_arrays_for,
    stencil_shard_arrays,
)
from repro_torch.core.hardware import Chip, device_chip
from repro_torch.exec.batch import per_instance_chip
from repro_torch.exec.plan import PRECISIONS, Plan
from repro_torch.exec.precision import dot_for
from repro_torch.exec.problem import HaloSpec, Problem, operand_fingerprint
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import stencil2d as ks
from repro_torch.kernels.common import StencilSpec


def operator_fingerprint(data, cols, matrix, matvec) -> str:
    """Operand fingerprint of one sparse operator, preferring content (ELL
    planes, then the exact container's values) over identity (an opaque
    matvec callable), as the reference computes it: folded into CG problem
    ``name``s so two same-size problems over different operators never
    alias."""
    if data is not None:
        return operand_fingerprint(data, cols)
    if matrix is not None:
        return operand_fingerprint(getattr(matrix, "data", None))
    return operand_fingerprint(matvec)


def _operand_sig(a):
    """id + shape/dtype of one shared operand (batch-key component)."""
    if a is None:
        return None
    shape = getattr(a, "shape", None)
    return (id(a), None if shape is None else tuple(shape),
            str(getattr(a, "dtype", None)))


def fusion_schedule(steps: int, fuse_steps: int) -> list[tuple[int, int]]:
    """How ``steps`` decompose into fused chunks: ``[(n_chunks, chunk_t)]``
    — ceil(steps/fuse_steps) chunks, a non-dividing tail as one narrower
    chunk, never an overshoot."""
    full, rem = divmod(steps, fuse_steps)
    sched = []
    if full:
        sched.append((full, fuse_steps))
    if rem:
        sched.append((1, rem))
    return sched


def fit_stencil_plan(shape: Sequence[int], dtype_bytes: int,
                     spec: StencilSpec, plan: Plan, chip: Chip,
                     n_steps: Optional[int] = None
                     ) -> tuple[Plan, Optional[str]]:
    """``plan`` fitted to what the stencil kernels hold on ``chip`` (one
    CTA an SM, its per-block shared memory less
    ``stencil2d.PERKS_STATIC_SMEM``), for a domain of ``shape`` and
    ``n_steps`` steps (default the plan's). A resident plan whose layout
    the kernel cannot hold (``resident_layout`` with every row cached,
    ``perks_layout`` at one step a pass, ``tb_layout`` otherwise) takes:

    1. fewer cached rows, the most the layout holds at its schedule and
       depth;
    2. where no band fits at that depth, the next shallower depth of the
       same schedule (halving it; the deep schedule down to 2, the shallow
       one down to 1) at which one does, with the most rows it holds up to
       the plan's; where none does, the plan's depth with no row cached,
       or the first shallower depth that runs at all.

    Every kernel and layout gives the same bits, so the fitted plan
    computes what the plan does. Returns ``(plan, None)`` when it fits,
    else the fitted plan and a message naming both."""
    if plan.tier != "resident" or plan.cached_rows is None:
        return plan, None
    shape = tuple(int(d) for d in shape)
    H, r, db = shape[0], spec.radius, dtype_bytes
    n = plan.n_steps if n_steps is None else n_steps
    limit = chip.smem_per_block - ks.PERKS_STATIC_SMEM
    ctas = chip.sms
    deep = plan.schedule == "deep"

    def fits(t: int, rows: int) -> bool:
        if rows >= H:
            return (ks.resident_layout(shape, r, db, ctas, limit) is not None
                    or ks.perks_layout(shape, r, db, ctas, limit, H)
                    is not None)
        if t == 1 and not deep:
            return ks.perks_layout(shape, r, db, ctas, limit, rows) is not None
        return ks.tb_layout(shape, r, t, db, deep=deep, ctas=ctas,
                            limit=limit, cached_rows=rows) is not None

    def most(t: int, rows: int) -> Optional[int]:
        """The most cached rows up to ``rows`` that fit at depth t (0 or at
        least r), or None where t does not run even with none."""
        if fits(t, rows):
            return rows
        if not fits(t, 0):
            return None
        lo, hi = 0, min(rows, H - 1)    # fits(lo); the answer is < hi + 1
        if t == 1 and not deep:
            lo = min(hi, ks.perks_cached_rows(shape, r, db, ctas, limit))
            while lo > 0 and not fits(t, lo):
                lo -= 1
        else:
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if fits(t, mid):
                    lo = mid
                else:
                    hi = mid - 1
        return lo if lo >= r else 0

    R = min(plan.cached_rows, H)
    t = max(1, min(plan.fuse_steps, n)) if n else max(1, plan.fuse_steps)
    if fits(t, R):
        return plan, None
    floor = 2 if deep else 1
    depths = [t]
    while depths[-1] // 2 >= floor:
        depths.append(depths[-1] // 2)
    got = None
    for d in depths:
        rows = most(d, R)
        if rows is not None and (rows > 0 or R == 0):
            got = (d, rows)
            break
    if got is None:
        got = next(((d, 0) for d in depths if fits(d, 0)), (1, 0))
    t2, R2 = got
    schedule = plan.schedule if (t2 > 1 or not deep) else "shallow"
    row_bytes = math.prod(shape[1:]) * db
    cache = tuple(dataclasses.replace(c, cached_bytes=R2 * row_bytes)
                  if c.name == "domain_rows" else c for c in plan.cache)
    fitted = dataclasses.replace(plan, fuse_steps=t2, cached_rows=R2,
                                 schedule=schedule, cache=cache)
    return fitted, (
        f"the {plan.schedule} t={t} plan caching {plan.cached_rows} rows of "
        f"{shape} does not fit the kernels' layout on {chip.name} "
        f"({ctas} CTAs of {limit} B); running {schedule} t={t2} with "
        f"{R2} cached rows")


@dataclasses.dataclass(frozen=True, eq=False)
class StencilProblem(Problem):
    """Iterative stencil sweep: ``n_steps`` applications of ``spec`` to the
    domain ``x`` (outermost ``radius`` cells Dirichlet-frozen).

    ``x`` is a tensor or anything numpy takes; it is moved to ``device``,
    which defaults to ``"cuda"``. Without a CUDA device the constructor
    raises ``RuntimeError`` unless ``device="cpu"`` is passed.
    """

    x: torch.Tensor
    spec: StencilSpec
    n_steps: int
    device: Optional[_device.DeviceLike] = None

    kind = "stencil"

    def __post_init__(self):
        dev = _device.resolve(self.device)
        object.__setattr__(self, "device", dev)
        object.__setattr__(self, "x", _device.as_domain(self.x, dev))
        spec = self.spec

        def step(x, out):
            return kops.stencil_baseline_step(x, spec=spec, out=out)

        # one step function per problem, so the device loop's kept graph
        # (core.perks) is found again on the next execute
        object.__setattr__(self, "_step", step)

    @property
    def name(self) -> str:  # type: ignore[override]
        return f"stencil_{self.spec.name}"

    # -- protocol -------------------------------------------------------------

    def initial_state(self):
        return self.x

    def step_fn(self):
        return self._step

    def cacheable_arrays(self, *, fuse_steps: int = 1) -> Sequence[CacheableArray]:
        row_bytes = int(math.prod(self.x.shape[1:])) * self.x.element_size()
        return stencil_shard_arrays(self.x.shape[0], row_bytes,
                                    self.spec.radius, fuse_steps=fuse_steps)

    def oracle(self):
        return kref.stencil_run(self.x, self.spec, self.n_steps)

    def halo_spec(self) -> HaloSpec:
        return HaloSpec(axis=0, halo=self.spec.radius, partitions=("rows",))

    def domain_bytes(self) -> int:
        return self.x.numel() * self.x.element_size()

    # -- batching -------------------------------------------------------------

    def payload(self):
        return self.x

    def with_payload(self, payload) -> "StencilProblem":
        """This problem on the domain ``payload``, sharing its step
        function (so its device loop's kept graphs)."""
        copy = dataclasses.replace(self, x=payload)
        object.__setattr__(copy, "_step", self._step)
        return copy

    def batch_key(self) -> tuple:
        return ("stencil", self.spec.name, tuple(self.x.shape),
                str(self.x.dtype).replace("torch.", ""), self.n_steps,
                str(self.device))

    def batched_tiers(self) -> tuple[str, ...]:
        return ("host_loop", "device_loop", "resident")

    def batched_step_fn(self):
        # stencil_baseline_step takes [B, ...] as B domains in one launch
        return self._step

    # -- tiers ----------------------------------------------------------------

    def run_resident(self, plan):
        return self._resident(self.x, plan, device_chip())

    def run_resident_batched(self, payload, plan):
        """The B domains ``payload`` ``[B, ...]`` in one launch of the
        kernel ``plan`` names, each lane on its share of the card
        (``batch.per_instance_chip``: ``sms // B`` CTAs of the full
        per-block shared memory), the plan fitted to that share as a single
        run's is to the card. Raises ``ValueError`` where the lanes outnumber
        the SMs (the reference vmaps any B; waves of lanes are not
        ported)."""
        chip = device_chip()
        lanes = payload.shape[0]
        lane = per_instance_chip(chip, lanes)
        if lane.sms < 1:
            raise ValueError(
                f"a batched resident stencil plan runs every lane at once, "
                f"on at least one CTA each: {lanes} lanes outnumber the "
                f"{chip.sms} SMs of {chip.name}; run this batch on a loop "
                f"tier or in batches of at most {chip.sms}")
        return self._resident(payload, plan, lane)

    def _resident(self, x, plan, chip: Chip):
        """The resident tier on ``x`` (this problem's domain, or a batch of
        like domains) with ``plan`` fitted to ``chip`` (one domain's share
        of the card)."""
        plan.validate(radius=self.spec.radius, domain_rows=self.x.shape[0])
        if plan.cached_rows is None:
            raise ValueError("resident stencil plan must set cached_rows "
                             "(use repro_torch.exec.plan to build plans)")
        # a plan the card's kernels cannot hold runs at the layout they do
        plan, why = fit_stencil_plan(tuple(self.x.shape),
                                     self.x.element_size(), self.spec, plan,
                                     chip, n_steps=self.n_steps)
        if why is not None:
            warnings.warn(why, RuntimeWarning, stacklevel=4)
        H = self.x.shape[0]
        cached_rows = plan.cached_rows
        if cached_rows >= H:
            # stencil_resident where it holds the domain, else the one-step
            # kernel's boxes take every plane
            return kops.stencil_perks(x, spec=self.spec, steps=self.n_steps,
                                      cached_rows=H)
        if plan.schedule == "deep":
            return kops.stencil_perks_deep(
                x, spec=self.spec, steps=self.n_steps,
                cached_rows=cached_rows, sub_rows=plan.sub_rows,
                fuse_steps=plan.fuse_steps)
        return kops.stencil_perks(x, spec=self.spec, steps=self.n_steps,
                                  cached_rows=cached_rows,
                                  sub_rows=plan.sub_rows,
                                  fuse_steps=plan.fuse_steps)


# =============================================================================
# Conjugate gradient
# =============================================================================

def fused_block_rows(n: int, cap: int = 512) -> int:
    """Largest power-of-two block size <= cap dividing n: the reference's
    streamed fused kernel takes whole row blocks. Plans carry it as
    ``block_rows``; the CUDA kernel does not need it."""
    bm = 1
    while bm * 2 <= cap and n % (bm * 2) == 0:
        bm *= 2
    return bm


def place_operands(problem) -> torch.Tensor:
    """Check a Krylov problem's operator forms and precision, and move its
    ``b`` and ELL planes to its device (default ``"cuda"``; raises without
    a card unless ``device="cpu"``); returns ``b``."""
    if problem.matvec is None and problem.data is None:
        raise ValueError(f"{type(problem).__name__} needs ELL planes "
                         f"(data, cols) or a matvec callable")
    if problem.precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {problem.precision!r}")
    dev = _device.resolve(problem.device)
    object.__setattr__(problem, "device", dev)
    b = _device.as_domain(problem.b, dev)
    object.__setattr__(problem, "b", b)
    if problem.data is not None:
        object.__setattr__(problem, "data",
                           _device.as_domain(problem.data, dev))
        object.__setattr__(problem, "cols",
                           _device.as_domain(problem.cols, dev))
    return b


def loop_matvec(problem) -> Callable[[torch.Tensor], torch.Tensor]:
    """The loop tiers' SpMV of a Krylov problem: its matvec, else its ELL
    planes through ``kernels.ops.spmv``."""
    if problem.matvec is not None:
        return problem.matvec
    return functools.partial(kops.spmv, problem.data, problem.cols)


def check_fused(problem, what: str) -> None:
    """Raise unless the fused ``what`` kernel can run ``problem``: it needs
    ELL planes, and reduces in the storage dtype only."""
    if problem.data is None:
        raise NotImplementedError(
            f"the fused {what} kernel needs ELL planes (matvec-only "
            f"problem)")
    if problem.precision != "uniform":
        raise NotImplementedError(
            "mixed precision is a loop-tier dimension (the fused kernel "
            "reduces in the storage dtype)")


class SharedSteps:
    """Loop-tier step functions of a Krylov problem, one per precision,
    kept in a table that the problem shares with its ``with_precision``
    copies (each made once and kept) and its ``with_rhs`` copies. The
    device loop keeps its CUDA graph per step function (``core.perks``),
    so a mixed-precision run or a refinement round replays the graph of
    the first run instead of capturing its own. A class using it sets
    ``_steps`` in ``__post_init__`` (``object.__setattr__(self, "_steps",
    {})``) and builds its step in ``_make_step``."""

    @property
    def _step(self):
        fn = self._steps.get(self.precision)
        if fn is None:
            fn = self._steps[self.precision] = self._make_step()
        return fn

    def step_fn(self):
        return self._step

    def with_precision(self, precision: str):
        if precision == self.precision:
            return self
        copies = self.__dict__.setdefault("_precision_copies", {})
        if precision not in copies:
            copy = dataclasses.replace(self, precision=precision)
            object.__setattr__(copy, "_steps", self._steps)
            copies[precision] = copy
        return copies[precision]

    def with_rhs(self, b):
        """This problem against the right-hand side ``b``, sharing its
        operator and step functions (so its kept graphs)."""
        copy = dataclasses.replace(self, b=b)
        object.__setattr__(copy, "_steps", self._steps)
        return copy


#: Launches of one CG step on the card, its SpMV counted as one: the SpMV,
#: two dots, two ``_safe_div``s of five operations each (abs, compare,
#: divide, the zero's fill, where), and three axpys of two operations each
#: (``kernels.ref.cg_iteration_matvec``). The SELL operator's matvec is two
#: launches (the kernel and the row-order gather), which this count takes
#: as one. The planner charges the host loop this many dispatches per
#: step; ``tests/test_torch_cg.py`` counts the operators one step
#: dispatches against it.
CG_STEP_LAUNCHES = 19


@dataclasses.dataclass(frozen=True, eq=False)
class CGProblem(SharedSteps, Problem):
    """Conjugate gradient on an SPD operator.

    Two operator forms: ELL planes (``data``/``cols``, needed for the fused
    resident kernel) and/or an opaque ``matvec`` callable (e.g.
    ``solvers.cg.SellOperator.matvec``), which takes precedence in the loop
    tiers. ``matrix`` may carry any sparse container so the cache planner
    ranks A by its **true** nnz rather than padded slots.

    ``b``, ``data`` and ``cols`` are tensors or anything numpy takes; they
    are moved to ``device``, which defaults to ``"cuda"`` (without a card
    the constructor raises unless ``device="cpu"``). The result of
    ``execute`` is ``(x, rr)``, rr = ||r||^2 as a 0-dim tensor.
    """

    b: torch.Tensor
    n_steps: int
    data: Optional[torch.Tensor] = None
    cols: Optional[torch.Tensor] = None
    matvec: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    matrix: Any = None
    tol: Optional[float] = None
    precision: str = "uniform"
    device: Optional[_device.DeviceLike] = None

    kind = "cg"

    def __post_init__(self):
        b = place_operands(self)
        # the initial state and the tol threshold are made once, so the
        # device loop's kept graph (core.perks, keyed by the state's
        # addresses) is found again on the next execute, and planning reads
        # no tensor
        rr0 = torch.dot(b, b)
        object.__setattr__(self, "_state0", (torch.zeros_like(b), b, b, rr0))
        object.__setattr__(self, "_steps", {})
        object.__setattr__(self, "_thresh", None if self.tol is None
                           else self.tol * rr0)

    @classmethod
    def from_ell(cls, data, cols, b, iters: int, *, matrix=None,
                 tol: Optional[float] = None,
                 device: _device.DeviceLike = None) -> "CGProblem":
        return cls(b=b, n_steps=iters, data=data, cols=cols, matrix=matrix,
                   tol=tol, device=device)

    @classmethod
    def from_matvec(cls, matvec, b, iters: int, *, matrix=None,
                    tol: Optional[float] = None,
                    device: _device.DeviceLike = None) -> "CGProblem":
        return cls(b=b, n_steps=iters, matvec=matvec, matrix=matrix, tol=tol,
                   device=device)

    @property
    def name(self) -> str:  # type: ignore[override]
        fp = operator_fingerprint(self.data, self.cols, self.matrix,
                                  self.matvec)
        return f"cg_n{self.b.shape[0]}_{fp}"

    # -- protocol -------------------------------------------------------------

    def initial_state(self):
        return self._state0

    def _make_step(self):
        mv = loop_matvec(self)
        dot = dot_for(self.precision)
        return lambda s, out: kref.cg_iteration_matvec(s, mv, dot=dot,
                                                       out=out)

    def finalize(self, state):
        return state[0], state[3]

    def convergence(self):
        # relative residual: ||r_k||^2 < tol * ||b||^2, read on the host
        # only at sync points (core.perks.chunked_loop's on_sync)
        if self.tol is None:
            return None
        return (lambda s, th: s[3] < th), self._thresh

    def cacheable_arrays(self, *, fuse_steps: int = 1) -> Sequence[CacheableArray]:
        if self.matrix is not None:
            return cg_arrays_for(self.matrix)
        n = self.b.shape[0]
        nnz = self.data.numel() if self.data is not None else 0
        return cg_arrays(n, nnz, self.b.element_size())

    def oracle(self):
        if self.data is None:
            raise NotImplementedError("CG oracle needs ELL planes")
        return kref.cg_run(self.data, self.cols, self.b, self.n_steps)

    def halo_spec(self) -> HaloSpec:
        return HaloSpec(axis=0, halo=0, partitions=("rows", "nnz"))

    # -- batching -------------------------------------------------------------

    def payload(self):
        return self.b

    def with_payload(self, payload) -> "CGProblem":
        return self.with_rhs(payload)

    def array_scales_with_batch(self, name: str) -> bool:
        # the matrix is shared by every instance of a batch; the Krylov
        # vectors are per-instance
        return name != "A"

    def batched_tiers(self) -> tuple[str, ...]:
        if self.matvec is not None:
            return ()
        return ("host_loop", "device_loop", "resident")

    def batched_step_fn(self):
        """The loop tiers' step over (B, n) lanes: ``spmv_ell`` and
        ``vdot`` take every lane in one launch, so a batched step makes
        ``CG_STEP_LAUNCHES`` launches whatever B is."""
        if self.matvec is not None:
            raise NotImplementedError(
                "batched CG over a matvec callable (a SELL-C-sigma operator "
                "through csrc/spmv_sell.cu, or any opaque matvec) has no "
                "batched launch yet (ROADMAP, Queue 1: the batched "
                "spmv_sell); batch CG given as ELL planes")
        # the ELL step takes (B, n) stacks as it takes vectors
        return self._step

    def run_resident_batched(self, payload, plan):
        """``cg_fused`` over the B right-hand sides ``payload`` (B, n) in
        one launch; returns (x (B, n), rr (B,))."""
        check_fused(self, "CG")
        return kops.cg(self.data, self.cols, payload, iters=self.n_steps,
                       block_rows=plan.block_rows or 256,
                       matrix_rows=self.resident_matrix_rows(plan))

    def batch_key(self) -> tuple:
        # instances share one batch iff they solve against the same
        # operator with the same iteration budget
        fp = operator_fingerprint(self.data, self.cols, self.matrix,
                                  self.matvec)
        return ("cg", fp, _operand_sig(self.data), _operand_sig(self.cols),
                id(self.matvec), id(self.matrix), tuple(self.b.shape),
                str(self.b.dtype), self.n_steps, self.tol, self.precision)

    # -- tiers ----------------------------------------------------------------

    def run_resident(self, plan):
        """The fused kernel (``kernels.cg_fused``): VEC streams A, MIX/MAT
        keep the share of A the plan's ``"A"`` cache entry names (all of A
        when the plan has none)."""
        check_fused(self, "CG")
        x, rr = kops.cg(self.data, self.cols, self.b, iters=self.n_steps,
                        block_rows=plan.block_rows or 256,
                        matrix_rows=self.resident_matrix_rows(plan))
        return x, rr[0]

    def resident_matrix_rows(self, plan) -> int:
        """Rows of A the fused kernel keeps on chip under ``plan``
        (``plan_matrix_rows``)."""
        return plan_matrix_rows(plan, self.b.shape[0])

    def step_launches(self) -> int:
        """Launches of one loop-tier step (``CG_STEP_LAUNCHES``)."""
        return CG_STEP_LAUNCHES


def plan_matrix_rows(plan, n: int) -> int:
    """Rows of an n-row A that a fused Krylov kernel keeps on chip under
    ``plan``: none for VEC (and IMP), for MIX/MAT the share of the plan's
    ``"A"`` cache entry, all of A when the plan has no such entry."""
    if (plan.policy or "MIX") not in ("MAT", "MIX"):
        return 0
    a = next((c for c in plan.cache if c.name == "A"), None)
    if a is None or a.cached_bytes >= a.total_bytes:
        return n
    return n * a.cached_bytes // a.total_bytes
