"""The nonsymmetric Krylov family for the executor: BiCGStab and restarted
GMRES(m) — the single-device part of ``repro/exec/krylov.py``.

* :class:`BiCGStabProblem` — two SpMVs and five dots per iteration; its
  resident tier is one launch of ``kernels.krylov_fused.bicgstab_fused``
  with the vectors, and all or part of A, in shared memory.
* :class:`GMRESProblem` — one executor step is one restart cycle (m inner
  Arnoldi steps). The basis V, (m+1) x n, is a cacheable array of its own;
  when V and all of A fit on chip the resident tier runs each cycle,
  its small least-squares solve and the update of x included, as one
  launch of ``gmres_cycle_fused``.

Both take the operator as ELL planes (needed by the fused kernels) and/or
an opaque ``matvec``, like ``CGProblem``, and run host_loop, device_loop (a
kept CUDA graph) and resident through ``plan`` -> ``execute``.

Both batch as CG does: B right-hand sides against one operator given as
ELL planes run on the loop tiers as (B, n) lanes (``batched_step_fn``), one
``spmv_ell`` and one ``vdot`` launch for every lane at each SpMV and dot,
so a batched step makes the single step's launches, and each lane is bit
for bit its instance solved alone. A batch runs no resident tier:
``csrc/bicgstab_fused.cu`` and ``csrc/gmres_cycle_fused.cu`` take one
right-hand side a launch.

Not ported here: the distributed tier (``bicgstab_distributed``,
``gmres_distributed``, s-step CG: ``sstep_block``, ``cg_sstep_run``,
``cg_sstep_distributed``) comes with the multi-device slice, so
``run_distributed`` is the ``Problem`` default, which raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core.cache_policy import (
    CacheableArray,
    bicgstab_arrays,
    bicgstab_arrays_for,
    gmres_arrays,
    gmres_arrays_for,
)
from repro_torch.exec.adapters import (
    SharedSteps,
    _operand_sig,
    check_fused,
    loop_matvec,
    operator_fingerprint,
    place_operands,
    plan_matrix_rows,
)
from repro_torch.exec.precision import dot_for
from repro_torch.exec.problem import HaloSpec, Problem
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

#: Launches of one BiCGStab step on the card, each SpMV counted as one: two
#: SpMVs, five dots, four ``_safe_div``s of five operations each (abs,
#: compare, divide, the zero's fill, where), beta's product, and the vector
#: updates with the scalar products that feed them (p: four; s: two; x:
#: four; r: two) (``kernels.ref.bicgstab_iteration_matvec``).
#: ``tests/test_torch_krylov.py`` counts the operators one step dispatches
#: against it; the planner charges the host loop this many per step.
BICGSTAB_STEP_LAUNCHES = 40


def GMRES_CYCLE_LAUNCHES(m: int) -> int:
    """Launches of one GMRES(m) cycle on the card (``kernels.ref.
    gmres_cycle_matvec``), each SpMV and each lane dot counted as one,
    views and in-place reshapes not counted; the same for B lanes as for
    one. 41 per Arnoldi step: 20 for the step (the SpMV, two projections
    of four operations: the lane dot, the products, their sum over the
    basis and the difference; the norm, two writes to H, the zero-guarded
    reciprocal of six and the scaled basis vector), 14 for its Givens
    rotation (the radius and its test, cos and sin of three operations
    each, the two rows' four products, their sum and difference) and 7 for its
    back-substitution column; and 21 per cycle (the starting residual and
    its norm, V, H, the first basis vector, the least-squares set-up, the
    first column's missing update, y, x += y V[:m] and the final residual).
    Counted by ``tests/test_torch_krylov.py`` for several m, and with
    lanes by ``tests/test_torch_krylov_batch.py``."""
    return 41 * m + 21


class _KrylovLanes:
    """The batching surface BiCGStab and GMRES share: the payload is b, A
    is shared by every lane, and a batch over ELL planes steps (B, n) lanes
    on the loop tiers with the single step function (``spmv_ell`` and
    ``vdot`` take every lane in one launch). A class using it names its
    fused kernel in ``_fused_source``."""

    _fused_source = ""

    def payload(self):
        return self.b

    def with_payload(self, payload):
        return self.with_rhs(payload)

    def array_scales_with_batch(self, name: str) -> bool:
        # the matrix is shared by every instance of a batch; the Krylov
        # vectors (and GMRES's basis) are per-instance
        return name != "A"

    def batched_tiers(self) -> tuple[str, ...]:
        if self.matvec is not None:
            return ()
        return ("host_loop", "device_loop")

    def batched_step_fn(self):
        """The loop tiers' step over (B, n) lanes, making the single step's
        launches (``step_launches``) whatever B is."""
        if self.matvec is not None:
            raise NotImplementedError(
                f"batched {type(self).__name__} (family {self.kind!r}) over "
                f"a matvec callable (a SELL-C-sigma operator through "
                f"csrc/spmv_sell.cu, or any opaque matvec) has no batched "
                f"launch yet (ROADMAP, Queue 1: the batched spmv_sell); "
                f"batch it given as ELL planes")
        return self._step

    @property
    def batched_resident_missing(self) -> str:
        return (f"{self._fused_source} takes one right-hand side a launch "
                f"(ROADMAP, Queue 1: the batched resident Krylov launches); "
                f"such a batch runs on the loop tiers")


# =============================================================================
# BiCGStab
# =============================================================================

@dataclasses.dataclass(frozen=True, eq=False)
class BiCGStabProblem(_KrylovLanes, SharedSteps, Problem):
    """BiCGStab on a (possibly nonsymmetric) operator.

    The operator forms of ``CGProblem``: ELL planes (``data``/``cols``,
    needed by the fused resident kernel) and/or an opaque ``matvec``, which
    the loop tiers take first; ``matrix`` carries the exact container so
    the planner ranks A by its true nnz. Operands are tensors or anything
    numpy takes, moved to ``device`` (default ``"cuda"``; without a card
    the constructor raises unless ``device="cpu"``). ``execute`` returns
    ``(x, rr)``, rr = ||r||^2 as a 0-dim tensor.
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

    kind = "bicgstab"
    _fused_source = "csrc/bicgstab_fused.cu"

    def __post_init__(self):
        b = place_operands(self)
        # made once, so the device loop's kept graph (keyed by the state's
        # addresses) is found again on the next execute
        state0 = kref.bicgstab_initial_state(b)
        object.__setattr__(self, "_state0", state0)
        object.__setattr__(self, "_steps", {})
        object.__setattr__(self, "_thresh", None if self.tol is None
                           else self.tol * state0[8])

    @classmethod
    def from_ell(cls, data, cols, b, iters: int, *, matrix=None,
                 tol: Optional[float] = None,
                 device: _device.DeviceLike = None) -> "BiCGStabProblem":
        return cls(b=b, n_steps=iters, data=data, cols=cols, matrix=matrix,
                   tol=tol, device=device)

    @classmethod
    def from_matvec(cls, matvec, b, iters: int, *, matrix=None,
                    tol: Optional[float] = None,
                    device: _device.DeviceLike = None) -> "BiCGStabProblem":
        return cls(b=b, n_steps=iters, matvec=matvec, matrix=matrix, tol=tol,
                   device=device)

    @property
    def name(self) -> str:  # type: ignore[override]
        fp = operator_fingerprint(self.data, self.cols, self.matrix,
                                  self.matvec)
        return f"bicgstab_n{self.b.shape[0]}_{fp}"

    # -- protocol -------------------------------------------------------------

    def initial_state(self):
        return self._state0

    def _make_step(self):
        mv = loop_matvec(self)
        dot = dot_for(self.precision)
        return lambda s, out: kref.bicgstab_iteration_matvec(s, mv, dot=dot,
                                                             out=out)

    def step_launches(self) -> int:
        """Launches of one loop-tier step (``BICGSTAB_STEP_LAUNCHES``)."""
        return BICGSTAB_STEP_LAUNCHES

    def finalize(self, state):
        return state[0], state[8]

    def convergence(self):
        if self.tol is None:
            return None
        return (lambda s, th: s[8] < th), self._thresh

    def cacheable_arrays(self, *, fuse_steps: int = 1) -> Sequence[CacheableArray]:
        if self.matrix is not None:
            return bicgstab_arrays_for(self.matrix)
        nnz = self.data.numel() if self.data is not None else 0
        return bicgstab_arrays(self.b.shape[0], nnz, self.b.element_size())

    def oracle(self):
        if self.data is None:
            raise NotImplementedError("BiCGStab oracle needs ELL planes")
        return kref.bicgstab_run(self.data, self.cols, self.b, self.n_steps)

    def halo_spec(self) -> HaloSpec:
        return HaloSpec(axis=0, halo=0, partitions=("rows",))

    def batch_key(self) -> tuple:
        fp = operator_fingerprint(self.data, self.cols, self.matrix,
                                  self.matvec)
        return ("bicgstab", fp, _operand_sig(self.data),
                _operand_sig(self.cols), id(self.matvec),
                tuple(self.b.shape), str(self.b.dtype), self.n_steps,
                self.tol, self.precision)

    # -- tiers ----------------------------------------------------------------

    def resident_matrix_rows(self, plan) -> int:
        """Rows of A the fused kernel keeps on chip under ``plan``
        (``adapters.plan_matrix_rows``)."""
        return plan_matrix_rows(plan, self.b.shape[0])

    def run_resident(self, plan):
        """The fused kernel (``kernels.krylov_fused.bicgstab_fused``): VEC
        streams A twice per iteration, MIX/MAT keep the share of A the
        plan's ``"A"`` cache entry names (all of A without one)."""
        check_fused(self, "BiCGStab")
        x, rr = kops.bicgstab(self.data, self.cols, self.b,
                              iters=self.n_steps,
                              block_rows=plan.block_rows or 256,
                              matrix_rows=self.resident_matrix_rows(plan))
        return x, rr[0]


# =============================================================================
# GMRES(m)
# =============================================================================

@dataclasses.dataclass(frozen=True, eq=False)
class GMRESProblem(_KrylovLanes, SharedSteps, Problem):
    """Restarted GMRES(m); one executor step is one restart cycle.

    ``n_steps`` counts cycles of m inner Arnoldi steps. The right-hand side
    rides in the loop state ``(x, rr, b)``, as in the reference (whose
    batched tier gives every lane its own b); the step function returns the
    state's own ``b`` untouched, so the runners never copy it. Operands and
    ``device`` as in :class:`BiCGStabProblem`.
    """

    b: torch.Tensor
    n_steps: int
    m: int = 16
    data: Optional[torch.Tensor] = None
    cols: Optional[torch.Tensor] = None
    matvec: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    matrix: Any = None
    tol: Optional[float] = None
    precision: str = "uniform"
    device: Optional[_device.DeviceLike] = None

    kind = "gmres"
    _fused_source = "csrc/gmres_cycle_fused.cu"

    def __post_init__(self):
        if self.m < 1:
            raise ValueError(f"m must be >= 1, got {self.m}")
        b = place_operands(self)
        rr0 = torch.dot(b, b)
        object.__setattr__(self, "_state0", (torch.zeros_like(b), rr0, b))
        object.__setattr__(self, "_steps", {})
        object.__setattr__(self, "_thresh", None if self.tol is None
                           else self.tol * rr0)

    @classmethod
    def from_ell(cls, data, cols, b, cycles: int, *, m: int = 16,
                 matrix=None, tol: Optional[float] = None,
                 device: _device.DeviceLike = None) -> "GMRESProblem":
        return cls(b=b, n_steps=cycles, m=m, data=data, cols=cols,
                   matrix=matrix, tol=tol, device=device)

    @classmethod
    def from_matvec(cls, matvec, b, cycles: int, *, m: int = 16,
                    matrix=None, tol: Optional[float] = None,
                    device: _device.DeviceLike = None) -> "GMRESProblem":
        return cls(b=b, n_steps=cycles, m=m, matvec=matvec, matrix=matrix,
                   tol=tol, device=device)

    @property
    def name(self) -> str:  # type: ignore[override]
        fp = operator_fingerprint(self.data, self.cols, self.matrix,
                                  self.matvec)
        return f"gmres_n{self.b.shape[0]}_m{self.m}_{fp}"

    # -- protocol -------------------------------------------------------------

    def initial_state(self):
        return self._state0

    def _make_step(self):
        mv = loop_matvec(self)
        m = self.m
        dot = dot_for(self.precision)

        def cycle(state, out):
            x, rr, b = state
            x, rr = kref.gmres_cycle_matvec((x, rr), mv, b, m, dot=dot,
                                            out=out[0], proj=kops.vdot)
            return (x, rr, b)

        return cycle

    def step_launches(self) -> int:
        """Launches of one loop-tier cycle (``GMRES_CYCLE_LAUNCHES``)."""
        return GMRES_CYCLE_LAUNCHES(self.m)

    def finalize(self, state):
        return state[0], state[1]

    def convergence(self):
        if self.tol is None:
            return None
        return (lambda s, th: s[1] < th), self._thresh

    def cacheable_arrays(self, *, fuse_steps: int = 1) -> Sequence[CacheableArray]:
        if self.matrix is not None:
            return gmres_arrays_for(self.matrix, self.m)
        nnz = self.data.numel() if self.data is not None else 0
        return gmres_arrays(self.b.shape[0], self.m, nnz,
                            self.b.element_size())

    def oracle(self):
        if self.data is None:
            raise NotImplementedError("GMRES oracle needs ELL planes")
        return kref.gmres_run(self.data, self.cols, self.b, self.n_steps,
                              self.m)

    def halo_spec(self) -> HaloSpec:
        return HaloSpec(axis=0, halo=0, partitions=("rows",))

    def batch_key(self) -> tuple:
        fp = operator_fingerprint(self.data, self.cols, self.matrix,
                                  self.matvec)
        return ("gmres", fp, _operand_sig(self.data),
                _operand_sig(self.cols), id(self.matvec),
                tuple(self.b.shape), str(self.b.dtype), self.n_steps,
                self.m, self.tol, self.precision)

    # -- tiers ----------------------------------------------------------------

    def run_resident(self, plan):
        """Each cycle is one launch of ``gmres_cycle_fused``: the basis and
        all of A on chip, the (m+1) x m least-squares problem solved by
        Givens rotations in every CTA and x + y V[:m] written by the
        kernel, so nothing leaves the card. The final residual is one
        ``spmv_ell`` launch."""
        check_fused(self, "GMRES cycle")
        x = torch.zeros_like(self.b)
        for _ in range(self.n_steps):
            x = kops.gmres_cycle(self.data, self.cols, x, self.b, m=self.m)[3]
        r = self.b - kops.spmv(self.data, self.cols, x)
        return x, torch.dot(r, r)
