"""Problem adapters: the stencil described for the executor — the stencil
part of ``repro/exec/adapters.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core.cache_policy import CacheableArray, stencil_shard_arrays
from repro_torch.exec.problem import HaloSpec, Problem
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.common import StencilSpec


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

    # -- tiers ----------------------------------------------------------------

    def run_resident(self, plan):
        plan.validate(radius=self.spec.radius, domain_rows=self.x.shape[0])
        cached_rows = plan.cached_rows
        if cached_rows is None:
            raise ValueError("resident stencil plan must set cached_rows "
                             "(use repro_torch.exec.plan to build plans)")
        if cached_rows >= self.x.shape[0]:
            return kops.stencil_resident(self.x, spec=self.spec,
                                         steps=self.n_steps)
        if plan.schedule == "deep":
            raise NotImplementedError(
                "schedule='deep' needs stencil_perks_deep, which is not "
                "ported yet (ROADMAP, Queue 2: stencil_perks_deep)")
        return kops.stencil_perks(self.x, spec=self.spec, steps=self.n_steps,
                                  cached_rows=cached_rows,
                                  sub_rows=plan.sub_rows,
                                  fuse_steps=plan.fuse_steps)
