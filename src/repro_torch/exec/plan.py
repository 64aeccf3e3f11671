"""The ``Plan`` artifact: one immutable, loggable answer to *how to run* —
the port of ``repro/exec/plan.py`` with the same JSON schema, so a plan
that either package serialises loads in the other.

A plan is everything the executor needs beyond the problem itself — the
execution tier, the temporal-blocking depth, the cache assignment, the
shard axis — frozen into a dataclass with a JSON round-trip so that a
chosen plan can be stored next to a benchmark CSV, attached to a CI
artifact, or replayed later with ``Plan.from_json``. Section numbers
(§) refer to the reference's ``docs/DESIGN.md``.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Optional

#: Reduction-hardening modes of the schema (``exec/precision.py``).
PRECISIONS = ("uniform", "mixed")

#: Execution tiers the executor dispatches on (DESIGN.md §2/§3).
TIERS = ("host_loop", "device_loop", "resident", "distributed")

#: Row-partition strategies for the distributed tier.
PARTITIONS = ("rows", "nnz")

#: Resident-tier temporal-blocking schedules (DESIGN.md §4/§12):
#: "shallow" = r*t-wide redundant-recompute windows (stencil_perks),
#: "deep" = wavefront scratchpad scheme (stencil_perks_deep).
SCHEDULES = ("shallow", "deep")


@dataclasses.dataclass(frozen=True)
class CacheDecision:
    """One array (or domain region) the plan keeps on-chip.

    ``cached_bytes`` of ``total_bytes`` stay on chip across steps —
    the executor-level record of a ``core.cache_policy.CacheAssignment``.
    """

    name: str
    cached_bytes: int
    total_bytes: int

    @property
    def fraction(self) -> float:
        return self.cached_bytes / self.total_bytes if self.total_bytes else 0.0


@dataclasses.dataclass(frozen=True)
class Plan:
    """An immutable execution plan for one iterative problem.

    Generic fields apply to every problem kind; ``cached_rows``/``sub_rows``
    are consumed by the resident stencil kernel, ``policy``/``block_rows``
    by the fused CG kernel, ``shard_axis``/``partition``/``fuse_reductions``
    by the distributed tier. Unused fields keep their defaults and survive
    the JSON round-trip unchanged.
    """

    tier: str
    n_steps: int = 0                      # 0 = "whatever the problem says"
    problem: str = ""                     # problem name, for logging only
    chip: str = "h100"
    #: instances served by ONE dispatch of this plan (repro.exec.batch):
    #: per-step traffic scales by batch, dispatch/barrier cost does not.
    batch: int = 1
    # temporal blocking / host sync (DESIGN.md §4)
    fuse_steps: int = 1
    #: which resident-tier blocking schedule runs the fused steps
    #: (DESIGN.md §12): "shallow" recomputes r*t-wide windows, "deep" is
    #: the wavefront scratchpad scheme — same arithmetic, different
    #: traffic/scratch economics. Loop/distributed tiers ignore it.
    schedule: str = "shallow"
    sync_every: Optional[int] = None
    # cache assignment (what stays on-chip across steps)
    cache: tuple[CacheDecision, ...] = ()
    cached_rows: Optional[int] = None     # stencil RESIDENT: resident planes
    sub_rows: int = 128                   # stencil RESIDENT: streaming tile
    policy: Optional[str] = None          # CG: IMP | VEC | MAT | MIX
    block_rows: Optional[int] = None      # CG fused kernel row-block size
    # distributed tier
    shard_axis: Optional[str] = None
    partition: str = "rows"
    fuse_reductions: bool = False         # CG: pipelined one-psum iterations
    #: s-step (communication-avoiding) depth: ONE collective per s_step
    #: iterations on the distributed tier (exec.krylov; DESIGN.md §10).
    s_step: int = 1
    inner_tier: str = "device_loop"       # loop tier inside the mesh program
    #: reduction hardening (exec.precision): "uniform" = storage dtype,
    #: "mixed" = fp64-or-compensated dots in the loop-tier step functions.
    precision: str = "uniform"
    # planner metadata (projected cost of this plan; not used by execute)
    predicted_s: Optional[float] = None
    predicted_bound: Optional[str] = None

    def __post_init__(self):
        if self.tier not in TIERS:
            raise ValueError(f"tier must be one of {TIERS}, got {self.tier!r}")
        if self.inner_tier not in ("host_loop", "device_loop"):
            raise ValueError(
                f"inner_tier must be host_loop|device_loop, got "
                f"{self.inner_tier!r}")
        if self.partition not in PARTITIONS:
            raise ValueError(
                f"partition must be one of {PARTITIONS}, got "
                f"{self.partition!r}")
        if self.fuse_steps < 1:
            raise ValueError(f"fuse_steps must be >= 1, got {self.fuse_steps}")
        if self.n_steps < 0:
            raise ValueError(f"n_steps must be >= 0, got {self.n_steps}")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.s_step < 1:
            raise ValueError(f"s_step must be >= 1, got {self.s_step}")
        if self.s_step > 1 and self.tier != "distributed":
            raise ValueError(
                "s_step > 1 is a distributed-tier dimension (it folds the "
                f"reduction collectives); tier={self.tier!r} has no "
                "collectives to fold")
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, got "
                f"{self.precision!r}")
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"schedule must be one of {SCHEDULES}, got "
                f"{self.schedule!r}")

    # -- kernel-feasibility validation ----------------------------------------

    def validate(self, *, radius: Optional[int] = None,
                 domain_rows: Optional[int] = None) -> "Plan":
        """Reject plans the resident kernels cannot legally run, with a
        message that names the violated constraint — the executor-level
        home of what used to be a bare ``assert`` inside ``stencil_perks``.

        ``radius``/``domain_rows`` come from the problem (a Plan does not
        know the stencil geometry); when omitted, only geometry-free
        checks run. Returns ``self`` so call sites can chain. Raises
        :class:`ValueError` on the first violation.
        """
        if self.tier != "resident" or radius is None:
            return self
        r = radius
        eff_t = min(self.fuse_steps, self.n_steps) if self.n_steps \
            else self.fuse_steps
        if self.schedule == "shallow":
            need = r * eff_t
            if self.sub_rows < need:
                raise ValueError(
                    f"shallow resident plan is infeasible: sub_rows="
                    f"{self.sub_rows} < radius*fuse_steps = {r}*{eff_t} = "
                    f"{need} — the streaming subtile cannot carry the "
                    f"fused halo. Shrink fuse_steps, grow sub_rows, or "
                    f"use schedule='deep' (needs only sub_rows >= radius)")
        else:
            if self.sub_rows < r:
                raise ValueError(
                    f"deep resident plan is infeasible: sub_rows="
                    f"{self.sub_rows} < radius = {r} — one wavefront "
                    f"block must carry a single level's halo")
        cached = self.cached_rows
        if cached is not None and domain_rows is not None:
            if cached > domain_rows:
                raise ValueError(
                    f"resident plan caches {cached} rows of a "
                    f"{domain_rows}-row domain")
            if 0 < cached < domain_rows and cached < r:
                raise ValueError(
                    f"resident plan is infeasible: cached_rows={cached} "
                    f"< radius={r} — partial caching needs at least one "
                    f"halo's worth of resident rows")
        return self

    # -- derived quantities ---------------------------------------------------

    @property
    def barriers(self) -> int:
        """Device-wide barriers this plan pays: ceil(n_steps/fuse_steps),
        with s-step folding (one collective per ``s_step`` iterations)
        compounding the same way — the two never combine (plan validation
        in the adapters rejects it), so the effective stride is the max."""
        if self.n_steps == 0:
            return 0
        return math.ceil(self.n_steps / max(self.fuse_steps, self.s_step))

    @property
    def cached_bytes(self) -> int:
        return sum(d.cached_bytes for d in self.cache)

    # -- JSON round-trip ------------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["cache"] = [dataclasses.asdict(c) for c in self.cache]
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Plan":
        d = dict(d)
        cache = tuple(CacheDecision(**c) for c in d.pop("cache", ()))
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown Plan fields: {sorted(unknown)}")
        return cls(cache=cache, **d)

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "Plan":
        return cls.from_dict(json.loads(text))
