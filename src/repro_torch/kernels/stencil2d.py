"""PERKS stencil kernels on Hopper: the port of ``repro/kernels/stencil2d.py``.

Three entry points with the reference's signatures, generic over 2D/3D
(blocking is along the leading axis; a 3D "row" is a whole plane):

``stencil_perks``
    ``steps`` steps in ONE cooperative persistent launch; rows
    [0, cached_rows) stay in shared memory for the kernel's whole life, the
    rest stream between two device-memory ping-pong buffers every step
    (``csrc/stencil_perks.cu``).
``stencil_resident``
    The same kernel with every row cached; raises ``ValueError`` when the
    domain does not fit the co-resident CTAs' shared memory.
``stencil_baseline_step``
    One non-persistent, out-of-place step (``csrc/stencil_step.cu``): the
    loop tiers' step on the card.

Dispatch: a CPU tensor runs the plain torch version (``ref.py``); a CUDA
tensor launches the hand kernel or raises — there is no fallback. Each
wrapper counts its launches in its ``launches`` attribute.

Not ported yet (ROADMAP): ``fuse_steps > 1`` in the CUDA kernel (the CUDA
path raises ``NotImplementedError``), the deep wavefront schedule
(``stencil_perks_deep``), dtypes other than float32 on the card, and
cached rows wider than one CTA can hold.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import StencilSpec

#: Threads of one persistent CTA and the widest row (cells) its registers
#: hold while a row is updated in place (``csrc/stencil_perks.cu``).
PERKS_THREADS = 1024
PERKS_MAX_ROW_CELLS = 20 * PERKS_THREADS
#: Shared memory per CTA reserved for the kernel's static buffers (the spec
#: and the row-pointer table). The planner and the wrapper both give a band
#: the opt-in per-block limit less this reserve; the wrapper checks at each
#: launch that the built kernel's static shared memory fits in it.
PERKS_STATIC_SMEM = 1024


# -- layout arithmetic shared by the wrappers and the planner -----------------

def rows_per_cta(row_cells: int, dtype_bytes: int, radius: int,
                 smem_bytes: int) -> int:
    """Cached rows one CTA can hold: its shared memory less the ``radius``-
    row ring of old values the in-place update keeps; 0 for rows wider
    than the kernel's registers hold."""
    if row_cells > PERKS_MAX_ROW_CELLS:
        return 0
    return max(0, smem_bytes // (row_cells * dtype_bytes) - radius)


def band_layout(cached_rows: int, radius: int, ctas: int) -> tuple[int, int]:
    """``(bands, rows of the largest band)``: the cached rows are cut into
    at most ``ctas`` contiguous bands of at least ``radius`` rows each, so
    a neighbour's halo always lies in the adjacent band's published
    border."""
    if cached_rows == 0:
        return 0, 0
    nb = max(1, min(ctas, cached_rows // radius))
    return nb, -(-cached_rows // nb)


def band_smem_bytes(cached_rows: int, radius: int, row_bytes: int,
                    ctas: int) -> int:
    """Dynamic shared memory one CTA needs: its band plus the ring."""
    nb, maxband = band_layout(cached_rows, radius, ctas)
    return 0 if nb == 0 else (maxband + radius) * row_bytes


# -- argument checks -----------------------------------------------------------

def _check_perks_args(x, spec: StencilSpec, steps: int, cached_rows: int,
                      sub_rows: int, fuse_steps: int) -> None:
    """The reference's kernel preconditions, raised as ``ValueError``."""
    H, r = x.shape[0], spec.radius
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if fuse_steps < 1:
        raise ValueError(f"fuse_steps must be >= 1, got {fuse_steps}")
    if not 0 <= cached_rows <= H:
        raise ValueError(f"cached_rows={cached_rows} outside [0, {H}]")
    if cached_rows not in (0, H) and cached_rows < r:
        raise ValueError("partial caching needs at least `radius` resident "
                         f"rows (cached_rows={cached_rows} < radius={r})")
    if sub_rows < r * min(fuse_steps, steps):
        raise ValueError(
            "subtile must cover the next subtile's fused halo "
            f"(sub_rows >= radius*fuse_steps = {r * min(fuse_steps, steps)})")


def _check_cuda(x: torch.Tensor, spec: StencilSpec) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA stencil kernels take float32, got "
                        f"{x.dtype} (other dtypes: ROADMAP)")
    if x.dim() != spec.ndim or spec.ndim not in (2, 3):
        raise ValueError(f"{spec.name} needs a {spec.ndim}D domain, got "
                         f"shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("the CUDA stencil kernels take contiguous tensors")
    if x.numel() >= 2**31:
        raise ValueError(f"domain of {x.numel()} cells exceeds 32-bit "
                         f"indexing")
    if spec.npoints > _build.MAX_POINTS or not 1 <= spec.radius <= _build.MAX_RADIUS:
        raise ValueError(f"{spec.name}: the kernels take at most "
                         f"{_build.MAX_POINTS} points and radius 1.."
                         f"{_build.MAX_RADIUS}")


@functools.lru_cache(maxsize=64)
def stencil_args(spec: StencilSpec, shape: tuple[int, ...]) -> _build.StencilArgs:
    """The kernels' by-value description of ``spec`` on a domain ``shape``
    (cached: the loop tiers launch with the same one every step)."""
    D2 = shape[-1]
    D1 = shape[1] if spec.ndim == 3 else 1
    a = _build.StencilArgs()
    a.H, a.D1, a.D2 = shape[0], D1, D2
    a.P, a.ndim, a.r, a.npts = D1 * D2, spec.ndim, spec.radius, spec.npoints
    for k, (off, w) in enumerate(zip(spec.offsets, spec.weights)):
        a.d0[k] = off[0]
        a.dc[k] = off[1] * D2 + off[2] if spec.ndim == 3 else off[1]
        a.w[k] = w
    return a


# -- the persistent kernel ----------------------------------------------------

def _launch_perks(x: torch.Tensor, spec: StencilSpec, steps: int,
                  cached_rows: int) -> torch.Tensor:
    """Launch the persistent kernel on a checked CUDA tensor."""
    lib = _build.load("stencil_perks")
    if lib.stencil_perks_max_row_cells() != PERKS_MAX_ROW_CELLS:
        raise RuntimeError("csrc/stencil_perks.cu and stencil2d.py disagree "
                           "on the widest cached row")
    H, r = x.shape[0], spec.radius
    row_cells = math.prod(x.shape[1:])
    row_bytes = row_cells * x.element_size()
    with _build.on_device(x):
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        optin, static = ctypes.c_int(), ctypes.c_int()
        _build.check(lib.stencil_perks_smem(spec.npoints, ctypes.byref(optin),
                                            ctypes.byref(static)),
                     "stencil_perks_smem")
        if static.value > PERKS_STATIC_SMEM:
            raise RuntimeError(
                f"the built stencil_perks kernel takes {static.value} B of "
                f"static shared memory, more than the {PERKS_STATIC_SMEM} B "
                f"that stencil2d.PERKS_STATIC_SMEM reserves for it")
        limit = optin.value - PERKS_STATIC_SMEM
        nb, maxband = band_layout(cached_rows, r, sms)
        smem = band_smem_bytes(cached_rows, r, row_bytes, sms)
        if nb and (row_cells > PERKS_MAX_ROW_CELLS or smem > limit):
            cap = sms * rows_per_cta(row_cells, x.element_size(), r, limit)
            raise ValueError(
                f"cannot cache {cached_rows} rows of {row_cells} float32 "
                f"cells: a band of {maxband} rows plus the {r}-row ring "
                f"needs {smem} B of shared memory per CTA and a CTA has "
                f"{limit} B, so the kernel holds at most {cap} rows "
                f"of this width over {sms} SMs (rows wider than "
                f"{PERKS_MAX_ROW_CELLS} cells are not cached)")
        grid = ctypes.c_int()
        _build.check(lib.stencil_perks_max_ctas(spec.npoints, smem,
                                                ctypes.byref(grid)),
                     "stencil_perks_max_ctas")
        if grid.value < max(nb, 1):
            raise ValueError(f"{nb} bands need {nb} co-resident CTAs, the "
                             f"card runs {grid.value} with {smem} B each")
        buf0 = torch.empty_like(x)
        buf1 = torch.empty_like(x)
        err = lib.stencil_perks_launch(
            x.data_ptr(), buf0.data_ptr(), buf1.data_ptr(),
            stencil_args(spec, tuple(x.shape)), steps, cached_rows, nb,
            grid.value, smem, _build.stream())
    _build.check(err, "stencil_perks_launch")
    return buf0 if (steps - 1) % 2 == 0 else buf1


def stencil_perks(
    x: torch.Tensor,
    spec: StencilSpec,
    *,
    steps: int,
    cached_rows: int,
    sub_rows: int = 128,
    fuse_steps: int = 1,
) -> torch.Tensor:
    """Run ``steps`` time steps of ``spec`` with rows [0, cached_rows) kept
    on chip for the kernel's whole lifetime (the PERKS scheme); ``x`` is
    not written.

    ``sub_rows`` is the reference's streaming tile, checked as the
    reference checks it; the CUDA kernel streams cell by cell and does not
    use it. ``fuse_steps > 1`` runs on the CPU only (the plain version
    performs the same steps); the CUDA kernel raises for it.
    """
    _check_perks_args(x, spec, steps, cached_rows, sub_rows, fuse_steps)
    if _build.is_cpu(x, "stencil"):
        return ref.stencil_run(x, spec, steps)
    if fuse_steps > 1:
        raise NotImplementedError(
            "fuse_steps > 1 (temporal blocking) is not in the CUDA kernel "
            "yet (ROADMAP)")
    _check_cuda(x, spec)
    if steps == 0:
        return x.clone()
    out = _launch_perks(x, spec, steps, cached_rows)
    stencil_perks.launches += 1
    return out


stencil_perks.launches = 0


def stencil_resident(
    x: torch.Tensor,
    spec: StencilSpec,
    *,
    steps: int,
) -> torch.Tensor:
    """Small-domain PERKS: the whole domain stays in the co-resident CTAs'
    shared memory for all steps — device memory sees one load and one
    store. Raises ``ValueError`` if it does not fit; never streams."""
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if _build.is_cpu(x, "stencil"):
        return ref.stencil_run(x, spec, steps)
    _check_cuda(x, spec)
    if steps == 0:
        return x.clone()
    out = _launch_perks(x, spec, steps, x.shape[0])
    stencil_resident.launches += 1
    return out


stencil_resident.launches = 0


def stencil_baseline_step(
    x: torch.Tensor,
    spec: StencilSpec,
    *,
    sub_rows: int = 128,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One non-persistent time step (the host-loop baseline's kernel),
    written into ``out`` when given (it must not alias ``x``). ``sub_rows``
    is accepted for the reference's signature and not used."""
    if _build.is_cpu(x, "stencil"):
        return ref.stencil_step(x, spec, out=out)
    _check_cuda(x, spec)
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()
          or out.data_ptr() == x.data_ptr()):
        raise ValueError("out must be a contiguous tensor like x, apart "
                         "from x")
    lib = _build.load("stencil_step")
    with _build.on_device(x):
        err = lib.stencil_step_launch(x.data_ptr(), out.data_ptr(),
                                      stencil_args(spec, tuple(x.shape)),
                                      _build.stream())
    _build.check(err, "stencil_step_launch")
    stencil_baseline_step.launches += 1
    return out


stencil_baseline_step.launches = 0
