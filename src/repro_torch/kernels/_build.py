"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``.cu`` file becomes its own shared library with a plain C interface,
compiled for ``sm_90a`` at first use (never at import) into ``build/kernels``
at the root of the checkout. A library's file name carries a digest of its
sources and flags, so an edited source is rebuilt and a stale library is
never loaded. ``build_all`` starts one ``nvcc`` per source at once. The
cooperative kernels' capacity checks live here too: ``smem_limit``,
``require_ctas`` and the row-split shared-memory ``layout``/``fit`` of the
fused Krylov kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: library name -> its CUDA source in csrc/
SOURCES = {
    "stencil_step": "stencil_step.cu",
    "stencil_perks": "stencil_perks.cu",
    "stencil_resident": "stencil_resident.cu",
    "stencil_shallow": "stencil_shallow.cu",
    "stencil_tb": "stencil_tb.cu",
    "spmv_ell": "spmv_ell.cu",
    "spmv_sell": "spmv_sell.cu",
    "cg_fused": "cg_fused.cu",
    "bicgstab_fused": "bicgstab_fused.cu",
    "gmres_cycle_fused": "gmres_cycle_fused.cu",
    "ssm_scan": "ssm_scan.cu",
    "decode_attn": "decode_attn.cu",
    "vdot": "vdot.cu",
}
HEADERS = ("stencil_common.cuh", "stencil_band.cuh", "stencil_async.cuh",
           "krylov_common.cuh")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: ``-D`` flags that ``load`` builds with: the profiles of the deep
#: schedule's waits (``DEEP_PROFILE``), of ``stencil_resident``'s step
#: phases (``RES_PROFILE``) and of the fused Krylov kernels' rounds
#: (``KRY_PROFILE``), for variant builds as ``scripts/kernel_variants.py``
#: makes them; empty for the shipped kernels. Every tuning value is a plain
#: constant.
EXTRA_FLAGS: tuple[str, ...] = ()

MAX_POINTS = 32
MAX_RADIUS = 8


class StencilArgs(ctypes.Structure):
    """Mirror of ``struct StencilArgs`` in ``csrc/stencil_common.cuh``."""

    _fields_ = [
        ("H", ctypes.c_int), ("D1", ctypes.c_int), ("D2", ctypes.c_int),
        ("P", ctypes.c_int), ("ndim", ctypes.c_int), ("r", ctypes.c_int),
        ("npts", ctypes.c_int),
        ("d0", ctypes.c_int * MAX_POINTS),
        ("dc", ctypes.c_int * MAX_POINTS),
        ("d1", ctypes.c_int * MAX_POINTS),
        ("d2", ctypes.c_int * MAX_POINTS),
        ("w", ctypes.c_float * MAX_POINTS),
    ]


class StepArgs(ctypes.Structure):
    """Mirror of ``struct StepArgs`` in ``csrc/stencil_step.cu``."""

    _fields_ = [(f, ctypes.c_int) for f in (
        "lanes", "rows", "ra", "span", "slot", "slots", "seg", "tiles_x",
        "aligned")]


class TbArgs(ctypes.Structure):
    """Mirror of ``struct TbArgs`` in ``csrc/stencil_tb.cu``."""

    _fields_ = [(f, ctypes.c_int) for f in (
        "steps", "t", "R", "nb", "sy", "sx", "rows", "band_bytes",
        "q0", "q", "h0", "w0")]


class ShallowArgs(ctypes.Structure):
    """Mirror of ``struct ShallowArgs`` in ``csrc/stencil_shallow.cu``
    (``lin`` and ``async_`` are filled by its launcher)."""

    _fields_ = [(f, ctypes.c_int) for f in (
        "steps", "t", "R", "nb", "sy", "sx", "rows", "left", "wx", "wy",
        "segs", "prefetch", "band_bytes", "buf_cells", "async_")] + [
        ("lin", ctypes.c_int * MAX_POINTS)]


class PerksArgs(ctypes.Structure):
    """Mirror of ``struct PerksArgs`` in ``csrc/stencil_perks.cu``
    (``async_`` and ``lin`` are filled by its launcher)."""

    _fields_ = [(f, ctypes.c_int) for f in (
        "steps", "R", "nbz", "nby", "box_bytes", "sy", "sx", "left", "wx",
        "wy", "nseg", "slots", "async_")] + [
        ("lin", ctypes.c_int * MAX_POINTS)]


class ResArgs(ctypes.Structure):
    """Mirror of ``struct ResArgs`` in ``csrc/stencil_resident.cu``
    (``safe``, ``cells``, ``lin`` and ``async_`` are filled by its
    launcher)."""

    _fields_ = [(f, ctypes.c_int) for f in (
        "steps", "nb", "kb", "safe", "cells", "halo", "async_")] + [
        ("lin", ctypes.c_int * MAX_POINTS)]


_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)

#: C signatures: library -> {function: (restype, argtypes)}; the persistent
#: stencil kernels' launches take (..., dtype, CTAs a lane, lanes, dynamic
#: shared memory, stream, flag)
_SIGNATURES = {
    "stencil_step": {
        "stencil_step_launch": (_I, [_P, _P, StencilArgs, StepArgs, _I, _I,
                                     _I, _I, _I, _P, _IP]),
        "stencil_step_per_sm": (_I, [StencilArgs, _I, _I, _I, _IP]),
    },
    "stencil_perks": {
        "stencil_perks_launch": (_I, [_P, _P, _P, StencilArgs, PerksArgs,
                                      _I, _I, _I, _I, _P, _IP]),
        "stencil_perks_max_ctas": (_I, [_I, _I, _I, _IP]),
        "stencil_perks_smem": (_I, [_I, _I, _IP, _IP]),
        "stencil_perks_shape": (_I, [_IP, _IP, _IP, _IP]),
    },
    "stencil_resident": {
        "stencil_resident_launch": (_I, [_P, _P, _P, StencilArgs, ResArgs,
                                         _I, _I, _I, _I, _P, _IP]),
        "stencil_resident_max_ctas": (_I, [_I, _I, _I, _IP]),
        "stencil_resident_smem": (_I, [_I, _I, _IP, _IP]),
        "stencil_resident_shape": (_I, [_IP, _IP]),
    },
    "stencil_shallow": {
        "stencil_shallow_launch": (_I, [_P, _P, _P, StencilArgs, ShallowArgs,
                                        _I, _I, _I, _I, _P, _IP]),
        "stencil_shallow_max_ctas": (_I, [_I, _I, _I, _IP]),
        "stencil_shallow_smem": (_I, [_I, _I, _IP, _IP]),
        "stencil_shallow_shape": (_I, [_IP, _IP, _IP]),
    },
    "stencil_tb": {
        "stencil_tb_launch": (_I, [_P, _P, _P, StencilArgs, TbArgs, _I, _I,
                                   _I, _I, _P, _IP]),
        "stencil_tb_max_ctas": (_I, [_I, _I, _I, _IP]),
        "stencil_tb_smem": (_I, [_I, _I, _IP, _IP]),
        "stencil_tb_max_row_cells": (_I, []),
    },
    "spmv_ell": {
        "spmv_ell_launch": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    },
    "spmv_sell": {
        "spmv_sell_launch": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _P]),
    },
    "cg_fused": {
        "cg_fused_launch": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _P]),
        "cg_fused_max_ctas": (_I, [_I, _IP]),
        "cg_fused_smem": (_I, [_IP, _IP]),
    },
    "bicgstab_fused": {
        "bicgstab_fused_launch": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _I, _I, _I, _P]),
        "bicgstab_fused_max_ctas": (_I, [_I, _IP]),
        "bicgstab_fused_smem": (_I, [_IP, _IP]),
    },
    "gmres_cycle_fused": {
        "gmres_cycle_fused_launch": (_I, [_P, _P, _P, _P, _P, _P, _P, _P,
                                          _P, _P, _I, _I, _I, _I, _I, _I,
                                          _P]),
        "gmres_cycle_fused_max_ctas": (_I, [_I, _IP]),
        "gmres_cycle_fused_smem": (_I, [_IP, _IP]),
    },
    "ssm_scan": {
        "ssm_scan_launch": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _I, _I, _P]),
        "ssm_scan_workspace_floats": (ctypes.c_longlong, [_I, _I, _I, _I]),
        "ssm_scan_config": (_I, [_I, _I, _I, _I, _I, _I, _I, _IP]),
    },
    "vdot": {
        "vdot_launch": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
        "vdot_blocks_for": (_I, [_I]),
    },
    "decode_attn": {
        "decode_attn_launch": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _P]),
        "decode_attn_mma_launch": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                        _I, _I, _I, _I, _I, _P]),
    },
}

#: (library name, EXTRA_FLAGS) -> the loaded library
_loaded: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME)")


def library_path(name: str, extra: tuple[str, ...] | None = None) -> Path:
    """Where library ``name`` built with ``extra`` flags (default
    ``EXTRA_FLAGS``) lives."""
    extra = EXTRA_FLAGS if extra is None else extra
    h = hashlib.sha256(" ".join(NVCC_FLAGS + extra).encode())
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None, extra: tuple[str, ...] | None = None
              ) -> dict[str, float]:
    """Compile every library in ``names`` (default: all) that is not built
    yet with ``extra`` flags (default ``EXTRA_FLAGS``), one ``nvcc`` per
    source, all started together. Returns each compiled library's build
    seconds; raises ``RuntimeError`` with the compiler's output if one
    fails. ``ptxas -v`` output is kept beside each library (``build_log``)."""
    extra = EXTRA_FLAGS if extra is None else extra
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n, extra).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n, extra)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    seconds, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        seconds[n] = time.perf_counter() - t0
        build_log(n, extra).write_text(log)
        if p.returncode != 0:
            failed.append(f"{n} (nvcc exit {p.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return seconds


def build_log(name: str, extra: tuple[str, ...] | None = None) -> Path:
    """The compiler's output for library ``name`` as last built."""
    return library_path(name, extra).with_suffix(".log")


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get((name, EXTRA_FLAGS))
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (res, args) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = res
            f.argtypes = args
        _loaded[(name, EXTRA_FLAGS)] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed with cudaError_t {err}")


def smem_limit(lib: ctypes.CDLL, prefix: str) -> int:
    """Dynamic shared memory one CTA of the cooperative kernel ``prefix``
    may take: the card's opt-in per-block maximum less the kernel's static
    shared memory, both asked of the card and of the built kernel through
    its ``<prefix>_smem`` entry point."""
    optin, static = ctypes.c_int(), ctypes.c_int()
    check(getattr(lib, f"{prefix}_smem")(ctypes.byref(optin),
                                         ctypes.byref(static)),
          f"{prefix}_smem")
    return optin.value - static.value


def require_ctas(lib: ctypes.CDLL, prefix: str, smem: int, ctas: int) -> None:
    """Raise ``ValueError`` unless ``ctas`` CTAs of the cooperative kernel
    ``prefix`` with ``smem`` bytes of dynamic shared memory each are
    co-resident on the card (its ``<prefix>_max_ctas`` entry point)."""
    grid = ctypes.c_int()
    check(getattr(lib, f"{prefix}_max_ctas")(smem, ctypes.byref(grid)),
          f"{prefix}_max_ctas")
    if grid.value < ctas:
        raise ValueError(f"{prefix} needs {ctas} co-resident CTAs with "
                         f"{smem} B each; the card runs {grid.value}")


#: Bytes of shared memory per cached slot of A (float32 value, int32 column).
MATRIX_BYTES_PER_SLOT = 8


def layout(n: int, k: int, ctas: int, matrix_rows: int,
           vector_bytes: int, extra: int = 0) -> tuple[int, int, int]:
    """``(rows per CTA, cached A rows per CTA, dynamic shared memory bytes)``
    of a row-split cooperative Krylov kernel (``cg_fused``,
    ``bicgstab_fused``, ``gmres_cycle_fused``, each with its own
    ``vector_bytes`` per owned row) for ``n`` rows of ``k`` slots
    over ``ctas`` CTAs with ``matrix_rows`` rows of A kept on chip in
    all, and ``extra`` bytes of the kernel's own before them."""
    stride = -(-n // ctas)
    ca = min(stride, -(-matrix_rows // ctas))
    smem = extra + vector_bytes * stride + MATRIX_BYTES_PER_SLOT * k * ca
    return stride, ca, smem


def fit(lib: ctypes.CDLL, prefix: str, n: int, k: int, ctas: int,
        matrix_rows: int, vector_bytes: int,
        vectors: str, extra: int = 0) -> tuple[int, int, int]:
    """``layout``, checked against the built kernel ``prefix``: raises
    ``ValueError`` with the capacity when a CTA cannot hold its rows'
    ``vectors`` (described for the message) and cached rows of A, or when
    ``ctas`` such CTAs are not co-resident."""
    limit = smem_limit(lib, prefix)
    stride, ca, smem = layout(n, k, ctas, matrix_rows, vector_bytes, extra)
    if smem > limit:
        vec = vector_bytes * stride + extra
        rows_cap = max(0, (limit - vec) // (MATRIX_BYTES_PER_SLOT * k))
        raise ValueError(
            f"{prefix} cannot hold this plan: {n} rows over {ctas} CTAs "
            f"give each CTA {stride} rows, whose {vectors} take {vec} B of "
            f"shared memory, and {ca} cached rows of A take "
            f"{MATRIX_BYTES_PER_SLOT * k * ca} B more; a CTA has {limit} B, "
            f"so the kernel holds at most "
            f"{ctas * (limit // vector_bytes)} rows of vectors and, at this "
            f"n, at most {ctas * min(rows_cap, stride)} rows of A")
    require_ctas(lib, prefix, smem, ctas)
    return stride, ca, smem


#: Values a tagged round of ``bicgstab_fused`` sums at most
#: (``csrc/krylov_common.cuh`` ``KRY_TAG_VALUES``); the rounds of
#: ``gmres_cycle_fused`` and of ``cg_fused`` (one value a right-hand side)
#: sum up to ``KRY_WARPS`` = 32.
TAG_VALUES = 2


def tag_words(ctas: int, device: torch.device,
              values: int = TAG_VALUES) -> torch.Tensor:
    """The tagged rounds' words of a launch on ``ctas`` CTAs whose rounds
    sum up to ``values`` values: two parities of ``values`` words a CTA (64
    bits each; the launch zeroes them on its stream before the kernel runs,
    and refuses more CTAs than a round polls)."""
    return torch.empty(2 * values * ctas, dtype=torch.int64, device=device)


def is_cpu(x: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (the wrapper runs the plain version), False
    for a CUDA tensor (it launches the kernel); raises for anything else."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"{what} kernels take CPU or CUDA tensors, got "
                     f"{x.device}")


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def on_device(x: torch.Tensor):
    """Make ``x``'s card the current device for the launch (a no-op when
    it already is, which saves the loop tiers a device switch per step)."""
    if x.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)
