"""Dot products in a fixed order, one pair or B pairs a launch: the loop
tiers' reduction on Hopper.

``vdot(a, b)`` takes two vectors of n elements (a 0-dim result) or two
``[B, n]`` stacks (a ``[B]`` result: lane l is ``a[l] . b[l]``), float32 or
float64; with one more leading axis on ``a`` than on ``b`` (``a`` of
``[k, *b.shape]``) ``b`` is shared along it: the result is ``[k, ...]``,
``a[i] . b`` lane by lane (GMRES's projections of each lane's vector on
the rows of its basis). On a CUDA tensor it launches ``csrc/vdot.cu`` (one launch for
every lane) or raises; on a CPU tensor it runs the plain version, one
``torch.dot`` a lane. The CUDA kernel's order of additions depends on n
only, so a lane of a batch gets the bits of the same pair alone, B = 1
included; that is what makes the batched Krylov loop tiers
(``exec/batch.py``) bit-equal to their instances solved one by one. The
wrapper counts its launches in ``launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

#: Lanes one launch takes at most (the ticket counters kept a stream).
MAX_LANES = 1024
_DTYPES = {torch.float32: 0, torch.float64: 1}
#: (device, stream) -> its MAX_LANES ticket counters, zero between launches
#: (the kernel resets what it takes). Launches on one stream run one after
#: another, so two launches in flight at once never share counters.
_COUNTERS: dict[tuple[torch.device, int], torch.Tensor] = {}


def plain_vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: ``torch.dot`` of each lane (``b`` shared along
    ``a``'s extra leading axis, if it has one)."""
    if a.dim() == 1:
        return torch.dot(a, b)
    if a.dim() > b.dim():
        return torch.stack([plain_vdot(a[i], b) for i in range(a.shape[0])])
    return torch.stack([torch.dot(a[i], b[i]) for i in range(a.shape[0])])


def _counters(device: torch.device, stream: int, lanes: int) -> torch.Tensor:
    """The ticket counters of a launch of ``lanes`` lanes on ``stream``.
    A launch captured into a CUDA graph gets counters of its own, zeroed
    by a node of the graph, so the graph's replays share them with no
    eager launch and no other graph, on whatever stream they run."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(lanes, dtype=torch.int32, device=device)
    c = _COUNTERS.get((device, stream))
    if c is None:
        c = _COUNTERS[device, stream] = torch.zeros(
            MAX_LANES, dtype=torch.int32, device=device)
    return c


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a . b`` for vectors (0-dim), or each lane's for ``[B, n]`` stacks
    (``[B]``), in the order of ``csrc/vdot.cu`` on the card; ``a`` of
    ``[k, *b.shape]`` pairs each ``a[i]`` with the shared ``b``."""
    shared = a.dim() == b.dim() + 1
    if (a.shape[shared:] != b.shape or b.dim() not in (1, 2)
            or a.dim() > 3):
        raise ValueError(f"vdot: a and b must be alike, [n] or [B, n], or a "
                         f"[k, *b.shape] against b; got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if _build.is_cpu(a, "vdot"):
        return plain_vdot(a, b)
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"vdot: the CUDA kernel takes float32 or float64, "
                        f"got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()) or a.device != b.device:
        raise ValueError("vdot: the CUDA kernel takes contiguous tensors on "
                         "one device")
    n = a.shape[-1]
    lanes, b_lanes = math.prod(a.shape[:-1]), math.prod(b.shape[:-1])
    if lanes > MAX_LANES:
        raise ValueError(f"vdot: at most {MAX_LANES} lanes a launch, got "
                         f"{lanes}")
    lib = _build.load("vdot")
    out = torch.empty(lanes, dtype=a.dtype, device=a.device)
    partial = torch.empty(lanes * lib.vdot_blocks_for(n), dtype=a.dtype,
                          device=a.device)
    with _build.on_device(a):
        stream = torch.cuda.current_stream().cuda_stream
        count = _counters(a.device, stream, lanes)
        err = lib.vdot_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                              partial.data_ptr(),
                              ctypes.c_void_p(count.data_ptr()), n, lanes,
                              b_lanes, _DTYPES[a.dtype],
                              ctypes.c_void_p(stream))
    _build.check(err, "vdot_launch")
    vdot.launches += 1
    return out.view(a.shape[:-1])


vdot.launches = 0
