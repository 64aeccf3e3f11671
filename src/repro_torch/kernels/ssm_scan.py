"""Mamba2 SSD chunk scan on Hopper: the port of ``repro/kernels/ssm_scan.py``
(and of the batch ``vmap`` of ``repro/kernels/ops.py:ssd_scan``).

``ssd_scan(x, dt, a, b, c, d, chunk=)`` scans a batch of sequences:
x (B, T, H, P), dt (B, T, H), a (H,), b/c (B, T, N), d (H,) -> y
(B, T, H, P) in x's dtype; with ``return_state=True`` also the state after
the last step, h (B, H, N, P) float32, which the kernel's state warps store
from their registers (y is bit for bit the launch's without it). ``ssm_scan`` is the single-sequence form of the
reference (no batch axis). A CPU tensor runs the plain version (the
per-step recurrence ``ref.ssm_scan`` on float32 copies of the streams, y
cast back to x's dtype); a CUDA tensor launches ``csrc/ssm_scan.cu`` or
raises — there is no fallback. The streams are float32 or bf16; a and d are
read as float32. The chunk may be any length from 1 to 128 (a longer one
runs as 128: the result is the same function) and need not divide T (the
last chunk is shorter), where the reference's TPU kernel asserts
``T % chunk == 0``. The state may have up to 256 rows. A call is two
kernels (the chunks' scores and slots, then the scan, in a float32
workspace the wrapper allocates); the wrapper counts its calls in
``ssd_scan.launches``, and those that return the state also in
``ssd_scan.state_launches``. ``config`` reports the launch a call makes.

The workspace holds, for every chunk of every sequence, S's lower 16x16
tiles and the chunk's c and b with its rows padded to a multiple of 16 and
N to a multiple of 16 (to 128 at chunks of 16 rows or fewer):
``4 * ssm_scan_workspace_floats(B, T, N, chunk)`` bytes. At N = 128 that
is 164 KiB a chunk at chunk 128 (1.3 times the chunk's c and b) and 17 KiB a
chunk at any chunk of 16 rows or fewer: at chunk 1 it is 17 times c and b,
143 MB a sequence of T = 8192.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

#: The kernel's largest chunk (``SSM_MAX_CHUNK`` in ``csrc/ssm_scan.cu``).
MAX_CHUNK = 128
#: The kernel's largest state (``SSM_MAX_STATE``).
MAX_STATE = 256


def _plain(x, dt, a, b, c, d, return_state):
    outs = [ref.ssm_scan(x[i].float(), dt[i].float(), a.float(),
                         b[i].float(), c[i].float(), d.float(),
                         return_state=True) for i in range(x.shape[0])]
    y = torch.stack([o[0] for o in outs]).to(x.dtype)
    if not return_state:
        return y
    return y, torch.stack([o[1] for o in outs])


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
             chunk: int = 128, return_state: bool = False):
    """Batched SSD scan: x (B,T,H,P), dt (B,T,H), a (H,), b/c (B,T,N), d (H,)
    -> y (B,T,H,P), or (y, h (B,H,N,P) float32) with ``return_state``."""
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, T, H, P), got "
                         f"{tuple(x.shape)}")
    bsz, t_len, h, p = x.shape
    n = b.shape[-1]
    if (tuple(dt.shape) != (bsz, t_len, h) or tuple(b.shape) != (bsz, t_len, n)
            or tuple(c.shape) != (bsz, t_len, n) or a.shape != (h,)
            or d.shape != (h,)):
        raise ValueError(
            f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
            f"{tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}, d "
            f"{tuple(d.shape)} do not fit (B,T,H,P), (B,T,H), (H,), (B,T,N)")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if n > MAX_STATE and x.device.type == "cuda":
        raise ValueError(f"ssd_scan: the CUDA kernel takes a state of at "
                         f"most {MAX_STATE}, got N = {n}")
    if _build.is_cpu(x, "ssd_scan"):
        return _plain(x, dt, a, b, c, d, return_state)
    if x.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != x.dtype for t in (dt, b, c)):
        raise TypeError(f"ssd_scan: the CUDA kernel takes float32 or bf16 "
                        f"streams of one dtype, got x {x.dtype}, dt "
                        f"{dt.dtype}, b {b.dtype}, c {c.dtype}")
    if any(t.device != x.device for t in (dt, a, b, c, d)):
        raise ValueError("ssd_scan: every operand must lie on x's device")
    if x.numel() >= 2**31 or bsz * t_len * n >= 2**31:
        raise ValueError("ssd_scan: the streams exceed 32-bit indexing")
    ck = min(chunk, t_len, MAX_CHUNK)
    x, dt, b, c = (t.contiguous() for t in (x, dt, b, c))
    a32, d32 = a.float().contiguous(), d.float().contiguous()
    y = torch.empty_like(x)
    h_out = (torch.zeros((bsz, h, n, p), dtype=torch.float32,
                         device=x.device) if return_state else None)
    if x.numel() == 0:
        return (y, h_out) if return_state else y
    lib = _build.load("ssm_scan")
    with _build.on_device(x):
        ws = torch.empty(lib.ssm_scan_workspace_floats(bsz, t_len, n, ck),
                         dtype=torch.float32, device=x.device)
        err = lib.ssm_scan_launch(
            x.data_ptr(), dt.data_ptr(), a32.data_ptr(), b.data_ptr(),
            c.data_ptr(), d32.data_ptr(), y.data_ptr(),
            None if h_out is None else h_out.data_ptr(), ws.data_ptr(),
            bsz, t_len, h, p, n, ck, int(x.dtype == torch.bfloat16),
            _build.stream())
    _build.check(err, "ssm_scan_launch")
    ssd_scan.launches += 1
    if not return_state:
        return y
    ssd_scan.state_launches += 1
    return y, h_out


ssd_scan.launches = 0
ssd_scan.state_launches = 0


def config(bsz: int, t_len: int, h: int, p: int, n: int, chunk: int = 128,
           dtype: torch.dtype = torch.float32) -> dict:
    """The launch ``ssd_scan`` makes at these shapes on the current card, as
    the built kernel reports it: the scan kernel's grid, its dynamic shared
    memory a CTA, the slots in its ring, its threads a CTA, and the prep
    kernel's shared memory."""
    lib = _build.load("ssm_scan")
    out = (ctypes.c_int * 7)()
    ck = min(chunk, t_len, MAX_CHUNK)
    _build.check(lib.ssm_scan_config(bsz, t_len, h, p, n, ck,
                                     int(dtype == torch.bfloat16), out),
                 "ssm_scan_config")
    return dict(grid=list(out[:3]), smem=out[3], ring=out[4],
                threads=out[5], prep_smem=out[6])


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """Single-sequence SSD scan, as the reference's kernel: x (T,H,P), dt
    (T,H), a (H,), b/c (T,N), d (H,) -> y (T,H,P)."""
    return ssd_scan(x[None], dt[None], a, b[None], c[None], d,
                    chunk=chunk)[0]
