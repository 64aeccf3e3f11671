"""Time the port's kernels, and build variants of them, on one NVIDIA GPU.

    python3 scripts/kernel_variants.py [--src SRC]
    python3 scripts/kernel_variants.py --kernels spmv_decode [--src SRC]
    python3 scripts/kernel_variants.py --kernels sell_deep [--src SRC]
    python3 scripts/kernel_variants.py --kernels deep_profile
    python3 scripts/kernel_variants.py --kernels shallow_resident [--src SRC]
    python3 scripts/kernel_variants.py --kernels resident_profile
    python3 scripts/kernel_variants.py --kernels perks_stream [--src SRC]
    python3 scripts/kernel_variants.py --kernels perks_profile
    python3 scripts/kernel_variants.py --kernels krylov [--src SRC]
                                       [--digests FILE]
    python3 scripts/kernel_variants.py --kernels krylov_lanes [--src SRC]
                                       [--digests FILE]
    python3 scripts/kernel_variants.py --kernels krylov_profile
    python3 scripts/kernel_variants.py --kernels ssm [--src SRC]
    python3 scripts/kernel_variants.py --kernels ssm_profile
    python3 scripts/kernel_variants.py --kernels step_specs [--src SRC]

With no ``--kernels`` it builds the step and one-step kernels
(``csrc/stencil_step.cu``, ``csrc/stencil_perks.cu``), prints their
``ptxas`` register and spill counts, holds them against the plain torch
version at atol 5e-6 (rtol 0), and times them at the main path's shapes:
one step of 2d5pt on 8192x8192 (``stencil_baseline_step``),
``stencil_perks`` on 8192x8192 for 100 steps at the one-step plan's cached
rows, ``stencil_resident`` on 3072x1152 for 1000 steps, and the kept
device loop's replay on 8192x8192 x 100 (``execute`` with
``Plan(tier="device_loop")`` after its first run). Every tuning value is
a plain constant, so another arm of a kernel is a copy of the tree with
the constant changed, timed with ``--src``. Prints one JSON line per
round, then the card's name and power limit. Exits non-zero without a
CUDA device or if a kernel disagrees with its plain version.

``--src`` is the ``src`` directory of the tree to time (default: this
checkout's); its kernels build into that tree's own ``build/``. To compare
two commits on one card, unpack the other one (``git archive <commit> |
tar -x -C build/parent``) and run both in one call, in turns: ``--src
build/parent/src --rounds 1``, this tree, this tree, the other.

``--kernels spmv_decode`` times the shipped ``spmv_ell`` and
``decode_attention`` instead, at the main path's shapes, each beside the
PyTorch call that computes the same function: ``spmv_ell`` on cg-large
(``poisson2d(1024)``, n = 2^20, K = 5; bit-equal to ``ref.spmv_ell``) eager
and in a CUDA graph of 50 calls, beside cuSPARSE's CSR ``A @ x`` in a graph,
and CG's host and device loop tiers there (100 iterations); and bf16
``decode_attention`` at B = 8, S = 32768, 14/2 heads of 64 (qwen2-0.5b's,
held to ``ref.decode_attention`` at rtol 5e-2 and atol 5e-2 times the
output's rms) in a graph, beside one ``scaled_dot_product_attention``.
With ``--src`` and a parent tree this is the before/after of those kernels.

``--kernels sell_deep`` times ``spmv_sell`` and ``stencil_perks_deep``:
``spmv_sell`` on cg-sell (``fem_variable_band(2**20)`` as SELL-32-256;
bit-equal to ``ref.spmv_sell``) eager and in a CUDA graph, beside
cuSPARSE's CSR ``A @ x`` of the same matrix eager and in a graph, and CG's
host and device loop tiers on it (100 iterations, microseconds an
iteration); then ``stencil_perks_deep`` with no cached row, 100 steps, on
2d5pt 8192x8192 at t = 8 and 32 and on 3d7pt 256^3 at t = 2, 4 and 8
(bit-equal to ``ref.stencil_run``). In turns with a parent tree
(``--src build/parent/src --rounds 1``, this tree, this tree, the parent)
it is the before/after of those two kernels.

``--kernels deep_profile`` times ``stencil_perks_deep`` on the same
stencil cells as built and built with ``-DDEEP_PROFILE``, which sums its
warps' clock cycles by what they wait for (the loader for a free slot,
level warps for input rows or for a free slot) beside their totals.

``--kernels shallow_resident`` times the stencil kernels of the small and
large cells, 1000 / 100 steps f32, each bit-equal to ``ref.stencil_run``:
``stencil_resident`` on 2d5pt 3072x1152 beside the kept device loop
there; ``stencil_perks`` at t = 4 (shallow tiles) and t = 1 (the one-step
plan's cached rows), ``stencil_perks_deep`` at t = 4, 8 and 32 and the
kept device loop on 2d5pt 8192x8192; shallow t = 2 and 4 and deep t = 2, 4
and 8 on 3d7pt 256^3 (no cached row). It prints each stencil library's
``ptxas`` registers and spills first. In turns with a parent tree
(``--src build/parent/src --rounds 1``, this tree, this tree, the parent)
it is the before/after of the shallow tiles and ``stencil_resident``.

``--kernels resident_profile`` times ``stencil_resident`` on 2d5pt
3072x1152 x 1000 as shipped and built with ``-DRES_PROFILE`` (in turns,
each bit-equal to ``ref.stencil_run``), which sums thread 0's clock cycles
a step by phase (computing blocks, writing them back, ``grid.sync()``, the
halo copies), read back through ``stencil_resident_profile``.

``--kernels perks_stream`` is ``shallow_resident``'s cells plus the
one-step plan (``stencil_perks`` at t = 1, at the cached planes the tree's
own planner gives its one-step candidate) on 3d7pt 256^3 x 100 and one
``stencil_baseline_step`` on 2d5pt 8192x8192; in turns with a parent tree
(``--src build/parent/src --rounds 1``, this tree, this tree, the parent)
it is the before/after of the one-step kernel, with every other stencil
kernel beside it.

``--kernels perks_profile`` times ``stencil_perks`` (the one-step plan) on
2d5pt 8192x8192 and 3d7pt 256^3 x 100 as shipped and built with
``-DPERKS_PROFILE`` (in turns, each bit-equal to ``ref.stencil_run``),
which sums thread 0's clock cycles a step by phase (the box, waiting for a
window row, its ``__syncthreads``, issuing copies, computing a row,
``grid.sync()``), read back through ``stencil_perks_profile``.

``--kernels krylov`` times the fused Krylov kernels at the Krylov cells'
shapes, 100 iterations from a seeded right-hand side: ``cg_fused`` on
cg-small and cg-large (``poisson2d`` 512 and 1024) and ``bicgstab_fused``
on bicgstab-small and bicgstab-large (``convdiff2d`` 512 and 768), each
under VEC and under MIX at the tree's planner's ``matrix_rows`` (all of A
on the small cells, part of it on the large), with the streamed rows' rate
(the A bytes no CTA holds, once per SpMV, over the time); one m = 16 cycle
of ``gmres_cycle_fused`` on gmres-small (``convdiff2d(448)``; eager and
in a CUDA graph of 20 calls); and the
microseconds of one iteration of each fused kernel on a 16x16 grid (2000
iterations less none), where the rows' work is small. Each line carries
a digest of every output's bits (x and rr; V, H, beta and the new
iterate). With ``--digests FILE`` the digests are kept in FILE by cell,
policy and cached rows, and a run whose outputs differ from those
already there fails: run in turns with a parent tree (``--src
build/parent/src --rounds 1``, this tree, this tree, the parent, one
FILE) it is the A/B of the fused kernels, bit for bit. The GMRES cycle is
also held to its plain version (``ref.gmres_cycle_update`` on the same
inputs, at the smoke's Krylov tolerance), its largest difference from it
by output printed beside its digest, so a parent that sums in another
order (the PR 15 kernel's projections, before 1 + 3m rounds) fails only
the digest.

``--kernels krylov_profile`` runs the same fused CG and BiCGStab cells,
tiny grids and GMRES cycle as shipped and built with ``-DKRY_PROFILE`` (in
turns, each bit-equal to the shipped build), which sums thread 0's clock
cycles by phase (the work between rounds outside the SpMVs and
projections; a round's first barrier, the release of its tagged word, the
polling, its sum and last barrier; the SpMVs; GMRES's projections), read
back through ``<kernel>_profile``: cycles an iteration (a GMRES cycle) a
CTA, the GMRES cycle and the batched cells also eager and in a graph.

Both Krylov modes also run the batched ``cg_fused`` cells
(``KRYLOV_LANE_CELLS``: poisson2d(512) at B = 1, 2, 3, 4, poisson2d(256)
at B = 1, 16 and poisson2d(128) at B = 1, 32, MIX with all of A on
chip, 100 iterations; right-hand sides from seed 1), each in a graph
too and with its digest, so the A/B holds every lane's bits across
trees; a tree whose ``cg_fused`` takes no batch (before batched launches)
runs their B = 1 cells only. ``--kernels krylov_lanes`` runs those cells
alone (``cg_fused`` built alone, its ``ptxas`` registers and spills by
kernel instance printed), and cg-batch-small through ``execute`` (the
planner's batched resident MIX plan, median of 20 runs, and the same
instances one by one, median of 5; ms per instance), for the A/B of the
batched kernel and of arms of it (copies of the tree, ``--src``).

``--kernels ssm`` times ``ssd_scan`` at mamba2-780m's SSD widths (B = 1,
T = 8192, H = 48, P = 64, N = 128; streams from seed 0 as
``chip_smoke.py`` makes them): float32 and bf16 streams at chunks 128, 15
and 1, each eager (``ms``) and in a CUDA graph (``graph_ms``), with the
largest absolute error against the plain version (``ref.ssm_scan`` on
float32 copies of the same streams) and a digest of y's bits, and the
launch the tree's build reports (the scan kernel's grid, shared memory a
CTA, slots in its ring); it prints the library's ``ptxas`` registers and
spills first. In turns with a parent tree (``--src build/parent/src
--rounds 1``, this tree, this tree, the parent) it is the A/B of the scan,
and equal digests show that both trees compute y bit for bit.

``--kernels ssm_profile`` times the float32 chunk-128 cell as shipped and
built with ``-DSSM_PROFILE`` (clock cycles a chunk a CTA by phase, for the
first row warp, the first state warp and the copy warp), each held to the
plain version at chunks 128, 15 and 1 (largest absolute errors and a
digest of the outputs' bits printed), and prints the shipped build's
device time by kernel from ``torch.profiler``. Other arms of the scan are
copies of the tree with the kernel changed, timed with ``--kernels ssm
--src``.

``--kernels step_specs`` times ``stencil_baseline_step`` (one step,
``csrc/stencil_step.cu``) on every Table-III spec, 2D specs on 8192x8192
and 3D specs on 256^3, in float32 and bf16: eager (``ms``) and in a CUDA
graph of 20 calls (``graph_ms``), beside the byte bound (each cell read
once and written once at 3.35 TB/s), the plain version's time
(``ref.stencil_step``, against which each output must be bit-equal) and
one cuDNN convolution computing the interior (``conv2d``/``conv3d``, TF32
off; ``library_ms``), with the launches the step made; then the batched
step on 2d5pt, B = 8 domains of 2048x2048 f32 (each lane bit-equal to
its own launch), one ``copy_`` of the 8192x8192 f32 domain (the card's
achievable copy rate), and ``execute`` of 2ds25pt 8192x8192 x 100 on the
host and device loop tiers. It prints the step library's ``ptxas``
registers and spills first. In turns with a parent tree (``--src
build/parent/src --rounds 1``, this tree, this tree, the parent) it is
the A/B of the step kernel.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ATOL = 5e-6
#: The GMRES cycle against its plain version: chip_smoke.py's Krylov
#: tolerance
KRYLOV_TOL = dict(rtol=1e-3, atol=1e-5)

def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def spills(log: str) -> dict:
    """Largest register count and spill-store bytes over the instances."""
    regs, stores = 0, 0
    for ln in log.splitlines():
        if "Used" in ln and "registers" in ln:
            regs = max(regs, int(ln.split("Used")[1].split()[0]))
        if "spill stores" in ln:
            stores = max(stores, int(ln.split("bytes spill stores")[0]
                                     .split(",")[-1].strip()))
    return {"max_registers": regs, "max_spill_store_bytes": stores}


def instance_spills(log: str) -> dict:
    """Registers and spill-store bytes of each kernel a library's ``ptxas``
    log names (by mangled name)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out[name] = {}
        elif name and "spill stores" in ln:
            out[name]["spill_store_bytes"] = int(
                ln.split("bytes spill stores")[0].split(",")[-1].strip())
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(ln.split("Used")[1].split()[0])
    return out


def graph_ms(fn, calls: int = 50) -> float:
    """Milliseconds of one call of ``fn`` on the card alone: ``calls`` calls
    captured into a CUDA graph, the replay's median over three runs divided
    by ``calls``."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, 3) / calls


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def spmv_decode(src: str, rounds: int) -> int:
    """``--kernels spmv_decode``: one JSON line per round."""
    import torch.nn.functional as F
    from repro_torch import CGProblem, Plan, execute
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.sparse.generate import poisson2d

    _build.build_all(("spmv_ell", "decode_attn"))
    rng = np.random.default_rng(0)
    csr = poisson2d(1024)
    ell = csr.to_ell()
    b = rng.standard_normal(csr.shape[0]).astype(np.float32)
    problem = CGProblem.from_ell(ell.data, ell.cols, b, 100, matrix=csr)
    data, cols, x = problem.data, problem.cols, problem.b
    a = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr.astype(np.int32)).cuda(),
        torch.from_numpy(csr.indices.astype(np.int32)).cuda(),
        torch.from_numpy(csr.data).cuda(), size=csr.shape)
    bsz, s, hq, hkv, dim = 8, 32768, 14, 2, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
               .cuda().bfloat16()
               for sh in ((bsz, hq, dim), (bsz, s, hkv, dim),
                          (bsz, s, hkv, dim)))
    want = ref.decode_attention(q.float(), k.float(), v.float())
    rms = want.double().pow(2).mean().sqrt().item()
    qh, kh, vh = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    spmv = lambda: ops.spmv(data, cols, x)
    decode = lambda: ops.decode_attention(q, k, v)
    bad = []
    if not torch.equal(spmv(), ref.spmv_ell(data, cols, x)):
        bad.append("spmv_ell is not bit-equal to ref.spmv_ell")
    if not torch.allclose(decode().float(), want, rtol=5e-2, atol=5e-2 * rms):
        bad.append("decode_attention misses the bf16 rule")
    for rnd in range(rounds):
        line = {"src": src, "round": rnd,
                "spmv_ell_ms": cuda_ms(spmv, 20),
                "spmv_ell_graph_ms": graph_ms(spmv),
                "cusparse_graph_ms": graph_ms(lambda: a @ x)}
        for tier in ("host_loop", "device_loop"):
            run = lambda: execute(problem, Plan(tier=tier))
            line[f"cg_{tier}_ms_per_iter"] = cuda_ms(run, 3) / 100
        line["decode_attention_graph_ms"] = graph_ms(decode, 20)
        line["sdpa_graph_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, enable_gqa=True), 20)
        print(json.dumps(line), flush=True)
    print(card_name())
    if bad:
        print("kernel_variants FAILED: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


#: (spec, shape, t): stencil_perks_deep's A/B cells, 100 steps, no cached row
DEEP_CELLS = [("2d5pt", (8192, 8192), 8), ("2d5pt", (8192, 8192), 32),
              ("3d7pt", (256, 256, 256), 2), ("3d7pt", (256, 256, 256), 4),
              ("3d7pt", (256, 256, 256), 8)]


def sell_deep(src: str, rounds: int) -> int:
    """``--kernels sell_deep``: one JSON line per round."""
    from repro_torch import CGProblem, Plan, execute
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.common import get_spec
    from repro_torch.solvers.cg import SellOperator
    from repro_torch.sparse.generate import fem_variable_band

    _build.build_all(("spmv_sell", "stencil_tb"))
    rng = np.random.default_rng(0)
    csr = fem_variable_band(2**20)
    op = SellOperator.from_matrix(csr.to_sell(c=32, sigma=256))
    b = rng.standard_normal(csr.shape[0]).astype(np.float32)
    problem = CGProblem.from_matvec(op.matvec, b, 100, matrix=op.matrix)
    x = problem.b
    a = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr.astype(np.int32)).cuda(),
        torch.from_numpy(csr.indices.astype(np.int32)).cuda(),
        torch.from_numpy(csr.data).cuda(), size=csr.shape)
    args = (op.data, op.cols, op.slice_offsets, op.slice_k, x)
    spmv = lambda: ops.spmv_sell(*args, c=op.c, k_max=op.k_max)
    bad = []
    if not torch.equal(spmv(), ref.spmv_sell(*args, c=op.c, k_max=op.k_max)):
        bad.append("spmv_sell is not bit-equal to ref.spmv_sell")
    domains = {}
    for name, shape, t in DEEP_CELLS:
        if (name, shape) not in domains:
            d = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                 ).cuda()
            domains[name, shape] = (d, ref.stencil_run(d, get_spec(name), 100))
    for rnd in range(rounds):
        line = {"src": src, "round": rnd,
                "spmv_sell_ms": cuda_ms(spmv, 20),
                "spmv_sell_graph_ms": graph_ms(spmv),
                "cusparse_ms": cuda_ms(lambda: a @ x, 20),
                "cusparse_graph_ms": graph_ms(lambda: a @ x)}
        for tier in ("host_loop", "device_loop"):
            run = lambda: execute(problem, Plan(tier=tier))
            line[f"cg_sell_{tier}_us_per_iter"] = 1e3 * cuda_ms(run, 3) / 100
        for name, shape, t in DEEP_CELLS:
            d, want = domains[name, shape]
            run = lambda: ops.stencil_perks_deep(
                d, spec=get_spec(name), steps=100, cached_rows=0,
                fuse_steps=t)
            key = f"deep_{name}_{shape[0]}_t{t}"
            if rnd == 0 and not torch.equal(run(), want):
                bad.append(f"{key} is not bit-equal to ref.stencil_run")
            line[f"{key}_ms"] = cuda_ms(run, 3)
        print(json.dumps(line), flush=True)
    print(card_name())
    if bad:
        print("kernel_variants FAILED: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


def deep_profile(src: str, rounds: int) -> int:
    """``--kernels deep_profile``: ``stencil_perks_deep`` on the sell_deep
    cells, shipped and built with -DDEEP_PROFILE (its warps' clock cycles
    by what they wait for): one JSON line per build, cell and round."""
    import ctypes
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.common import get_spec

    variants = {"profile": ("-DDEEP_PROFILE",), "shipped": ()}
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        list(pool.map(lambda v: _build.build_all(("stencil_tb",), extra=v),
                      variants.values()))
    rng = np.random.default_rng(0)
    kinds = ("load_wait_slot", "level_wait_input", "level_wait_slot",
             "level_all", "load_all")
    for rnd in range(rounds):
        for name, shape, t in DEEP_CELLS:
            d = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                 ).cuda()
            run = lambda: ops.stencil_perks_deep(
                d, spec=get_spec(name), steps=100, cached_rows=0,
                fuse_steps=t)
            for v, flags in variants.items():
                _build.EXTRA_FLAGS = flags
                lib = _build.load("stencil_tb")
                tma = ops.launch_counts()["stencil_perks_deep_tma"]
                line = {"variant": v, "cell": f"{name} {shape} t={t}",
                        "round": rnd, "ms": cuda_ms(run, 2),
                        "tma": ops.launch_counts()["stencil_perks_deep_tma"]
                        > tma}
                if flags:
                    out = (ctypes.c_ulonglong * len(phases))()
                    lib.stencil_tb_profile.argtypes = [ctypes.c_void_p]
                    _build.check(lib.stencil_tb_profile(out), "profile")
                    run()
                    torch.cuda.synchronize()
                    _build.check(lib.stencil_tb_profile(out), "profile")
                    line.update(zip(kinds, (int(c) for c in out)))
                print(json.dumps(line), flush=True)
    _build.EXTRA_FLAGS = ()
    print(card_name())
    return 0


#: (key, spec, shape, steps, kernel, t): the shallow_resident cells
SR_CELLS = [
    ("resident_2d5pt_3072", "2d5pt", (3072, 1152), 1000, "resident", 1),
    ("device_loop_2d5pt_3072", "2d5pt", (3072, 1152), 1000, "device_loop", 1),
    ("shallow_2d5pt_8192_t4", "2d5pt", (8192, 8192), 100, "shallow", 4),
    ("perks_2d5pt_8192_t1", "2d5pt", (8192, 8192), 100, "perks", 1),
    ("deep_2d5pt_8192_t4", "2d5pt", (8192, 8192), 100, "deep", 4),
    ("deep_2d5pt_8192_t8", "2d5pt", (8192, 8192), 100, "deep", 8),
    ("deep_2d5pt_8192_t32", "2d5pt", (8192, 8192), 100, "deep", 32),
    ("device_loop_2d5pt_8192", "2d5pt", (8192, 8192), 100, "device_loop", 1),
    ("shallow_3d7pt_256_t2", "3d7pt", (256, 256, 256), 100, "shallow", 2),
    ("shallow_3d7pt_256_t4", "3d7pt", (256, 256, 256), 100, "shallow", 4),
    ("deep_3d7pt_256_t2", "3d7pt", (256, 256, 256), 100, "deep", 2),
    ("deep_3d7pt_256_t4", "3d7pt", (256, 256, 256), 100, "deep", 4),
    ("deep_3d7pt_256_t8", "3d7pt", (256, 256, 256), 100, "deep", 8),
]
#: ``--kernels perks_stream``: the same cells, the one-step plan on 3d7pt
#: 256^3 and one step of the loop tiers' kernel
PS_CELLS = SR_CELLS + [
    ("perks_3d7pt_256_t1", "3d7pt", (256, 256, 256), 100, "perks", 1),
    ("step_2d5pt_8192", "2d5pt", (8192, 8192), 1, "step", 1),
]


def shallow_resident(src: str, rounds: int, cells=SR_CELLS) -> int:
    """``--kernels shallow_resident`` (and ``perks_stream``, with
    ``PS_CELLS``): one JSON line per round."""
    from repro_torch import Plan, StencilProblem, execute
    from repro_torch.core import perks
    from repro_torch.exec import plan_candidates
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.common import get_spec

    libs = [n for n in ("stencil_perks", "stencil_resident",
                        "stencil_shallow", "stencil_tb")
            if n in _build.SOURCES]
    secs = _build.build_all(libs)
    for n in libs:
        print(json.dumps({"src": src, "library": n, "build_s": secs.get(n),
                          **spills(_build.build_log(n).read_text())}))
    rng = np.random.default_rng(0)
    domains, runs = {}, {}
    for key, name, shape, steps, kind, t in cells:
        spec = get_spec(name)
        if (name, shape) not in domains:
            d = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                 ).cuda()
            domains[name, shape] = (d, ref.stencil_run(d, spec, steps),
                                    StencilProblem(d, spec, steps))
        d, want, problem = domains[name, shape]
        if kind == "step":
            runs[key] = (lambda d=d, s=spec: ops.stencil_baseline_step(
                d, spec=s), ref.stencil_step(d, spec))
            continue
        if kind == "resident":
            fn = lambda d=d, s=spec, n=steps: ops.stencil_resident(
                d, spec=s, steps=n)
        elif kind == "device_loop":
            fn = lambda p=problem: execute(p, Plan(tier="device_loop"))
        elif kind == "deep":
            fn = lambda d=d, s=spec, n=steps, t=t: ops.stencil_perks_deep(
                d, spec=s, steps=n, cached_rows=0, fuse_steps=t)
        else:
            rows = 0
            if kind == "perks":
                rows = next(c.cached_rows for c in plan_candidates(problem)
                            if c.tier == "resident" and c.fuse_steps == 1
                            and c.schedule == "shallow")
            fn = lambda d=d, s=spec, n=steps, t=t, R=rows: ops.stencil_perks(
                d, spec=s, steps=n, cached_rows=R, fuse_steps=t)
        runs[key] = (fn, want)
    bad = []
    for rnd in range(rounds):
        line = {"src": src, "round": rnd}
        for key, (fn, want) in runs.items():
            if key.startswith("device_loop"):
                perks.clear_graphs()
            before = ops.launch_counts()
            got = fn()
            torch.cuda.synchronize()
            if rnd == 0:
                line[f"{key}_launches"] = {
                    k: v - before[k] for k, v in ops.launch_counts().items()
                    if v != before[k]}
                if not torch.equal(got, want):
                    bad.append(f"{key} is not bit-equal to ref.stencil_run")
            line[f"{key}_ms"] = cuda_ms(fn, 3)
        print(json.dumps(line), flush=True)
    print(card_name())
    if bad:
        print("kernel_variants FAILED: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


def resident_profile(src: str, rounds: int) -> int:
    """``--kernels resident_profile``: ``stencil_resident`` on 2d5pt
    3072x1152 x 1000, shipped and built with -DRES_PROFILE (thread 0's
    clock cycles a step by phase): one JSON line per build and round."""
    import ctypes
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.common import get_spec

    variants = {"shipped": (), "profile": ("-DRES_PROFILE",)}
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        list(pool.map(lambda v: _build.build_all(("stencil_resident",),
                                                 extra=v),
                      variants.values()))
    for n, flags in variants.items():
        log = _build.build_log("stencil_resident", flags).read_text()
        print(json.dumps({"variant": n, "flags": flags, **spills(log)}))
    spec = get_spec("2d5pt")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3072, 1152), dtype=np.float32)
                         ).cuda()
    want = ref.stencil_run(x, spec, 1000)
    ctas = torch.cuda.get_device_properties(0).multi_processor_count
    run = lambda: ops.stencil_resident(x, spec=spec, steps=1000)
    bad = []
    for rnd in range(rounds):
        for n, flags in variants.items():
            _build.EXTRA_FLAGS = flags
            lib = _build.load("stencil_resident")
            if rnd == 0 and not torch.equal(run(), want):
                bad.append(f"{n} is not bit-equal to ref.stencil_run")
            line = {"variant": n, "round": rnd, "ms": cuda_ms(run, 5)}
            if flags:
                out = (ctypes.c_ulonglong * 4)()
                lib.stencil_resident_profile.argtypes = [ctypes.c_void_p]
                _build.check(lib.stencil_resident_profile(out), "profile")
                run()
                torch.cuda.synchronize()
                _build.check(lib.stencil_resident_profile(out), "profile")
                # thousands of cycles a step of thread 0 of a CTA
                line.update(zip(("compute", "write", "grid_sync", "halo"),
                                (c / ctas / 1000 for c in out)))
            print(json.dumps(line), flush=True)
    _build.EXTRA_FLAGS = ()
    print(card_name())
    if bad:
        print("kernel_variants FAILED: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


def perks_profile(src: str, rounds: int) -> int:
    """``--kernels perks_profile``: the one-step plan on 2d5pt 8192x8192
    and 3d7pt 256^3 x 100, shipped and built with -DPERKS_PROFILE (thread
    0's clock cycles a step by phase): one JSON line per build, cell and
    round."""
    import ctypes
    from repro_torch import StencilProblem
    from repro_torch.exec import plan_candidates
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.common import get_spec

    variants = {"shipped": (), "profile": ("-DPERKS_PROFILE",)}
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        list(pool.map(lambda v: _build.build_all(("stencil_perks",), extra=v),
                      variants.values()))
    for n, flags in variants.items():
        log = _build.build_log("stencil_perks", flags).read_text()
        print(json.dumps({"variant": n, "flags": flags, **spills(log)}))
    rng = np.random.default_rng(0)
    ctas = torch.cuda.get_device_properties(0).multi_processor_count
    cells = []
    for name, shape in (("2d5pt", (8192, 8192)), ("3d7pt", (256, 256, 256))):
        spec = get_spec(name)
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                             ).cuda()
        rows = next(c.cached_rows for c in plan_candidates(
            StencilProblem(x, spec, 100)) if c.tier == "resident"
            and c.fuse_steps == 1 and c.schedule == "shallow")
        cells.append((name, rows, ref.stencil_run(x, spec, 100),
                      lambda x=x, s=spec, R=rows: ops.stencil_perks(
                          x, spec=s, steps=100, cached_rows=R)))
    phases = ("box", "wait", "barrier", "issue", "compute", "grid_sync")
    bad = []
    for rnd in range(rounds):
        for n, flags in variants.items():
            _build.EXTRA_FLAGS = flags
            lib = _build.load("stencil_perks")
            for name, rows, want, run in cells:
                if rnd == 0 and not torch.equal(run(), want):
                    bad.append(f"{n} {name} is not bit-equal to "
                               f"ref.stencil_run")
                line = {"variant": n, "cell": name, "cached_rows": rows,
                        "round": rnd, "ms": cuda_ms(run, 3)}
                if flags:
                    out = (ctypes.c_ulonglong * len(phases))()
                    lib.stencil_perks_profile.argtypes = [ctypes.c_void_p]
                    _build.check(lib.stencil_perks_profile(out), "profile")
                    run()
                    torch.cuda.synchronize()
                    _build.check(lib.stencil_perks_profile(out), "profile")
                    # thousands of cycles a step of thread 0 of a CTA
                    line.update(zip(phases, (c / ctas / 100 / 1000
                                             for c in out)))
                print(json.dumps(line), flush=True)
    _build.EXTRA_FLAGS = ()
    print(card_name())
    if bad:
        print("kernel_variants FAILED: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0

#: (cell, kind, grid side): the fused Krylov kernels' A/B cells
KRYLOV_AB_CELLS = [("cg-small", "cg", 512), ("cg-large", "cg", 1024),
                   ("bicgstab-small", "bicgstab", 512),
                   ("bicgstab-large", "bicgstab", 768),
                   ("gmres-small", "gmres", 448)]
#: (cell, grid side, lane counts): the batched ``cg_fused`` cells, MIX with
#: all of A on chip, 100 iterations; B = 1 is the single-instance launch
#: (a 1-D b) on the same operator, which every tree takes
KRYLOV_LANE_CELLS = [("cg-small", 512, (1, 2, 3, 4)), ("cg-256", 256, (1, 16)),
                     ("cg-128", 128, (1, 32))]


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _krylov_runs(rng, lanes_only: bool = False):
    """The krylov modes' runs: {key: (fn, iterations, streamed A bytes a
    run, plain version or None)} over KRYLOV_AB_CELLS (VEC and the
    planner's MIX; one GMRES cycle, with ``ref.gmres_cycle_update`` on the
    same inputs), the batched ``cg_fused`` cells (KRYLOV_LANE_CELLS, their
    right-hand sides from a generator of their own, seed 1), then each
    fused kernel on a 16x16 grid at 0 and 2000 iterations; ``lanes_only``:
    the batched cells alone."""
    import functools

    from repro_torch import BiCGStabProblem, CGProblem, GMRESProblem, plan
    from repro_torch.kernels import ops, ref
    from repro_torch.sparse.generate import convdiff2d, poisson2d

    runs = {}
    for cell, kind, side in () if lanes_only else KRYLOV_AB_CELLS:
        csr = poisson2d(side) if kind == "cg" else convdiff2d(side)
        ell = csr.to_ell()
        n = csr.shape[0]
        b = rng.standard_normal(n).astype(np.float32)
        if kind == "gmres":
            p = GMRESProblem.from_ell(ell.data, ell.cols, b, 1, m=16,
                                      matrix=csr)
            x0 = torch.zeros_like(p.b)
            runs[cell] = (lambda p=p, x0=x0: ops.gmres_cycle(
                p.data, p.cols, x0, p.b, m=16), 1, 0.0,
                lambda p=p, x0=x0: ref.gmres_cycle_update(
                    x0, p.b, functools.partial(ref.spmv_ell, p.data,
                                               p.cols), 16))
            continue
        cls = CGProblem if kind == "cg" else BiCGStabProblem
        p = cls.from_ell(ell.data, ell.cols, b, 100, matrix=csr)
        fused = ops.cg if kind == "cg" else ops.bicgstab
        spmvs = 100 if kind == "cg" else 200
        for rows in (0, p.resident_matrix_rows(plan(p))):
            policy = "VEC" if rows == 0 else ("MIX" if rows == n
                                              else "partial MIX")
            runs[f"{cell} {policy} rows={rows}"] = (
                lambda p=p, f=fused, r=rows: f(p.data, p.cols, p.b,
                                               iters=100, matrix_rows=r,
                                               resident_matrix=r > 0),
                100, spmvs * ell.data.size * 8 * (n - rows) / n, None)
    # a tree before batched launches (its cg_fused has no MAX_LANES) takes
    # only the B = 1 cells
    from repro_torch.kernels import cg_fused as kcg
    most = getattr(kcg, "MAX_LANES", 1)
    lane_rng = np.random.default_rng(1)
    for cell, side, lanes in KRYLOV_LANE_CELLS:
        ell = poisson2d(side).to_ell()
        d, c = torch.from_numpy(ell.data).cuda(), torch.from_numpy(
            ell.cols).cuda()
        n = ell.data.shape[0]
        for b in lanes:
            bs = torch.from_numpy(lane_rng.standard_normal((b, n)).astype(
                np.float32)).cuda()
            if b > most:
                continue
            bs = bs[0] if b == 1 else bs
            runs[f"{cell} MIX B={b}"] = (
                lambda d=d, c=c, bs=bs: ops.cg(d, c, bs, iters=100), 100,
                0.0, None)
    if lanes_only:
        return runs
    for name, f, m in (("cg_fused", ops.cg, poisson2d(16)),
                       ("bicgstab_fused", ops.bicgstab, convdiff2d(16))):
        ell = m.to_ell()
        d, c = torch.from_numpy(ell.data).cuda(), torch.from_numpy(
            ell.cols).cuda()
        b = torch.from_numpy(rng.standard_normal(256).astype(np.float32)
                             ).cuda()
        for it in (0, 2000):
            runs[f"{name} tiny iters={it}"] = (
                lambda f=f, d=d, c=c, b=b, it=it: f(d, c, b, iters=it), it,
                0.0, None)
    return runs


def _batch_path():
    """cg-batch-small through ``execute``: poisson2d(512), B = 4, 100
    iterations, the planner's batched resident MIX plan and the same
    instances one by one (``execute_sequential``), built as
    ``chip_smoke.py``'s [batch path] builds them; (batched, sequential)
    thunks, or None for a tree without batched execution."""
    import dataclasses

    try:
        from repro_torch.exec import (BatchedProblem, CGProblem,
                                      execute, execute_sequential,
                                      plan_candidates)
    except ImportError:
        return None
    from repro_torch.sparse.generate import poisson2d

    csr = poisson2d(512)
    ell = csr.to_ell()
    rng = np.random.default_rng(2)
    rhs = [rng.standard_normal(csr.shape[0]).astype(np.float32)
           for _ in range(4)]
    first = CGProblem.from_ell(ell.data, ell.cols, rhs[0], 100, matrix=csr)
    insts = [first] + [first.with_payload(torch.from_numpy(v).cuda())
                       for v in rhs[1:]]
    bp = BatchedProblem.from_instances(insts)
    plan = next(c for c in plan_candidates(bp)
                if c.tier == "resident" and c.policy == "MIX")
    single = dataclasses.replace(plan, batch=1, problem="")
    return (lambda: execute(bp, plan),
            lambda: execute_sequential(insts, single))


def _plain_gap(out, plain) -> tuple[list[float], bool]:
    """The largest absolute difference of each of a GMRES cycle's outputs
    (V, H, beta, x_new) from its plain version's, and whether every output
    is within ``KRYLOV_TOL`` of it."""
    want = plain()
    return ([(a - b).abs().max().item() for a, b in zip(out, want)],
            all(torch.allclose(a, b, **KRYLOV_TOL)
                for a, b in zip(out, want)))


def krylov(src: str, rounds: int, digests: str | None,
           lanes_only: bool = False) -> int:
    """``--kernels krylov`` (``krylov_lanes``: the batched cells alone):
    one JSON line per round."""
    from repro_torch.kernels import _build

    libs = (("cg_fused",) if lanes_only else
            ("cg_fused", "bicgstab_fused", "gmres_cycle_fused"))
    secs = _build.build_all(libs)
    for n in libs:
        log = _build.build_log(n).read_text()
        print(json.dumps({"src": src, "library": n, "build_s": secs.get(n),
                          **spills(log)}))
        if n == "cg_fused":
            print(json.dumps({"src": src, "cg_fused instances":
                              instance_spills(log)}))
    runs = _krylov_runs(np.random.default_rng(0), lanes_only)
    path = _batch_path() if lanes_only else None
    kept = {}
    if digests and os.path.exists(digests):
        with open(digests) as f:
            kept = json.load(f)
    bad = []
    for rnd in range(rounds):
        line = {"src": src, "round": rnd}
        for key, (fn, _, streamed, plain) in runs.items():
            out = fn()
            torch.cuda.synchronize()
            if rnd == 0 and "tiny" not in key:
                d = _digest(*out)
                line[f"{key} digest"] = d
                if plain is not None:
                    line[f"{key} max_abs_err"], close = _plain_gap(out, plain)
                    if not close:
                        bad.append(f"{key}: outside {KRYLOV_TOL} of the "
                                   f"plain version")
                if kept.setdefault(key, d) != d:
                    bad.append(f"{key}: outputs {d} differ from {kept[key]}")
            ms = cuda_ms(fn, 20 if key.startswith("gmres") else 5)
            line[f"{key} ms"] = ms
            if key.startswith("gmres") or " B=" in key:
                line[f"{key} graph_ms"] = graph_ms(fn, 20)
            if streamed:
                line[f"{key} streamed_GBps"] = streamed / ms / 1e6
        for name in () if lanes_only else ("cg_fused", "bicgstab_fused"):
            line[f"{name} tiny us_per_iter"] = 1e3 * (
                line.pop(f"{name} tiny iters=2000 ms")
                - line.pop(f"{name} tiny iters=0 ms")) / 2000
        if path is not None:
            batched, sequential = path
            line["cg-batch-small resident per_instance_ms"] = cuda_ms(
                batched, 20) / 4
            line["cg-batch-small sequential per_instance_ms"] = cuda_ms(
                sequential, 5) / 4
        print(json.dumps(line), flush=True)
    if digests:
        with open(digests, "w") as f:
            json.dump(kept, f, indent=1)
    print(card_name())
    if bad:
        print("kernel_variants FAILED: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


def krylov_profile(src: str, rounds: int) -> int:
    """``--kernels krylov_profile``: the fused runs of ``--kernels krylov``
    (CG, BiCGStab, the GMRES cycle), shipped and built with -DKRY_PROFILE
    (thread 0's clock cycles by phase, krylov_common.cuh), each bit-equal
    to the shipped build, the GMRES cycle also held to its plain version
    at the smoke's Krylov tolerance: one JSON line per build, run and
    round, the cycles an iteration (a GMRES cycle) a CTA by phase; the
    GMRES cycle also in a graph."""
    import ctypes
    from repro_torch.kernels import _build

    libs = ("cg_fused", "bicgstab_fused", "gmres_cycle_fused")
    variants = {"shipped": (), "profile": ("-DKRY_PROFILE",)}
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        list(pool.map(lambda v: _build.build_all(libs, extra=v),
                      variants.values()))
    for n, flags in variants.items():
        for lib in libs:
            log = _build.build_log(lib, flags).read_text()
            print(json.dumps({"variant": n, "library": lib, **spills(log)}))
    runs = {k: v for k, v in _krylov_runs(np.random.default_rng(0)).items()
            if not k.endswith("iters=0")}
    ctas = torch.cuda.get_device_properties(0).multi_processor_count
    phases = ("work", "round_enter", "release", "poll", "round_exit",
              "spmv", "project")

    def library(key):   # "cg-small ...", "cg_fused tiny ...", "gmres-small"
        return {"cg": libs[0], "bicgstab": libs[1], "gmres": libs[2]}[
            key.replace("_", "-").split("-")[0]]

    want, bad = {}, []
    for rnd in range(rounds):
        for n, flags in variants.items():
            _build.EXTRA_FLAGS = flags
            for key, (fn, iters, _, plain) in runs.items():
                name = library(key)
                lib = _build.load(name)
                line = {"variant": n, "round": rnd, "run": key}
                if rnd == 0:
                    out = fn()
                    d = _digest(*out)
                    line["digest"] = d
                    if plain is not None:
                        line["max_abs_err"], close = _plain_gap(out, plain)
                        if not close:
                            bad.append(f"{n} {key}: outside {KRYLOV_TOL} "
                                       f"of the plain version")
                    if want.setdefault(key, d) != d:
                        bad.append(f"{n} {key} differs from the shipped "
                                   f"build")
                line["ms"] = cuda_ms(fn, 3)
                if key.startswith("gmres") or " B=" in key:
                    line["graph_ms"] = graph_ms(fn, 20)
                if "-DKRY_PROFILE" in flags:
                    prof = getattr(lib, f"{name}_profile")
                    prof.argtypes = [ctypes.c_void_p]
                    out = (ctypes.c_ulonglong * len(phases))()
                    _build.check(prof(out), "profile")
                    fn()
                    torch.cuda.synchronize()
                    _build.check(prof(out), "profile")
                    line.update(zip(phases, (c / ctas / iters for c in out)))
                print(json.dumps(line), flush=True)
    _build.EXTRA_FLAGS = ()
    print(card_name())
    if bad:
        print("kernel_variants FAILED: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


#: ``--kernels ssm``: mamba2-780m's SSD widths and the timed cells
SSM_SHAPE = (1, 8192, 48, 64, 128)
SSM_CELLS = [(dtype, chunk) for dtype in ("float32", "bfloat16")
             for chunk in (128, 15, 1)]


def ssm(src: str, rounds: int) -> int:
    """``--kernels ssm``: one JSON line per round."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import ssm_scan as kssm

    secs = _build.build_all(("ssm_scan",))
    log = _build.build_log("ssm_scan").read_text()
    print(json.dumps({"src": src, "library": "ssm_scan",
                      "build_s": secs.get("ssm_scan"), **spills(log)}))
    bsz, t, h, p, n = SSM_SHAPE
    rng = np.random.default_rng(0)

    def put(v):
        return torch.from_numpy(np.asarray(v, np.float32)).cuda()

    x = put(0.5 * rng.standard_normal((bsz, t, h, p)))
    dt = torch.nn.functional.softplus(put(rng.standard_normal((bsz, t, h))))
    a = -torch.exp(put(rng.standard_normal(h)))
    b = put(0.5 * rng.standard_normal((bsz, t, n)))
    c = put(0.5 * rng.standard_normal((bsz, t, n)))
    d = put(rng.standard_normal(h))
    streams, want = {}, {}
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        xs, dts, bs, cs = (v.to(td) for v in (x, dt, b, c))
        streams[dtype] = (xs, dts, a, bs, cs, d)
        want[dtype] = torch.stack([ref.ssm_scan(
            xs[i].float(), dts[i].float(), a, bs[i].float(), cs[i].float(),
            d) for i in range(bsz)])
    launch = {}
    for dtype, chunk in SSM_CELLS:
        if hasattr(kssm, "config"):
            cfg = kssm.config(bsz, t, h, p, n, chunk, getattr(torch, dtype))
        else:   # the parent's kernel: 32 columns a CTA
            lib = _build.load("ssm_scan")
            cfg = dict(grid=[-(-p // 32), h, bsz],
                       smem=lib.ssm_scan_smem_bytes(min(chunk, t), n))
        launch[f"{dtype} chunk={chunk}"] = cfg
    print(json.dumps({"src": src, "launch": launch}))
    bad = []
    for rnd in range(rounds):
        line = {"src": src, "round": rnd}
        for dtype, chunk in SSM_CELLS:
            args = streams[dtype]
            run = lambda: ops.ssd_scan(*args, chunk=chunk)
            key = f"{dtype} chunk={chunk}"
            if rnd == 0:
                err = (run().float() - want[dtype]).abs().max().item()
                line[f"{key} max_abs_err"] = err
                line[f"{key} digest"] = _digest(run().float())
                tol = 1e-3 if dtype == "float32" else 5e-2
                if not torch.allclose(run().float(), want[dtype], rtol=tol,
                                      atol=tol):
                    bad.append(f"{key}: misses rtol=atol {tol} ({err})")
            reps = 10 if chunk == 128 else 3
            line[f"{key} ms"] = cuda_ms(run, reps)
            line[f"{key} graph_ms"] = graph_ms(run, 20 if chunk == 128
                                               else 3)
        print(json.dumps(line), flush=True)
    print(card_name())
    if bad:
        print("kernel_variants FAILED: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


#: ``--kernels ssm_profile``: name -> -D flags
SSM_VARIANTS = {"shipped": (), "profile": ("-DSSM_PROFILE",)}
SSM_PHASES = (
    [f"row {p}" for p in ("barrier", "wait_M", "intra", "wait_slots",
                          "slots", "y_next_x")]
    + [f"state {p}" for p in ("barrier_publish", "wait_next_S", "make_M",
                              "wait_slots", "slots", "h")]
    + ["copy wait", "copy rest"])


def ssm_profile(src: str, rounds: int) -> int:
    """``--kernels ssm_profile``: one JSON line per build and round."""
    import ctypes
    from repro_torch.kernels import _build, ops, ref

    with concurrent.futures.ThreadPoolExecutor(len(SSM_VARIANTS)) as pool:
        list(pool.map(lambda v: _build.build_all(("ssm_scan",), extra=v),
                      SSM_VARIANTS.values()))
    for n, flags in SSM_VARIANTS.items():
        log = _build.build_log("ssm_scan", flags).read_text()
        scan = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(json.dumps({"variant": n, **spills(log), "ptxas": scan}))
    bsz, t, h, p, nn = SSM_SHAPE
    rng = np.random.default_rng(0)

    def put(v):
        return torch.from_numpy(np.asarray(v, np.float32)).cuda()

    x = put(0.5 * rng.standard_normal((bsz, t, h, p)))
    dt = torch.nn.functional.softplus(put(rng.standard_normal((bsz, t, h))))
    a = -torch.exp(put(rng.standard_normal(h)))
    b = put(0.5 * rng.standard_normal((bsz, t, nn)))
    c = put(0.5 * rng.standard_normal((bsz, t, nn)))
    d = put(rng.standard_normal(h))
    want = torch.stack([ref.ssm_scan(x[i], dt[i], a, b[i], c[i], d)
                        for i in range(bsz)])
    run = lambda: ops.ssd_scan(x, dt, a, b, c, d, chunk=128)
    ctas = -(-p // 16) * h * bsz
    bad = []
    for rnd in range(rounds):
        for n, flags in SSM_VARIANTS.items():
            _build.EXTRA_FLAGS = flags
            lib = _build.load("ssm_scan")
            line = {"variant": n, "round": rnd}
            if rnd == 0:
                for chunk in (128, 15, 1):
                    got = ops.ssd_scan(x, dt, a, b, c, d, chunk=chunk)
                    err = (got - want).abs().max().item()
                    line[f"chunk={chunk} max_abs_err"] = err
                    line[f"chunk={chunk} digest"] = _digest(got)
                    if not torch.allclose(got, want, rtol=1e-3, atol=1e-3):
                        bad.append(f"{n} chunk={chunk}: {err}")
            line["ms"] = cuda_ms(run, 5)
            line["graph_ms"] = graph_ms(run, 10)
            if "-DSSM_PROFILE" in flags:
                prof = lib.ssm_scan_profile
                prof.argtypes = [ctypes.c_void_p]
                out = (ctypes.c_ulonglong * len(SSM_PHASES))()
                _build.check(prof(out), "ssm_scan_profile")
                run()
                _build.check(prof(out), "ssm_scan_profile")
                line.update(zip(SSM_PHASES,
                                (v / ctas / 64 for v in out)))
            print(json.dumps(line), flush=True)
    _build.EXTRA_FLAGS = ()
    run()
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_:
        for _ in range(5):
            run()
        torch.cuda.synchronize()
    for ev in prof_.key_averages():
        dev = getattr(ev, "device_time_total", 0) or getattr(
            ev, "cuda_time_total", 0)
        if dev and "ssd" in ev.key:
            print(json.dumps({"kernel": ev.key[:60], "calls": ev.count,
                              "device_us_per_call": dev / ev.count}))
    print(card_name())
    if bad:
        print("kernel_variants FAILED: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


#: The [step specs] cells: every Table-III spec at the loop tiers' full
#: shapes (2D 8192x8192, 3D 256^3)
STEP_SHAPES = {2: (8192, 8192), 3: (256, 256, 256)}
HBM_BW = 3.35e12


def conv_yardstick(spec, x):
    """One cuDNN convolution computing the interior of one step of ``spec``
    on ``x`` (2D or 3D), in x's type; the port never calls it."""
    r, k = spec.radius, 2 * spec.radius + 1
    w = torch.zeros((1, 1) + (k,) * spec.ndim, device=x.device,
                    dtype=x.dtype)
    for off, wt in zip(spec.offsets, spec.weights):
        w[(0, 0) + tuple(o + r for o in off)] = wt
    conv = (torch.nn.functional.conv2d if spec.ndim == 2
            else torch.nn.functional.conv3d)
    return lambda: conv(x[None, None], w)


def step_specs(src: str, rounds: int) -> int:
    """``--kernels step_specs``: one JSON line per cell and round."""
    from repro_torch import Plan, StencilProblem, execute
    from repro_torch.core import perks
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.common import BENCHMARKS

    torch.backends.cudnn.allow_tf32 = False
    secs = _build.build_all(("stencil_step",))
    print(json.dumps({"src": src, "library": "stencil_step",
                      "build_s": secs.get("stencil_step"),
                      **spills(_build.build_log("stencil_step").read_text())}))
    rng = np.random.default_rng(0)
    step = ops.stencil_baseline_step
    bad = []
    for rnd in range(rounds):
        for name, spec in BENCHMARKS.items():
            shape = STEP_SHAPES[spec.ndim]
            base = torch.from_numpy(rng.standard_normal(
                shape, dtype=np.float32)).cuda()
            for dt in (torch.float32, torch.bfloat16):
                x = base.to(dt)
                out = torch.empty_like(x)
                fn = lambda x=x, s=spec, o=out: step(x, spec=s, out=o)
                line = {"src": src, "round": rnd, "spec": name,
                        "shape": list(shape), "dtype": str(dt)[6:]}
                before = ops.launch_counts()
                got = fn()
                torch.cuda.synchronize()
                line["launches"] = {k: v - before[k] for k, v in
                                    ops.launch_counts().items()
                                    if v != before[k]}
                want = ref.stencil_step(x, spec)
                if not torch.equal(got, want):
                    bad.append(f"{name} {line['dtype']} is not bit-equal to "
                               f"ref.stencil_step")
                line["bit_equal"] = bool(torch.equal(got, want))
                line["ms"] = cuda_ms(fn, 20)
                line["graph_ms"] = graph_ms(fn, 20)
                line["bound_ms"] = 1e3 * 2 * x.numel() * x.element_size() / HBM_BW
                line["plain_ms"] = cuda_ms(lambda: ref.stencil_step(x, spec), 3)
                line["library_ms"] = cuda_ms(conv_yardstick(spec, x), 5)
                print(json.dumps(line), flush=True)
                del x, out, got, want
        spec = BENCHMARKS["2d5pt"]
        xs = torch.from_numpy(rng.standard_normal(
            (8, 2048, 2048), dtype=np.float32)).cuda()
        out = torch.empty_like(xs)
        fn = lambda: step(xs, spec=spec, out=out)
        got = fn().clone()
        lanes = all(torch.equal(got[i], step(xs[i], spec=spec))
                    for i in range(8))
        if not lanes:
            bad.append("batched 2d5pt: a lane differs from its own launch")
        big = torch.from_numpy(rng.standard_normal(
            (8192, 8192), dtype=np.float32)).cuda()
        dst = torch.empty_like(big)
        line = {"src": src, "round": rnd,
                "batched_2d5pt_8x2048_ms": cuda_ms(fn, 20),
                "batched_2d5pt_8x2048_graph_ms": graph_ms(fn, 20),
                "batched_lanes_bit_equal": lanes,
                "copy_8192_f32_graph_ms": graph_ms(lambda: dst.copy_(big), 20)}
        problem = StencilProblem(big, BENCHMARKS["2ds25pt"], 100)
        for tier in ("host_loop", "device_loop"):
            perks.clear_graphs()
            run = lambda: execute(problem, Plan(tier=tier))
            line[f"2ds25pt_8192_x100_{tier}_ms"] = cuda_ms(run, 3)
        print(json.dumps(line), flush=True)
        del xs, out, got, big, dst, problem
    print(card_name())
    if bad:
        print("kernel_variants FAILED: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--kernels", choices=("stencil", "spmv_decode",
                                          "sell_deep", "deep_profile",
                                          "shallow_resident",
                                          "resident_profile", "perks_stream",
                                          "perks_profile", "krylov",
                                          "krylov_lanes", "krylov_profile",
                                          "ssm",
                                          "ssm_profile", "step_specs"),
                    default="stencil")
    ap.add_argument("--digests", default=None,
                    help="--kernels krylov: keep and compare the outputs' "
                         "digests in this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    if args.kernels == "spmv_decode":
        return spmv_decode(src, args.rounds)
    if args.kernels == "sell_deep":
        return sell_deep(src, args.rounds)
    if args.kernels == "deep_profile":
        return deep_profile(src, args.rounds)
    if args.kernels == "shallow_resident":
        return shallow_resident(src, args.rounds)
    if args.kernels == "resident_profile":
        return resident_profile(src, args.rounds)
    if args.kernels == "perks_stream":
        return shallow_resident(src, args.rounds, PS_CELLS)
    if args.kernels == "perks_profile":
        return perks_profile(src, args.rounds)
    if args.kernels in ("krylov", "krylov_lanes"):
        return krylov(src, args.rounds, args.digests,
                      lanes_only=args.kernels == "krylov_lanes")
    if args.kernels == "krylov_profile":
        return krylov_profile(src, args.rounds)
    if args.kernels == "ssm":
        return ssm(src, args.rounds)
    if args.kernels == "ssm_profile":
        return ssm_profile(src, args.rounds)
    if args.kernels == "step_specs":
        return step_specs(src, args.rounds)
    from repro_torch import Plan, StencilProblem, execute
    from repro_torch.exec import plan_candidates
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.common import get_spec

    stencil_libs = ("stencil_step", "stencil_perks")
    _build.build_all(stencil_libs)
    log = "\n".join(_build.build_log(s).read_text() for s in stencil_libs)
    print(json.dumps({"src": src, **spills(log)}))

    spec = get_spec("2d5pt")
    rng = np.random.default_rng(0)
    big = torch.from_numpy(rng.standard_normal((8192, 8192), dtype=np.float32)).cuda()
    small = torch.from_numpy(rng.standard_normal((3072, 1152), dtype=np.float32)).cuda()
    problem = StencilProblem(big, spec, 100)
    rows = next(c.cached_rows for c in plan_candidates(problem)
                if c.tier == "resident" and c.fuse_steps == 1
                and c.schedule == "shallow")
    want = {"step": ref.stencil_step(big, spec),
            "perks": ref.stencil_run(big, spec, 100),
            "resident": ref.stencil_run(small, spec, 1000)}
    want["device_loop"] = want["perks"]
    runs = {
        "step": lambda: ops.stencil_baseline_step(big, spec=spec),
        "perks": lambda: ops.stencil_perks(big, spec=spec, steps=100,
                                           cached_rows=rows),
        "resident": lambda: ops.stencil_resident(small, spec=spec, steps=1000),
        "device_loop": lambda: execute(problem, Plan(tier="device_loop")),
    }
    bad = []
    for rnd in range(args.rounds):
        line = {"round": rnd, "src": src, "perks_cached_rows": rows}
        for k, fn in runs.items():
            if rnd == 0:
                err = (fn() - want[k]).abs().max().item()
                line[f"{k}_max_abs_err"] = err
                if not err <= ATOL:
                    bad.append(f"{k}: {err}")
            line[f"{k}_ms"] = cuda_ms(fn, 20 if k == "step" else 5)
        print(json.dumps(line), flush=True)
    print(card_name())
    if bad:
        print("kernel_variants FAILED: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
