"""Drive the PyTorch/CUDA port's stencil, conjugate-gradient, Krylov
(BiCGStab, GMRES(m)), SSD-scan, serving, batched and solver-service paths
on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together) and print the build seconds;
2. hold each stencil kernel against its plain torch version on the card,
   at atol 5e-6, rtol 0: all 13 Table-III specs at a moderate size (the
   one-step ``stencil_perks``, ``csrc/stencil_perks.cu``, bit for bit at
   0 < R < H cached rows, every launch fed its window by bulk copies), the
   temporally blocked ``stencil_perks`` (t = 2, 4) and
   ``stencil_perks_deep`` (t = 2, 8, 32; bit for bit) with 0 and 4r+1
   cached rows included (a layout one CTA cannot hold is listed, not run);
   then the same in bf16 at atol 2e-2 (the one-step and deep kernels bit
   for bit); the one-step kernel on 3d7pt and 3d27pt domains of 160x160
   planes, wider than a CTA's registers hold, with their cached planes cut
   into boxes, bit for bit in f32 and bf16; then
   each kernel at the stencil path's full shapes, with its time, its plain
   version's time and (for the one-step kernel) a cuDNN convolution's; the
   deep kernel there must load level 0 by TMA, the shallow tiles
   (``csrc/stencil_shallow.cu``) and ``stencil_resident``
   (``csrc/stencil_resident.cu``) must copy their tiles and halo rows by
   ``cp.async``;
3. the stencil path, with every launch counter set to 0 just before and
   read just after: ``StencilProblem`` -> ``plan`` -> ``execute`` for
   2d5pt at 8192x8192 f32 (100 steps) and at 3072x1152 f32 (1000 steps)
   and 3d7pt at 256^3 f32 (100 steps), every loop tier, the one-step
   resident candidate (partial caching, ``stencil_perks``, which must
   cache part of the 3D domain; the whole small domain,
   ``stencil_resident``), shallow (t = 4) and deep (t = 8, 32) resident
   plans, and plans in the JAX package's JSON form with ``fuse_steps>1``
   and ``schedule="deep"``, and two the card cannot hold as they are (deep
   t = 8 with 1240 cached rows of 8192x8192, shallow t = 4 with 176 cached
   planes of 3d27pt 256^3), which must run with one ``RuntimeWarning``;
   each result against the plain version; every one-step launch must have
   fed its window by bulk copies, every deep launch must have loaded
   level 0 by TMA, the whole small domain must have run
   ``csrc/stencil_resident.cu`` with its halo rows copied by ``cp.async``,
   and the shallow t = 4 plan ``csrc/stencil_shallow.cu`` with its tiles
   copied by ``cp.async``;
4. each stencil tier's median time, cells/s and effective bandwidth, every
   planner candidate's time beside its price, and the planner's pick
   against the fastest candidate measured; then
   each depth of both schedules on 2d5pt 8192x8192 and 3d7pt 256^3 f32
   (100 steps), the one-step plan included: time, cells/s, cached bytes,
   the port's byte model and the least bytes against the measured time,
   and the planner's price;
5. the CG kernels against their plain versions: every SPD registry entry
   at its own size (50 iterations of ``cg_fused``, VEC and MIX), then each
   kernel at the CG path's full shapes with its time, its plain version's
   and (for the SpMVs) one cuSPARSE call's; ``spmv_ell`` on cg-large also
   bit for bit against its plain version; ``spmv_sell`` bit for bit on
   every registry entry (c = 8 and 32) and on cg-sell, where it and cuSPARSE
   are also timed inside a CUDA graph;
6. the CG path, with every launch counter set to 0 just before and read
   just after: ``CGProblem`` -> ``plan`` -> ``execute`` and every offered
   tier by hand, 100 iterations each, on cg-small (``poisson2d(512)``,
   ELL), cg-large (``poisson2d(1024)``, ELL) and cg-sell
   (``fem_variable_band(2**20)`` as SELL-32-256 through ``from_matvec``);
   each x against a float64 plain run;
7. each CG tier's median time, per-iteration time and effective bandwidth
   against the planner's prediction;
8. the Krylov kernels against their plain versions: every nonsymmetric
   registry entry at its own size (30 iterations of ``bicgstab_fused``,
   VEC and MIX; one m=16 cycle of ``gmres_cycle_fused``: V, H, beta, the
   new iterate and |V^T V - I|), the time of one iteration and of one
   reduction round of ``cg_fused`` and ``bicgstab_fused`` on a tiny
   system, then each kernel at the Krylov path's full shapes with its
   time and its plain version's (the GMRES cycle also in a graph, beside
   its 1 + 3m = 49 tagged rounds);
9. the Krylov path, with every launch counter set to 0 just before and read
   just after: ``BiCGStabProblem``/``GMRESProblem`` -> ``plan`` ->
   ``execute`` and every offered tier by hand on bicgstab-small and
   bicgstab-large (``convdiff2d`` 512 and 768, 100 iterations), gmres-small
   and gmres-large (``convdiff2d`` 448 and 1024, m = 16, 4 and 2 cycles);
   each x and rr against a float64 plain run;
10. each Krylov tier's median time against the planner's prediction, a
   ``precision="mixed"`` host loop on bicgstab-small, and the kept graph
   reused on bicgstab-small: the mixed-precision device loop's first run
   and its replays, and ``solve_refined`` rounds (no launch on a replay);
11. the ML kernels against their plain versions: ``ssm_scan`` at the
   reference test's shapes and at mamba2-780m's SSD widths (H = 48, P = 64,
   N = 128, T = 8192) in f32 and bf16 at chunks 128, 15 and 1, its
   float32, byte and 3xTF32 tensor-core bounds, and the launch it makes
   (grid, shared memory a CTA, slots in its ring);
   ``decode_attention`` over four (Hq, Hkv) pairs with and without
   ``length`` in f32 and bf16, its tensor-core kernel (bf16) at D = 64, 80,
   128, 256, four head layouts (groups 1-16), S = 1-1000 and four lengths,
   both decode kernels (and SDPA) timed in a graph at every configuration's
   (Hq, Hkv, D), B = 8, S = 4096, beside the kernel ``kernel_for`` picks,
   and at B = 8, S = 32768, Hq = 14, Hkv = 2, D = 64 bf16 (and f32); each
   with its time, its plain version's, (decode) one
   ``scaled_dot_product_attention`` call's and the CUDA-core kernel's on
   the same bf16 inputs;
12. the SSD scan path, counted: ``SSMScanProblem`` at those widths through
   ``plan`` -> ``execute`` on all three tiers, each held to the oracle at
   1e-3, and each tier's time;
13. the serving path, counted: the ``Engine`` on qwen2-0.5b at full width
   (seeded random weights on the card), 8 requests, prompt 128, 32 new
   tokens, in the persistent and the host-loop mode, then
   ``DecodeAttentionProblem`` on every tier from one prefill: tokens
   identical everywhere, ``decode_attention`` 24 launches a token on the
   host loop, every one on the tensor cores, times per tier; and the smoke
   config in float32 on the card against the CPU;
13b. [serve ssm] the SSM and hybrid families served, counted: the
   ``Engine`` on mamba2-780m and zamba2-1.2b at full width (seeded random
   weights on the card), 8 requests, prompt 512, 32 new tokens, bf16, two
   persistent batches (capture, replay) and a host-loop one, then
   ``DecodeAttentionProblem`` on every tier: tokens identical everywhere,
   ``ssm_scan`` launches equal to the layers a prefill (all with the final
   state), zamba2's ``decode_attention`` 6 a token on the tensor cores,
   the replayed batch's torch operators against a prefill's; zamba2's
   six ``decode_attention`` calls of the first and the last decode step,
   recorded, against their plain version in bf16 and float32;
   ``ssd_scan(return_state=True)`` against the per-step recurrence on
   layer 0's recorded prefill inputs (y and h within 1e-3, y bit for bit
   the stateless launch's), timed; prefill and decode times beside the
   byte model of a token;
14. [batch kernels] the batched launches, B instances in one launch: the
   batched ``stencil_step`` on every Table-III spec in f32 and bf16 at
   B = 3, ``spmv_ell`` at B = 1, 2, 4, 8 on poisson2d(1024), ``vdot`` on
   eight lanes, and ``cg_fused`` at B = 1, 2, 3, 4 on poisson2d(512),
   B = 16 on poisson2d(256) and B = 32 on poisson2d(128) (100 iterations,
   A on chip), each bit for bit against B single launches and
   (``cg_fused``: x and rr of every lane held to a float64 run) its plain
   version, and timed at full size, in a graph too, beside one library
   call (``cg_fused``: at every B, beside one lane's single launch); then
   the resident stencil kernels with B domains in one cooperative launch
   (a lane on SMs // B CTAs, a different seeded domain a lane): the
   one-step kernel, the shallow tiles (t = 4) and the deep pipelines
   (t = 8) on 2d5pt 2048^2 x 100 at B = 3 and 8, the one-step kernel on
   3d7pt 256^3 x 100 at B = 3, ``stencil_resident`` (the whole domain) on
   2d5pt 1024^2 at B = 3 and 4 and 512^2 at B = 8, and a bf16 set; every
   lane bit for bit against its single launch on the whole card and the
   plain version, with the lane's CTAs and cached rows, timed eager and
   in a graph beside its bound;
15. [batch path] counted: ``BatchedProblem`` -> ``plan_candidates`` ->
   ``execute`` on every offered tier, the resident candidates included,
   against ``execute_sequential`` of the same plan (bit for bit,
   per-instance ms) for stencil-batch (2d5pt, B = 8 domains of
   2048x2048, 100 steps), stencil-batch-small (2d5pt, B = 4 x 1024^2,
   whose lanes hold their whole domains), cg-batch-small (poisson2d(512), B = 4, 100
   iterations), cg-batch-large (poisson2d(1024), B = 8), bicgstab-batch
   (convdiff2d(512), B = 8, 100 iterations) and gmres-batch
   (convdiff2d(448), B = 4, 4 GMRES(16) cycles), and the launches of one
   batched step against one single step (1, 19, 40 and 677);
16. [service] a ``SolverService(max_batch=8)`` fed 16 stencil and 8 CG
   requests, interleaved: its stats, its plans, the tier of each stencil
   batch, the graph captures per key (one for the stencil key on the
   device loop, none on the resident tier), every result bit for bit
   against its own
   ``execute``, and the ``service_*``/``executor_*`` Prometheus lines;
   then [async service], with every launch counter set to 0 just before
   and read just after: ``AsyncSolverService(AsyncConfig(max_batch=8))
   .serve(trace)`` of a seeded Poisson arrival trace of the same 16
   stencil and 8 CG requests plus 8 BiCGStab (convdiff2d(512), 100
   iterations) and 4 GMRES(16) (convdiff2d(448), 4 cycles) requests: its
   stats (p50/p99 queued and latency, instances/s), admissions mid-solve,
   barriers and graph captures a key (one each), every result bit for bit
   against its request alone under the engine's cadence, the synchronous
   ``SolverService``'s p50/p99 on the same trace beside them, and a
   barrier's cost: the kept in-place chunk graph against a chunk through
   ``LaneRunner.advance`` (copied in and out of the device loop's graph);
17. [obs] traced ``execute`` bit-equal to untraced on four plans, and the
   Chrome trace's event count;
18. [autotune] ``autotune(top_k=4)`` with a drift ledger file on 2d5pt and
   2ds25pt at 8192x8192 and 3d7pt 256^3 (100 steps): each candidate's
   predicted and measured ms, and a second call against the same file
   that measures nothing;
19. [step specs] the loop tiers' step (``csrc/stencil_step.cu``) on every
   Table-III spec at the loop tiers' full shapes (2D specs 8192x8192, 3D
   specs 256^3) in f32 and bf16: bit for bit against its plain version
   (and B = 3 domains in one launch, each lane against its own launch),
   timed eager and in a CUDA graph beside its byte bound, the plain
   version and one cuDNN convolution (``conv2d``/``conv3d``, TF32 off);
   then, counted, ``StencilProblem`` -> ``execute`` on the host and device
   loop tiers (4 steps), bit for bit against the plain run, every launch
   on a compiled shape and on 16-byte rows;
20. one ``{"kernels": [...]}`` line with all twelve kernels, the SSD
   scan's final-state launch (``ssm_scan_state``), the seven
   batched launches (the step kernel, ``spmv_ell``, ``cg_fused`` and the
   four resident stencil kernels), ``vdot`` and the step kernel per spec
   and type, the card's name and power limit, and ``{"ok": true,
   "device": {...}}`` as the last line.

Without a CUDA device it prints no result and exits non-zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ATOL = 5e-6              # the reference's kernel bound (tests/test_deep_blocking.py)
BF16_ATOL = 2e-2         # the reference's bf16 bound (tests/test_kernels_stencil.py)
# The SpMVs against their plain version: the reference's SpMV bound
# (tests/test_kernels_linalg.py) plus a relative term, for the order of
# summation.
SPMV_RTOL, SPMV_ATOL = 1e-5, 1e-5
# cg_fused and the CG tiers against the plain version at moderate size: the
# reference's fused-CG bound (tests/test_kernels_linalg.py) on x and rr.
CG_RTOL, CG_ATOL = 1e-3, 1e-5
# At full size after 100 iterations rounding grows with n, so x is held
# against a float64 plain run: its distance may be at most twice the
# float32 plain version's distance plus X64_REL * ||x_64||. At moderate size
# every entry is held so, and the entries below also at CG_RTOL/CG_ATOL
# against the float32 plain run. graph_powerlaw_8k is not among them: two
# float32 plain runs that differ only in the order of their dot products'
# sums already differ by about 2e-4 in x after 50 iterations there, so
# no float32 kernel with its own reduction order meets that
# bound on it; the moderate phase prints that spread for every entry.
X64_REL = 1e-5
F32_EPS = float(np.finfo(np.float32).eps)   # float32's relative resolution
CG_F32_CLOSE = ("poisson2d_small", "poisson2d_16k", "poisson3d_16",
                "fem_band_8k", "graph_regular_4k", "rand_shift_16k")
CG_ITERS = 100
KRYLOV_M = 16
KRYLOV_KERNEL_ITERS = 30
KRYLOV_CELLS = [  # (cell, kind, convdiff2d side, iterations or cycles)
    ("bicgstab-small", "bicgstab", 512, 100),   # n = 2^18, A wholly on chip
    ("bicgstab-large", "bicgstab", 768, 100),   # A partly on chip
    ("gmres-small", "gmres", 448, 4),           # V and A on chip
    ("gmres-large", "gmres", 1024, 2),          # loop tiers only
]
CG_CELLS = [  # (cell, generator, size): the CG path's three shapes
    ("cg-small", "poisson2d", 512),             # n = 2^18, A wholly on chip
    ("cg-large", "poisson2d", 1024),            # n = 2^20, A partly on chip
    ("cg-sell", "fem_variable_band", 2**20),    # SELL-32-256, loop tiers
]
HBM_BW = 3.35e12         # H100 SXM device memory, bytes/s (NVIDIA data sheet)
FP32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores, FLOP/s
TF32_FLOPS = 495e12      # H100 SXM dense TF32 on the tensor cores, FLOP/s
SEED = 0
MAIN = [  # (spec, shape, n_steps, what the one-step resident plan caches)
    ("2d5pt", (8192, 8192), 100, "partial"),
    ("2d5pt", (3072, 1152), 1000, "whole"),
    ("3d7pt", (256, 256, 256), 100, "boxes"),
]
# The one-step kernel on planes wider than a CTA's registers hold (160 x 160
# = 25,600 cells): one star and one box 3D spec of radius 1.
WIDE = [("3d7pt", (40, 160, 160)), ("3d27pt", (40, 160, 160))]
FUSED_T = 4              # stencil_perks_fused's depth on the main path
DEEP_T = 8               # stencil_perks_deep's in the kernels line
TB_STEPS = 37            # moderate-size temporal-blocking checks: 37 % t != 0
# Every temporal-blocking depth of the [depths] sweep: each is timed beside
# the planner's price of it (planner_ms), so the levels' prices
# (planner.TB_SHALLOW_TERM_S, TB_DEEP_LANE_CELL_S, PERKS_TERM_S) can be read
# off it; the loop tiers are timed there too, beside the planner's pick.
DEPTHS = [("shallow", 1), ("shallow", 2), ("shallow", 4), ("deep", 2),
          ("deep", 4), ("deep", 8), ("deep", 16), ("deep", 32)]
SWEEP = [("2d5pt", (8192, 8192), 100), ("3d7pt", (256, 256, 256), 100)]
# Plans as the JAX package serialises them (``Plan.to_json``), with
# temporal blocking: they load through the shared schema and run here.
REFERENCE_PLANS = [
    '{"tier": "resident", "n_steps": 100, "problem": "stencil_2d5pt", '
    '"chip": "tpu_v5e", "batch": 1, "fuse_steps": 4, "schedule": "shallow", '
    '"sync_every": null, "cache": [{"name": "domain_rows", "cached_bytes": '
    '0, "total_bytes": 268435456}], "cached_rows": 0, "sub_rows": 128, '
    '"policy": null, "block_rows": null, "shard_axis": null, "partition": '
    '"rows", "fuse_reductions": false, "s_step": 1, "inner_tier": '
    '"device_loop", "precision": "uniform", "predicted_s": null, '
    '"predicted_bound": null}',
    '{"tier": "resident", "n_steps": 100, "problem": "stencil_2d5pt", '
    '"chip": "tpu_v5e", "batch": 1, "fuse_steps": 16, "schedule": "deep", '
    '"sync_every": null, "cache": [{"name": "domain_rows", "cached_bytes": '
    '0, "total_bytes": 268435456}], "cached_rows": 0, "sub_rows": 128, '
    '"policy": null, "block_rows": null, "shard_axis": null, "partition": '
    '"rows", "fuse_reductions": false, "s_step": 1, "inner_tier": '
    '"device_loop", "precision": "uniform", "predicted_s": null, '
    '"predicted_bound": null}',
]
# The JAX package's plans the card cannot hold as they are, with their
# problems: (plan JSON, spec, shape, steps). Each runs fitted to the
# kernels' layouts, with one RuntimeWarning (exec.adapters.fit_stencil_plan).
FIT_PLANS = [
    ('{"tier": "resident", "n_steps": 100, "problem": "stencil_2d5pt", '
     '"chip": "tpu_v5e", "batch": 1, "fuse_steps": 8, "schedule": "deep", '
     '"sync_every": null, "cache": [{"name": "domain_rows", "cached_bytes": '
     '40632320, "total_bytes": 268435456}], "cached_rows": 1240, '
     '"sub_rows": 128, "policy": null, "block_rows": null, "shard_axis": '
     'null, "partition": "rows", "fuse_reductions": false, "s_step": 1, '
     '"inner_tier": "device_loop", "precision": "uniform", "predicted_s": '
     'null, "predicted_bound": null}', "2d5pt", (8192, 8192), 100),
    ('{"tier": "resident", "n_steps": 100, "problem": "stencil_3d27pt", '
     '"chip": "tpu_v5e", "batch": 1, "fuse_steps": 4, "schedule": '
     '"shallow", "sync_every": null, "cache": [{"name": "domain_rows", '
     '"cached_bytes": 46137344, "total_bytes": 67108864}], "cached_rows": '
     '176, "sub_rows": 128, "policy": null, "block_rows": null, '
     '"shard_axis": null, "partition": "rows", "fuse_reductions": false, '
     '"s_step": 1, "inner_tier": "device_loop", "precision": "uniform", '
     '"predicted_s": null, "predicted_bound": null}', "3d27pt",
     (256, 256, 256), 100),
]
STENCIL_KERNELS = {
    "stencil_perks": ("src/repro_torch/kernels/csrc/stencil_perks.cu",
                      "src/repro/kernels/stencil2d.py:203"),
    "stencil_perks_fused": ("src/repro_torch/kernels/csrc/stencil_shallow.cu",
                            "src/repro/kernels/stencil2d.py:203"),
    "stencil_perks_deep": ("src/repro_torch/kernels/csrc/stencil_tb.cu",
                           "src/repro/kernels/stencil2d.py:468"),
    "stencil_resident": ("src/repro_torch/kernels/csrc/stencil_resident.cu",
                         "src/repro/kernels/stencil2d.py:540"),
    "stencil_baseline_step": ("src/repro_torch/kernels/csrc/stencil_step.cu",
                              "src/repro/kernels/stencil2d.py:566"),
}
CG_KERNELS = {
    "spmv_ell": ("src/repro_torch/kernels/csrc/spmv_ell.cu",
                 "src/repro/kernels/spmv_ell.py:38"),
    "spmv_sell": ("src/repro_torch/kernels/csrc/spmv_sell.cu",
                  "src/repro/kernels/spmv_sell.py:65"),
    "cg_fused": ("src/repro_torch/kernels/csrc/cg_fused.cu",
                 "src/repro/kernels/cg_fused.py:104"),
}

KRYLOV_KERNELS = {
    "bicgstab_fused": ("src/repro_torch/kernels/csrc/bicgstab_fused.cu",
                       "src/repro/kernels/krylov_fused.py:129"),
    "gmres_cycle_fused": ("src/repro_torch/kernels/csrc/gmres_cycle_fused.cu",
                          "src/repro/kernels/krylov_fused.py:235"),
}

ML_KERNELS = {
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:72"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                         "src/repro/kernels/decode_attn.py:61"),
}
# The ML kernels against their plain versions: the reference's bounds
# (tests/test_kernels_linalg.py), the SSD scan at rtol = atol 1e-3 (f32) /
# 5e-2 (bf16), decode attention at rtol 1e-4, atol 1e-5 (f32) / 5e-2 (bf16).
SSM_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
DECODE_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
              torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}
SSM_H, SSM_P, SSM_N, SSM_T = 48, 64, 128, 8192   # mamba2-780m's SSD widths
DECODE_HEADS = [(8, 8), (8, 2), (4, 1), (14, 2)]
DECODE_LONG = (8, 32768, 14, 2, 64)    # B, S, Hq, Hkv, D: qwen2-0.5b heads
# the tensor-core kernel's shapes: the configs' head dims and groups of 1-16
TC_DIMS = (64, 80, 128, 256)
TC_HEADS = [(16, 16), (40, 8), (14, 2), (64, 4)]
TC_SEQS = (1, 63, 64, 65, 160, 1000)
DECODE_BY_CONFIG = (8, 4096)           # B, S: both kernels at each config
SERVE_ARCH = "qwen2-0.5b"
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 8, 128, 32
# [serve ssm]: the SSM and hybrid families at full width, prompt 512 (four
# chunks of 128)
SSM_SERVE_ARCHS = ("mamba2-780m", "zamba2-1.2b")
SSM_SERVE_REQUESTS, SSM_SERVE_PROMPT, SSM_SERVE_NEW = 8, 512, 32
SSM_STATE_KERNEL = {
    "ssm_scan_state": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                       "src/repro/kernels/ssm_scan.py:72"),
}

FAILS: list[str] = []


def check_close(what: str, got: torch.Tensor, want: torch.Tensor,
                rtol: float, atol: float, quiet: bool = False) -> float:
    """Max abs error of ``got`` against ``want``; a FAIL unless every
    element lies within atol + rtol * |want| and all are finite. ``quiet``
    prints the line only for a FAIL."""
    diff = (got.double() - want.double()).abs()
    err = diff.max().item() if diff.numel() else 0.0
    ok = (got.shape == want.shape and bool(torch.isfinite(got).all())
          and bool((diff <= atol + rtol * want.double().abs()).all()))
    if not (ok and quiet):
        print(f"  {what}: max_abs_err={err!r} {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILS.append(what)
    return err


def check_decode_bf16(what: str, got: torch.Tensor,
                      want: torch.Tensor, quiet: bool = False) -> float:
    """bf16 ``decode_attention`` against its plain version on float32 copies
    of the same inputs: rtol 5e-2 and an atol of 5e-2 times the rms of
    ``want`` over its last three axes (one call's (B, Hq, D)), so an output
    of zeros or one missing a KV split fails however small the outputs are
    (about sqrt(1/S) on random inputs)."""
    tol = DECODE_TOL[torch.bfloat16]
    rms = want.double().pow(2).mean(dim=(-3, -2, -1), keepdim=True).sqrt()
    return check_close(f"{what} (atol {tol['atol']} x rms, rms >= "
                       f"{rms.min().item()!r})", got, want, tol["rtol"],
                       tol["atol"] * rms, quiet)


def digest(t: torch.Tensor) -> str:
    """A short hash of a tensor's bits (to compare runs of two trees)."""
    import hashlib
    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()[:16]


def bit_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """A FAIL unless ``got`` equals ``want`` bit for bit (a kernel that
    sums in its plain version's order); prints only a FAIL."""
    if not torch.equal(got, want):
        print(f"  {what}: not bit-equal to its plain version FAIL")
        FAILS.append(f"{what} is not bit-equal")


def check(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """The stencil bound: atol ATOL, rtol 0."""
    return check_close(what, got, want, 0.0, ATOL)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events, after
    one warm-up run); ``reps=0`` times one run with no warm-up."""
    if reps:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(max(reps, 1)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = 50) -> float:
    """Host microseconds of one call of ``fn``: ``calls`` calls enqueued
    back to back, timed on the host's clock before the card catches up (the
    wrapper's own cost, which ``cuda_ms`` adds to a short kernel's time)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / calls


def graph_ms(fn, calls: int = 50) -> float:
    """Milliseconds of one call of ``fn`` on the card alone: ``calls`` calls
    captured into a CUDA graph, the replay timed (median of three, CUDA
    events) and divided by ``calls``. For kernels shorter than the host's
    cost of a call, which ``cuda_ms`` would measure instead."""
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


def bound(spec, shape, steps: int, moved_bytes: float) -> tuple[float, str]:
    """Least time for ``steps`` steps on ``shape``: the bytes the kernel
    must move at the device-memory rate, or the interior's float32
    operations at the peak rate, whichever is larger (ms, which)."""
    r = spec.radius
    t_bytes = moved_bytes / HBM_BW
    interior = math.prod(max(0, d - 2 * r) for d in shape)
    t_ops = steps * interior * spec.flops_per_cell / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def conv_step(spec, x):
    """One cuDNN float32 convolution computing the interior of one 2D step
    (the yardstick for the one-step kernel; the port never calls it)."""
    r = spec.radius
    w = torch.zeros((1, 1, 2 * r + 1, 2 * r + 1), device=x.device)
    for (d0, d1), wt in zip(spec.offsets, spec.weights):
        w[0, 0, d0 + r, d1 + r] = wt
    return lambda: torch.nn.functional.conv2d(x[None, None], w)


def check_x64(what: str, x: torch.Tensor, x32: torch.Tensor,
              x64: torch.Tensor) -> float:
    """Distance of ``x`` from the float64 plain run, held to twice the
    float32 plain run's distance plus X64_REL * ||x64||; returns the max
    abs error against the float32 plain run."""
    d = torch.linalg.vector_norm(x.double() - x64).item()
    d32 = torch.linalg.vector_norm(x32.double() - x64).item()
    limit = 2 * d32 + X64_REL * torch.linalg.vector_norm(x64).item()
    ok = (x.shape == x64.shape and bool(torch.isfinite(x).all())
          and d <= limit)
    err = (x - x32).abs().max().item()
    print(f"  {what}: |x-x64|={d!r} |x32-x64|={d32!r} limit={limit!r} "
          f"max_abs_err_vs_f32={err!r} {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILS.append(what)
    return err


def check_rr(what: str, rr: torch.Tensor, rr32s, rr64: torch.Tensor,
             bb: float) -> None:
    """rr against the float64 plain run's: finite, and its distance at
    most twice the farthest of the float32 plain runs ``rr32s`` (each in
    its own dot order, ``f32_witnesses``) plus X64_REL * rr64 — unless rr
    and rr64 both lie below (F32_EPS |b|)^2 (``bb`` = |b|^2): both then
    claim a residual below float32's resolution, which no float32 run can
    check. That is where BiCGStab's recurrence rr ends after 100
    iterations on the Krylov cells: 10-14 orders below the true residual
    |b - A x|^2 of every float32 run, the kernels' x included, and
    scattered over a factor of up to 9 around rr64 by the dot order alone
    (scripts/krylov_rr_seeds.py on an H100 SXM); x is held to float64 by
    ``check_x64`` all the same."""
    r, w = rr.double().item(), rr64.item()
    gap = max(abs(float(v) - w) for v in rr32s)
    limit = 2 * gap + X64_REL * abs(w)
    floor = F32_EPS ** 2 * bb
    ok = math.isfinite(r) and (abs(r - w) <= limit or max(r, w) <= floor)
    print(f"  {what}: rr={r!r} rr64={w!r} |rr-rr64|={abs(r - w)!r} "
          f"limit={limit!r} float32 floor={floor!r} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        FAILS.append(what)


def cg_bound(n: int, slots: int, iters: int,
             streamed_bytes: float) -> tuple[float, str]:
    """Least time for ``iters`` CG iterations (ms, which): the bytes the
    kernel must move at the device-memory rate — A, b read once, x and rr
    written once, plus the A bytes no CTA can hold streamed again each
    later iteration — or the float32 operations (2 per stored slot for the
    SpMV, 10 per row for the two dots and three axpys) at the peak rate."""
    moved = slots * 8 + n * 4 + n * 4 + 4 + max(0, iters - 1) * streamed_bytes
    t_bytes = moved / HBM_BW
    t_ops = iters * (2 * slots + 10 * n) / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def spmv_bound(n_in: int, n_out: int, slots: int,
               table_bytes: int) -> tuple[float, str]:
    """Least time for one SpMV (ms, which): its stored slots (8 B each),
    its tables and x read once, y written once; or 2 float32 operations
    per stored slot."""
    t_bytes = (slots * 8 + table_bytes + 4 * n_in + 4 * n_out) / HBM_BW
    t_ops = 2 * slots / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def blocked_dot(a, b, width: int = 1024):
    """A float32 dot in another order than ``torch.dot``: ``width``-wide
    rows, then their sums (to show how far two dot orders drift apart)."""
    prod = a * b
    pad = torch.nn.functional.pad(prod, (0, -prod.shape[0] % width))
    return pad.view(-1, width).sum(1).sum()


def cusparse_mv(csr, x):
    """One cuSPARSE CSR matrix-vector product of the same matrix (the
    yardstick for the SpMV kernels; the port never calls it)."""
    a = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr.astype(np.int32)).cuda(),
        torch.from_numpy(csr.indices.astype(np.int32)).cuda(),
        torch.from_numpy(csr.data).cuda(), size=csr.shape)
    return lambda: a @ x


def cg_phases(rng):
    """Phases 5-7: the CG kernels against their plain versions, the CG path
    counted, the CG tiers timed. Returns (errors, timing, launches) by
    kernel name."""
    from repro_torch import CGProblem, Plan, execute, plan
    from repro_torch.core import perks
    from repro_torch.exec import plan_candidates
    from repro_torch.exec.adapters import CG_STEP_LAUNCHES
    from repro_torch.kernels import ops, ref, spmv_ell
    from repro_torch.solvers.cg import SellOperator
    from repro_torch.sparse import generate, symmetric_names
    from repro_torch.sparse.generate import fem_variable_band, poisson2d

    def vec(n):
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()

    def plain_cg(matvec, b, iters, dot=torch.dot):
        state = (torch.zeros_like(b), b, b, dot(b, b))
        for _ in range(iters):
            state = ref.cg_iteration_matvec(state, matvec, dot=dot)
        return state[0], state[3]

    errs = {k: 0.0 for k in CG_KERNELS}

    def keep(k, e):
        errs[k] = max(errs[k], e)

    # -- 5. kernels against their plain versions -------------------------------
    print("[cg kernels] every SPD registry entry; cg_fused 50 iterations")
    for name in symmetric_names():
        csr = generate(name)
        n = csr.shape[0]
        ell = csr.to_ell()
        data = torch.from_numpy(ell.data).cuda()
        cols = torch.from_numpy(ell.cols).cuda()
        x, b = vec(n), vec(n)
        keep("spmv_ell", check_close(
            f"{name} spmv_ell", ops.spmv(data, cols, x),
            ref.spmv_ell(data, cols, x), SPMV_RTOL, SPMV_ATOL))
        for c, sigma in ((8, 64), (32, 256)):
            op = SellOperator.from_matrix(csr.to_sell(c=c, sigma=sigma))
            args = (op.data, op.cols, op.slice_offsets, op.slice_k, x)
            got = ops.spmv_sell(*args, c=c, k_max=op.k_max)
            want = ref.spmv_sell(*args, c=c, k_max=op.k_max)
            keep("spmv_sell", check_close(f"{name} spmv_sell c={c}", got,
                                          want, SPMV_RTOL, SPMV_ATOL))
            bit_equal(f"{name} spmv_sell c={c}", got, want)
        wx, wrr = ref.cg_run(data, cols, b, 50)
        x64, rr64 = ref.cg_run(data.double(), cols, b.double(), 50)
        bx, _ = plain_cg(lambda p: ref.spmv_ell(data, cols, p), b, 50,
                         dot=blocked_dot)
        print(f"  {name}: two float32 plain runs, dot orders apart: "
              f"max|dx|={(bx - wx).abs().max().item()!r}")
        for policy, resident in (("VEC", False), ("MIX", True)):
            gx, grr = ops.cg(data, cols, b, iters=50,
                             resident_matrix=resident)
            if name in CG_F32_CLOSE:
                keep("cg_fused", check_close(
                    f"{name} cg_fused {policy} x", gx, wx, CG_RTOL, CG_ATOL))
                check_close(f"{name} cg_fused {policy} rr", grr[0], wrr,
                            CG_RTOL, CG_ATOL)
            keep("cg_fused", check_x64(f"{name} cg_fused {policy} x", gx,
                                       wx, x64))
            check_x64(f"{name} cg_fused {policy} rr", grr[0], wrr, rr64)

    # -- the CG path's cells ------------------------------------------------------
    cells = []
    for cell, build, size in CG_CELLS:
        t0 = time.perf_counter()
        csr = (poisson2d if build == "poisson2d" else fem_variable_band)(size)
        n = csr.shape[0]
        b = rng.standard_normal(n).astype(np.float32)
        if cell == "cg-sell":
            sell = csr.to_sell(c=32, sigma=256)
            op = SellOperator.from_matrix(sell)
            problem = CGProblem.from_matvec(op.matvec, b, CG_ITERS,
                                            matrix=op.matrix)
            d64 = op.data.double()

            def mv32(p, op=op):
                return ref.spmv_sell(op.data, op.cols, op.slice_offsets,
                                     op.slice_k, p, c=op.c,
                                     k_max=op.k_max)[op.positions]

            def mv64(p, op=op, d64=d64):
                return ref.spmv_sell(d64, op.cols, op.slice_offsets,
                                     op.slice_k, p, c=op.c,
                                     k_max=op.k_max)[op.positions]

            slots, streamed = sell.stored, sell.stored * 8
        else:
            op = None
            ell = csr.to_ell()
            problem = CGProblem.from_ell(ell.data, ell.cols, b, CG_ITERS,
                                         matrix=csr)
            d64 = problem.data.double()

            def mv32(p, problem=problem):
                return ref.spmv_ell(problem.data, problem.cols, p)

            def mv64(p, problem=problem, d64=d64):
                return ref.spmv_ell(d64, problem.cols, p)

            slots, streamed = ell.data.size, ell.data.size * 8
        x32, rr32 = plain_cg(mv32, problem.b, CG_ITERS)
        x64, rr64 = plain_cg(mv64, problem.b.double(), CG_ITERS)
        torch.cuda.synchronize()
        best = plan(problem)
        print(f"[cg] {cell}: n={n} nnz={csr.nnz} stored slots={slots} "
              f"rr32={rr32.item()!r} rr64={rr64.item()!r} set-up "
              f"{time.perf_counter() - t0:.1f} s; plan "
              f"{best.to_json(indent=None)}")
        cells.append(dict(cell=cell, csr=csr, op=op, problem=problem,
                          best=best, x32=x32, x64=x64, slots=slots,
                          streamed=streamed))
    small, large, sellc = cells

    # -- 5b. each kernel at the CG path's full shapes -----------------------------
    print("[cg kernels] main-path shapes")
    timing = {}
    pl, x = large["problem"], large["problem"].b
    got, want = ops.spmv(pl.data, pl.cols, x), ref.spmv_ell(pl.data, pl.cols, x)
    keep("spmv_ell", check_close("spmv_ell cg-large", got, want, SPMV_RTOL,
                                 SPMV_ATOL))
    # the kernel sums in the plain version's slot order: bit for bit
    same = torch.equal(got, want)
    print(f"  spmv_ell cg-large bit-equal to ref.spmv_ell: {same} "
          f"({'ok' if same else 'FAIL'}); rows a run: "
          f"{spmv_ell.run_rows(pl.data.shape[1])}")
    if not same:
        FAILS.append("spmv_ell cg-large is not bit-equal to ref.spmv_ell")
    n_l = x.shape[0]
    run = lambda: ops.spmv(pl.data, pl.cols, x)
    lib = cusparse_mv(large["csr"], x)
    timing["spmv_ell"] = dict(
        ms=cuda_ms(run, 20), graph_ms=graph_ms(run), host_us=host_us(run),
        plain_ms=cuda_ms(lambda: ref.spmv_ell(pl.data, pl.cols, x), 10),
        bound=spmv_bound(n_l, n_l, large["slots"], 0),
        library_ms=cuda_ms(lib, 20), library_graph_ms=graph_ms(lib))
    print(f"  spmv_ell cg-large: {json.dumps(timing['spmv_ell'])}")
    op, xs = sellc["op"], sellc["problem"].b
    args = (op.data, op.cols, op.slice_offsets, op.slice_k, xs)
    got = ops.spmv_sell(*args, c=op.c, k_max=op.k_max)
    want = ref.spmv_sell(*args, c=op.c, k_max=op.k_max)
    keep("spmv_sell", check_close("spmv_sell cg-sell", got, want, SPMV_RTOL,
                                  SPMV_ATOL))
    bit_equal("spmv_sell cg-sell", got, want)
    n_slices = op.slice_k.shape[0]
    run = lambda: ops.spmv_sell(*args, c=op.c, k_max=op.k_max)
    lib = cusparse_mv(sellc["csr"], xs)
    timing["spmv_sell"] = dict(
        ms=cuda_ms(run, 20), graph_ms=graph_ms(run), host_us=host_us(run),
        plain_ms=cuda_ms(lambda: ref.spmv_sell(*args, c=op.c,
                                               k_max=op.k_max), 5),
        bound=spmv_bound(xs.shape[0], n_slices * op.c, sellc["slots"],
                         8 * n_slices),
        library_ms=cuda_ms(lib, 20), library_graph_ms=graph_ms(lib))
    print(f"  spmv_sell cg-sell: {json.dumps(timing['spmv_sell'])}")
    for c in (small, large):
        p, best = c["problem"], c["best"]
        rows = p.resident_matrix_rows(best)
        run = lambda: ops.cg(p.data, p.cols, p.b, iters=CG_ITERS,
                             matrix_rows=rows)
        gx, _ = run()
        keep("cg_fused", check_x64(
            f"cg_fused {c['cell']} {best.policy} matrix_rows={rows}", gx,
            c["x32"], c["x64"]))
        n = p.b.shape[0]
        uncached = c["streamed"] * (n - rows) / n
        t = dict(ms=cuda_ms(run, 5),
                 plain_ms=cuda_ms(lambda: ref.cg_run(p.data, p.cols, p.b,
                                                     CG_ITERS), 3),
                 bound=cg_bound(n, c["slots"], CG_ITERS, uncached),
                 library_ms=None)
        print(f"  cg_fused {c['cell']}: {json.dumps(t)}")
        if c is large:
            timing["cg_fused"] = t

    # -- 6. the CG path, counted ---------------------------------------------------
    print("[cg path] counters set to 0")
    perks.clear_graphs()
    ops.reset_launch_counts()
    for c in cells:
        problem, best = c["problem"], c["best"]
        runs = ([best] + plan_candidates(problem)
                + [Plan(tier="device_loop")])   # the second: a replay
        for p in runs:
            replay = p.tier == "device_loop" and perks.graph_cached(
                problem.step_fn(), problem.initial_state(), CG_ITERS)
            before = ops.launch_counts()
            x, rr = execute(problem, p)
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in ops.launch_counts().items()
                     if v != before[k]}
            e = check_x64(f"execute {c['cell']} {p.tier} {p.policy} "
                          f"replay={replay} launches={delta}", x, c["x32"],
                          c["x64"])
            keep("cg_fused" if p.tier == "resident" else
                 ("spmv_sell" if c is sellc else "spmv_ell"), e)
            if replay and delta:
                FAILS.append(f"device_loop replay on {c['cell']} launched "
                             f"{delta}")
    launches = ops.launch_counts()
    print(f"[cg path] launches {json.dumps(launches)}")
    for k in CG_KERNELS:
        if launches[k] == 0:
            FAILS.append(f"{k} was not launched on the CG path")
    for c, frac in ((small, "whole"), (large, "partial")):
        best = c["best"]
        a = next((d for d in best.cache if d.name == "A"), None)
        whole = a is not None and a.cached_bytes == a.total_bytes
        if not (best.tier == "resident" and best.policy == "MIX"
                and a is not None and whole == (frac == "whole")):
            FAILS.append(f"{c['cell']} plan is not MIX with {frac} A: {best}")
    if sellc["best"].tier == "resident":
        FAILS.append("cg-sell planned the resident tier")

    # -- 7. CG tier timing (not counted) ---------------------------------------------
    print("[cg tiers] median ms over 3 runs (the device loop's graph kept "
          "after the first, which is timed alone as first_ms)")
    for c in cells:
        problem = c["problem"]
        n = problem.b.shape[0]
        tiers = {}
        for p in plan_candidates(problem):
            first = None
            if p.tier == "device_loop":
                perks.clear_graphs()
                first = cuda_ms(lambda: execute(problem, p), 0)
            ms = cuda_ms(lambda: execute(problem, p), 3)
            rows = (problem.resident_matrix_rows(p) if p.tier == "resident"
                    else 0)
            streamed = c["streamed"] * (n - rows) / n
            tiers[f"{p.tier}/{p.policy}"] = ms
            print("  " + json.dumps(dict(
                cell=c["cell"], tier=p.tier, policy=p.policy,
                matrix_rows=rows, ms=ms, first_ms=first,
                us_per_iter=1e3 * ms / CG_ITERS,
                predicted_us_per_iter=1e6 * p.predicted_s / CG_ITERS,
                streamed_A_bytes_per_iter=streamed,
                effective_GBps=streamed * CG_ITERS / (ms / 1e3) / 1e9,
                predicted_ms=1e3 * p.predicted_s)))
        print(f"  {c['cell']}: planner chose {c['best'].tier}/"
              f"{c['best'].policy} (no graph kept); fastest measured: "
              f"{min(tiers, key=tiers.get)}; planner now: "
              f"{plan(problem).tier}")
        perks.clear_graphs()
    tiny = poisson2d(8).to_ell()
    tp = CGProblem.from_ell(tiny.data, tiny.cols, vec(64), 1000)
    per_iter = cuda_ms(lambda: execute(tp, Plan(tier="host_loop")), 3)
    print(f"[cg tiers] host_loop on poisson2d(8), 1000 iterations: "
          f"{per_iter / 1000 * 1e3!r} us per iteration, "
          f"{per_iter / 1000 * 1e3 / CG_STEP_LAUNCHES!r} us per launch "
          f"({CG_STEP_LAUNCHES} launches a step)")
    return errs, timing, launches


def krylov_bound(moved: float, ops: float) -> tuple[float, str]:
    """Least time (ms, which) for ``moved`` bytes at the device-memory rate
    or ``ops`` float32 operations at the peak rate, whichever is larger."""
    t_bytes, t_ops = moved / HBM_BW, ops / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def bicgstab_bound(n: int, slots: int, iters: int,
                   streamed_bytes: float) -> tuple[float, str]:
    """``iters`` BiCGStab iterations: A, b read once, x and rr written
    once, plus the A bytes no CTA holds streamed again by every later SpMV
    (two per iteration); or 2 float32 operations per stored slot per SpMV
    and 22 per row per iteration (five dots, the p, s, x and r updates)."""
    moved = (slots * 8 + n * 8 + 4
             + max(0, 2 * iters - 1) * streamed_bytes)
    return krylov_bound(moved, iters * (4 * slots + 22 * n))


def gmres_cycle_bound(n: int, slots: int, m: int) -> tuple[float, str]:
    """One GMRES(m) cycle: A, x and b read once, V, H, beta and the new x
    written once; or the m+1 SpMVs (2 operations a slot) and, per row, 8
    (j+1) operations for the two projections of step j and their updates,
    3 for the norm and the scaling, 4 for the starting residual and 2 m for
    x + y V[:m] (the (m+1) x m least-squares solve is a few thousand
    operations, left out)."""
    moved = slots * 8 + n * 12 + (m + 1) * n * 4 + (m + 1) * m * 4 + 4
    ops = 2 * slots * (m + 1) + n * (4 * m * (m + 1) + 5 * m + 4)
    return krylov_bound(moved, ops)


def krylov_phases(rng):
    """Phases 8-10: the Krylov kernels against their plain versions, the
    Krylov path counted, the Krylov tiers timed. Returns (errors, timing,
    launches) by kernel name."""
    import functools

    from repro_torch import BiCGStabProblem, GMRESProblem, Plan, execute, plan
    from repro_torch.core import perks
    from repro_torch.exec import solve_refined
    from repro_torch.exec import plan_candidates
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.krylov_fused import gmres_cycle_rounds
    from repro_torch.sparse import generate, nonsymmetric_names
    from repro_torch.sparse.generate import convdiff2d, poisson2d

    def vec(n):
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()

    def plain_bicgstab(matvec, b, iters, dot=torch.dot):
        state = ref.bicgstab_initial_state(b, dot=dot)
        for _ in range(iters):
            state = ref.bicgstab_iteration_matvec(state, matvec, dot=dot)
        return state[0], state[8]

    def plain_gmres(matvec, b, cycles, m, dot=torch.dot):
        state = (torch.zeros_like(b), dot(b, b))
        for _ in range(cycles):
            state = ref.gmres_cycle_matvec(state, matvec, b, m, dot=dot)
        return state

    def f32_witnesses(kind, problem, steps):
        """rr of float32 plain runs in four dot orders: ``torch.dot`` and
        1024- and 32-wide blocked sums on the card, ``torch.dot`` on the
        CPU. Two orders are too few: over eight right-hand sides the
        kernels' gap from float64 on gmres-small fell outside twice the
        farther of two on one (by 0.2%) and inside twice the farthest of
        four on all (scripts/krylov_rr_seeds.py on an H100 SXM)."""
        out = []
        for dev, dot in (("cuda", torch.dot), ("cuda", blocked_dot),
                         ("cuda", functools.partial(blocked_dot, width=32)),
                         ("cpu", torch.dot)):
            mv = functools.partial(ref.spmv_ell, problem.data.to(dev),
                                   problem.cols.to(dev))
            b = problem.b.to(dev)
            rr = (plain_bicgstab(mv, b, steps, dot=dot)[1]
                  if kind == "bicgstab" else
                  plain_gmres(mv, b, steps, KRYLOV_M, dot=dot)[1])
            out.append(rr.cuda())
        return out

    def orth(V):
        eye = torch.eye(V.shape[0], device=V.device, dtype=V.dtype)
        return (V @ V.T - eye).abs().max().item()

    errs = {k: 0.0 for k in KRYLOV_KERNELS}

    def keep(k, e):
        errs[k] = max(errs[k], e)

    # -- 8. kernels against their plain versions --------------------------------
    print(f"[krylov kernels] every nonsymmetric registry entry; "
          f"bicgstab_fused {KRYLOV_KERNEL_ITERS} iterations, "
          f"gmres_cycle_fused m={KRYLOV_M}, one cycle")
    for name in nonsymmetric_names():
        csr = generate(name)
        n = csr.shape[0]
        ell = csr.to_ell()
        data = torch.from_numpy(ell.data).cuda()
        cols = torch.from_numpy(ell.cols).cuda()
        b = vec(n)
        mv = functools.partial(ref.spmv_ell, data, cols)
        mv64 = functools.partial(ref.spmv_ell, data.double(), cols)
        it = KRYLOV_KERNEL_ITERS
        wx, wrr = plain_bicgstab(mv, b, it)
        x64, rr64 = plain_bicgstab(mv64, b.double(), it)
        bx, _ = plain_bicgstab(mv, b, it, dot=blocked_dot)
        f32_close = bool(torch.allclose(bx, wx, rtol=CG_RTOL, atol=CG_ATOL))
        print(f"  {name}: n={n} two float32 plain runs, dot orders apart: "
              f"max|dx|={(bx - wx).abs().max().item()!r} "
              f"(within rtol {CG_RTOL}/atol {CG_ATOL}: {f32_close})")
        for policy, resident in (("VEC", False), ("MIX", True)):
            gx, grr = ops.bicgstab(data, cols, b, iters=it,
                                   resident_matrix=resident)
            if f32_close:
                keep("bicgstab_fused", check_close(
                    f"{name} bicgstab_fused {policy} x", gx, wx, CG_RTOL,
                    CG_ATOL))
                check_close(f"{name} bicgstab_fused {policy} rr", grr[0],
                            wrr, CG_RTOL, CG_ATOL)
            keep("bicgstab_fused", check_x64(
                f"{name} bicgstab_fused {policy} x", gx, wx, x64))
        x0 = torch.zeros_like(b)
        V, H, beta, gxn = ops.gmres_cycle(data, cols, x0, b, m=KRYLOV_M)
        pV, pH, pbeta, pxn = ref.gmres_cycle_update(x0, b, mv, KRYLOV_M)
        xn64 = ref.gmres_cycle_update(x0.double(), b.double(), mv64,
                                      KRYLOV_M)[3]
        # the steps before the Krylov space is numerically exhausted: past
        # h_{j+1,j} < 1e-4 max|H| the next basis vector is rounding noise,
        # different in every summation order
        sub = (pH.diagonal(-1) < 1e-4 * pH.abs().max()).nonzero()
        live = int(sub[0, 0]) + 1 if sub.numel() else KRYLOV_M
        print(f"  {name} gmres_cycle_fused: |V^T V - I| kernel={orth(V)!r} "
              f"plain={orth(pV)!r}; steps compared: {live} of {KRYLOV_M}")
        keep("gmres_cycle_fused", check_close(
            f"{name} gmres_cycle_fused V[:{live + 1}]", V[:live + 1],
            pV[:live + 1], CG_RTOL, CG_ATOL))
        check_close(f"{name} gmres_cycle_fused H[:, :{live}]",
                    H[:, :live], pH[:, :live], CG_RTOL, CG_ATOL)
        check_close(f"{name} gmres_cycle_fused beta", beta, pbeta, CG_RTOL,
                    CG_ATOL)
        # the cycle's new iterate x + y V[:m] (the kernel's own
        # least-squares solve), which is defined past exhaustion too
        keep("gmres_cycle_fused", check_x64(
            f"{name} gmres_cycle_fused x + y V[:m]", gxn, pxn, xn64))

    # one reduction round: the fused CG (two a iteration) and BiCGStab
    # (three) on tiny systems, where the rows' work is a few hundred
    # operations
    for name, run, rounds, system in (
            ("cg_fused", ops.cg, 2, poisson2d(16)),
            ("bicgstab_fused", ops.bicgstab, 3, convdiff2d(16))):
        tiny = system.to_ell()
        td = torch.from_numpy(tiny.data).cuda()
        tc = torch.from_numpy(tiny.cols).cuda()
        tb = vec(256)
        t0 = cuda_ms(lambda: run(td, tc, tb, iters=0), 5)
        t1 = cuda_ms(lambda: run(td, tc, tb, iters=2000), 5)
        us = 1e3 * (t1 - t0) / 2000
        print(f"[rounds] {name} on a 16x16 grid, 2000 iterations: "
              f"{us!r} us per iteration, {us / rounds!r} us per reduction "
              f"round at most ({rounds} a iteration)")

    # -- the Krylov path's cells ---------------------------------------------------
    cells = []
    for cell, kind, side, steps in KRYLOV_CELLS:
        t0 = time.perf_counter()
        csr = convdiff2d(side)
        n = csr.shape[0]
        ell = csr.to_ell()
        b = rng.standard_normal(n).astype(np.float32)
        if kind == "bicgstab":
            problem = BiCGStabProblem.from_ell(ell.data, ell.cols, b, steps,
                                               matrix=csr)
        else:
            problem = GMRESProblem.from_ell(ell.data, ell.cols, b, steps,
                                            m=KRYLOV_M, matrix=csr)
        mv = functools.partial(ref.spmv_ell, problem.data, problem.cols)
        mv64 = functools.partial(ref.spmv_ell, problem.data.double(),
                                 problem.cols)
        if kind == "bicgstab":
            x32, _ = plain_bicgstab(mv, problem.b, steps)
            x64, rr64 = plain_bicgstab(mv64, problem.b.double(), steps)
        else:
            x32, _ = plain_gmres(mv, problem.b, steps, KRYLOV_M)
            x64, rr64 = plain_gmres(mv64, problem.b.double(), steps,
                                    KRYLOV_M)
        rr32s = f32_witnesses(kind, problem, steps)
        torch.cuda.synchronize()
        best = plan(problem)
        print(f"[krylov] {cell}: n={n} nnz={csr.nnz} steps={steps} "
              f"rr32 (four dot orders)={[v.item() for v in rr32s]!r} "
              f"rr64={rr64.item()!r} set-up "
              f"{time.perf_counter() - t0:.1f} s; plan "
              f"{best.to_json(indent=None)}")
        cells.append(dict(cell=cell, kind=kind, problem=problem, best=best,
                          x32=x32, x64=x64, rr32s=rr32s, rr64=rr64,
                          bb=torch.dot(problem.b.double(),
                                       problem.b.double()).item(),
                          slots=ell.data.size, steps=steps))
    bsmall, blarge, gsmall, glarge = cells

    # -- 8b. each kernel at the Krylov path's full shapes ------------------------------
    print("[krylov kernels] main-path shapes")
    timing = {}
    for c in (bsmall, blarge):
        p, best = c["problem"], c["best"]
        rows = p.resident_matrix_rows(best)
        run = lambda: ops.bicgstab(p.data, p.cols, p.b, iters=c["steps"],
                                   matrix_rows=rows)
        gx, grr = run()
        keep("bicgstab_fused", check_x64(
            f"bicgstab_fused {c['cell']} {best.policy} matrix_rows={rows}",
            gx, c["x32"], c["x64"]))
        check_rr(f"bicgstab_fused {c['cell']} rr", grr[0], c["rr32s"],
                 c["rr64"], c["bb"])
        n = p.b.shape[0]
        t = dict(ms=cuda_ms(run, 5),
                 plain_ms=cuda_ms(lambda: ref.bicgstab_run(
                     p.data, p.cols, p.b, c["steps"]), 3),
                 bound=bicgstab_bound(n, c["slots"], c["steps"],
                                      c["slots"] * 8 * (n - rows) / n),
                 library_ms=None)
        print(f"  bicgstab_fused {c['cell']}: {json.dumps(t)}")
        if c is blarge:
            timing["bicgstab_fused"] = t
    p = gsmall["problem"]
    n = p.b.shape[0]
    x0 = torch.zeros_like(p.b)
    mv = functools.partial(ref.spmv_ell, p.data, p.cols)
    mv64 = functools.partial(ref.spmv_ell, p.data.double(), p.cols)
    run = lambda: ops.gmres_cycle(p.data, p.cols, x0, p.b, m=KRYLOV_M)
    V, H, beta, xn = run()
    pV, pH, pbeta, pxn = ref.gmres_cycle_update(x0, p.b, mv, KRYLOV_M)
    keep("gmres_cycle_fused", check_close(
        "gmres_cycle_fused gmres-small V", V, pV, CG_RTOL, CG_ATOL))
    check_close("gmres_cycle_fused gmres-small H", H, pH, CG_RTOL, CG_ATOL)
    check_close("gmres_cycle_fused gmres-small beta", beta, pbeta, CG_RTOL,
                CG_ATOL)
    keep("gmres_cycle_fused", check_x64(
        "gmres_cycle_fused gmres-small x + y V[:m]", xn, pxn,
        ref.gmres_cycle_update(x0.double(), p.b.double(), mv64,
                               KRYLOV_M)[3]))
    print(f"  gmres_cycle_fused gmres-small: |V^T V - I| kernel={orth(V)!r} "
          f"plain={orth(pV)!r}")
    timing["gmres_cycle_fused"] = dict(
        ms=cuda_ms(run, 10), graph_ms=graph_ms(run, 20),
        rounds=gmres_cycle_rounds(KRYLOV_M),
        plain_ms=cuda_ms(
            lambda: ref.gmres_cycle_update(x0, p.b, mv, KRYLOV_M), 5),
        bound=gmres_cycle_bound(n, gsmall["slots"], KRYLOV_M),
        library_ms=None)
    print(f"  gmres_cycle_fused gmres-small: "
          f"{json.dumps(timing['gmres_cycle_fused'])}")
    t = timing["gmres_cycle_fused"]
    print(f"[rounds] gmres_cycle_fused m={KRYLOV_M} on gmres-small: "
          f"{t['rounds']} tagged rounds a cycle, {t['graph_ms']!r} ms a "
          f"cycle in a graph, {1e3 * t['graph_ms'] / t['rounds']!r} us a "
          f"round at most")

    # -- 9. the Krylov path, counted ---------------------------------------------------
    print("[krylov path] counters set to 0")
    perks.clear_graphs()
    ops.reset_launch_counts()
    for c in cells:
        problem, best = c["problem"], c["best"]
        runs = ([best] + plan_candidates(problem)
                + [Plan(tier="device_loop")])   # the second: a replay
        for p in runs:
            replay = p.tier == "device_loop" and perks.graph_cached(
                problem.step_fn(), problem.initial_state(), c["steps"])
            before = ops.launch_counts()
            x, rr = execute(problem, p)
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in ops.launch_counts().items()
                     if v != before[k]}
            e = check_x64(f"execute {c['cell']} {p.tier} {p.policy} "
                          f"replay={replay} launches={delta}", x, c["x32"],
                          c["x64"])
            check_rr(f"execute {c['cell']} {p.tier} {p.policy} rr", rr,
                     c["rr32s"], c["rr64"], c["bb"])
            if p.tier == "resident":
                keep("bicgstab_fused" if c["kind"] == "bicgstab"
                     else "gmres_cycle_fused", e)
            if replay and delta:
                FAILS.append(f"device_loop replay on {c['cell']} launched "
                             f"{delta}")
    launches = ops.launch_counts()
    print(f"[krylov path] launches {json.dumps(launches)}")
    for k in list(KRYLOV_KERNELS) + ["spmv_ell"]:
        if launches[k] == 0:
            FAILS.append(f"{k} was not launched on the Krylov path")
    for c, frac in ((bsmall, "whole"), (blarge, "partial"),
                    (gsmall, "whole")):
        best = c["best"]
        a = next((d for d in best.cache if d.name == "A"), None)
        whole = a is not None and a.cached_bytes == a.total_bytes
        if not (best.tier == "resident" and best.policy == "MIX"
                and a is not None and whole == (frac == "whole")):
            FAILS.append(f"{c['cell']} plan is not MIX with {frac} A: {best}")
    if any(p.tier == "resident" for p in plan_candidates(glarge["problem"])):
        FAILS.append("gmres-large was offered the resident tier")

    # -- 10. Krylov tier timing (not counted) ----------------------------------------------
    print("[krylov tiers] median ms over 3 runs (the device loop's graph kept "
          "after the first, which is timed alone as first_ms)")
    for c in cells:
        problem = c["problem"]
        tiers = {}
        for p in plan_candidates(problem):
            first = None
            if p.tier == "device_loop":
                perks.clear_graphs()
                first = cuda_ms(lambda: execute(problem, p), 0)
            ms = cuda_ms(lambda: execute(problem, p), 3)
            tiers[f"{p.tier}/{p.policy}"] = ms
            rows = (problem.resident_matrix_rows(p)
                    if p.tier == "resident" and c["kind"] == "bicgstab"
                    else None)
            print("  " + json.dumps(dict(
                cell=c["cell"], tier=p.tier, policy=p.policy,
                matrix_rows=rows, ms=ms, first_ms=first,
                us_per_step=1e3 * ms / c["steps"],
                predicted_ms=1e3 * p.predicted_s)))
        print(f"  {c['cell']}: planner chose {c['best'].tier}/"
              f"{c['best'].policy} (no graph kept); fastest measured: "
              f"{min(tiers, key=tiers.get)}; planner now: "
              f"{plan(problem).tier}")
        perks.clear_graphs()
    p = bsmall["problem"]
    mixed = Plan(tier="host_loop", precision="mixed")
    x, _ = execute(p, mixed)
    check_x64("execute bicgstab-small host_loop precision=mixed", x,
              bsmall["x32"], bsmall["x64"])
    ms = cuda_ms(lambda: execute(p, mixed), 3)
    print("  " + json.dumps(dict(cell="bicgstab-small", tier="host_loop",
                                 precision="mixed", ms=ms)))

    # the kept graph of a changed problem: a mixed-precision copy and the
    # b-swapped copies of solve_refined share the first run's graph
    print("[graph reuse] bicgstab-small, device_loop precision=mixed: the "
          "first run (capture) and replays, then refinement rounds")
    perks.clear_graphs()
    mixed = Plan(tier="device_loop", precision="mixed")

    def counted(fn):
        before = ops.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, sum(v - before[k] for k, v in ops.launch_counts().items())

    first_ms = cuda_ms(lambda: execute(p, mixed), 0)
    (x1, _), _ = counted(lambda: execute(p, mixed))
    replay_ms = [cuda_ms(lambda: execute(p, mixed), 0) for _ in range(3)]
    check_x64("execute bicgstab-small device_loop precision=mixed", x1,
              bsmall["x32"], bsmall["x64"])
    r = p.b - ops.spmv(p.data, p.cols, x1)
    q = p.with_rhs(r)
    (xq, _), n_q = counted(lambda: execute(q, mixed))
    round_ms = [cuda_ms(lambda: execute(q, mixed), 0) for _ in range(2)]
    fresh = BiCGStabProblem.from_ell(p.data, p.cols, r, bsmall["steps"],
                                     matrix=p.matrix)
    perks.clear_graphs()
    (xf, _), n_f = counted(lambda: execute(fresh, mixed))
    perks.clear_graphs()
    execute(p, mixed)
    _, n_refined = counted(lambda: solve_refined(p, mixed, rounds=3))
    refined_ms = cuda_ms(lambda: solve_refined(p, mixed, rounds=3), 0)
    print("  " + json.dumps(dict(
        first_ms=first_ms, replay_ms=replay_ms, round_replay_launches=n_q,
        round_ms=round_ms, fresh_capture_launches=n_f,
        refined_3_rounds_launches=n_refined, refined_3_rounds_ms=refined_ms,
        round_equals_fresh_capture=bool(torch.equal(xq, xf)))))
    if n_q or n_refined != 3 or not torch.equal(xq, xf):
        FAILS.append(f"a changed problem did not replay the kept graph: "
                     f"{n_q} launches on the round, {n_refined} in three "
                     f"refinement rounds (3 residual SpMVs expected), same "
                     f"x as a fresh capture: {torch.equal(xq, xf)}")
    perks.clear_graphs()
    return errs, timing, launches


def ssd_scan_flops(t_len: int, heads: int, p: int, n: int,
                   chunk: int) -> float:
    """Float32 operations of the SSD scan as ``ssm_scan`` does it (multiply
    and add apart): per output the intra-chunk sum over its row of the
    chunk and the cross term over N, per state entry the update over the
    chunk, and the chunks' score matrices (shared by the heads)."""
    ck = min(chunk, t_len)
    full, rem = divmod(t_len, ck)
    tri = full * ck * (ck + 1) // 2 + rem * (rem + 1) // 2
    return float(heads * 2 * p * (tri + 2 * t_len * n) + 2 * tri * n)


def ssd_scan_bytes(t_len: int, heads: int, p: int, n: int,
                   itemsize: int) -> float:
    """Bytes the SSD scan must move: x, dt, b, c read once, y written once,
    a and d (float32) read once."""
    return float(itemsize * (2 * t_len * heads * p + t_len * heads
                             + 2 * t_len * n) + 8 * heads)


def decode_bytes(bsz: int, seq: int, hq: int, hkv: int, dim: int,
                 itemsize: int) -> float:
    """Bytes decode attention must move over a full cache: every K and V
    row read once, q read and the output written once."""
    return float(itemsize * (2 * bsz * seq * hkv * dim + 2 * bsz * hq * dim))


def sdpa_decode(q, k, v, length):
    """One ``F.scaled_dot_product_attention`` call computing the same
    masked GQA decode (the yardstick for ``decode_attention``; the port
    never calls it)."""
    import torch.nn.functional as F
    qh = q[:, :, None, :]                      # (B, Hq, 1, D)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)   # (B, Hkv, S, D) views
    mask = None
    if length is not None:
        mask = (torch.arange(k.shape[1], device=q.device)[None, :]
                < length[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  enable_gqa=True)


def direct_decode(kernel, q, k, v, length=None):
    """A call of one decode kernel of ``csrc/decode_attn.cu`` on these
    inputs through its C entry point, whatever ``kernel_for`` names:
    ``"cuda_cores"`` (``decode_attn_launch``) or ``"tensor_cores"``
    (``decode_attn_mma_launch``), each with its own ``splits_for`` rule, to
    time the two kernels side by side on the same bf16 inputs (not counted;
    the port never calls them so)."""
    from repro_torch.kernels import _build, decode_attn
    bsz, hq, dim = q.shape
    s, hkv = k.shape[1], k.shape[2]
    splits, per = decode_attn.splits_for(
        bsz, hkv, s, torch.cuda.get_device_properties(0).multi_processor_count,
        kernel=kernel)
    out = torch.empty_like(q)
    part = torch.empty(bsz * hq * splits * (dim + 2), dtype=torch.float32,
                       device=q.device)
    lib = _build.load("decode_attn")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if length is None else length.data_ptr(), out.data_ptr(),
            part.data_ptr(), bsz, s, hq, hkv, dim, splits, per)
    if kernel == "tensor_cores":
        entry = "decode_attn_mma_launch"
        last = decode_attn.mma_layout(dim)[0]
    else:
        entry = "decode_attn_launch"
        last = int(q.dtype == torch.bfloat16)

    def run():
        _build.check(getattr(lib, entry)(*args, last, _build.stream()), entry)
        return out
    # the launch writes through out's and part's pointers: both must live
    # as long as run (a freed part was reused, or unmapped under a graph
    # replay, which then faulted)
    run.buffers = (out, part)
    return run


def ml_phases(rng):
    """Phases 11-13: the ML kernels against their plain versions, the SSD
    scan path and the serving path, each counted. Returns (errors, timing,
    launches) by kernel name."""
    from repro_torch import (DecodeAttentionProblem, Engine, Model, Plan,
                             SSMScanProblem, execute, plan)
    from repro_torch.configs import ARCHS, get_config, get_smoke_config
    from repro_torch.core import perks
    from repro_torch.exec import plan_candidates
    from repro_torch.kernels import decode_attn, ops, ref
    from repro_torch.nn.param import tree_map
    from repro_torch.runtime.server import Request, ServeConfig

    errs = {k: 0.0 for k in ML_KERNELS}
    timing, launches = {}, {}

    def keep(k, e):
        errs[k] = max(errs[k], e)

    def put(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda().to(dtype)

    def ssd_inputs(bsz, t, h, p, n):
        x = put(0.5 * rng.standard_normal((bsz, t, h, p)))
        dt = torch.nn.functional.softplus(put(rng.standard_normal((bsz, t, h))))
        a = -torch.exp(put(rng.standard_normal(h)))
        b = put(0.5 * rng.standard_normal((bsz, t, n)))
        c = put(0.5 * rng.standard_normal((bsz, t, n)))
        d = put(rng.standard_normal(h))
        return x, dt, a, b, c, d

    def plain_ssd(x, dt, a, b, c, d):
        return torch.stack([ref.ssm_scan(x[i].float(), dt[i].float(), a,
                                         b[i].float(), c[i].float(), d)
                            for i in range(x.shape[0])])

    # -- 11. kernels against their plain versions ------------------------------
    print(f"[ml kernels] ssm_scan at the reference test's shapes and at "
          f"mamba2-780m widths (H={SSM_H}, P={SSM_P}, N={SSM_N}, "
          f"T={SSM_T}); rtol=atol {SSM_TOL}")
    for bsz, t, h, p, n, chunks in ((2, 64, 4, 8, 16, (8, 16, 64, 15)),
                                    (1, SSM_T, SSM_H, SSM_P, SSM_N,
                                     (128, 15, 1))):
        inputs = ssd_inputs(bsz, t, h, p, n)
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, a, b, c, d = (v.to(dtype) if v.dim() > 1 else v
                                 for v in inputs)
            want = plain_ssd(x, dt, a, b, c, d)
            tol = SSM_TOL[dtype]
            for ck in chunks:
                got = ops.ssd_scan(x, dt, a, b, c, d, chunk=ck)
                keep("ssm_scan", check_close(
                    f"ssm_scan B={bsz} T={t} H={h} P={p} N={n} "
                    f"{str(dtype)[6:]} chunk={ck}", got.float(), want, tol,
                    tol))
            if t == SSM_T and dtype == torch.float32:
                mamba = inputs, want
    (x, dt, a, b, c, d), ssm_want = mamba
    run = lambda: ops.ssd_scan(x, dt, a, b, c, d, chunk=128)
    flops = ssd_scan_flops(SSM_T, SSM_H, SSM_P, SSM_N, 128)
    moved = ssd_scan_bytes(SSM_T, SSM_H, SSM_P, SSM_N, 4)
    t_ops, t_bytes = flops / FP32_FLOPS, moved / HBM_BW
    timing["ssm_scan"] = dict(
        ms=cuda_ms(run, 5), graph_ms=graph_ms(run, 5),
        plain_ms=cuda_ms(lambda: plain_ssd(x, dt, a, b, c, d), 1),
        bound=(1e3 * max(t_ops, t_bytes),
               "operations" if t_ops >= t_bytes else "bytes"),
        library_ms=None, flops=flops, bytes=moved)
    print(f"  ssm_scan mamba2-780m f32 chunk=128: "
          f"{json.dumps(timing['ssm_scan'])}")
    from repro_torch.kernels import ssm_scan as kssm
    print(f"  ssm_scan bounds: float32 {1e3 * t_ops!r} ms (the operations at "
          f"67 TFLOP/s), bytes {1e3 * t_bytes!r} ms, 3xTF32 on the tensor "
          f"cores {1e3 * 3 * flops / TF32_FLOPS!r} ms (3 x the operations at "
          f"495 TFLOP/s); launch "
          f"{json.dumps(kssm.config(1, SSM_T, SSM_H, SSM_P, SSM_N))}")
    for ck in (15, 1):
        print(f"  ssm_scan mamba2-780m f32 chunk={ck}: ms="
              f"{cuda_ms(lambda: ops.ssd_scan(x, dt, a, b, c, d, chunk=ck), 2)!r}")
    xb = [v.to(torch.bfloat16) if v.dim() > 1 else v for v in (x, dt, a, b, c, d)]
    print(f"  ssm_scan mamba2-780m bf16 chunk=128: ms="
          f"{cuda_ms(lambda: ops.ssd_scan(*xb, chunk=128), 5)!r}")

    print(f"[ml kernels] decode_attention over (Hq, Hkv) {DECODE_HEADS}, "
          f"with and without length; f32 rtol/atol {DECODE_TOL[torch.float32]}"
          f", bf16 {DECODE_TOL[torch.bfloat16]}")
    for hq, hkv in DECODE_HEADS:
        dim = 64 if hq == 14 else 32
        for s in (96, 128, 1000):
            base = [put(rng.standard_normal(shape)) for shape in (
                (2, hq, dim), (2, s, hkv, dim), (2, s, hkv, dim))]
            length = torch.tensor([s, s // 3 + 1], dtype=torch.int32,
                                  device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (t.to(dtype) for t in base)
                for ln in (None, length):
                    got = ops.decode_attention(q, k, v, length=ln)
                    want = ref.decode_attention(q.float(), k.float(),
                                                v.float(), length=ln)
                    what = (f"decode_attention Hq={hq} Hkv={hkv} S={s} "
                            f"D={dim} {str(dtype)[6:]} "
                            f"length={ln is not None}")
                    keep("decode_attention", check_close(
                        what, got.float(), want, **DECODE_TOL[dtype])
                        if dtype == torch.float32 else
                        check_decode_bf16(what, got.float(), want))
    print(f"[ml kernels] decode_attention on the tensor cores, bf16: D in "
          f"{TC_DIMS}, (Hq, Hkv) in {TC_HEADS}, B = 2, S in {TC_SEQS}, "
          f"length None, 1, S // 3 + 1, S (the second sequence S); one line "
          f"per (D, Hq, Hkv), and one per FAIL")
    for dim in TC_DIMS:
        for hq, hkv in TC_HEADS:
            before = ops.launch_counts()["decode_attention_tc"]
            calls, worst = 0, 0.0
            for s in TC_SEQS:
                q, k, v = (put(rng.standard_normal(shape), torch.bfloat16)
                           for shape in ((2, hq, dim), (2, s, hkv, dim),
                                         (2, s, hkv, dim)))
                for ln in (None, 1, s // 3 + 1, s):
                    length = None if ln is None else torch.tensor(
                        [ln, s], dtype=torch.int32, device="cuda")
                    got = ops.decode_attention(q, k, v, length=length)
                    want = ref.decode_attention(q.float(), k.float(),
                                                v.float(), length=length)
                    e = check_decode_bf16(
                        f"decode_attention tensor cores D={dim} Hq={hq} "
                        f"Hkv={hkv} S={s} length={ln}", got.float(), want,
                        quiet=True)
                    keep("decode_attention", e)
                    worst = max(worst,
                                e / want.double().pow(2).mean().sqrt().item())
                    calls += 1
            ran = ops.launch_counts()["decode_attention_tc"] - before
            print(f"  D={dim} Hq={hq} Hkv={hkv}: {calls} calls, {ran} on "
                  f"the tensor cores, max_abs_err / rms = {worst!r}")
            if ran != calls:
                FAILS.append(f"decode_attention D={dim} Hq={hq} Hkv={hkv} "
                             f"bf16 ran {ran} of {calls} calls on the tensor "
                             f"cores")
    # the two kernels side by side at every attention config's (Hq, Hkv, D)
    bsz, s = DECODE_BY_CONFIG
    print(f"[ml kernels] decode_attention by attention config, bf16, "
          f"B = {bsz}, S = {s}, length S - 37 b: the tensor-core and the "
          f"CUDA-core kernel on the same inputs and one SDPA call, each in a "
          f"graph of 20 calls; kernel_for's choice")
    seen = set()
    for arch in ARCHS:
        cfg = get_config(arch)
        hq, hkv, dim = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        if dim < 16 or (hq // hkv, dim) in seen:  # the SSD model: no attention
            continue
        seen.add((hq // hkv, dim))
        q = put(rng.standard_normal((bsz, hq, dim)), torch.bfloat16)
        k = put(rng.standard_normal((bsz, s, hkv, dim)), torch.bfloat16)
        v = put(rng.standard_normal((bsz, s, hkv, dim)), torch.bfloat16)
        ln = torch.tensor([s - 37 * i for i in range(bsz)], dtype=torch.int32,
                          device="cuda")
        want = ref.decode_attention(q.float(), k.float(), v.float(), length=ln)
        row = dict(arch=arch, group=hq // hkv, D=dim, Hq=hq, Hkv=hkv,
                   kernel=decode_attn.kernel_for(q.dtype, hq // hkv, dim))
        for kind in ("tensor_cores", "cuda_cores"):
            run = direct_decode(kind, q, k, v, ln)
            keep("decode_attention", check_decode_bf16(
                f"decode_attention {kind} {arch} B={bsz} S={s}",
                run().float(), want, quiet=True))
            row[f"{kind}_graph_ms"] = graph_ms(run, 20)
        row["sdpa_graph_ms"] = graph_ms(sdpa_decode(q, k, v, ln), 20)
        row["bound_ms"] = 1e3 * decode_bytes(bsz, s, hq, hkv, dim, 2) / HBM_BW
        faster = min(("tensor_cores", "cuda_cores"),
                     key=lambda kd: row[f"{kd}_graph_ms"])
        row["kernel_for_is_faster"] = row["kernel"] == faster
        print("  " + json.dumps(row))
        del q, k, v

    bsz, s, hq, hkv, dim = DECODE_LONG
    q = put(rng.standard_normal((bsz, hq, dim)), torch.bfloat16)
    k = put(rng.standard_normal((bsz, s, hkv, dim)), torch.bfloat16)
    v = put(rng.standard_normal((bsz, s, hkv, dim)), torch.bfloat16)
    q32, k32, v32 = q.float(), k.float(), v.float()
    for ln in (None, torch.tensor([s - 37 * i for i in range(bsz)],
                                  dtype=torch.int32, device="cuda")):
        got = ops.decode_attention(q, k, v, length=ln)
        want = ref.decode_attention(q32, k32, v32, length=ln)
        what = (f"decode_attention B={bsz} S={s} Hq={hq} Hkv={hkv} D={dim} "
                f"length={ln is not None}")
        keep("decode_attention", check_decode_bf16(f"{what} bf16",
                                                   got.float(), want))
        # the float32 kernel on the same values: the multi-split combine
        # held at the f32 tolerance
        keep("decode_attention", check_close(
            f"{what} f32", ops.decode_attention(q32, k32, v32, length=ln),
            want, **DECODE_TOL[torch.float32]))
        lib = sdpa_decode(q, k, v, ln)
        check_close(f"  (SDPA yardstick against the plain version, "
                    f"length={ln is not None})", lib()[:, :, 0].float(), want,
                    **DECODE_TOL[torch.bfloat16])
        check_decode_bf16(f"  (the CUDA-core kernel on the same bf16 inputs, "
                          f"length={ln is not None})",
                          direct_decode("cuda_cores", q, k, v, ln)().float(),
                          want)
    run32 = lambda: ops.decode_attention(q32, k32, v32)
    f32_ms = dict(kernel=decode_attn.kernel_for(q32.dtype, hq // hkv, dim),
                  ms=cuda_ms(run32, 20), graph_ms=graph_ms(run32, 20))
    del q32, k32, v32
    run = lambda: ops.decode_attention(q, k, v)
    moved = decode_bytes(bsz, s, hq, hkv, dim, 2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kind = decode_attn.kernel_for(q.dtype, hq // hkv, dim)
    cc = direct_decode("cuda_cores", q, k, v)
    timing["decode_attention"] = dict(
        kernel=kind, ms=cuda_ms(run, 20), graph_ms=graph_ms(run, 20),
        plain_ms=cuda_ms(lambda: ref.decode_attention(q, k, v), 5),
        bound=(1e3 * moved / HBM_BW, "bytes"),
        library_ms=cuda_ms(sdpa_decode(q, k, v, None), 20),
        library_graph_ms=graph_ms(sdpa_decode(q, k, v, None), 20),
        host_us=host_us(run), bytes=moved,
        splits=decode_attn.splits_for(bsz, hkv, s, sms, kernel=kind),
        stages=decode_attn.mma_layout(dim)[0],
        cuda_cores_ms=cuda_ms(cc, 20), cuda_cores_graph_ms=graph_ms(cc, 20),
        cuda_cores_host_us=host_us(cc), f32=f32_ms)
    timing["decode_attention"]["graph_TBps"] = (
        moved / (timing["decode_attention"]["graph_ms"] / 1e3) / 1e12)
    print(f"  decode_attention B={bsz} S={s} bf16: "
          f"{json.dumps(timing['decode_attention'])}")

    # -- 12. the SSD scan path, counted -----------------------------------------
    print(f"[ssm path] SSMScanProblem mamba2-780m widths T={SSM_T}, chunk "
          f"128, f32; counters set to 0")
    problem = SSMScanProblem(x[0], dt[0], a, b[0], c[0], d, chunk=128)
    best = plan(problem)
    print(f"  plan: {best.to_json(indent=None)}")
    want = ssm_want[0]
    perks.clear_graphs()
    ops.reset_launch_counts()
    for p in (best, Plan(tier="host_loop"), Plan(tier="device_loop"),
              Plan(tier="device_loop"), Plan(tier="resident")):
        before = ops.launch_counts()
        y = execute(problem, p)
        torch.cuda.synchronize()
        delta = {k: v_ - before[k] for k, v_ in ops.launch_counts().items()
                 if v_ != before[k]}
        e = check_close(f"execute ssm {p.tier} launches={delta}", y, want,
                        1e-3, 1e-3)
        if p.tier == "resident":
            keep("ssm_scan", e)
            y_resident = y
    launches["ssm_scan"] = ops.launch_counts()["ssm_scan"]
    print(f"[ssm path] launches {json.dumps(ops.launch_counts())}")
    # the launch that also returns the final state gives the path's y bit
    # for bit (after the count is read)
    y_state, _ = ops.ssd_scan(x, dt, a, b, c, d, chunk=128, return_state=True)
    bit_equal("[ssm path] resident y against ssd_scan(return_state=True)'s",
              y_resident, y_state[0])
    print(f"  resident y digest {digest(y_resident)}")
    if launches["ssm_scan"] == 0:
        FAILS.append("ssm_scan was not launched on the SSD scan path")
    if best.tier != "resident":
        FAILS.append(f"the SSD scan plan is not resident: {best}")
    for p in plan_candidates(problem):
        first = None
        if p.tier == "device_loop":
            perks.clear_graphs()
            first = cuda_ms(lambda: execute(problem, p), 0)
        ms = cuda_ms(lambda: execute(problem, p), 3)
        print("  " + json.dumps(dict(cell="ssm", tier=p.tier, ms=ms,
                                     first_ms=first,
                                     predicted_ms=1e3 * p.predicted_s)))
    perks.clear_graphs()

    # -- 13. the serving path, counted --------------------------------------------
    cfg = get_config(SERVE_ARCH)
    print(f"[serve] Engine on {SERVE_ARCH} at full width ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, vocab {cfg.vocab}), seeded init "
          f"on the card; {SERVE_REQUESTS} requests, prompt {SERVE_PROMPT}, "
          f"{SERVE_NEW} new tokens; counters set to 0")
    t0 = time.perf_counter()
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    print(f"  init {time.perf_counter() - t0:.2f} s, "
          f"{model.n_params()} parameters")
    prompts = [rng.integers(0, cfg.vocab, SERVE_PROMPT, dtype=np.int32)
               for _ in range(SERVE_REQUESTS)]
    perks.clear_graphs()
    ops.reset_launch_counts()
    outs = {}
    for persistent in (True, False):
        # one engine per mode, two batches: the first persistent batch
        # captures the decode graph, the second replays it
        eng = Engine(model, params, ServeConfig(max_batch=SERVE_REQUESTS,
                                                persistent=persistent))
        for batch in range(2):
            for pr in prompts:
                eng.submit(Request(prompt=pr, max_new_tokens=SERVE_NEW))
            before = ops.launch_counts()
            out, stats = eng.run_batch()
            n, n_tc = (ops.launch_counts()[k] - before[k] for k in (
                "decode_attention", "decode_attention_tc"))
            ok = (out.shape == (SERVE_REQUESTS, SERVE_NEW)
                  and bool(((out >= 0) & (out < cfg.vocab)).all()))
            stats.update(batch_index=batch, decode_attention_launches=n,
                         tensor_core_launches=n_tc, tokens_ok=ok)
            print("  " + json.dumps(stats))
            if not ok:
                FAILS.append(f"the Engine returned tokens of shape "
                             f"{out.shape} or outside the vocabulary")
            if not persistent and n != cfg.n_layers * (SERVE_NEW - 1):
                FAILS.append(f"host-loop serving launched decode_attention "
                             f"{n} times, not {cfg.n_layers} a token")
            if not persistent and n_tc != cfg.n_layers * (SERVE_NEW - 1):
                FAILS.append(f"host-loop serving launched the tensor-core "
                             f"decode_attention {n_tc} times, not "
                             f"{cfg.n_layers} a token")
            if persistent and batch and n:
                FAILS.append(f"the second persistent batch launched "
                             f"decode_attention {n} times (no graph replay)")
            outs.setdefault(stats["mode"], []).append(out)
    toks = outs["persistent"][0]
    if not all(np.array_equal(toks, o) for os_ in outs.values() for o in os_):
        FAILS.append("the Engine's tokens differ between modes or runs")
    # DecodeAttentionProblem on every tier from one prefill
    cparams = model.compute_params(params)
    tokens = torch.from_numpy(np.stack(prompts)).cuda()
    logits, cache = model.prefill(cparams, {"tokens": tokens},
                                  cache_seq=SERVE_PROMPT + SERVE_NEW)
    if not bool(torch.isfinite(logits).all()):
        FAILS.append("the prefill logits are not finite")
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    prob = DecodeAttentionProblem(model=model, params=cparams, cache=cache,
                                  first_tokens=first, n_steps=SERVE_NEW - 1)
    best = plan(prob)
    print(f"  plan: {best.to_json(indent=None)}")
    tiers = {}
    for p in (Plan(tier="host_loop"), Plan(tier="device_loop"),
              Plan(tier="device_loop"), Plan(tier="resident"),
              Plan(tier="resident")):
        before = ops.launch_counts()["decode_attention"]
        got, _ = execute(prob, p)
        torch.cuda.synchronize()
        n = ops.launch_counts()["decode_attention"] - before
        same = np.array_equal(np.concatenate(
            [first.cpu().numpy()[:, None], got.cpu().numpy()], 1), toks)
        print(f"  execute decode {p.tier}: launches={n} tokens equal the "
              f"Engine's: {same}")
        if not same:
            FAILS.append(f"decode {p.tier} tokens differ from the Engine's")
        tiers[p.tier] = p
    launches["decode_attention"] = ops.launch_counts()["decode_attention"]
    print(f"[serve] launches {json.dumps(ops.launch_counts())}")
    if launches["decode_attention"] == 0:
        FAILS.append("decode_attention was not launched on the serving path")
    if ops.launch_counts()["decode_attention_tc"] != launches[
            "decode_attention"]:
        FAILS.append("the serving path ran decode_attention off the tensor "
                     "cores")
    keep("decode_attention", check_served_decode(
        "[serve]", model, cparams, prob.cache, first, toks, SERVE_NEW,
        cfg.n_layers))
    for name, p in tiers.items():
        ms = cuda_ms(lambda: execute(prob, p), 3)
        print("  " + json.dumps(dict(
            cell="serve", tier=name, decode_ms=ms,
            ms_per_token=ms / (SERVE_NEW - 1),
            tok_per_s=SERVE_REQUESTS * (SERVE_NEW - 1) / (ms / 1e3))))
    ms = cuda_ms(lambda: model.prefill(cparams, {"tokens": tokens},
                                       cache_seq=SERVE_PROMPT + SERVE_NEW), 3)
    print("  " + json.dumps(dict(cell="serve", prefill_ms=ms)))
    kc = prob.cache["k"][0]
    ln = torch.full((SERVE_REQUESTS,), SERVE_PROMPT, dtype=torch.int32,
                    device="cuda")
    qd = torch.randn((SERVE_REQUESTS, cfg.n_heads, cfg.head_dim),
                     device="cuda").to(kc.dtype)
    one = lambda: ops.decode_attention(qd, kc, prob.cache["v"][0], length=ln)
    lib = sdpa_decode(qd, kc, prob.cache["v"][0], ln)
    print("  " + json.dumps(dict(
        cell="serve", what="one layer's decode attention, S = "
        f"{kc.shape[1]}, in a graph of 50 calls",
        kernel=decode_attn.kernel_for(qd.dtype, cfg.n_heads // cfg.n_kv_heads,
                                      cfg.head_dim),
        decode_attention_ms=graph_ms(one), sdpa_ms=graph_ms(lib),
        cuda_cores_ms=graph_ms(direct_decode("cuda_cores", qd, kc,
                                             prob.cache["v"][0], ln)),
        decode_attention_host_ms=cuda_ms(one, 20))))
    perks.clear_graphs()

    # the port's card path against its CPU path on a small input: the smoke
    # config in float32, the same weights on both
    import dataclasses
    small = Model(dataclasses.replace(get_smoke_config(SERVE_ARCH),
                                      compute_dtype=torch.float32))
    sp = small.init(torch.Generator(device="cuda").manual_seed(SEED))
    spc = tree_map(torch.Tensor.cpu, sp)
    pr = torch.from_numpy(rng.integers(0, small.cfg.vocab, (2, 16),
                                       dtype=np.int32))
    lg_c, cache_c = small.prefill(sp, {"tokens": pr.cuda()}, cache_seq=24)
    lg_h, cache_h = small.prefill(spc, {"tokens": pr}, cache_seq=24)
    check_close("smoke f32 prefill logits, card vs CPU", lg_c.cpu(), lg_h,
                1e-4, 1e-4)
    tok = torch.argmax(lg_h, -1).to(torch.int32)
    for i in range(4):
        lg_c, cache_c = small.decode_step(sp, cache_c, tok.cuda())
        lg_h, cache_h = small.decode_step(spc, cache_h, tok)
        check_close(f"smoke f32 decode step {i} logits, card vs CPU",
                    lg_c.cpu(), lg_h, 1e-4, 1e-4)
        tok = torch.argmax(lg_h, -1).to(torch.int32)
    return errs, timing, launches


def check_served_decode(label: str, model, cparams, cache, first, toks,
                        n_new: int, n_calls: int) -> float:
    """``decode_attention`` against its plain version at the shapes and on
    the values a served model gives it: the ``n_calls`` attention calls of
    the first and of the last decode step (q, the ring and length), recorded
    from ``decode_step`` on a copy of the prefilled ``cache`` (these
    launches come after the path's count is read), in bf16 and in float32.
    The recorded run's tokens must be the Engine's ``toks``. Returns the
    largest error."""
    import repro_torch.models.transformer as tfm
    from repro_torch.kernels import ops, ref
    real, calls = tfm.decode_attention, []

    def record(q, k, v, *, length=None):
        calls.append((q.clone(), k.clone(), v.clone(), length.clone()))
        return real(q, k, v, length=length)

    rec_cache = {n: t.clone() for n, t in cache.items()}
    tok, rec_toks = first, [first]
    for i in range(n_new - 1):
        tfm.decode_attention = record if i in (0, n_new - 2) else real
        try:
            lg, rec_cache = model.decode_step(cparams, rec_cache, tok)
        finally:
            tfm.decode_attention = real
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        rec_toks.append(tok)
    if not np.array_equal(torch.stack(rec_toks, 1).cpu().numpy(), toks):
        FAILS.append(f"{label} the recorded decode_step tokens differ from "
                     f"the Engine's")
    if len(calls) != 2 * n_calls:
        FAILS.append(f"{label} a decode step called decode_attention "
                     f"{len(calls) // 2} times, not {n_calls}")
        return float("inf")
    q0, k0 = calls[0][:2]
    print(f"{label} decode_attention against its plain version on the "
          f"served inputs: B={q0.shape[0]}, S={k0.shape[1]}, "
          f"Hq/Hkv={q0.shape[1]}/{k0.shape[2]}, D={q0.shape[2]}, "
          f"{str(k0.dtype)[6:]}, length=pos+1, {n_calls} calls a step; "
          f"bf16 and float32")
    err = 0.0
    for step, part in (("first", calls[:n_calls]), ("last", calls[n_calls:])):
        want = torch.stack([ref.decode_attention(
            qi.float(), ki.float(), vi.float(), length=li)
            for qi, ki, vi, li in part])
        got = torch.stack([ops.decode_attention(qi, ki, vi, length=li)
                           for qi, ki, vi, li in part])
        got32 = torch.stack([ops.decode_attention(
            qi.float(), ki.float(), vi.float(), length=li)
            for qi, ki, vi, li in part])
        what = (f"decode_attention served, {n_calls} calls of the {step} "
                f"step, length={int(part[0][3][0])}")
        err = max(err, check_decode_bf16(f"{what} {str(q0.dtype)[6:]}",
                                         got.float(), want),
                  check_close(f"{what} f32", got32, want,
                              **DECODE_TOL[torch.float32]))
    return err


def ssm_serve_phase(rng):
    """[serve ssm]: the ``Engine`` on mamba2-780m and zamba2-1.2b at full
    width, counted, with ``ssd_scan(return_state=True)`` (the prefill's
    scan, which hands the final state to the decode) held to its plain
    version on one layer's recorded prefill inputs, and zamba2's
    ``decode_attention`` to its plain version on the shared block's served
    inputs. Returns (errors, timing, launches): the ``ssm_scan_state``
    entry, and the served ``decode_attention`` error."""
    from repro_torch import DecodeAttentionProblem, Engine, Model, Plan, execute
    from repro_torch.configs import get_config
    from repro_torch.core import perks
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssm_scan as kssm
    from repro_torch.models import mamba2 as mb
    from repro_torch.nn.param import tree_leaves
    from repro_torch.runtime.server import Request, ServeConfig

    errs = {"ssm_scan_state": 0.0, "decode_attention": 0.0}
    timing, launches = {}, {"ssm_scan_state": 0}
    nreq, plen, new = SSM_SERVE_REQUESTS, SSM_SERVE_PROMPT, SSM_SERVE_NEW
    for arch in SSM_SERVE_ARCHS:
        cfg = get_config(arch)
        hybrid = cfg.family == "hybrid"
        n_attn = cfg.n_layers // cfg.shared_attn_every if hybrid else 0
        print(f"[serve ssm] Engine on {arch} at full width ({cfg.n_layers} "
              f"Mamba2 layers, {n_attn} shared-attention applications, "
              f"d_model {cfg.d_model}, vocab {cfg.vocab}, "
              f"{str(cfg.compute_dtype)[6:]} compute), seeded init on the "
              f"card; {nreq} requests, prompt {plen}, {new} new tokens")
        t0 = time.perf_counter()
        model = Model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
        cparams = model.compute_params(params)
        torch.cuda.synchronize()
        print(f"  init {time.perf_counter() - t0:.2f} s, {model.n_params()} "
              f"parameters")
        prompts = [rng.integers(0, cfg.vocab, plen, dtype=np.int32)
                   for _ in range(nreq)]
        tokens = torch.from_numpy(np.stack(prompts)).cuda()
        # torch operators of one prefill and of one decode step, for the
        # replayed batch's count below
        with LaunchCount() as lc:
            _, cache = model.prefill(cparams, {"tokens": tokens},
                                     cache_seq=plen + new)
        prefill_ops = lc.n
        first = torch.zeros(nreq, dtype=torch.int32, device="cuda")
        with LaunchCount() as lc:
            model.decode_step(cparams, cache, first)
        step_ops = lc.n
        del cache
        print(f"[serve ssm] {arch}: counters set to 0")
        perks.clear_graphs()
        ops.reset_launch_counts()
        outs = {}
        for persistent, batches in ((True, 2), (False, 1)):
            # the first persistent batch captures the decode graph, the
            # second replays it (counted under an operator counter)
            eng = Engine(model, params, ServeConfig(max_batch=nreq,
                                                    persistent=persistent))
            for batch in range(batches):
                for pr in prompts:
                    eng.submit(Request(prompt=pr, max_new_tokens=new))
                before = ops.launch_counts()
                caps = perks.capture.count
                replay = persistent and batch == 1
                with (LaunchCount() if replay else contextlib.nullcontext()
                      ) as lc:
                    out, stats = eng.run_batch()
                torch.cuda.synchronize()
                d = {k: v - before[k] for k, v in ops.launch_counts().items()}
                ok = (out.shape == (nreq, new)
                      and bool(((out >= 0) & (out < cfg.vocab)).all()))
                stats.update(
                    batch_index=batch, ssm_scan_launches=d["ssm_scan"],
                    ssm_scan_state_launches=d["ssm_scan_state"],
                    decode_attention_launches=d["decode_attention"],
                    tensor_core_launches=d["decode_attention_tc"],
                    graph_captures=perks.capture.count - caps, tokens_ok=ok)
                if replay:
                    stats.update(torch_ops=lc.n, prefill_ops=prefill_ops,
                                 decode_step_ops=step_ops)
                print("  " + json.dumps(stats))
                if not ok:
                    FAILS.append(f"{arch}: the Engine returned tokens of "
                                 f"shape {out.shape} or outside the "
                                 f"vocabulary")
                if d["ssm_scan"] != cfg.n_layers or d["ssm_scan_state"] != (
                        cfg.n_layers):
                    FAILS.append(f"{arch}: a prefill launched ssm_scan "
                                 f"{d['ssm_scan']} times ({d['ssm_scan_state']}"
                                 f" with the state), not {cfg.n_layers}")
                if not persistent and (
                        d["decode_attention"] != n_attn * (new - 1)
                        or d["decode_attention_tc"] != n_attn * (new - 1)):
                    FAILS.append(f"{arch}: host-loop serving launched "
                                 f"decode_attention {d['decode_attention']} "
                                 f"times ({d['decode_attention_tc']} on the "
                                 f"tensor cores), not {n_attn} a token")
                if replay and (d["decode_attention"] or stats["graph_captures"]
                               or lc.n - prefill_ops >= step_ops):
                    FAILS.append(f"{arch}: the replayed persistent batch "
                                 f"launched decode work outside its graph "
                                 f"({d['decode_attention']} decode_attention, "
                                 f"{stats['graph_captures']} captures, "
                                 f"{lc.n - prefill_ops} operators beside the "
                                 f"prefill's)")
                outs.setdefault(stats["mode"], []).append(out)
        toks = outs["persistent"][0]
        if not all(np.array_equal(toks, o) for os_ in outs.values()
                   for o in os_):
            FAILS.append(f"{arch}: the Engine's tokens differ between modes "
                         f"or batches")
        # DecodeAttentionProblem on every tier from one prefill; layer 0's
        # scan inputs recorded on the way
        real, rec = mb.ssd_chunked, []

        def record(*args, **kw):
            if not rec:
                rec.append(tuple(t.float().clone() for t in args))
            return real(*args, **kw)

        mb.ssd_chunked = record
        try:
            logits, cache = model.prefill(cparams, {"tokens": tokens},
                                          cache_seq=plen + new)
        finally:
            mb.ssd_chunked = real
        if not all(bool(torch.isfinite(t.float()).all()) for t in
                   tree_leaves(cache)) or not bool(
                       torch.isfinite(logits).all()):
            FAILS.append(f"{arch}: the prefill's logits or cache are not "
                         f"finite")
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        prob = DecodeAttentionProblem(model=model, params=cparams,
                                      cache=cache, first_tokens=first,
                                      n_steps=new - 1)
        tiers = {}
        for p in (Plan(tier="host_loop"), Plan(tier="device_loop"),
                  Plan(tier="device_loop"), Plan(tier="resident"),
                  Plan(tier="resident")):
            before = ops.launch_counts()
            got, _ = execute(prob, p)
            torch.cuda.synchronize()
            n = {k: ops.launch_counts()[k] - before[k]
                 for k in ("decode_attention", "ssm_scan")}
            same = np.array_equal(np.concatenate(
                [first.cpu().numpy()[:, None], got.cpu().numpy()], 1), toks)
            print(f"  execute decode {p.tier}: launches={n} tokens equal the "
                  f"Engine's: {same}")
            if not same:
                FAILS.append(f"{arch}: decode {p.tier} tokens differ from "
                             f"the Engine's")
            tiers[p.tier] = p
        launches["ssm_scan_state"] += ops.launch_counts()["ssm_scan_state"]
        print(f"[serve ssm] {arch} launches {json.dumps(ops.launch_counts())}")
        if hybrid:
            # the shared block's decode_attention on its served inputs
            errs["decode_attention"] = max(
                errs["decode_attention"], check_served_decode(
                    f"[serve ssm] {arch}", model, cparams, prob.cache, first,
                    toks, new, n_attn))

        # the final-state launch on layer 0's recorded prefill inputs (not
        # counted): against its plain version, and its y bit for bit
        # against the launch without the state
        x, dt, a, b, c, d = rec[0][:6]
        bsz, t_len, h, p_ = x.shape
        n_st = b.shape[-1]
        ck = cfg.ssm.chunk
        run_state = lambda: kssm.ssd_scan(x, dt, a, b, c, d, chunk=ck,
                                          return_state=True)
        y1, h1 = run_state()
        y0 = kssm.ssd_scan(x, dt, a, b, c, d, chunk=ck)
        bit_equal(f"{arch} ssd_scan y with the state against without",
                  y1, y0)

        def plain():
            outs_ = [ref.ssm_scan(x[i], dt[i], a, b[i], c[i], d,
                                  return_state=True) for i in range(bsz)]
            return (torch.stack([o[0] for o in outs_]),
                    torch.stack([o[1] for o in outs_]))

        yp, hp = plain()
        what = (f"{arch} ssd_scan(return_state=True) on layer 0's prefill "
                f"inputs B={bsz} T={t_len} H={h} P={p_} N={n_st} f32 "
                f"chunk={ck}")
        e = max(check_close(f"{what}: y", y1, yp, 1e-3, 1e-3),
                check_close(f"{what}: h_final", h1, hp, 1e-3, 1e-3))
        errs["ssm_scan_state"] = max(errs["ssm_scan_state"], e)
        flops = bsz * ssd_scan_flops(t_len, h, p_, n_st, ck)
        moved = bsz * (ssd_scan_bytes(t_len, h, p_, n_st, 4)
                       + 4 * h * n_st * p_) - (bsz - 1) * 8 * h
        t_ops, t_bytes = flops / FP32_FLOPS, moved / HBM_BW
        row = dict(ms=cuda_ms(run_state, 5), graph_ms=graph_ms(run_state, 5),
                   plain_ms=cuda_ms(plain, 1),
                   bound=(1e3 * max(t_ops, t_bytes),
                          "operations" if t_ops >= t_bytes else "bytes"),
                   library_ms=None, flops=flops, bytes=moved,
                   stateless_graph_ms=graph_ms(
                       lambda: kssm.ssd_scan(x, dt, a, b, c, d, chunk=ck), 5),
                   launches_a_prefill=cfg.n_layers,
                   launch=kssm.config(bsz, t_len, h, p_, n_st, ck))
        print(f"  ssm_scan_state {arch}: {json.dumps(row)}")
        timing.setdefault("ssm_scan_state", row)
        del rec, x, dt, b, c, y0, y1, h1, yp, hp

        # times: the prefill, and each decode tier (ms a token, tokens/s)
        # beside the byte model of a token (every compute weight read once,
        # the SSM state read and written, the K/V rings read)
        state_b = sum(t.numel() * t.element_size() for k_, t in cache.items()
                      if k_ not in prob.ring_keys and k_ != "pos")
        ring_b = sum(t.numel() * t.element_size() for k_, t in cache.items()
                     if k_ in prob.ring_keys)
        param_b = sum(t.numel() * t.element_size()
                      for t in tree_leaves(cparams))
        token_b = param_b + 2 * state_b + ring_b
        pre_ms = cuda_ms(lambda: model.prefill(
            cparams, {"tokens": tokens}, cache_seq=plen + new), 3)
        print("  " + json.dumps(dict(
            cell=f"serve-{arch}", prefill_ms=pre_ms,
            prefill_tok_per_s=nreq * plen / (pre_ms / 1e3),
            params_bytes=param_b, state_bytes=state_b, ring_bytes=ring_b,
            token_bytes=token_b,
            token_bound_ms=1e3 * token_b / HBM_BW)))
        for name, p in tiers.items():
            ms = cuda_ms(lambda: execute(prob, p), 3)
            print("  " + json.dumps(dict(
                cell=f"serve-{arch}", tier=name, decode_ms=ms,
                ms_per_token=ms / (new - 1),
                tok_per_s=nreq * (new - 1) / (ms / 1e3),
                bound_share=1e3 * token_b / HBM_BW / (ms / (new - 1)))))
        del model, params, cparams, cache, prob, logits, eng
        perks.clear_graphs()
        torch.cuda.empty_cache()
    return errs, timing, launches


BATCH_KERNELS = {
    "stencil_baseline_step_batched": (
        "src/repro_torch/kernels/csrc/stencil_step.cu",
        "src/repro/kernels/stencil2d.py:566"),
    "spmv_ell_batched": ("src/repro_torch/kernels/csrc/spmv_ell.cu",
                         "src/repro/kernels/spmv_ell.py:38"),
    "cg_fused_batched": ("src/repro_torch/kernels/csrc/cg_fused.cu",
                         "src/repro/kernels/cg_fused.py:104"),
    "vdot": ("src/repro_torch/kernels/csrc/vdot.cu",
             "src/repro/kernels/ref.py:70"),
    "stencil_perks_batched": ("src/repro_torch/kernels/csrc/stencil_perks.cu",
                              "src/repro/kernels/stencil2d.py:203"),
    "stencil_shallow_batched": (
        "src/repro_torch/kernels/csrc/stencil_shallow.cu",
        "src/repro/kernels/stencil2d.py:203"),
    "stencil_resident_batched": (
        "src/repro_torch/kernels/csrc/stencil_resident.cu",
        "src/repro/kernels/stencil2d.py:540"),
    "stencil_tb_batched": ("src/repro_torch/kernels/csrc/stencil_tb.cu",
                           "src/repro/kernels/stencil2d.py:468"),
}
# [batch kernels] the batched resident stencil launches: (kernel, spec,
# shape, steps, t, lanes, type); the kernels line times the first case of
# each kernel in f32 at the largest B (its bf16 and 3D cases beside it)
LANE_CASES = [
    ("stencil_perks_batched", "2d5pt", (2048, 2048), 100, 1, 8, "f32"),
    ("stencil_perks_batched", "2d5pt", (2048, 2048), 100, 1, 3, "f32"),
    ("stencil_perks_batched", "3d7pt", (256, 256, 256), 100, 1, 3, "f32"),
    ("stencil_perks_batched", "2d5pt", (2048, 2048), 100, 1, 8, "bf16"),
    ("stencil_shallow_batched", "2d5pt", (2048, 2048), 100, 4, 8, "f32"),
    ("stencil_shallow_batched", "2d5pt", (2048, 2048), 100, 4, 3, "f32"),
    ("stencil_shallow_batched", "2d5pt", (2048, 2048), 100, 4, 3, "bf16"),
    ("stencil_tb_batched", "2d5pt", (2048, 2048), 100, 8, 8, "f32"),
    ("stencil_tb_batched", "2d5pt", (2048, 2048), 100, 8, 3, "f32"),
    ("stencil_tb_batched", "2d5pt", (2048, 2048), 100, 8, 3, "bf16"),
    ("stencil_resident_batched", "2d5pt", (1024, 1024), 100, 1, 4, "f32"),
    ("stencil_resident_batched", "2d5pt", (1024, 1024), 100, 1, 3, "f32"),
    ("stencil_resident_batched", "2d5pt", (512, 512), 100, 1, 8, "f32"),
    ("stencil_resident_batched", "2d5pt", (1024, 1024), 100, 1, 4, "bf16"),
]
# [step specs]: the loop tiers' step on every Table-III spec at the loop
# tiers' full shapes, and the steps of its counted path on each tier
STEP_SPEC_SHAPES = {2: (8192, 8192), 3: (256, 256, 256)}
STEP_SPEC_STEPS = 4
STEP_SPEC_BATCH = {2: (3, 1536, 1000), 3: (3, 96, 100, 104)}
STEP_SPEC_TYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def step_spec_kernels() -> dict:
    """The [step specs] entries of the kernels line: one a spec and type."""
    from repro_torch.kernels.common import BENCHMARKS
    return {f"stencil_baseline_step[{name} {t}]":
            STENCIL_KERNELS["stencil_baseline_step"]
            for name in BENCHMARKS for t in STEP_SPEC_TYPES}


# The batched path's cells: (cell, what, size, B, steps); a lane of
# stencil-batch-small holds its whole domain (stencil_resident)
BATCH_CELLS = [
    ("stencil-batch", "2d5pt", (2048, 2048), 8, 100),
    ("stencil-batch-small", "2d5pt", (1024, 1024), 4, 100),
    ("cg-batch-small", "poisson2d", 512, 4, 100),
    ("cg-batch-large", "poisson2d", 1024, 8, 100),
    ("bicgstab-batch", "convdiff2d", 512, 8, 100),
    ("gmres-batch", "convdiff2d", 448, 4, 4),     # GMRES(KRYLOV_M) cycles
]
BATCH_B = 3                          # [batch kernels] stencil instances
SPMV_LANES = (1, 2, 4, 8)
# [batch kernels] cg_fused: (poisson2d side, lane counts), A on chip; the
# kernels line's entry is the cg-batch-small cell's launch
CG_LANES = ((512, (1, 2, 3, 4)), (256, (16,)), (128, (32,)))
CG_LANES_MAIN = (512, 4)
SERVICE_STENCILS, SERVICE_CGS = 16, 8
SERVICE_SHAPE, SERVICE_STEPS = (1024, 1024), 100
# [async service]: the [service] requests plus BiCGStab and GMRES ones,
# (count, convdiff2d side, iterations or cycles), arriving as a seeded
# Poisson process with this mean gap
ASYNC_BICGSTABS, ASYNC_GMRES = (8, 512, 100), (4, 448, 4)
ASYNC_MEAN_GAP_S = 0.001
AUTOTUNE = [("2d5pt", (8192, 8192), 100), ("2ds25pt", (8192, 8192), 100),
            ("3d7pt", (256, 256, 256), 100)]


class LaunchCount(TorchDispatchMode):
    """Counts the torch operators that launch a kernel (views and
    allocations launch none); the port's own kernels are counted by their
    wrappers."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not (func.is_view or func.__name__.startswith("empty"))
        return func(*args, **(kwargs or {}))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def conv_yardstick(spec, x):
    """One cuDNN convolution computing the interior of one step of ``spec``
    on ``x`` (2D or 3D) in x's type: the [step specs] library time (the
    port never calls it)."""
    r, k = spec.radius, 2 * spec.radius + 1
    w = torch.zeros((1, 1) + (k,) * spec.ndim, device=x.device,
                    dtype=x.dtype)
    for off, wt in zip(spec.offsets, spec.weights):
        w[(0, 0) + tuple(o + r for o in off)] = wt
    conv = (torch.nn.functional.conv2d if spec.ndim == 2
            else torch.nn.functional.conv3d)
    return lambda: conv(x[None, None], w)


def step_spec_phase(rng):
    """Phase 19: the step kernel on every Table-III spec and type at full
    shape against its plain version, timed; then its counted path on both
    loop tiers. Returns (errors, timing, launches) by kernel-line name."""
    from repro_torch.core import perks
    from repro_torch.exec import Plan, StencilProblem, execute
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.common import BENCHMARKS

    card = card_line()
    errs, timing, launches = {}, {}, {}
    print(f"[step specs] {card}: csrc/stencil_step.cu on every Table-III "
          f"spec, 2D {STEP_SPEC_SHAPES[2]} and 3D {STEP_SPEC_SHAPES[3]}, "
          f"f32 and bf16, bit for bit; ms (eager), graph_ms, bound, plain, "
          f"cuDNN; then host and device loop, {STEP_SPEC_STEPS} steps, "
          f"counters set to 0 before each")
    n_ok = 0
    for name, spec in BENCHMARKS.items():
        shape = STEP_SPEC_SHAPES[spec.ndim]
        base = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()
        for tag, dt in STEP_SPEC_TYPES.items():
            key = f"stencil_baseline_step[{name} {tag}]"
            x = base.to(dt)
            out = torch.empty_like(x)
            run = lambda: ops.stencil_baseline_step(x, spec=spec, out=out)
            got = run().clone()
            want = ref.stencil_step(x, spec)
            errs[key] = (got.double() - want.double()).abs().max().item()
            ok = torch.equal(got, want)
            if not ok:
                print(f"  {key}: not bit-equal to its plain version FAIL")
                FAILS.append(f"{key} is not bit-equal")
            moved = 2 * x.numel() * x.element_size()
            timing[key] = dict(
                ms=cuda_ms(run, 20), graph_ms=graph_ms(run, 20),
                bound=bound(spec, shape, 1, moved),
                plain_ms=cuda_ms(lambda: ref.stencil_step(x, spec), 3),
                library_ms=cuda_ms(conv_yardstick(spec, x), 5))
            del got, want, out
            # a batch: each lane bit-equal to its own launch
            xs = torch.from_numpy(rng.standard_normal(
                STEP_SPEC_BATCH[spec.ndim]).astype(np.float32)).cuda().to(dt)
            got = ops.stencil_baseline_step(xs, spec=spec)
            lanes = all(torch.equal(got[i], ops.stencil_baseline_step(
                xs[i], spec=spec)) for i in range(xs.shape[0]))
            if not (lanes and torch.equal(got, ref.stencil_step(xs, spec))):
                print(f"  {key} batched {tuple(xs.shape)}: a lane differs "
                      f"from its own launch or the plain version FAIL")
                FAILS.append(f"{key} batched is not bit-equal")
                ok = False
            del xs, got
            # the counted path: both loop tiers, bit for bit
            want = ref.stencil_run(x, spec, STEP_SPEC_STEPS)
            problem = StencilProblem(x, spec, STEP_SPEC_STEPS)
            perks.clear_graphs()
            ops.reset_launch_counts()
            for tier in ("host_loop", "device_loop"):
                y = execute(problem, Plan(tier=tier))
                torch.cuda.synchronize()
                if not torch.equal(y, want):
                    print(f"  {key} {tier}: not bit-equal to the plain run "
                          f"FAIL")
                    FAILS.append(f"{key} {tier} is not bit-equal")
                    ok = False
            counts = ops.launch_counts()
            perks.clear_graphs()
            launches[key] = counts["stencil_baseline_step"]
            # the host loop's steps, the graph's warm-up step and its steps
            expect = 2 * STEP_SPEC_STEPS + 1
            if (counts["stencil_baseline_step"] != expect
                    or counts["stencil_baseline_step_runtime"]
                    or counts["stencil_baseline_step_unaligned"]):
                FAILS.append(f"{key}: the loop tiers made "
                             f"{counts['stencil_baseline_step']} launches "
                             f"({counts['stencil_baseline_step_runtime']} on "
                             f"the runtime path, "
                             f"{counts['stencil_baseline_step_unaligned']} "
                             f"unaligned), not {expect} on a compiled shape")
            n_ok += ok
            t = timing[key]
            print(f"  {key}: ms={t['ms']!r} graph_ms={t['graph_ms']!r} "
                  f"bound_ms={t['bound'][0]!r} ({t['bound'][1]}) "
                  f"plain_ms={t['plain_ms']!r} library_ms="
                  f"{t['library_ms']!r} launches={launches[key]} "
                  f"{'ok' if ok else 'FAIL'}")
            del x, y, want, problem
    print(f"  {n_ok} of {len(launches)} bit-equal on the kernel and both "
          f"loop tiers")
    return errs, timing, launches


def lane_phase(rng, card: str, errs: dict, timing: dict) -> None:
    """[batch kernels], the batched resident stencil launches: each case of
    LANE_CASES (a different seeded domain a lane) in one launch, every lane
    bit for bit against its single launch on the whole card and against
    the plain version; the lane's CTAs and cached rows (the planner's for
    one lane, ``per_instance_chip``); timed eager and in a graph beside its
    bound (B lanes' bytes at the lane's cached rows, or their operations)
    and the plain version."""
    from repro_torch.core.cache_policy import gm_bytes_deep, gm_bytes_fused
    from repro_torch.core.hardware import device_chip
    from repro_torch.exec import per_instance_chip
    from repro_torch.kernels import ops, ref, stencil2d
    from repro_torch.kernels.common import get_spec
    from repro_torch.kernels.stencil3d import plan_resident_planes

    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    chip = device_chip()
    limit = chip.smem_per_block - stencil2d.PERKS_STATIC_SMEM
    print(f"[batch kernels] {card}: the resident stencil kernels, B domains "
          f"(a different seeded domain a lane) in one cooperative launch, "
          f"each lane bit for bit against its single launch and the plain "
          f"version; lane CTAs = {chip.sms} SMs // B")
    for kname, sname, shape, n, t, b, tag in LANE_CASES:
        spec = get_spec(sname)
        dt = types[tag]
        xs = torch.from_numpy(rng.standard_normal((b,) + shape).astype(
            np.float32)).cuda().to(dt)
        eb = xs.element_size()
        lane = per_instance_chip(chip, b)
        if kname == "stencil_resident_batched":
            R = shape[0]
            fn = lambda x: ops.stencil_resident(x, spec=spec, steps=n)
        elif kname == "stencil_perks_batched":
            R = plan_resident_planes(shape, eb, spec, chip=lane)
            fn = lambda x: ops.stencil_perks(x, spec=spec, steps=n,
                                             cached_rows=R)
        else:
            deep = kname == "stencil_tb_batched"
            R = stencil2d.tb_cached_rows(shape, spec.radius, t, eb, deep=deep,
                                         ctas=lane.sms, limit=limit)
            run_ = ops.stencil_perks_deep if deep else ops.stencil_perks
            fn = lambda x: run_(x, spec=spec, steps=n, cached_rows=R,
                                sub_rows=max(128, spec.radius * t),
                                fuse_steps=t)
        what = f"{kname} {sname} {shape} {tag} B={b} t={t} cached_rows={R}"
        if R is None or (kname == "stencil_perks_batched"
                         and not 0 < R < shape[0]):
            print(f"  {what}: the lane's plan is not this kernel's FAIL")
            FAILS.append(f"{what}: no lane plan for the kernel")
            continue
        before = ops.launch_counts()[kname]
        got = fn(xs)
        if ops.launch_counts()[kname] != before + 1:
            FAILS.append(f"{what}: not one {kname} launch")
        want = ref.stencil_run(xs, spec, n)
        ok = torch.equal(got, want)
        errs[kname] = max(errs[kname], (got.double() - want.double())
                          .abs().max().item())
        n_same = sum(torch.equal(got[i], fn(xs[i])) for i in range(b))
        ok &= n_same == b
        if not ok:
            print(f"  {what}: {n_same} of {b} lanes bit-equal to their "
                  f"single launch, plain version "
                  f"{'bit-equal' if torch.equal(got, want) else 'differs'} "
                  f"FAIL")
            FAILS.append(f"{what} is not bit-equal lane by lane")
        dom = math.prod(shape) * eb
        row = dom // shape[0]
        if kname == "stencil_tb_batched":
            least = gm_bytes_deep(n, dom, R * row, fuse_steps=t)
        else:
            least = gm_bytes_fused(n, dom, R * row, row_bytes=row,
                                   radius=spec.radius, fuse_steps=t)
        run = lambda: fn(xs)
        t_ = dict(
            spec=sname, shape=shape, type=tag, B=b, t=t, steps=n,
            lane_ctas=lane.sms, cached_rows=R, ms=cuda_ms(run, 3),
            graph_ms=graph_ms(run, 3),
            plain_ms=cuda_ms(lambda: ref.stencil_run(xs, spec, n), 1),
            bound=bound(spec, shape, n * b, b * least), library_ms=None,
            lanes_bit_equal=n_same)
        if kname not in timing:
            timing[kname] = t_
        print(f"  {json.dumps(t_)} {'ok' if ok else 'FAIL'}")
        del xs, got, want


def batch_phases(rng):
    """Phases 14-18: the batched launches against B single launches and
    their plain versions, the batched path counted against
    ``execute_sequential``, the ``SolverService``, a traced ``execute``, and
    ``autotune`` with the drift ledger. Returns (errors, timing, launches)
    by kernel name."""
    import tempfile

    from repro_torch import obs
    from repro_torch.core import perks
    from repro_torch.exec import (BatchedProblem, BiCGStabProblem, CGProblem,
                                  GMRESProblem, Plan, StencilProblem,
                                  autotune, execute, execute_sequential,
                                  plan_candidates)
    from repro_torch.kernels import ops, ref, vdot as kvdot
    from repro_torch.kernels.common import BENCHMARKS, get_spec
    from repro_torch.runtime.solver_service import (ServiceConfig,
                                                    SolverService)
    from repro_torch.sparse.generate import convdiff2d, poisson2d

    card = card_line()
    errs = {k: 0.0 for k in BATCH_KERNELS}
    timing = {}

    def keep(k, e):
        errs[k] = max(errs[k], e)

    def vecs(b, n):
        return torch.from_numpy(
            rng.standard_normal((b, n)).astype(np.float32)).cuda()

    def same(what, got, want):
        ok = all(torch.equal(g, w) for g, w in zip(
            got if isinstance(got, tuple) else (got,),
            want if isinstance(want, tuple) else (want,)))
        if not ok:
            print(f"  {what}: not bit-equal FAIL")
            FAILS.append(f"{what} is not bit-equal")
        return ok

    # -- 14. the batched launches ---------------------------------------------------
    print(f"[batch kernels] {card}: every Table-III spec, f32 and bf16, "
          f"B={BATCH_B}: one batched stencil_step launch against "
          f"{BATCH_B} single launches and the plain version, bit for bit")
    n_ok = 0
    for name, spec in BENCHMARKS.items():
        shape = (384, 320) if spec.ndim == 2 else (48, 40, 36)
        for dt in (torch.float32, torch.bfloat16):
            xs = torch.from_numpy(rng.standard_normal(
                (BATCH_B,) + shape).astype(np.float32)).cuda().to(dt)
            got = ops.stencil_baseline_step(xs, spec=spec)
            ok = same(f"{name} {dt} batched stencil_step vs single",
                      got, torch.stack([ops.stencil_baseline_step(
                          xs[i], spec=spec) for i in range(BATCH_B)]))
            want = ref.stencil_step(xs, spec)
            ok &= same(f"{name} {dt} batched stencil_step vs plain", got,
                       want)
            keep("stencil_baseline_step_batched",
                 (got.double() - want.double()).abs().max().item())
            n_ok += ok
    print(f"  {n_ok} of {2 * len(BENCHMARKS)} bit-equal")
    cell, sname, shape, B, steps = BATCH_CELLS[0]
    spec = get_spec(sname)
    xs = vecs(B, math.prod(shape)).view((B,) + shape)
    out = torch.empty_like(xs)
    run = lambda: ops.stencil_baseline_step(xs, spec=spec, out=out)
    w = torch.zeros((1, 1, 3, 3), device=xs.device)
    for (d0, d1), wt in zip(spec.offsets, spec.weights):
        w[0, 0, d0 + 1, d1 + 1] = wt
    conv = lambda: torch.nn.functional.conv2d(xs[:, None], w)
    dom = math.prod(shape) * 4
    timing["stencil_baseline_step_batched"] = dict(
        B=B, shape=shape, ms=cuda_ms(run, 20), graph_ms=graph_ms(run),
        host_us=host_us(run),
        plain_ms=cuda_ms(lambda: ref.stencil_step(xs, spec), 5),
        bound=(max(1e3 * 2 * B * dom / HBM_BW, bound(spec, shape, B, 0)[0]),
               "bytes" if 2 * B * dom / HBM_BW >= bound(spec, shape, B, 0)[0]
               / 1e3 else "operations"),
        library_ms=cuda_ms(conv, 20))
    print(f"  stencil_step {sname} B={B} x {shape} f32: "
          f"{json.dumps(timing['stencil_baseline_step_batched'])}")
    lane_phase(rng, card, errs, timing)

    csr = poisson2d(1024)
    ell = csr.to_ell()
    data = torch.from_numpy(ell.data).cuda()
    cols = torch.from_numpy(ell.cols).cuda()
    n = data.shape[0]
    print(f"[batch kernels] {card}: spmv_ell on poisson2d(1024) (n={n}), "
          f"B in {SPMV_LANES}: one launch against B single launches and "
          f"the plain version, bit for bit")
    for b in SPMV_LANES:
        x = vecs(b, n)
        got = ops.spmv(data, cols, x)
        same(f"spmv_ell B={b} vs single", got,
             torch.stack([ops.spmv(data, cols, x[i]) for i in range(b)]))
        want = ref.spmv_ell(data, cols, x)
        same(f"spmv_ell B={b} vs plain", got, want)
        keep("spmv_ell_batched", (got - want).abs().max().item())
        if b == max(SPMV_LANES):
            sp = torch.sparse_csr_tensor(
                torch.from_numpy(csr.indptr.astype(np.int32)).cuda(),
                torch.from_numpy(csr.indices.astype(np.int32)).cuda(),
                torch.from_numpy(csr.data).cuda(), size=csr.shape)
            xt = x.t().contiguous()
            run = lambda: ops.spmv(data, cols, x)
            timing["spmv_ell_batched"] = dict(
                B=b, ms=cuda_ms(run, 20), graph_ms=graph_ms(run),
                host_us=host_us(run),
                single_graph_ms=graph_ms(lambda: ops.spmv(data, cols, x[0])),
                plain_ms=cuda_ms(lambda: ref.spmv_ell(data, cols, x), 5),
                bound=spmv_bound(b * n, b * n, ell.data.size, 0),
                library_ms=cuda_ms(lambda: sp @ xt, 20))
            print(f"  spmv_ell B={b}: "
                  f"{json.dumps(timing['spmv_ell_batched'])}")

    a, c = vecs(8, n), vecs(8, n)
    got = ops.vdot(a, c)
    same("vdot B=8 vs single", got, torch.stack(
        [ops.vdot(a[i].contiguous(), c[i].contiguous()) for i in range(8)]))
    want = (a.double() * c.double()).sum(-1)
    keep("vdot", check_close("vdot B=8 against float64", got, want, 1e-5,
                             1e-3))
    run = lambda: ops.vdot(a, c)
    timing["vdot"] = dict(
        B=8, n=n, ms=cuda_ms(run, 20), graph_ms=graph_ms(run),
        host_us=host_us(run),
        single_graph_ms=graph_ms(lambda: ops.vdot(a[0], c[0])),
        plain_ms=cuda_ms(lambda: kvdot.plain_vdot(a, c), 20),
        bound=(1e3 * 2 * 8 * n * 4 / HBM_BW, "bytes"),
        library_ms=cuda_ms(lambda: torch.linalg.vecdot(a, c), 20))
    print(f"  vdot B=8 n={n}: {json.dumps(timing['vdot'])}")

    for side, lanes in CG_LANES:
        csr_s = poisson2d(side)
        ell_s = csr_s.to_ell()
        ds = torch.from_numpy(ell_s.data).cuda()
        cs = torch.from_numpy(ell_s.cols).cuda()
        ns = ds.shape[0]
        print(f"[batch kernels] {card}: cg_fused on poisson2d({side}) "
              f"(n={ns}), MIX with A on chip, {CG_ITERS} iterations, B in "
              f"{lanes}: x and rr against B single-instance launches (bit "
              f"for bit) and a float64 plain run")
        single = lambda: ops.cg(ds, cs, bs[0], iters=CG_ITERS)
        single_ms = single_graph_ms = None
        for b in lanes:
            bs = vecs(b, ns)
            x, rr = ops.cg(ds, cs, bs, iters=CG_ITERS)
            n_same = 0
            for i in range(b):
                x1, rr1 = ops.cg(ds, cs, bs[i].contiguous(), iters=CG_ITERS)
                n_same += same(f"cg_fused B={b} lane {i} vs single",
                               (x[i], rr[i]), (x1, rr1[0]))
                x32, rr32 = ref.cg_run(ds, cs, bs[i], CG_ITERS)
                x64, rr64 = ref.cg_run(ds.double(), cs, bs[i].double(),
                                       CG_ITERS)
                keep("cg_fused_batched", check_x64(
                    f"cg_fused B={b} lane {i} x", x[i], x32, x64))
                check_rr(f"cg_fused B={b} lane {i} rr", rr[i], [rr32], rr64,
                         float(torch.dot(bs[i].double(), bs[i].double())))
            print(f"  cg_fused B={b}: {n_same} of {b} lanes bit-equal to "
                  f"their single launches")
            run = lambda: ops.cg(ds, cs, bs, iters=CG_ITERS)
            if single_ms is None:      # one lane of this operator, once
                single_ms = cuda_ms(single, 3)
                single_graph_ms = graph_ms(single, 3)
            moved = (ell_s.data.size * 8 + b * (ns * 4 * 2 + 4))
            ops_ = CG_ITERS * b * (2 * ell_s.data.size + 10 * ns)
            t_b, t_o = moved / HBM_BW, ops_ / FP32_FLOPS
            t = dict(
                B=b, side=side, ms=cuda_ms(run, 3), graph_ms=graph_ms(run, 3),
                single_ms=single_ms, single_graph_ms=single_graph_ms,
                plain_ms=cuda_ms(lambda: [ref.cg_run(ds, cs, bs[i], CG_ITERS)
                                          for i in range(b)], 1),
                bound=(1e3 * max(t_b, t_o),
                       "bytes" if t_b >= t_o else "operations"),
                library_ms=None)
            if (side, b) == CG_LANES_MAIN:
                timing["cg_fused_batched"] = t
            print(f"  cg_fused B={b}: {json.dumps(t)}")

    # -- 15. the batched path, counted ----------------------------------------------
    print(f"[batch path] {card}: counters set to 0; every tier the planner "
          f"offers, batched against execute_sequential, per-instance ms")
    perks.clear_graphs()
    ops.reset_launch_counts()
    for cell, what, size, B, steps in BATCH_CELLS:
        # the instances share their step function (with_payload), so the
        # sequential device loop replays one kept graph, as the batch does
        if cell.startswith("stencil"):
            first = StencilProblem(vecs(1, math.prod(size)).view(size),
                                   get_spec(what), steps)
            insts = [first] + [first.with_payload(
                vecs(1, math.prod(size)).view(size)) for _ in range(B - 1)]
        else:
            csr = (poisson2d if what == "poisson2d" else convdiff2d)(size)
            ell = csr.to_ell()
            seed_rng = np.random.default_rng(SEED)
            rhs = [seed_rng.standard_normal(csr.shape[0]).astype(np.float32)
                   for _ in range(B)]
            kind = cell.split("-")[0]
            if kind == "cg":
                first = CGProblem.from_ell(ell.data, ell.cols, rhs[0], steps,
                                           matrix=csr)
            elif kind == "bicgstab":
                first = BiCGStabProblem.from_ell(ell.data, ell.cols, rhs[0],
                                                 steps, matrix=csr)
            else:
                first = GMRESProblem.from_ell(ell.data, ell.cols, rhs[0],
                                              steps, m=KRYLOV_M, matrix=csr)
            insts = [first] + [first.with_payload(
                torch.from_numpy(v).cuda()) for v in rhs[1:]]
        bp = BatchedProblem.from_instances(insts)
        # one batched step's launches against one single-instance step's
        n_launch = {}
        for what_, prob in (("batched", bp), ("single", insts[0])):
            state = prob.initial_state()
            bufs = tuple(torch.empty_like(t) for t in state) if isinstance(
                state, tuple) else torch.empty_like(state)
            before = ops.launch_counts()
            with LaunchCount() as lc:
                prob.step_fn()(state, bufs)
            torch.cuda.synchronize()
            ours = {k: v - before[k] for k, v in ops.launch_counts().items()
                    if v != before[k] and not k.endswith("_batched")}
            n_launch[what_] = (lc.n + sum(ours.values()), ours)
        want_n = (1 if cell.startswith("stencil") else
                  insts[0].step_launches())
        ok = n_launch["batched"][0] == n_launch["single"][0] == want_n
        print(f"  {cell}: launches of one step: batched B={B} "
              f"{n_launch['batched'][0]} (the port's kernels "
              f"{n_launch['batched'][1]}, the rest torch's), one instance "
              f"{n_launch['single'][0]} ({'ok' if ok else 'FAIL'})")
        if not ok:
            FAILS.append(f"{cell}: a batched step launched {n_launch}")
        cands = plan_candidates(bp)
        for p in cands:
            single = dataclasses.replace(p, batch=1, problem="")
            out = execute(bp, p)
            seq = execute_sequential(insts, single)
            good = all(same(f"{cell} {p.tier}/{p.policy} lane {i}", g, w)
                       for i, (g, w) in enumerate(zip(bp.split(out), seq)))
            ms = cuda_ms(lambda: execute(bp, p), 2)
            seq_ms = cuda_ms(lambda: execute_sequential(insts, single), 1)
            print("  " + json.dumps(dict(
                cell=cell, B=B, tier=p.tier, policy=p.policy,
                schedule=p.schedule, fuse_steps=p.fuse_steps,
                cached_rows=p.cached_rows, bit_equal=good, batched_ms=ms,
                per_instance_ms=ms / B,
                sequential_per_instance_ms=seq_ms / B,
                predicted_ms=1e3 * p.predicted_s)))
        perks.clear_graphs()
    launches = ops.launch_counts()
    print(f"[batch path] launches {json.dumps(launches)}")
    for k in BATCH_KERNELS:
        if launches[k] == 0:
            FAILS.append(f"{k} was not launched on the batched path")

    # -- 16. the service ------------------------------------------------------------
    print(f"[service] {card}: SolverService(max_batch=8), "
          f"{SERVICE_STENCILS} stencil requests (2d5pt {SERVICE_SHAPE} x "
          f"{SERVICE_STEPS}) and {SERVICE_CGS} CG requests (poisson2d(512), "
          f"{CG_ITERS} iterations, tol 1e-8) interleaved")
    reg = obs.MetricsRegistry()
    svc = SolverService(ServiceConfig(max_batch=8), metrics=reg)
    spec = get_spec("2d5pt")
    csr = poisson2d(512)
    ell = csr.to_ell()
    d = torch.from_numpy(ell.data).cuda()
    c = torch.from_numpy(ell.cols).cuda()
    reqs = {}
    for i in range(max(SERVICE_STENCILS, SERVICE_CGS)):
        if i < SERVICE_STENCILS:
            p = StencilProblem(vecs(1, math.prod(SERVICE_SHAPE)).view(
                SERVICE_SHAPE), spec, SERVICE_STEPS)
            reqs[svc.submit(p)] = p
        if i < SERVICE_CGS and i % 2 == 0:
            for _ in range(2):
                p = CGProblem.from_ell(d, c, vecs(1, d.shape[0])[0],
                                       CG_ITERS, matrix=csr, tol=1e-8)
                reqs[svc.submit(p)] = p
    perks.clear_graphs()
    with obs.use_metrics(reg):
        results = svc.drain()
    print(f"  stats {json.dumps(svc.stats())}")
    for key, p in svc.chosen_plans().items():
        print(f"  key {key[2][0]}: plan {p.to_json(indent=None)}")
    snap = reg.snapshot()
    caps = {k: v for k, v in snap.items()
            if k.startswith("service_graph_captures_total")}
    print(f"  graph captures per key: {json.dumps(caps)}")
    # the stencil key's batches: one kept graph for the key on the device
    # loop, none on the host loop or the resident tier (one launch a batch)
    stencil_plans = {(rr.plan.tier, rr.plan.schedule, rr.plan.fuse_steps,
                      rr.plan.cached_rows, rr.batch_size)
                     for rid, rr in results.items()
                     if reqs[rid].kind == "stencil"}
    print(f"  stencil batches (tier, schedule, t, cached rows, requests): "
          f"{json.dumps(sorted(stencil_plans))}")
    for k, v in caps.items():
        tiers = {t for t, *_ in stencil_plans}
        want = int(tiers == {"device_loop"})
        if "stencil" in k and v != want:
            FAILS.append(f"service key {k} on {tiers} captured {v} graphs, "
                         f"not {want}")
    n_same = 0
    for rid, p in reqs.items():
        rr = results[rid]
        alone = execute(p, dataclasses.replace(rr.plan, batch=1,
                                               problem=""))
        n_same += same(f"service request {rid} vs its own execute",
                       rr.result, alone)
    print(f"  {n_same} of {len(reqs)} results bit-equal to their own "
          f"execute")
    for ln in reg.prometheus_text().splitlines():
        if ln.startswith(("service_", "executor_")):
            print(f"  prom {ln}")
    perks.clear_graphs()

    # -- 17. tracing --------------------------------------------------------------------
    print(f"[obs] {card}: a traced execute against an untraced one")
    xs = vecs(1, 2048 * 2048).view(2048, 2048)
    sp = StencilProblem(xs, spec, 100)
    cp = CGProblem.from_ell(d, c, vecs(1, d.shape[0])[0], CG_ITERS,
                            matrix=csr, tol=1e-8)
    tr = obs.Tracer()
    for prob, p in ((sp, Plan(tier="device_loop")),
                    (sp, Plan(tier="host_loop")),
                    (cp, Plan(tier="host_loop", sync_every=25)),
                    (cp, Plan(tier="resident", policy="MIX"))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            base = execute(prob, p)
            with obs.use_tracer(tr):
                traced = execute(prob, p)
        same(f"traced execute {prob.name} {p.tier}", traced, base)
    doc = tr.to_chrome()
    print(f"  Chrome trace: {len(doc['traceEvents'])} events, by category "
          f"{json.dumps({k: len(tr.by_cat(k)) for k in obs.CATEGORIES})}")
    perks.clear_graphs()

    # -- 18. autotune ---------------------------------------------------------------------
    print(f"[autotune] {card}: autotune(top_k=4), median of 3 after 1 "
          f"warm-up, each candidate's predicted and measured ms")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ledger.json")
        for sname, shape, steps in AUTOTUNE:
            prob = StencilProblem(vecs(1, math.prod(shape)).view(shape),
                                  get_spec(sname), steps)
            led = obs.DriftLedger(path)
            res = autotune(prob, top_k=4, ledger=led)
            for row in res.table:
                print("  " + json.dumps(dict(
                    problem=obs.problem_key(prob),
                    plan=obs.plan_signature(row.plan),
                    predicted_ms=1e3 * row.predicted_s,
                    measured_ms=1e3 * row.measured_s,
                    ratio=row.prediction_ratio)))
            print(f"  {sname} {shape}: best "
                  f"{obs.plan_signature(res.best)}; planner's pick "
                  f"{obs.plan_signature(res.table[0].plan)}")
            perks.clear_graphs()      # the planner prices as it did first
            again = obs.DriftLedger(path)
            res2 = autotune(prob, top_k=4, ledger=again)
            print(f"  second autotune against the same ledger file: "
                  f"hits={again.hits} misses={again.misses}")
            if again.hits != len(res.table) or (obs.plan_signature(
                    res2.best) != obs.plan_signature(res.best)):
                FAILS.append(f"autotune {sname} measured again")
            perks.clear_graphs()
        drift = obs.DriftLedger(path).drift_report()
        print(f"  drift report (ratio beyond 4x): "
              f"{json.dumps([(r['plan_signature'], r['prediction_ratio']) for r in drift])}")
    return errs, timing, launches


def async_phase(rng):
    """[async service]: the continuous-batching engine serving a seeded
    Poisson arrival trace of stencil, CG, BiCGStab and GMRES requests, the
    synchronous service on the same trace, and a barrier's cost either way
    (the kept in-place chunk graph against ``LaneRunner.advance``)."""
    from repro_torch import obs
    from repro_torch.core import perks
    from repro_torch.exec import (BiCGStabProblem, CGProblem, GMRESProblem,
                                  LaneRunner, Plan, StencilProblem, execute)
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import get_spec
    from repro_torch.runtime.solver_service import (AsyncConfig,
                                                    AsyncSolverService,
                                                    ServiceConfig,
                                                    SolverService)
    from repro_torch.sparse.generate import convdiff2d, poisson2d

    card = card_line()
    n_bi, bi_side, bi_iters = ASYNC_BICGSTABS
    n_gm, gm_side, gm_cycles = ASYNC_GMRES
    print(f"[async service] {card}: AsyncSolverService(AsyncConfig("
          f"max_batch=8)).serve(trace): {SERVICE_STENCILS} stencil "
          f"(2d5pt {SERVICE_SHAPE} x {SERVICE_STEPS}), {SERVICE_CGS} CG "
          f"(poisson2d(512) x {CG_ITERS}, tol 1e-8), {n_bi} BiCGStab "
          f"(convdiff2d({bi_side}) x {bi_iters}, tol 1e-8) and {n_gm} "
          f"GMRES({KRYLOV_M}) (convdiff2d({gm_side}) x {gm_cycles} cycles, "
          f"tol 1e-8) requests, Poisson arrivals with a mean gap of "
          f"{ASYNC_MEAN_GAP_S * 1e3} ms")

    def vec(n):
        return torch.from_numpy(
            rng.standard_normal(n).astype(np.float32)).cuda()

    def operator(csr):
        ell = csr.to_ell()
        return (csr, torch.from_numpy(ell.data).cuda(),
                torch.from_numpy(ell.cols).cuda())

    spec = get_spec("2d5pt")
    cg_op, bi_op, gm_op = (operator(poisson2d(512)),
                           operator(convdiff2d(bi_side)),
                           operator(convdiff2d(gm_side)))
    problems = (
        [StencilProblem(vec(math.prod(SERVICE_SHAPE)).view(SERVICE_SHAPE),
                        spec, SERVICE_STEPS)
         for _ in range(SERVICE_STENCILS)]
        + [CGProblem.from_ell(cg_op[1], cg_op[2], vec(cg_op[0].shape[0]),
                              CG_ITERS, matrix=cg_op[0], tol=1e-8)
           for _ in range(SERVICE_CGS)]
        + [BiCGStabProblem.from_ell(bi_op[1], bi_op[2],
                                    vec(bi_op[0].shape[0]), bi_iters,
                                    matrix=bi_op[0], tol=1e-8)
           for _ in range(n_bi)]
        + [GMRESProblem.from_ell(gm_op[1], gm_op[2], vec(gm_op[0].shape[0]),
                                 gm_cycles, m=KRYLOV_M, matrix=gm_op[0],
                                 tol=1e-8)
           for _ in range(n_gm)])
    order = np.random.default_rng(SEED).permutation(len(problems))
    offsets = np.cumsum(np.random.default_rng(SEED + 1).exponential(
        ASYNC_MEAN_GAP_S, size=len(problems))).tolist()
    trace = [(t, problems[i]) for t, i in zip(offsets, order)]

    def pcts(rrs, busy_s):
        """p50/p99 of a pass's queued, latency and exec seconds (the
        registry's nearest-rank rule) and its instances a busy second."""
        out = {}
        for name in ("queued", "latency", "exec"):
            h = obs.Histogram()
            for rr in rrs:
                h.observe(getattr(rr, f"{name}_s"))
            out[f"p50_{name}_s"] = h.percentile(0.50)
            out[f"p99_{name}_s"] = h.percentile(0.99)
        out["instances_per_s"] = len(rrs) / busy_s
        return out

    def drives(tr):
        """Each key's drives (host ms, the card waited for): the first,
        which captures the key's chunk graph, and the sum of the rest."""
        by_key = {}
        for e in tr.events:
            if e.ph == "X" and e.name.startswith("drive:"):
                by_key.setdefault(e.name[6:], []).append(e.dur_us / 1e3)
        return {k: dict(first_ms=v[0], later_ms=sum(v[1:]), drives=len(v))
                for k, v in by_key.items()}

    perks.clear_graphs()
    ops.reset_launch_counts()
    reg = obs.MetricsRegistry()
    tr = obs.Tracer()
    eng = AsyncSolverService(AsyncConfig(max_batch=8), metrics=reg,
                             tracer=tr)
    with obs.use_metrics(reg):
        results = eng.serve(trace)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"  launches {json.dumps({k: v for k, v in launches.items() if v})}")
    for k in ("stencil_baseline_step_batched", "spmv_ell_batched", "vdot"):
        if launches[k] == 0:
            FAILS.append(f"{k} was not launched on the async service path")
    stats = eng.stats()
    print(f"  stats {json.dumps(stats)}")
    caps = eng.graph_captures()
    print(f"  admitted mid-solve {stats['admitted_mid_solve']!r}, barriers "
          f"{stats['barriers']!r}, groups {stats['groups']!r}, retired "
          f"early {stats['retired_early']!r}; graph captures a key "
          f"{json.dumps(caps)}; busy ms a barrier "
          f"{1e3 * stats['busy_s'] / max(1, stats['barriers'])!r}")
    for key, p in eng.chosen_plans().items():
        print(f"  key {key[0]}: plan {p.to_json(indent=None)}")
    if len(caps) != 4 or set(caps.values()) != {1}:
        FAILS.append(f"async service graph captures a key {caps}, not one")
    if stats["admitted_mid_solve"] < 1:
        FAILS.append("async service admitted no lane mid-solve")
    if len(results) != len(problems):
        FAILS.append(f"async service served {len(results)} of "
                     f"{len(problems)} requests")
    n_same = 0
    for rid, (_, p) in enumerate(trace):
        rr = results.get(rid)
        if rr is None:
            continue
        alone = execute(p, Plan(tier="device_loop",
                                sync_every=rr.plan.sync_every))
        got = rr.result if isinstance(rr.result, tuple) else (rr.result,)
        want = alone if isinstance(alone, tuple) else (alone,)
        if all(torch.equal(g, w) for g, w in zip(got, want)):
            n_same += 1
        else:
            print(f"  async request {rid} ({p.kind}): not bit-equal to its "
                  f"run alone FAIL")
            FAILS.append(f"async request {rid} is not bit-equal")
    print(f"  {n_same} of {len(problems)} results bit-equal to their run "
          f"alone (device_loop at the engine's cadence)")
    for ln in reg.prometheus_text().splitlines():
        if ln.startswith("async_") and "_bucket" not in ln:
            print(f"  prom {ln}")
    perks.clear_graphs()

    # the same trace again on the warm engine: its programs and graphs are
    # kept, so it captures nothing, and every result is the first pass's
    busy = stats["busy_s"]
    again = eng.serve(trace)
    torch.cuda.synchronize()
    warm = eng.stats()
    if eng.graph_captures() != caps:
        FAILS.append(f"the warm async pass captured: {eng.graph_captures()}")
    first = sorted(results)
    for rid, rid0 in zip(sorted(again), first):
        got, want = again[rid].result, results[rid0].result
        if not all(torch.equal(g, w) for g, w in zip(
                got if isinstance(got, tuple) else (got,),
                want if isinstance(want, tuple) else (want,))):
            FAILS.append(f"warm async request {rid} differs from its first "
                         f"pass")
    async_warm = pcts(list(again.values()), warm["busy_s"] - busy)
    print(f"  drives by key (host ms; the first is the cold activation, the "
          f"later ones include the warm pass): {json.dumps(drives(tr))}")
    perks.clear_graphs()

    # the synchronous service on the same trace, twice: a batch whenever
    # requests wait, arrivals submitted as they come due
    svc_tr = obs.Tracer()
    svc = SolverService(ServiceConfig(max_batch=8), tracer=svc_tr)

    def replay_sync():
        t0, i, out = time.perf_counter(), 0, {}
        while i < len(trace) or svc.pending():
            now = time.perf_counter() - t0
            while i < len(trace) and trace[i][0] <= now:
                svc.submit(trace[i][1])
                i += 1
            if svc.pending():
                out.update(svc.run_batch())
            elif i < len(trace):
                time.sleep(min(trace[i][0] - now, 0.001))
        return out

    sync_out = replay_sync()
    sync = svc.stats()
    sync_again = replay_sync()
    sync_warm = pcts(list(sync_again.values()),
                     svc.stats()["exec_s_total"] - sync["exec_s_total"])
    batches = {}
    for e in svc_tr.events:
        if e.ph == "X" and e.name.startswith("serve_batch:"):
            batches.setdefault(e.name[12:], []).append(round(
                e.dur_us / 1e3, 3))
    print(f"  SolverService batches by key (host ms, both passes): "
          f"{json.dumps(batches)}")
    print(f"  SolverService plans: " + json.dumps(
        {k[2][0]: (p.tier, p.sync_every) for k, p in
         svc.chosen_plans().items()}))
    keys = ("p50_queued_s", "p99_queued_s", "p50_latency_s",
            "p99_latency_s", "p50_exec_s", "p99_exec_s", "instances_per_s")
    print("  " + json.dumps(dict(
        engine="AsyncSolverService", passes="first",
        **{k: stats[k] for k in keys})))
    print("  " + json.dumps(dict(
        engine="SolverService", passes="first", batches=sync["batches"],
        **{k: sync[k] for k in keys})))
    print("  " + json.dumps(dict(engine="AsyncSolverService",
                                 passes="second (warm)", **async_warm)))
    print("  " + json.dumps(dict(engine="SolverService",
                                 passes="second (warm)", **sync_warm)))
    perks.clear_graphs()

    # a barrier's cost: one chunk of each key's full lane group through the
    # kept in-place graph, and through LaneRunner.advance (the device
    # loop's kept graph, the state copied in, cloned out and copied back)
    for p in (problems[0], problems[SERVICE_STENCILS],
              problems[SERVICE_STENCILS + SERVICE_CGS], problems[-1]):
        chunk = eng.chosen_plans()[p.batch_key()].sync_every
        runner = LaneRunner(p, 8)
        lanes = runner.fresh()
        for lane in range(8):
            runner.admit(lanes, lane, p)
        carry = runner.carry(lanes)
        state_mb = sum(t.numel() * t.element_size() for t in carry) / 1e6
        kept = perks.InPlaceChunk(runner.step_fn(), chunk)
        in_place = cuda_ms(lambda: kept(carry), 10)
        copied = cuda_ms(lambda: runner.advance(lanes, chunk), 10)
        print("  " + json.dumps(dict(
            barrier=p.kind, chunk_steps=chunk, lane_state_mb=state_mb,
            in_place_ms=in_place, advance_ms=copied,
            copies_ms=copied - in_place,
            three_passes_bound_ms=3 * 2 * state_mb / 3.35e6 * 1e3)))
        kept.release()
        perks.clear_graphs()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import Plan, StencilProblem, execute, plan
    from repro_torch.core import perks
    from repro_torch.core.hardware import device_chip
    from repro_torch.core.cache_policy import gm_bytes_deep, gm_bytes_fused
    from repro_torch.exec import plan_candidates
    from repro_torch.exec.adapters import fit_stencil_plan
    from repro_torch.exec.planner import stencil_model_bytes, stencil_model_s
    from repro_torch.kernels import _build, ops, ref, stencil2d
    from repro_torch.kernels.common import BENCHMARKS, get_spec
    from repro_torch.kernels.stencil3d import plan_resident_planes

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    rng = np.random.default_rng(SEED)

    def domain(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).cuda()

    # -- 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"[build] {json.dumps(secs)} total {time.perf_counter() - t0:.2f} s")
    for name in _build.SOURCES:
        log = _build.build_log(name).read_text()
        print("\n".join(f"  {name}: {ln.strip()}" for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln))

    # -- 2. kernels against their plain versions ----------------------------------
    errs = {k: 0.0 for k in STENCIL_KERNELS}
    bf16_errs = {k: 0.0 for k in STENCIL_KERNELS}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    limit = (torch.cuda.get_device_properties(0).shared_memory_per_block_optin
             - stencil2d.PERKS_STATIC_SMEM)

    def keep(table, k, e):
        table[k] = max(table[k], e)

    def fits(x, spec, t, R, deep):
        """Whether csrc/stencil_tb.cu holds this layout in one CTA."""
        return stencil2d.tb_layout(tuple(x.shape), spec.radius, t,
                                   x.element_size(), deep=deep, ctas=sms,
                                   limit=limit, cached_rows=R) is not None

    def blocked(x, spec, steps, R, table, tol, tag):
        """stencil_perks at t = 2, 4 and stencil_perks_deep at t = 2, 8,
        32 against the plain version; a layout that does not fit is
        listed."""
        want = ref.stencil_run(x, spec, steps)
        for kname, fn, depths in (
                ("stencil_perks_fused", ops.stencil_perks, (2, 4)),
                ("stencil_perks_deep", ops.stencil_perks_deep, (2, 8, 32))):
            for t in depths:
                what = (f"{spec.name} {tag} {kname} t={t} cached_rows={R}")
                if not fits(x, spec, t, R, kname.endswith("deep")):
                    print(f"  {what}: the layout does not fit one CTA "
                          f"({limit} B); not run")
                    continue
                got = fn(x, spec=spec, steps=steps, cached_rows=R,
                         sub_rows=max(128, spec.radius * t), fuse_steps=t)
                keep(table, kname, check_close(what, got, want, 0.0, tol))
                if kname == "stencil_perks_deep":
                    bit_equal(what, got, want)

    def one_step(x, spec, steps, R, want, table, tol, tag):
        """The one-step kernel against the plain version, bit for bit where
        rows stream (0 < R < H)."""
        what = f"{spec.name} {tag} stencil_perks cached_rows={R}"
        got = ops.stencil_perks(x, spec=spec, steps=steps, cached_rows=R)
        keep(table, "stencil_perks", check_close(what, got, want, 0.0, tol))
        if 0 < R < x.shape[0]:
            bit_equal(what, got, want)

    fed = (ops.launch_counts()["stencil_perks"],
           ops.launch_counts()["stencil_perks_window"])
    print(f"[kernels] all specs, moderate size, 7 steps (odd); temporal "
          f"blocking {TB_STEPS} steps")
    for name, spec in BENCHMARKS.items():
        shape = (256, 384) if spec.ndim == 2 else (48, 40, 56)
        x = domain(shape)
        want = ref.stencil_run(x, spec, 7)
        H = shape[0]
        for R in (0, 4 * spec.radius + 1, H // 2, H):
            one_step(x, spec, 7, R, want, errs, ATOL, "f32")
        keep(errs, "stencil_resident", check(
            f"{name} stencil_resident",
            ops.stencil_resident(x, spec=spec, steps=7), want))
        keep(errs, "stencil_baseline_step", check(
            f"{name} stencil_baseline_step",
            ops.stencil_baseline_step(x, spec=spec), ref.stencil_step(x, spec)))
        for R in (0, 4 * spec.radius + 1):
            blocked(x, spec, TB_STEPS, R, errs, ATOL, "f32")

    print(f"[kernels] bf16, all specs, moderate size, 7 steps; temporal "
          f"blocking {TB_STEPS} steps; atol {BF16_ATOL}")
    for name, spec in BENCHMARKS.items():
        shape = (256, 384) if spec.ndim == 2 else (48, 40, 56)
        x = domain(shape).to(torch.bfloat16)
        want = ref.stencil_run(x, spec, 7)
        R = 4 * spec.radius + 1
        for kname, got, w in (
                ("stencil_baseline_step", ops.stencil_baseline_step(
                    x, spec=spec), ref.stencil_step(x, spec)),
                ("stencil_resident", ops.stencil_resident(
                    x, spec=spec, steps=7), want)):
            keep(bf16_errs, kname, check_close(f"{name} bf16 {kname}", got, w,
                                               0.0, BF16_ATOL))
        for R1 in (R, shape[0] // 2):
            one_step(x, spec, 7, R1, want, bf16_errs, BF16_ATOL, "bf16")
        blocked(x, spec, TB_STEPS, R, bf16_errs, BF16_ATOL, "bf16")
    print(f"[kernels] bf16 max_abs_err {json.dumps(bf16_errs)}")

    print("[kernels] the one-step kernel's boxes: 3D planes wider than a "
          "CTA's registers hold, 5 steps, bit for bit")
    for name, shape in WIDE:
        spec = get_spec(name)
        for dt, table, tol in ((torch.float32, errs, ATOL),
                               (torch.bfloat16, bf16_errs, BF16_ATOL)):
            x = domain(shape).to(dt)
            want = ref.stencil_run(x, spec, 5)
            cap = stencil2d.perks_cached_rows(shape, spec.radius,
                                              x.element_size(), sms, limit)
            for R in (cap, max(spec.radius, cap // 2)):
                lay = stencil2d.perks_layout(shape, spec.radius,
                                             x.element_size(), sms, limit, R)
                print(f"  {name} {shape} {dt} cached_rows={R}: {lay}")
                if lay is None or lay.nby < 2:
                    FAILS.append(f"{name} {shape} {dt}: {R} cached planes "
                                 f"are not cut into boxes: {lay}")
                    continue
                one_step(x, spec, 5, R, want, table, tol, f"{dt} boxes")
    fed = (ops.launch_counts()["stencil_perks"] - fed[0],
           ops.launch_counts()["stencil_perks_window"] - fed[1])
    print(f"[kernels] one-step launches {fed[0]}, fed by bulk copies {fed[1]}")
    if fed[0] != fed[1]:
        FAILS.append(f"{fed[0] - fed[1]} of {fed[0]} one-step launches at "
                     f"moderate size did not feed their window by bulk "
                     f"copies")

    print("[kernels] main-path shapes")
    timing = {}
    main_inputs = []
    for spec_name, shape, n, caching in MAIN:
        spec = get_spec(spec_name)
        x = domain(shape)
        problem = StencilProblem(x, spec, n)
        best = plan(problem)
        cands = plan_candidates(problem)
        one = next(c for c in cands if c.tier == "resident"
                   and c.fuse_steps == 1 and c.schedule == "shallow")
        want = ref.stencil_run(x, spec, n)
        main_inputs.append((problem, best, one, cands, want))
        plain_ms = cuda_ms(lambda: ref.stencil_run(x, spec, n), 3)
        dom = x.numel() * x.element_size()
        row = dom // shape[0]
        if caching == "whole":
            kname = "stencil_resident"
            run = lambda: ops.stencil_resident(x, spec=spec, steps=n)
        else:
            kname, R = "stencil_perks", one.cached_rows
            run = lambda: ops.stencil_perks(x, spec=spec, steps=n, cached_rows=R)
        copied = ops.launch_counts()["stencil_resident_async"]
        keep(errs, kname, check(
            f"{kname} {shape} {n} steps cached_rows={one.cached_rows}",
            run(), want))
        if (kname == "stencil_resident"
                and ops.launch_counts()["stencil_resident_async"] == copied):
            FAILS.append(f"stencil_resident {shape} did not copy its halo "
                         f"rows by cp.async")
        # bytes it must move: Eq. 5 at the plan's cached rows (the streamed
        # rows twice a step, the cached ones once in all); with every row
        # cached that is the domain read once and written once
        moved = gm_bytes_fused(n, dom, one.cached_rows * row, row_bytes=row,
                               radius=spec.radius, fuse_steps=1)
        t = dict(ms=cuda_ms(run, 5), plain_ms=plain_ms,
                 bound=bound(spec, shape, n, moved), library_ms=None)
        if caching == "boxes":
            # the one-step plan on the 3D cell: its own line
            print("  stencil_perks 3D one-step plan: " + json.dumps(dict(
                shape=shape, n_steps=n, cached_rows=R,
                cached_bytes=R * row, ms=t["ms"], bound_ms=t["bound"][0],
                bound_by=t["bound"][1],
                cells_per_s=math.prod(shape) * n / (t["ms"] / 1e3),
                planner_ms=1e3 * stencil_model_s(problem, one)[0])))
            if R == 0:
                FAILS.append(f"the one-step plan on {shape} caches nothing")
            continue
        timing[kname] = t
        step = lambda: ops.stencil_baseline_step(x, spec=spec)
        keep(errs, "stencil_baseline_step", check(
            f"stencil_baseline_step {shape}", step(), ref.stencil_step(x, spec)))
        if caching != "partial":
            continue
        timing["stencil_baseline_step"] = dict(
            ms=cuda_ms(step, 20),
            plain_ms=cuda_ms(lambda: ref.stencil_step(x, spec), 10),
            bound=bound(spec, shape, 1, 2 * x.numel() * x.element_size()),
            library_ms=cuda_ms(conv_step(spec, x), 20))
        # the temporally blocked kernels at the planner's cached rows: the
        # fused one at FUSED_T, the deep one at DEEP_T
        for kname, fn, t, sched in (
                ("stencil_perks_fused", ops.stencil_perks, FUSED_T, "shallow"),
                ("stencil_perks_deep", ops.stencil_perks_deep, DEEP_T, "deep")):
            R = plan_resident_planes(shape, x.element_size(), spec,
                                     fuse_steps=t, schedule=sched)
            run = lambda: fn(x, spec=spec, steps=n, cached_rows=R, fuse_steps=t)
            tma = ops.launch_counts()["stencil_perks_deep_tma"]
            fed = ops.launch_counts()["stencil_perks_fused_async"]
            got = run()
            keep(errs, kname, check(f"{kname} {shape} {n} steps t={t} "
                                    f"cached_rows={R}", got, want))
            if sched == "deep":
                bit_equal(f"{kname} {shape}", got, want)
                if ops.launch_counts()["stencil_perks_deep_tma"] == tma:
                    FAILS.append(f"{kname} {shape} did not load level 0 "
                                 f"by TMA")
            elif ops.launch_counts()["stencil_perks_fused_async"] == fed:
                FAILS.append(f"{kname} {shape} did not copy its tiles by "
                             f"cp.async")
            least = (gm_bytes_deep(n, dom, R * row, fuse_steps=t)
                     if sched == "deep" else
                     gm_bytes_fused(n, dom, R * row, row_bytes=row,
                                    radius=spec.radius, fuse_steps=t))
            timing[kname] = dict(ms=cuda_ms(run, 3), plain_ms=plain_ms,
                                 bound=bound(spec, shape, n, least),
                                 library_ms=None, fuse_steps=t, cached_rows=R)
            print(f"  {kname}: {json.dumps(timing[kname])}")

    # -- 3. the main path, counted ------------------------------------------------
    print("[main path] counters set to 0")
    perks.clear_graphs()
    ops.reset_launch_counts()
    for problem, best, one, cands, want in main_inputs:
        shape = tuple(problem.x.shape)
        print(f"  plan {shape}: {best.to_json(indent=None)}")
        # the device loop twice: the second run replays the kept graph
        runs = [best, Plan(tier="host_loop"), Plan(tier="device_loop"),
                Plan(tier="device_loop"), one]
        if shape == MAIN[0][1]:
            runs += [c for c in cands if c.tier == "resident" and (
                (c.schedule, c.fuse_steps) in (("shallow", FUSED_T),
                                               ("deep", DEEP_T), ("deep", 32)))]
            runs += [Plan.from_json(j) for j in REFERENCE_PLANS]
        for p in runs:
            replay = p.tier == "device_loop" and perks.graph_cached(
                problem.step_fn(), problem.x, problem.n_steps)
            before = ops.launch_counts()
            y = execute(problem, p)
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in ops.launch_counts().items()
                     if v != before[k]}
            check(f"execute {shape} {p.tier} {p.schedule} t={p.fuse_steps} "
                  f"cached_rows={p.cached_rows} chip={p.chip} "
                  f"replay={replay} launches={delta}", y, want)
            if replay and delta:
                FAILS.append(f"device_loop replay on {shape} launched {delta}")
            # the redesigned kernels, known by the route only they take
            if (p.tier == "resident" and p.cached_rows == shape[0]
                    and delta.get("stencil_resident_async") != 1):
                FAILS.append(f"the resident run on {shape} did not launch "
                             f"csrc/stencil_resident.cu with cp.async halo "
                             f"rows: {delta}")
            if (p.tier == "resident" and p.schedule == "shallow"
                    and p.fuse_steps == FUSED_T and p.cached_rows < shape[0]
                    and delta.get("stencil_perks_fused_async") != 1):
                FAILS.append(f"the shallow t={FUSED_T} plan on {shape} did "
                             f"not launch csrc/stencil_shallow.cu with "
                             f"cp.async tiles: {delta}")
    # the JAX package's plans the card cannot hold as they are: fitted, one
    # RuntimeWarning each, the plain version's bits
    for text, name, shape, n in FIT_PLANS:
        spec = get_spec(name)
        x = domain(shape)
        problem = StencilProblem(x, spec, n)
        p = Plan.from_json(text)
        fitted, why = fit_stencil_plan(shape, x.element_size(), spec, p,
                                       device_chip())
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            before = ops.launch_counts()
            y = execute(problem, p)
            torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in ops.launch_counts().items()
                 if v != before[k]}
        warned = [str(w.message) for w in caught
                  if issubclass(w.category, RuntimeWarning)]
        bit_equal(f"execute {shape} {name} reference plan {p.schedule} "
                  f"t={p.fuse_steps} cached_rows={p.cached_rows} -> "
                  f"{fitted.schedule} t={fitted.fuse_steps} "
                  f"cached_rows={fitted.cached_rows} launches={delta}", y,
                  ref.stencil_run(x, spec, n))
        print(f"  warned: {warned}")
        if len(warned) != 1 or why is None:
            FAILS.append(f"the reference plan on {name} {shape} gave "
                         f"{len(warned)} RuntimeWarnings: {warned}")
        del x, y, problem
    launches = ops.launch_counts()
    print(f"[main path] launches {json.dumps(launches)}")
    if launches["stencil_perks_window"] != launches["stencil_perks"]:
        FAILS.append(f"stencil_perks fed its window by bulk copies in "
                     f"{launches['stencil_perks_window']} of its "
                     f"{launches['stencil_perks']} main-path launches")
    for k in STENCIL_KERNELS:
        if launches[k] == 0:
            FAILS.append(f"{k} was not launched on the stencil path")
    if launches["stencil_perks_deep_tma"] != launches["stencil_perks_deep"]:
        FAILS.append(f"stencil_perks_deep loaded level 0 by TMA in "
                     f"{launches['stencil_perks_deep_tma']} of its "
                     f"{launches['stencil_perks_deep']} main-path launches")
    b_big, b_small, _ = (best for _, best, _, _, _ in main_inputs)
    H_big, H_small = MAIN[0][1][0], MAIN[1][1][0]
    if not (b_big.tier == "resident" and b_big.cached_rows < H_big):
        FAILS.append(f"8192x8192 plan is not a streaming resident plan: "
                     f"{b_big}")
    if not (b_small.tier == "resident" and b_small.cached_rows == H_small):
        FAILS.append(f"3072x1152 plan does not cache the domain: {b_small}")

    # -- 4. tier timing (not counted) ------------------------------------------------
    print("[tiers] median ms over 3 runs (the device loop's graph kept after "
          "the first, which is timed alone as first_ms)")
    for problem, best, one, _, _ in main_inputs:
        shape, n = tuple(problem.x.shape), problem.n_steps
        dom = problem.domain_bytes()
        row_bytes = dom // shape[0]
        tiers = {}
        for p in (Plan(tier="host_loop"), Plan(tier="device_loop"), one, best):
            first = None
            if p.tier == "device_loop":
                perks.clear_graphs()
                first = cuda_ms(lambda: execute(problem, p), 0)
            ms = cuda_ms(lambda: execute(problem, p), 3)
            tiers[f"{p.tier}/{p.schedule}/{p.fuse_steps}"] = ms
            print("  " + json.dumps(dict(
                shape=shape, n_steps=n, tier=p.tier, schedule=p.schedule,
                fuse_steps=p.fuse_steps, cached_rows=p.cached_rows, ms=ms,
                first_ms=first,
                cells_per_s=math.prod(shape) * n / (ms / 1e3),
                effective_GBps=2 * dom * n / (ms / 1e3) / 1e9,
                effective_share_of_3350GBps=2 * dom * n / (ms / 1e3) / HBM_BW,
                model_bytes=stencil_model_bytes(problem, p),
                model_ms=1e3 * stencil_model_bytes(problem, p) / HBM_BW,
                predicted_ms=1e3 * p.predicted_s if p.predicted_s else None)))
        print(f"  {shape}: planner chose {best.tier}/{best.schedule}/"
              f"{best.fuse_steps} (predicted with no graph kept); fastest "
              f"measured: {min(tiers, key=tiers.get)}; planner now: "
              f"{plan(problem).tier}")
        # every other candidate, beside its price
        for p in plan_candidates(problem):
            key = f"{p.tier}/{p.schedule}/{p.fuse_steps}"
            if key in tiers:
                continue
            tiers[key] = cuda_ms(lambda: execute(problem, p), 2)
            print("  " + json.dumps(dict(
                shape=shape, n_steps=n, candidate=key,
                cached_rows=p.cached_rows, ms=tiers[key],
                predicted_ms=1e3 * p.predicted_s,
                bound=p.predicted_bound)))
        pick = f"{best.tier}/{best.schedule}/{best.fuse_steps}"
        fastest = min(tiers, key=tiers.get)
        print("  " + json.dumps(dict(
            shape=shape, pick=pick, pick_ms=tiers[pick], fastest=fastest,
            fastest_ms=tiers[fastest],
            pick_over_fastest=tiers[pick] / tiers[fastest],
            pick_predicted_ms=1e3 * best.predicted_s)))
        perks.clear_graphs()
    tiny = StencilProblem(domain((64, 64)), get_spec("2d5pt"), 1000)
    per_launch = cuda_ms(lambda: execute(tiny, Plan(tier="host_loop")), 3)
    print(f"[tiers] host_loop on 64x64, 1000 steps: {per_launch / 1000 * 1e3!r} "
          f"us per step (launch overhead)")

    print("[depths] each temporal-blocking depth, median ms over 2 runs; "
          "model = the port's byte model of its kernel, least = "
          "gm_bytes_deep; then the loop tiers and the planner's pick "
          "against the fastest of them all")
    for spec_name, shape, n in SWEEP:
        spec = get_spec(spec_name)
        x = domain(shape)
        problem = StencilProblem(x, spec, n)
        best = plan(problem)
        want = ref.stencil_run(x, spec, n)
        dom = x.numel() * x.element_size()
        swept = {}
        for sched, t in DEPTHS:
            if t > 1 and stencil2d.tb_cached_rows(
                    shape, spec.radius, t, x.element_size(),
                    deep=sched == "deep", ctas=sms, limit=limit) is None:
                print(f"  {shape} {sched} t={t}: the layout does not fit "
                      f"one CTA; not run")
                continue
            R = plan_resident_planes(shape, x.element_size(), spec,
                                     fuse_steps=t, schedule=sched)
            p = Plan(tier="resident", schedule=sched, fuse_steps=t,
                     cached_rows=R, n_steps=n)
            check(f"execute {shape} {sched} t={t} cached_rows={R}",
                  execute(problem, p), want)
            ms = cuda_ms(lambda: execute(problem, p), 2)
            swept[f"resident/{sched}/{t}"] = ms
            model = stencil_model_bytes(problem, p)
            model_s, model_by = stencil_model_s(problem, p)
            least = gm_bytes_deep(n, dom, R * (dom // shape[0]), fuse_steps=t)
            if t == 1 and len(shape) == 3 and R == 0:
                FAILS.append(f"the one-step plan on {shape} caches nothing")
            print("  " + json.dumps(dict(
                shape=shape, spec=spec_name, n_steps=n, schedule=sched,
                fuse_steps=t, cached_rows=R, cached_bytes=R * (dom // shape[0]),
                bound_ms=bound(spec, shape, n, least)[0], ms=ms,
                cells_per_s=math.prod(shape) * n / (ms / 1e3),
                model_bytes=model, model_ms=1e3 * model / HBM_BW,
                least_bytes=least, model_GBps=model / (ms / 1e3) / 1e9,
                share_of_model_bound=1e3 * model / HBM_BW / ms,
                planner_ms=1e3 * model_s, planner_bound=model_by)))
        for p in (Plan(tier="host_loop"), Plan(tier="device_loop")):
            perks.clear_graphs()
            swept[f"{p.tier}/shallow/1"] = cuda_ms(
                lambda: execute(problem, p), 2)
        perks.clear_graphs()
        pick = f"{best.tier}/{best.schedule}/{best.fuse_steps}"
        fastest = min(swept, key=swept.get)
        print("  " + json.dumps(dict(
            shape=shape, spec=spec_name, host_loop_ms=swept[
                "host_loop/shallow/1"], device_loop_ms=swept[
                "device_loop/shallow/1"], pick=pick, pick_ms=swept.get(pick),
            pick_predicted_ms=1e3 * best.predicted_s, fastest=fastest,
            fastest_ms=swept[fastest],
            pick_over_fastest=(swept[pick] / swept[fastest]
                               if pick in swept else None))))

    # -- 5-7. the CG path ------------------------------------------------------------
    cg_errs, cg_timing, cg_launches = cg_phases(rng)

    # -- 8-10. the Krylov path ------------------------------------------------------------
    kr_errs, kr_timing, kr_launches = krylov_phases(rng)

    # -- 11-13. the ML kernels, the SSD scan path and the serving path ---------------
    ml_errs, ml_timing, ml_launches = ml_phases(rng)

    # -- 13b. the SSM and hybrid families served --------------------------------------
    ss_errs, ss_timing, ss_launches = ssm_serve_phase(rng)
    ml_errs["decode_attention"] = max(ml_errs["decode_attention"],
                                      ss_errs["decode_attention"])

    # -- 14-18. batched launches and path, the service, tracing, autotune -------------
    b_errs, b_timing, b_launches = batch_phases(rng)

    # -- 16b. the continuous-batching service -------------------------------------------
    async_phase(rng)

    # -- 19. the step kernel on every spec ---------------------------------------------
    s_errs, s_timing, s_launches = step_spec_phase(rng)

    # -- 20. report -------------------------------------------------------------------
    kernels = []
    for table, e, tm, ln in ((STENCIL_KERNELS, errs, timing, launches),
                             (step_spec_kernels(), s_errs, s_timing,
                              s_launches),
                             (CG_KERNELS, cg_errs, cg_timing, cg_launches),
                             (KRYLOV_KERNELS, kr_errs, kr_timing,
                              kr_launches),
                             (ML_KERNELS, ml_errs, ml_timing, ml_launches),
                             (SSM_STATE_KERNEL, ss_errs, ss_timing,
                              ss_launches),
                             (BATCH_KERNELS, b_errs, b_timing, b_launches)):
        for k, (source, replaces) in table.items():
            t = tm[k]
            kernels.append(dict(
                name=k, route="cuda", source=source, replaces=replaces,
                launches=ln[k], max_abs_err=e[k], ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
                bound_by=t["bound"][1], library_ms=t["library_ms"],
                graph_ms=t.get("graph_ms")))
    print(json.dumps({"kernels": kernels}))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(card.stdout.strip().splitlines()[0])
    if FAILS:
        print("chip_smoke FAILED:\n  " + "\n  ".join(FAILS), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
