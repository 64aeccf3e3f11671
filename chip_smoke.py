"""Drive the PyTorch/CUDA port's stencil main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together) and print the build seconds;
2. hold each kernel against its plain torch version on the card, at
   atol 5e-6, rtol 0: all 13 Table-III specs at a moderate size, then each
   kernel at the main path's full shapes, with its time, its plain
   version's time and (for the one-step kernel) a cuDNN convolution's;
3. the main path, with every launch counter set to 0 just before and read
   just after: ``StencilProblem`` -> ``plan`` -> ``execute`` for 2d5pt at
   8192x8192 f32 (100 steps; partial caching, ``stencil_perks``) and at
   3072x1152 f32 (1000 steps; whole domain cached, ``stencil_resident``),
   then every tier by hand; each result against the plain version;
4. each tier's median time, cells/s and effective bandwidth;
5. one ``{"kernels": [...]}`` line, the card's name and power limit, and
   ``{"ok": true, "device": {...}}`` as the last line.

Without a CUDA device it prints no result and exits non-zero.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ATOL = 5e-6              # the reference's kernel bound (tests/test_deep_blocking.py)
HBM_BW = 3.35e12         # H100 SXM device memory, bytes/s (NVIDIA data sheet)
FP32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores, FLOP/s
SEED = 0
MAIN = [  # (spec, shape, n_steps, what caching the plan must choose)
    ("2d5pt", (8192, 8192), 100, "partial"),
    ("2d5pt", (3072, 1152), 1000, "whole"),
]
KERNELS = {
    "stencil_perks": ("src/repro_torch/kernels/csrc/stencil_perks.cu",
                      "src/repro/kernels/stencil2d.py:203"),
    "stencil_resident": ("src/repro_torch/kernels/csrc/stencil_perks.cu",
                         "src/repro/kernels/stencil2d.py:540"),
    "stencil_baseline_step": ("src/repro_torch/kernels/csrc/stencil_step.cu",
                              "src/repro/kernels/stencil2d.py:566"),
}

FAILS: list[str] = []


def check(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = (got - want).abs().max().item()
    ok = got.shape == want.shape and bool(torch.isfinite(got).all()) \
        and err <= ATOL
    print(f"  {what}: max_abs_err={err!r} {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILS.append(what)
    return err


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import Plan, StencilProblem, execute, plan
    from repro_torch.core import perks
    from repro_torch.core.cache_policy import gm_bytes_fused
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.common import BENCHMARKS, get_spec

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
    errs = {k: 0.0 for k in KERNELS}
    print("[kernels] all specs, moderate size, 7 steps (odd)")
    for name, spec in BENCHMARKS.items():
        shape = (256, 384) if spec.ndim == 2 else (48, 40, 56)
        x = domain(shape)
        want = ref.stencil_run(x, spec, 7)
        H = shape[0]
        for R in (0, 4 * spec.radius + 1, H):
            errs["stencil_perks"] = max(errs["stencil_perks"], check(
                f"{name} stencil_perks cached_rows={R}",
                ops.stencil_perks(x, spec=spec, steps=7, cached_rows=R), want))
        errs["stencil_resident"] = max(errs["stencil_resident"], check(
            f"{name} stencil_resident",
            ops.stencil_resident(x, spec=spec, steps=7), want))
        errs["stencil_baseline_step"] = max(errs["stencil_baseline_step"], check(
            f"{name} stencil_baseline_step",
            ops.stencil_baseline_step(x, spec=spec), ref.stencil_step(x, spec)))

    print("[kernels] main-path shapes")
    timing = {}
    main_inputs = []
    for spec_name, shape, n, caching in MAIN:
        spec = get_spec(spec_name)
        x = domain(shape)
        problem = StencilProblem(x, spec, n)
        best = plan(problem)
        want = ref.stencil_run(x, spec, n)
        main_inputs.append((problem, best, want))
        if caching == "partial":
            kname, R = "stencil_perks", best.cached_rows
            run = lambda: ops.stencil_perks(x, spec=spec, steps=n, cached_rows=R)
        else:
            kname = "stencil_resident"
            run = lambda: ops.stencil_resident(x, spec=spec, steps=n)
        errs[kname] = max(errs[kname], check(
            f"{kname} {shape} {n} steps cached_rows={best.cached_rows}",
            run(), want))
        # bytes it must move: Eq. 5 at the plan's cached rows (the streamed
        # rows twice a step, the cached ones once in all); with every row
        # cached that is the domain read once and written once
        dom = x.numel() * x.element_size()
        moved = gm_bytes_fused(n, dom, best.cached_rows * (dom // shape[0]),
                               row_bytes=dom // shape[0], radius=spec.radius,
                               fuse_steps=1)
        timing[kname] = dict(
            ms=cuda_ms(run, 5), plain_ms=cuda_ms(
                lambda: ref.stencil_run(x, spec, n), 3),
            bound=bound(spec, shape, n, moved), library_ms=None)
        step = lambda: ops.stencil_baseline_step(x, spec=spec)
        errs["stencil_baseline_step"] = max(
            errs["stencil_baseline_step"],
            check(f"stencil_baseline_step {shape}", step(),
                  ref.stencil_step(x, spec)))
        if caching == "partial":
            timing["stencil_baseline_step"] = dict(
                ms=cuda_ms(step, 20),
                plain_ms=cuda_ms(lambda: ref.stencil_step(x, spec), 10),
                bound=bound(spec, shape, 1, 2 * x.numel() * x.element_size()),
                library_ms=cuda_ms(conv_step(spec, x), 20))

    # -- 3. the main path, counted ------------------------------------------------
    print("[main path] counters set to 0")
    perks.clear_graphs()
    ops.reset_launch_counts()
    for problem, best, want in main_inputs:
        shape = tuple(problem.x.shape)
        print(f"  plan {shape}: {best.to_json(indent=None)}")
        # the device loop twice: the second run replays the kept graph
        for p in (best, Plan(tier="host_loop"), Plan(tier="device_loop"),
                  Plan(tier="device_loop"),
                  Plan(tier="resident", cached_rows=best.cached_rows)):
            replay = p.tier == "device_loop" and perks.graph_cached(
                problem.step_fn(), problem.x, problem.n_steps)
            before = ops.launch_counts()
            y = execute(problem, p)
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in ops.launch_counts().items()
                     if v != before[k]}
            check(f"execute {shape} {p.tier} cached_rows={p.cached_rows} "
                  f"replay={replay} launches={delta}", y, want)
            if replay and delta:
                FAILS.append(f"device_loop replay on {shape} launched {delta}")
    launches = ops.launch_counts()
    print(f"[main path] launches {json.dumps(launches)}")
    for k, v in launches.items():
        if v == 0:
            FAILS.append(f"{k} was not launched on the main path")
    b_big, b_small = (best for _, best, _ in main_inputs)
    H_big, H_small = MAIN[0][1][0], MAIN[1][1][0]
    if not (b_big.tier == "resident" and 0 < b_big.cached_rows < H_big):
        FAILS.append(f"8192x8192 plan is not partial caching: {b_big}")
    if not (b_small.tier == "resident" and b_small.cached_rows == H_small):
        FAILS.append(f"3072x1152 plan does not cache the domain: {b_small}")

    # -- 4. tier timing (not counted) ------------------------------------------------
    print("[tiers] median ms over 3 runs (the device loop's graph kept after "
          "the first, which is timed alone as first_ms)")
    for problem, best, _ in main_inputs:
        shape, n = tuple(problem.x.shape), problem.n_steps
        dom = problem.domain_bytes()
        row_bytes = dom // shape[0]
        tiers = {}
        for p in (Plan(tier="host_loop"), Plan(tier="device_loop"), best):
            first = None
            if p.tier == "device_loop":
                perks.clear_graphs()
                first = cuda_ms(lambda: execute(problem, p), 0)
            ms = cuda_ms(lambda: execute(problem, p), 3)
            tiers[p.tier] = ms
            cached = (p.cached_rows or 0) * row_bytes
            model = gm_bytes_fused(n, dom, cached, row_bytes=row_bytes,
                                   radius=problem.spec.radius, fuse_steps=1)
            print("  " + json.dumps(dict(
                shape=shape, n_steps=n, tier=p.tier,
                cached_rows=p.cached_rows, ms=ms, first_ms=first,
                cells_per_s=math.prod(shape) * n / (ms / 1e3),
                effective_GBps=2 * dom * n / (ms / 1e3) / 1e9,
                effective_share_of_3350GBps=2 * dom * n / (ms / 1e3) / HBM_BW,
                model_bytes=model,
                model_ms=1e3 * model / HBM_BW,
                predicted_ms=1e3 * p.predicted_s if p.predicted_s else None)))
        print(f"  {shape}: planner chose {best.tier} (predicted with no graph "
              f"kept); fastest measured: {min(tiers, key=tiers.get)}; "
              f"planner now: {plan(problem).tier}")
        perks.clear_graphs()
    tiny = StencilProblem(domain((64, 64)), get_spec("2d5pt"), 1000)
    per_launch = cuda_ms(lambda: execute(tiny, Plan(tier="host_loop")), 3)
    print(f"[tiers] host_loop on 64x64, 1000 steps: {per_launch / 1000 * 1e3!r} "
          f"us per step (launch overhead)")

    # -- 5. report -------------------------------------------------------------------
    kernels = []
    for k, (source, replaces) in KERNELS.items():
        t = timing[k]
        kernels.append(dict(
            name=k, route="cuda", source=source, replaces=replaces,
            launches=launches[k], max_abs_err=errs[k], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
            bound_by=t["bound"][1], library_ms=t["library_ms"]))
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
