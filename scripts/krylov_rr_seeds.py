"""How far the Krylov tiers' rr lies from float64, against how far float32
plain runs in several dot orders lie, over several right-hand sides.

    python3 scripts/krylov_rr_seeds.py [--seeds 0,1,...]

For each seed and each Krylov cell of ``chip_smoke.py`` with a resident
candidate (bicgstab-small, bicgstab-large: ``convdiff2d`` 512 / 768, 100
BiCGStab iterations; gmres-small: ``convdiff2d`` 448, four GMRES(16)
cycles), b is drawn from ``numpy.random.default_rng(seed)``. The script
runs the planner's pick and the two loop tiers through ``execute`` on the
card, and the plain versions (``repro_torch.kernels.ref``) in float32 with
four dot orders (``torch.dot`` on the card, 1024- and 32-wide blocked sums,
``torch.dot`` on the CPU) and in float64 with two (``torch.dot``, 1024-wide
blocks). It prints one JSON line per seed and cell: every rr, each
distance from the float64 ``torch.dot`` run's rr, the true residual
|b - A x|^2 of every x in float64, and three verdicts on each tier's rr:
the gate of 2 x the farther of the first two float32 orders + 1e-5
|rr64|, the same gate over all four orders, and ``chip_smoke.py``'s
``check_rr`` (four orders, or rr and rr64 both below float32's resolution
(eps |b|)^2). Then the card's name and power limit. Exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys

import numpy as np
import torch

X64_REL = 1e-5           # chip_smoke.py's relative term
F32_EPS = float(np.finfo(np.float32).eps)
KRYLOV_M = 16
CELLS = [  # (cell, kind, convdiff2d side, iterations or cycles)
    ("bicgstab-small", "bicgstab", 512, 100),
    ("bicgstab-large", "bicgstab", 768, 100),
    ("gmres-small", "gmres", 448, 4),
]


def blocked(width: int):
    """A float32 dot summing ``width``-wide rows first, then their sums."""
    def dot(a, b):
        prod = a * b
        pad = torch.nn.functional.pad(prod, (0, -prod.shape[0] % width))
        return pad.view(-1, width).sum(1).sum()
    return dot


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("krylov_rr_seeds: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import BiCGStabProblem, GMRESProblem, Plan, execute, plan
    from repro_torch.kernels import ref
    from repro_torch.sparse.generate import convdiff2d

    def plain(kind, data, cols, b, steps, dot):
        mv = functools.partial(ref.spmv_ell, data, cols)
        if kind == "bicgstab":
            state = ref.bicgstab_initial_state(b, dot=dot)
            for _ in range(steps):
                state = ref.bicgstab_iteration_matvec(state, mv, dot=dot)
            return state[0], state[8]
        state = (torch.zeros_like(b), dot(b, b))
        for _ in range(steps):
            state = ref.gmres_cycle_matvec(state, mv, b, KRYLOV_M, dot=dot)
        return state

    for cell, kind, side, steps in CELLS:
        csr = convdiff2d(side)
        ell = csr.to_ell()
        n = csr.shape[0]
        for seed in (int(s) for s in args.seeds.split(",")):
            b = np.random.default_rng(seed).standard_normal(n).astype(
                np.float32)
            if kind == "bicgstab":
                problem = BiCGStabProblem.from_ell(ell.data, ell.cols, b,
                                                   steps, matrix=csr)
            else:
                problem = GMRESProblem.from_ell(ell.data, ell.cols, b, steps,
                                                m=KRYLOV_M, matrix=csr)
            d, c, bv = problem.data, problem.cols, problem.b
            d64, b64 = d.double(), bv.double()
            xs, rrs = {}, {}
            for tag, p in (("resident", plan(problem)),
                           ("host_loop", Plan(tier="host_loop")),
                           ("device_loop", Plan(tier="device_loop"))):
                xs[tag], rrs[tag] = execute(problem, p)
            for tag, dot in (("f32 dot", torch.dot),
                             ("f32 blocked1024", blocked(1024)),
                             ("f32 blocked32", blocked(32))):
                xs[tag], rrs[tag] = plain(kind, d, c, bv, steps, dot)
            x, rr = plain(kind, d.cpu(), c.cpu(), bv.cpu(), steps, torch.dot)
            xs["f32 cpu"], rrs["f32 cpu"] = x.cuda(), rr.cuda()
            for tag, dot in (("f64 dot", torch.dot),
                             ("f64 blocked1024", blocked(1024))):
                xs[tag], rrs[tag] = plain(kind, d64, c, b64, steps, dot)
            rr64 = rrs["f64 dot"].item()
            gap = {k: abs(v.double().item() - rr64) for k, v in rrs.items()}
            f32 = [k for k in rrs if k.startswith("f32")]
            limit2 = 2 * max(gap[k] for k in f32[:2]) + X64_REL * abs(rr64)
            limit4 = 2 * max(gap[k] for k in f32) + X64_REL * abs(rr64)
            true = {k: torch.sum((b64 - ref.spmv_ell(d64, c, v.double()))
                                 ** 2).item() for k, v in xs.items()}
            bb = torch.dot(b64, b64).item()
            floor = F32_EPS ** 2 * bb
            tiers = ("resident", "host_loop", "device_loop")
            print(json.dumps(dict(
                cell=cell, seed=seed, bb=bb, f32_floor=floor,
                rr={k: v.double().item() for k, v in rrs.items()},
                gap_from_rr64=gap, true_residual=true,
                gate_two_orders=limit2, gate_four_orders=limit4,
                verdict_two_orders={k: gap[k] <= limit2 for k in tiers},
                verdict_four_orders={k: gap[k] <= limit4 for k in tiers},
                verdict_check_rr={k: gap[k] <= limit4 or max(
                    rrs[k].item(), rr64) <= floor for k in tiers})),
                  flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True)
    print(card.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
