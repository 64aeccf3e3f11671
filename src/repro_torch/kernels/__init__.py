"""Hand-written Hopper kernels of the port and their plain torch versions.

- ``stencil2d``/``stencil3d`` — PERKS stencils: a cooperative persistent
  CUDA kernel with the time loop inside and rows cached in shared memory,
  and the one-step kernel of the loop tiers (sources in ``csrc/``).
- ``spmv_ell``/``spmv_sell`` — the CG loop tiers' SpMVs for ELL planes and
  for SELL-C-σ operators.
- ``cg_fused`` — PERKS conjugate gradient: a cooperative persistent CUDA
  kernel with the iteration loop inside and the vectors (and part or all
  of the matrix) in shared memory.
- ``krylov_fused`` — PERKS BiCGStab (the iteration loop in one cooperative
  launch) and one GMRES(m) restart cycle (the Arnoldi basis and the matrix
  in shared memory for the cycle).
- ``ssm_scan`` — the Mamba2 SSD chunk scan, each CTA walking the chunks of
  its sequence with its head's state in shared memory.
- ``decode_attn`` — GQA flash-decode: one query token against its KV cache,
  split over CTAs along the sequence.

``ops.py`` holds the keyword wrappers and launch counters; ``ref.py`` the
plain torch versions every kernel is held against.
"""
from repro_torch.kernels.common import BENCHMARKS, StencilSpec, get_spec
