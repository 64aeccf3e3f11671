"""Hand-written Hopper kernels of the port and their plain torch versions.

- ``stencil2d``/``stencil3d`` — PERKS stencils: a cooperative persistent
  CUDA kernel with the time loop inside and rows cached in shared memory,
  and the one-step kernel of the loop tiers (sources in ``csrc/``).

``ops.py`` holds the keyword wrappers and launch counters; ``ref.py`` the
plain torch versions every kernel is held against.
"""
from repro_torch.kernels.common import BENCHMARKS, StencilSpec, get_spec
