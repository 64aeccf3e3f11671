"""repro_torch — the PyTorch/CUDA port of the PERKS reproduction, for one
NVIDIA H100 (Hopper, ``sm_90a``).

The JAX package ``repro`` is the reference and this package imports none of
it. The stencil main path::

    from repro_torch import StencilProblem, plan, execute
    from repro_torch.kernels.common import get_spec

    problem = StencilProblem(x, get_spec("2d5pt"), n_steps=100)  # on "cuda"
    y = execute(problem, plan(problem))

Entry points run on the card unless the caller passes ``device="cpu"``,
where the plain torch versions of the kernels run.
"""
from repro_torch.exec import Plan, StencilProblem, execute, plan

__all__ = ["Plan", "StencilProblem", "execute", "plan"]
