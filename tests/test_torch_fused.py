"""The port's shallow temporal blocking against the JAX reference:
``stencil_perks`` at ``fuse_steps`` t = 2, 3, 4 on all 13 Table-III specs.

Inputs are made with numpy from a seed and handed to both packages. The
JAX kernel runs as ``tests/test_deep_blocking.py`` runs it on the CPU
(Pallas interpret mode); the port's wrapper runs its plain torch version
(``ref.stencil_run``: t fused steps are t steps of the same function)
because the tensor lies on the CPU. 11 steps leave a remainder pass for
every t; the streaming tile is chosen so that it does not divide the
streamed rows. The bound is the reference's kernel bound, atol 5e-6 with
rtol 0. The CUDA kernel (``csrc/stencil_tb.cu``) is held to the same plain
version on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.common import BENCHMARKS as JAX_SPECS
from repro.kernels.stencil2d import stencil_perks as jax_perks
from repro_torch.kernels import ops
from repro_torch.kernels.common import BENCHMARKS, get_spec

ATOL = 5e-6
NAMES = sorted(BENCHMARKS)
STEPS = 11


def _domain(spec, seed=0):
    shape = (48, 64) if spec.ndim == 2 else (24, 16, 32)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def ragged_tile(H: int, cached: int, least: int) -> int:
    """The smallest tile of at least ``least`` rows that does not divide
    the streamed rows evenly."""
    tile = least
    while (H - cached) % tile == 0:
        tile += 1
    return tile


@pytest.mark.parametrize("t", [2, 3, 4])
@pytest.mark.parametrize("cached", ["none", "4r+1"])
@pytest.mark.parametrize("name", NAMES)
def test_fused_stencil_perks_matches_reference(name, cached, t):
    spec = get_spec(name)
    r = spec.radius
    x = _domain(spec, seed=t)
    H = x.shape[0]
    rows = 0 if cached == "none" else 4 * r + 1
    sub = ragged_tile(H, rows, max(5, r * t))
    want = jax_perks(jnp.asarray(x), JAX_SPECS[name], steps=STEPS,
                     cached_rows=rows, sub_rows=sub, fuse_steps=t)
    xt = torch.from_numpy(x)
    got = ops.stencil_perks(xt, spec=spec, steps=STEPS, cached_rows=rows,
                            sub_rows=sub, fuse_steps=t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert np.array_equal(xt.numpy(), x), "the input must not be written"


def test_fused_preconditions_raise():
    spec = get_spec("2ds9pt")                       # radius 2
    x = torch.from_numpy(_domain(spec))
    with pytest.raises(ValueError, match="sub_rows >= radius\\*fuse_steps = 8"):
        ops.stencil_perks(x, spec=spec, steps=9, cached_rows=0, sub_rows=7,
                          fuse_steps=4)
    # t = min(fuse_steps, steps): two steps need a tile of 2r rows only
    ops.stencil_perks(x, spec=spec, steps=2, cached_rows=0, sub_rows=4,
                      fuse_steps=4)
    with pytest.raises(ValueError, match="fuse_steps"):
        ops.stencil_perks(x, spec=spec, steps=2, cached_rows=0, fuse_steps=0)
