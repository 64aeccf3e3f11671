"""The port's stencil kernels against the JAX reference, all 13 Table-III
specs, 2D and 3D.

Inputs are made with numpy from a seed and handed to both packages. The
JAX kernels run as ``tests/test_kernels_stencil.py`` runs them on the CPU
(Pallas interpret mode); the port's wrappers run their plain torch versions
because the tensors lie on the CPU. The bound is the reference's own kernel
bound, atol 5e-6 with rtol 0 (``tests/test_deep_blocking.py``). The CUDA
kernels are held to their plain versions on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.common import BENCHMARKS as JAX_SPECS
from repro.kernels.stencil2d import stencil_baseline_step as jax_baseline_step
from repro.kernels.stencil2d import stencil_perks as jax_perks
from repro.kernels.stencil2d import stencil_resident as jax_resident
from repro_torch.convert import spec_from_reference
from repro_torch.kernels import ops, ref
from repro_torch.kernels.common import BENCHMARKS, get_spec

ATOL = 5e-6
NAMES = sorted(BENCHMARKS)
STEPS = 5


def _domain(spec, seed=0):
    shape = (32, 40) if spec.ndim == 2 else (20, 14, 18)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_spec_is_the_reference_spec(name):
    got = BENCHMARKS[name]
    assert spec_from_reference(JAX_SPECS[name]) == got
    assert got.radius == JAX_SPECS[name].radius
    assert got.npoints == JAX_SPECS[name].npoints


@pytest.mark.parametrize("name", NAMES)
def test_stencil_step_and_run_match_reference(name):
    spec = get_spec(name)
    x = _domain(spec)
    xt = torch.from_numpy(x)
    _close(ref.stencil_step(xt, spec), jref.stencil_step(jnp.asarray(x),
                                                         JAX_SPECS[name]))
    _close(ref.stencil_run(xt, spec, STEPS),
           jref.stencil_run(jnp.asarray(x), JAX_SPECS[name], STEPS))
    assert np.array_equal(xt.numpy(), x), "the input must not be written"


@pytest.mark.parametrize("cached", ["none", "partial", "all"])
@pytest.mark.parametrize("name", NAMES)
def test_stencil_perks_matches_reference(name, cached):
    spec = get_spec(name)
    x = _domain(spec, seed=1)
    H = x.shape[0]
    rows = {"none": 0, "partial": max(spec.radius, H // 2), "all": H}[cached]
    want = jax_perks(jnp.asarray(x), JAX_SPECS[name], steps=STEPS,
                     cached_rows=rows, sub_rows=8)
    got = ops.stencil_perks(torch.from_numpy(x), spec=spec, steps=STEPS,
                            cached_rows=rows, sub_rows=8)
    _close(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_stencil_resident_matches_reference(name):
    spec = get_spec(name)
    x = _domain(spec, seed=2)
    want = jax_resident(jnp.asarray(x), JAX_SPECS[name], steps=STEPS)
    _close(ops.stencil_resident(torch.from_numpy(x), spec=spec, steps=STEPS),
           want)


@pytest.mark.parametrize("name", NAMES)
def test_stencil_baseline_step_matches_reference(name):
    spec = get_spec(name)
    x = _domain(spec, seed=3)
    want = jax_baseline_step(jnp.asarray(x), JAX_SPECS[name], sub_rows=8)
    got = ops.stencil_baseline_step(torch.from_numpy(x), spec=spec, sub_rows=8)
    _close(got, want)
    out = torch.empty(x.shape, dtype=torch.float32)
    assert ops.stencil_baseline_step(torch.from_numpy(x), spec=spec,
                                     out=out) is out
    assert torch.equal(out, got)


def test_cpu_tensors_never_count_as_launches():
    spec = get_spec("2d5pt")
    before = ops.launch_counts()
    x = torch.from_numpy(_domain(spec))
    ops.stencil_perks(x, spec=spec, steps=2, cached_rows=4)
    ops.stencil_resident(x, spec=spec, steps=2)
    ops.stencil_baseline_step(x, spec=spec)
    assert ops.launch_counts() == before


def test_reference_preconditions_raise():
    spec = get_spec("2ds9pt")                       # radius 2
    x = torch.from_numpy(_domain(spec))
    with pytest.raises(ValueError, match="partial caching"):
        ops.stencil_perks(x, spec=spec, steps=2, cached_rows=1)
    with pytest.raises(ValueError, match="outside"):
        ops.stencil_perks(x, spec=spec, steps=2, cached_rows=x.shape[0] + 1)
    with pytest.raises(ValueError, match="sub_rows"):
        ops.stencil_perks(x, spec=spec, steps=2, cached_rows=0, sub_rows=1)
    with pytest.raises(ValueError, match="steps"):
        ops.stencil_resident(x, spec=spec, steps=-1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.stencil_baseline_step(x.to("meta"), spec=spec)


def test_perks_layout_arithmetic():
    from repro_torch.kernels.stencil2d import (band_layout, band_smem_bytes,
                                               rows_per_cta)
    # 8192 f32 cells = 32 KiB rows: 7 fit 227 KB, less the 1-row ring
    assert rows_per_cta(8192, 4, 1, 232448 - 1024) == 6
    assert rows_per_cta(20 * 1024 + 1, 4, 1, 10**9) == 0
    assert band_layout(0, 1, 132) == (0, 0)
    assert band_layout(792, 1, 132) == (132, 6)
    nb, maxband = band_layout(7, 2, 132)       # bands of >= radius rows
    assert nb == 3 and maxband == 3
    assert band_smem_bytes(792, 1, 32768, 132) == 7 * 32768
