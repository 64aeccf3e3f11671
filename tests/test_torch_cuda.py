"""The port's CUDA kernels and tiers on the card, against its own plain torch
version (the JAX parity of that plain version is in ``test_torch_stencil``
and ``test_torch_exec``).

This file imports nothing of JAX or of the reference package, so it also
runs on a machine without them:

    PYTHONPATH=src python3 -m pytest -q --noconftest tests/test_torch_cuda.py

Every test needs a CUDA device and skips, with its reason, where torch
finds none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import perks
from repro_torch.exec import Plan, StencilProblem, execute, plan
from repro_torch.kernels import ops, ref
from repro_torch.kernels.common import BENCHMARKS, get_spec

NAMES = sorted(BENCHMARKS)
STEPS = 5

pytestmark = pytest.mark.cuda


def _domain(spec, seed=0):
    shape = (32, 40) if spec.ndim == 2 else (20, 14, 18)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", NAMES)
def test_cuda_kernels_match_plain_version(name, cuda):
    spec = get_spec(name)
    x = torch.from_numpy(_domain(spec, seed=4)).to(cuda)
    want = ref.stencil_run(x, spec, STEPS)
    for rows in (0, max(spec.radius, x.shape[0] // 2), x.shape[0]):
        got = ops.stencil_perks(x, spec=spec, steps=STEPS, cached_rows=rows)
        assert torch.equal(got, want), (name, rows)
    assert torch.equal(ops.stencil_resident(x, spec=spec, steps=STEPS), want)
    assert torch.equal(ops.stencil_baseline_step(x, spec=spec),
                       ref.stencil_step(x, spec))


def test_cuda_wrappers_refuse_what_the_kernel_does_not_do(cuda):
    spec = get_spec("2d5pt")
    x = torch.from_numpy(_domain(spec)).to(cuda)
    with pytest.raises(NotImplementedError, match="fuse_steps"):
        ops.stencil_perks(x, spec=spec, steps=4, cached_rows=8, fuse_steps=2)
    with pytest.raises(TypeError, match="float32"):
        ops.stencil_perks(x.to(torch.bfloat16), spec=spec, steps=4,
                          cached_rows=8)
    with pytest.raises(TypeError, match="float32"):
        ops.stencil_baseline_step(x.to(torch.bfloat16), spec=spec)
    big = torch.zeros((40000, 8192), device=cuda)
    with pytest.raises(ValueError, match="holds at most"):
        ops.stencil_resident(big, spec=spec, steps=1)


@pytest.mark.parametrize("name", NAMES)
def test_cuda_tiers_agree_bit_for_bit(name, cuda):
    spec = get_spec(name)
    x = _domain(spec, seed=9)
    p = StencilProblem(x, spec, STEPS, device=cuda)
    want = p.oracle()
    for pl in (Plan(tier="host_loop"), Plan(tier="device_loop"),
               Plan(tier="resident", cached_rows=x.shape[0]),
               Plan(tier="resident", cached_rows=max(spec.radius,
                                                     x.shape[0] // 2)),
               plan(p)):
        assert torch.equal(execute(p, pl), want), pl.tier


def test_cuda_device_loop_keeps_its_graph(cuda):
    spec = get_spec("2d5pt")
    p = StencilProblem(_domain(spec, seed=10), spec, STEPS, device=cuda)
    want = p.oracle()
    perks.clear_graphs()
    first = execute(p, Plan(tier="device_loop"))
    assert perks.graph_cached(p.step_fn(), p.x, STEPS)
    before = ops.launch_counts()["stencil_baseline_step"]
    second = execute(p, Plan(tier="device_loop"))   # a replay: no new launch
    assert ops.launch_counts()["stencil_baseline_step"] == before
    assert torch.equal(first, want) and torch.equal(second, want)
    assert first.data_ptr() != second.data_ptr()
    perks.clear_graphs()
    assert not perks.graph_cached(p.step_fn(), p.x, STEPS)
