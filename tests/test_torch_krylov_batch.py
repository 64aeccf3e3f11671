"""The batching surface of the port's BiCGStab and GMRES(m)
(``repro_torch.exec.krylov``) and the lane-aware Krylov steps under it
(``repro_torch.kernels.ref``).

A batch of B right-hand sides against one ELL operator runs on host_loop
and device_loop, and every lane is bit for bit its instance run alone on
the same tier (B = 1, 3 and 8); each lane is held to the reference's
``execute_sequential`` at the Krylov tolerance (rtol 1e-3, atol 1e-5). A
batched step makes the single step's launches whatever B is
(``BICGSTAB_STEP_LAUNCHES``, ``GMRES_CYCLE_LAUNCHES(m)``), each SpMV and
each lane dot counted as one launch, as ``spmv_ell`` and ``vdot`` take
every lane in one. A batched resident plan raises, naming the fused
kernel. All on the CPU, inputs made with numpy from a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from repro.exec import Plan as JaxPlan
from repro.exec import execute_sequential as jax_execute_sequential
from repro.exec.krylov import BiCGStabProblem as JaxBiCGStabProblem
from repro.exec.krylov import GMRESProblem as JaxGMRESProblem
from repro_torch.exec import (BatchedProblem, BiCGStabProblem, GMRESProblem,
                              LaneRunner, Plan, execute, execute_sequential,
                              plan_candidates)
from repro_torch.exec.krylov import (BICGSTAB_STEP_LAUNCHES,
                                     GMRES_CYCLE_LAUNCHES)
from repro_torch.exec.precision import dot_for
from repro_torch.kernels import ref
from repro_torch.kernels.vdot import plain_vdot, vdot
from repro_torch.solvers.cg import load_matrix

KRYLOV_TOL = dict(rtol=1e-3, atol=1e-5)
M = 6
STEPS = {"bicgstab": 8, "gmres": 3}
FAMILIES = {"bicgstab": (BiCGStabProblem, JaxBiCGStabProblem),
            "gmres": (GMRESProblem, JaxGMRESProblem)}


@pytest.fixture(scope="module")
def convdiff():
    csr = load_matrix("convdiff_small")
    ell = csr.to_ell()
    return csr, torch.from_numpy(ell.data), torch.from_numpy(ell.cols)


def _rhs(n, b, seed=20):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(b)]


def _instances(kind, convdiff, b, seed=20, **kw):
    """B instances sharing one operator (and the first one's steps)."""
    csr, data, cols = convdiff
    cls = FAMILIES[kind][0]
    extra = dict(m=M) if kind == "gmres" else {}
    rhs = _rhs(data.shape[0], b, seed)
    first = cls.from_ell(data, cols, rhs[0], STEPS[kind], matrix=csr,
                         device="cpu", **extra, **kw)
    return rhs, [first] + [first.with_payload(torch.from_numpy(v))
                           for v in rhs[1:]]


def _same(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("tier", ["host_loop", "device_loop"])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("kind", ["bicgstab", "gmres"])
def test_lanes_are_bit_equal_to_their_instances_alone(kind, b, tier,
                                                      convdiff):
    rhs, insts = _instances(kind, convdiff, b)
    bp = BatchedProblem.from_instances(insts)
    assert bp.supports(tier)
    plan_ = Plan(tier=tier, batch=b)
    out = execute(bp, plan_)
    seq = execute_sequential(insts, Plan(tier=tier))
    lanes = bp.split(out)
    assert len(lanes) == b
    for i, (got, want) in enumerate(zip(lanes, seq)):
        assert _same(got, want), (kind, b, tier, i)


@pytest.mark.parametrize("kind", ["bicgstab", "gmres"])
def test_lanes_match_the_reference_sequential(kind, convdiff):
    csr, data, cols = convdiff
    rhs, insts = _instances(kind, convdiff, 3)
    bp = BatchedProblem.from_instances(insts)
    out = bp.split(execute(bp, Plan(tier="device_loop", batch=3)))
    jcls = FAMILIES[kind][1]
    extra = dict(m=M) if kind == "gmres" else {}
    jd, jc = jnp.asarray(data.numpy()), jnp.asarray(cols.numpy())
    jinsts = [jcls.from_ell(jd, jc, jnp.asarray(v), STEPS[kind], **extra)
              for v in rhs]
    want = jax_execute_sequential(jinsts, JaxPlan(tier="host_loop"))
    for (x, rr), (jx, jrr) in zip(out, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), **KRYLOV_TOL)
        np.testing.assert_allclose(float(rr), float(jrr), **KRYLOV_TOL)


@pytest.mark.parametrize("kind", ["bicgstab", "gmres"])
def test_batched_early_stop_and_mixed_precision_lanes(kind, convdiff):
    """A tolerance stops the batch when every lane has converged (one
    stacked reduction); mixed precision hardens every lane's dots alike;
    each lane stays bit-equal to its instance."""
    _, insts = _instances(kind, convdiff, 3, tol=1e-6)
    for precision in ("uniform", "mixed"):
        lanes = [p.with_precision(precision) for p in insts]
        bp = BatchedProblem.from_instances(lanes)
        plan_ = Plan(tier="host_loop", batch=3, precision=precision)
        out = bp.split(execute(bp, plan_))
        seq = execute_sequential(lanes, Plan(tier="host_loop",
                                             precision=precision))
        assert all(_same(g, w) for g, w in zip(out, seq))


class _Count(TorchDispatchMode):
    """The operators a call dispatches, views and in-place reshapes not
    counted; a call wrapped by ``kernel`` counts as one launch whatever it
    dispatches (the card runs ``spmv_ell`` and ``vdot`` as one launch for
    every lane)."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self._inside = 0

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        if not self._inside:
            self.ops.append(func)
        return func(*args, **(kwargs or {}))

    def kernel(self, fn):
        def call(*args):
            self.ops.append("kernel")
            self._inside += 1
            try:
                return fn(*args)
            finally:
                self._inside -= 1
        return call

    @property
    def launches(self):
        return [f for f in self.ops if f == "kernel" or not (
            f.is_view or "squeeze" in str(f))]


@pytest.mark.parametrize("b", [1, 3, 8])
def test_a_batched_step_makes_the_single_steps_launches(b, convdiff):
    _, data, cols = convdiff
    n = data.shape[0]
    x = torch.from_numpy(np.stack(_rhs(n, b)))
    one = x[0]
    for lanes in (one, x):
        state = ref.bicgstab_initial_state(lanes, dot=plain_vdot)
        out = tuple(torch.empty_like(t) for t in state)
        with _Count() as counted:
            mv = counted.kernel(lambda q: ref.spmv_ell(data, cols, q))
            dot = counted.kernel(plain_vdot)
            ref.bicgstab_iteration_matvec(state, mv, dot=dot, out=out)
        assert len(counted.launches) == BICGSTAB_STEP_LAUNCHES
        for m in (1, 3, 8):
            state = (torch.zeros_like(lanes), plain_vdot(lanes, lanes))
            out = torch.empty_like(lanes)
            with _Count() as counted:
                mv = counted.kernel(lambda q: ref.spmv_ell(data, cols, q))
                dot = counted.kernel(plain_vdot)
                ref.gmres_cycle_matvec(state, mv, lanes, m, dot=dot,
                                       out=out, proj=dot)
            assert len(counted.launches) == GMRES_CYCLE_LAUNCHES(m), (b, m)
            # nothing is read on the host, so a CUDA graph holds the cycle
            assert not any("_local_scalar_dense" in str(f)
                           or "item" in str(f) for f in counted.ops)


@pytest.mark.parametrize("kind", ["bicgstab", "gmres"])
def test_batched_resident_plan_raises_naming_the_fused_kernel(kind,
                                                              convdiff):
    _, insts = _instances(kind, convdiff, 2)
    bp = BatchedProblem.from_instances(insts)
    source = {"bicgstab": "csrc/bicgstab_fused.cu",
              "gmres": "csrc/gmres_cycle_fused.cu"}[kind]
    with pytest.raises(NotImplementedError, match=source):
        execute(bp, Plan(tier="resident", batch=2))
    tiers = {c.tier for c in plan_candidates(bp)}
    assert tiers == {"host_loop", "device_loop"}
    # a single instance is still offered its fused kernel
    assert "resident" in {c.tier for c in plan_candidates(insts[0])}


@pytest.mark.parametrize("kind", ["bicgstab", "gmres"])
def test_matvec_callables_do_not_batch(kind, convdiff):
    csr, data, cols = convdiff
    cls = FAMILIES[kind][0]
    b = _rhs(data.shape[0], 1)[0]
    p = cls.from_matvec(lambda q: ref.spmv_ell(data, cols, q), b, 2,
                        matrix=csr, device="cpu")
    assert p.batched_tiers() == ()
    with pytest.raises(NotImplementedError, match="spmv_sell"):
        BatchedProblem.from_instances([p, p])


@pytest.mark.parametrize("kind", ["bicgstab", "gmres"])
def test_batching_surface_shares_the_operator(kind, convdiff):
    _, insts = _instances(kind, convdiff, 3)
    a, b = insts[0], insts[1]
    assert a.batch_key() == b.batch_key()
    assert a.payload() is a.b and torch.equal(b.payload(), b.b)
    assert a.with_payload(b.b).step_fn() is a.step_fn()
    assert not a.array_scales_with_batch("A")
    assert a.array_scales_with_batch("x")
    bp = BatchedProblem.from_instances(insts)
    one = {c.name: c.bytes for c in a.cacheable_arrays()}
    many = {c.name: c.bytes for c in bp.cacheable_arrays()}
    for name, size in one.items():
        assert many[name] == (size if name == "A" else 3 * size)
    other = FAMILIES[kind][0].from_ell(
        insts[0].data.clone(), insts[0].cols, insts[0].b, STEPS[kind],
        device="cpu", **(dict(m=M) if kind == "gmres" else {}))
    assert other.batch_key() != a.batch_key()


@pytest.mark.parametrize("kind", ["bicgstab", "gmres"])
def test_lane_runner_retires_krylov_lanes_bit_exact(kind, convdiff):
    """LaneRunner lanes of BiCGStab or GMRES: one lane admitted a step
    later than the others, each harvested after its own steps, bit-equal
    to its instance alone on the host loop."""
    from repro_torch.core import perks
    _, insts = _instances(kind, convdiff, 3)
    runner = LaneRunner(insts[0], 3)
    lanes = runner.fresh()
    runner.admit(lanes, 0, insts[0])
    runner.admit(lanes, 1, insts[1])
    runner.advance(lanes, 1, perks.Execution.HOST_LOOP)
    runner.admit(lanes, 2, insts[2])
    n = insts[0].n_steps
    runner.advance(lanes, n - 1, perks.Execution.HOST_LOOP)
    for lane in (0, 1):
        assert _same(runner.harvest(lanes, lane),
                     execute(insts[lane], Plan(tier="host_loop")))
    runner.advance(lanes, 1, perks.Execution.HOST_LOOP)
    assert _same(runner.harvest(lanes, 2),
                 execute(insts[2], Plan(tier="host_loop")))


def test_gmres_pieces_take_a_leading_lane_axis(convdiff):
    """gmres_arnoldi, hessenberg_lstsq and gmres_cycle_update on B lanes
    give each lane's single-instance bits, in the lane-first shapes V
    (B, m+1, n), H (B, m+1, m), beta (B, 1)."""
    _, data, cols = convdiff
    n = data.shape[0]
    b = torch.from_numpy(np.stack(_rhs(n, 4)))
    x = torch.from_numpy(np.stack(_rhs(n, 4, seed=21))) * 0.1
    mv = lambda q: ref.spmv_ell(data, cols, q)
    V, H, beta, xn = ref.gmres_cycle_update(x, b, mv, M, dot=plain_vdot)
    assert (V.shape, H.shape, beta.shape, xn.shape) == (
        (4, M + 1, n), (4, M + 1, M), (4, 1), (4, n))
    Va, Ha, ba = ref.gmres_arnoldi(x, b, mv, M, dot=plain_vdot)
    assert torch.equal(Va, V) and torch.equal(Ha, H) and torch.equal(ba, beta)
    assert ref.hessenberg_lstsq(H, beta).shape == (4, M)
    for i in range(4):
        v, h, bt, xi = ref.gmres_cycle_update(x[i], b[i], mv, M)
        assert torch.equal(v, V[i]) and torch.equal(h, H[i])
        assert torch.equal(bt, beta[i]) and torch.equal(xi, xn[i])
        assert torch.equal(ref.hessenberg_lstsq(H[i], beta[i]),
                           ref.hessenberg_lstsq(H, beta)[i])
    # the basis is orthonormal lane by lane
    for i in range(4):
        gram = V[i] @ V[i].T
        np.testing.assert_allclose(gram.numpy(), np.eye(M + 1), atol=1e-4)


def test_vdot_shares_one_operand_along_a_leading_axis():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((5, 3, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    got = vdot(a, b)
    assert got.shape == (5, 3)
    for i in range(5):
        for j in range(3):
            assert torch.equal(got[i, j], torch.dot(a[i, j], b[j]))
    assert torch.equal(vdot(a[0], b[1]), plain_vdot(a[0], b[1]))
    assert torch.equal(dot_for("uniform")(a, b), got)
    with pytest.raises(ValueError, match="alike"):
        vdot(a, b[:2])
    with pytest.raises(ValueError, match="alike"):
        vdot(a[None], b)


def test_single_gmres_still_takes_a_vector_dot(convdiff):
    """A single instance hands its SpMV and its norms vectors, so a dot
    written for vectors (a blocked sum, say) still runs; the projections
    take the lane dot ``proj``."""
    _, data, cols = convdiff
    n = data.shape[0]
    b = torch.from_numpy(_rhs(n, 1)[0])

    def blocked(u, v):
        return (u * v).view(-1, 48).sum(1).sum()

    state = (torch.zeros(n), torch.dot(b, b))
    x, rr = ref.gmres_cycle_matvec(state, lambda q: ref.spmv_ell(
        data, cols, q), b, M, dot=blocked)
    x2, rr2 = ref.gmres_cycle_matvec(state, lambda q: ref.spmv_ell(
        data, cols, q), b, M)
    np.testing.assert_allclose(x.numpy(), x2.numpy(), **KRYLOV_TOL)
    assert float(rr) < float(torch.dot(b, b))
