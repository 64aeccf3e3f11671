"""The port's Krylov slice against the JAX reference: BiCGStab and GMRES(m)
through ``plan`` -> ``execute`` on every single-device tier, their fused
kernels' plain versions, the Givens least-squares solve, the cache arrays
and the planner's Krylov branch, mixed precision and refinement.

Inputs are made with numpy from a seed and handed to both packages. The
JAX kernels run as the JAX package's own tests run them on the CPU (Pallas
interpret mode); the port's wrappers run their plain torch versions
because the tensors lie on the CPU. Bounds: x and rr at rtol 1e-3, atol
1e-5, the reference's fused-CG bound (``tests/test_kernels_linalg.py``),
since the two packages sum the dots and the projections in different
orders. BiCGStab is held after 30 iterations, past its erratic phase: on
``convdiff_small`` with the kernel test's b, the reference's own two
float32 runs (its Pallas kernel and its plain ``bicgstab_run``) differ by
0.16 in x after 10 iterations and 0.004 after 20, and agree to 1e-6 after
30. The registry's Poisson entries are not among the parity inputs for
BiCGStab: after 20-30 iterations there two float32 runs whose dots sum in
different orders differ by up to 0.4 in x (max |x| about 10), each as far
from a float64 run; ``fem_band_8k`` is the SPD entry. Within the port the
loop tiers
agree bit for bit. The CUDA kernels are held to their plain versions on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import itertools
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode

from repro import sparse as jsp
from repro.core import cache_policy as jcp
from repro.exec import BiCGStabProblem as JaxBiCGStabProblem
from repro.exec import GMRESProblem as JaxGMRESProblem
from repro.exec import Plan as JaxPlan
from repro.exec import execute as jax_execute
from repro.exec import planner as jplanner
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import plan_from_reference
from repro_torch.core import cache_policy as tcp
from repro_torch.exec import (BiCGStabProblem, CGProblem, GMRESProblem, Plan,
                              compensated_vdot, execute, fused_block_rows,
                              plan_candidates, solve_refined)
from repro_torch.exec.krylov import (BICGSTAB_STEP_LAUNCHES,
                                     GMRES_CYCLE_LAUNCHES)
from repro_torch.exec.precision import dot_for
from repro_torch.kernels import ops, ref
from repro_torch.kernels.vdot import plain_vdot
from repro_torch.sparse import PROXY_ONCHIP_BYTES, generate
from repro_torch.sparse.generate import banded_spd, convdiff2d

TOL = dict(rtol=1e-3, atol=1e-5)
#: two nonsymmetric registry entries and one SPD entry
NAMES = ["convdiff_small", "skew_shift_8k", "fem_band_8k"]
ITERS = 30      # BiCGStab iterations
CYCLES, M = 2, 8


def _rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _pair(kind, name, steps=None, tol=None):
    """The reference's and the port's problem of ``kind`` on registry entry
    ``name`` with the same numpy b."""
    csr = generate(name)
    ell = csr.to_ell()
    b = _rhs(csr.shape[0], seed=5)
    jd, jc, jb = (jnp.asarray(a) for a in (ell.data, ell.cols, b))
    if kind == "bicgstab":
        steps = ITERS if steps is None else steps
        jp = JaxBiCGStabProblem.from_ell(jd, jc, jb, steps, matrix=csr,
                                         tol=tol)
        tp = BiCGStabProblem.from_ell(ell.data, ell.cols, b, steps,
                                      matrix=csr, tol=tol, device="cpu")
    else:
        steps = CYCLES if steps is None else steps
        jp = JaxGMRESProblem.from_ell(jd, jc, jb, steps, m=M, matrix=csr,
                                      tol=tol)
        tp = GMRESProblem.from_ell(ell.data, ell.cols, b, steps, m=M,
                                   matrix=csr, tol=tol, device="cpu")
    return jp, tp


# -- the loop tiers and the plain runs -------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", ["bicgstab", "gmres"])
def test_loop_tiers_match_reference(kind, name):
    jp, tp = _pair(kind, name)
    d, c, b = (jnp.asarray(t.numpy()) for t in (tp.data, tp.cols, tp.b))
    if kind == "bicgstab":
        want = jref.bicgstab_run(d, c, b, ITERS)
    else:
        want = jref.gmres_run(d, c, b, CYCLES, M)
    host = execute(tp, Plan(tier="host_loop"))
    dev = execute(tp, Plan(tier="device_loop"))
    chunked = execute(tp, Plan(tier="device_loop", sync_every=3))
    oracle = tp.oracle()
    for got in (host, oracle):
        _close(got[0], want[0])
        _close(got[1], want[1])
        assert got[1].shape == ()
    for other in (dev, chunked, oracle):   # one step function, one order
        assert torch.equal(host[0], other[0]) and torch.equal(host[1],
                                                              other[1])
    assert np.array_equal(tp.b.numpy(), _rhs(tp.b.shape[0], seed=5))


@pytest.mark.parametrize("name", NAMES)
def test_fused_kernels_plain_versions_match_pallas(name):
    csr = generate(name)
    ell = csr.to_ell()
    n = csr.shape[0]
    b = _rhs(n, seed=7)
    x0 = _rhs(n, seed=8) * 0.1
    jd, jc, jb, jx0 = (jnp.asarray(a) for a in (ell.data, ell.cols, b, x0))
    td, tc, tb, tx0 = (_t(a) for a in (ell.data, ell.cols, b, x0))
    bm = fused_block_rows(n)
    for resident in (True, False):
        gx, grr = jops.bicgstab(jd, jc, jb, iters=ITERS,
                                resident_matrix=resident, block_rows=bm)
        tx, trr = ops.bicgstab(td, tc, tb, iters=ITERS,
                               resident_matrix=resident, block_rows=bm)
        assert trr.shape == (1,)
        _close(tx, gx)
        _close(trr, grr)
    gV, gH, gbeta = jops.gmres_cycle(jd, jc, jx0, jb, m=M)
    tV, tH, tbeta, tx = ops.gmres_cycle(td, tc, tx0, tb, m=M)
    assert tV.shape == (M + 1, n) and tH.shape == (M + 1, M)
    assert tbeta.shape == (1,) and tx.shape == (n,)
    _close(tV, gV)
    _close(tH, gH)
    _close(tbeta, gbeta)
    # the port's kernel also takes the reference resident tier's next step:
    # the least-squares solve and x + y V[:m]
    e1 = jnp.zeros(M + 1, jnp.float32).at[0].set(gbeta[0])
    gy = jnp.linalg.lstsq(gH, e1)[0]
    _close(tx, jx0 + gy @ gV[:M])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", ["bicgstab", "gmres"])
def test_resident_tier_matches_reference(kind, name):
    jp, tp = _pair(kind, name)
    cands = plan_candidates(tp)
    resident = [p for p in cands if p.tier == "resident"]
    assert {p.policy for p in resident} == (
        {"MIX", "VEC"} if kind == "bicgstab" else {"MIX"})
    for p in resident:
        x, rr = execute(tp, p)
        jx, jrr = jax_execute(jp, JaxPlan.from_json(p.to_json()))
        _close(x, jx)
        _close(rr, jrr)
        assert rr.shape == ()


def test_gmres_breakdown_matches_reference():
    """An exact Arnoldi breakdown: A diagonal and b on one axis, so
    A v_0 = d v_0, h_{1,0} = 0 and every later column of H is 0; the Givens
    solve gives the reference SVD's minimum-norm answer. Then n < m, where
    the Krylov space runs out within the first cycle in rounding noise."""
    n = 6
    d = np.array([2, 3, 5, 7, 11, 13], np.float32)
    data = np.zeros((n, 3), np.float32)
    data[:, 0] = d
    cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, 3))
    b = np.zeros(n, np.float32)
    b[2] = 4.0
    V, H, beta = ref.gmres_arnoldi(torch.zeros(n), _t(b),
                                   lambda q: ref.spmv_ell(_t(data), _t(cols),
                                                          q), 8)
    assert float(beta[0]) == 4.0 and float(H[0, 0]) == 5.0
    assert (H[1:, 0] == 0).all() and (H[:, 1:] == 0).all()
    assert (V[1:] == 0).all()
    for cycles in (1, 2):
        want = jref.gmres_run(jnp.asarray(data), jnp.asarray(cols),
                              jnp.asarray(b), cycles, 8)
        got = ref.gmres_run(_t(data), _t(cols), _t(b), cycles, 8)
        _close(got[0], want[0])
        _close(got[1], want[1])
        assert float(got[0][2]) == pytest.approx(0.8) and float(got[1]) == 0
    p = GMRESProblem.from_ell(data, cols, b, 2, m=8, device="cpu")
    for pl in (Plan(tier="resident", policy="MIX"), Plan(tier="host_loop")):
        x, rr = execute(p, pl)      # the host solve and the Givens solve
        _close(x, got[0])
        assert float(rr) == 0

    rng = np.random.default_rng(3)
    n = 5
    a = rng.standard_normal((n, n)).astype(np.float32)
    a += np.diag(np.abs(a).sum(1) + 1).astype(np.float32)
    cols = np.tile(np.arange(n, dtype=np.int32), (n, 1))
    b = _rhs(n, seed=9)
    want = jref.gmres_run(jnp.asarray(a), jnp.asarray(cols), jnp.asarray(b),
                          2, 8)
    got = ref.gmres_run(_t(a), _t(cols), _t(b), 2, 8)
    _close(got[0], want[0])
    _close(got[1], want[1])
    np.testing.assert_allclose(np.linalg.solve(a.astype(np.float64), b),
                               got[0].numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("breakdown", [None, 5, 2, 0])
def test_hessenberg_lstsq_matches_reference_lstsq(breakdown):
    rng = np.random.default_rng(11 if breakdown is None else breakdown)
    m = 8
    H = np.triu(rng.standard_normal((m + 1, m)), -1).astype(np.float32)
    if breakdown is not None:   # h_{k+1,k} = 0 and the later columns 0
        H[breakdown + 1, breakdown] = 0.0
        H[:, breakdown + 1:] = 0.0
    beta = np.float32(1.7)
    e1 = np.zeros(m + 1, np.float32)
    e1[0] = beta
    want = np.asarray(jnp.linalg.lstsq(jnp.asarray(H), jnp.asarray(e1))[0])
    got = ref.hessenberg_lstsq(_t(H), torch.tensor([beta])).numpy()
    _close(got, want)
    if breakdown is not None:
        assert (got[breakdown + 1:] == 0).all()
    zero = ref.hessenberg_lstsq(torch.zeros(m + 1, m), torch.zeros(1))
    assert torch.equal(zero, torch.zeros(m))


def _ell(name):
    ell = generate(name).to_ell()
    return ell.data, ell.cols


def test_bicgstab_converged_state_is_a_fixed_point():
    data, cols = _ell("convdiff_small")
    tp = BiCGStabProblem.from_ell(data, cols, np.zeros(2304, np.float32), 5,
                                  device="cpu")
    for p in plan_candidates(tp):
        x, rr = execute(tp, p)
        assert torch.equal(x, torch.zeros(2304)) and float(rr) == 0.0


# -- the launch counts the planner charges ----------------------------------------

class _Count(TorchDispatchMode):
    """The operators a call dispatches, views and in-place reshapes not
    counted (they launch nothing on the card); a call wrapped by
    ``kernel`` counts as one launch whatever it dispatches (GMRES's lane
    dot, one ``vdot`` launch on the card)."""

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
        return [f for f in self.ops if f == "kernel" or (
            not f.is_view and "squeeze" not in str(f))]


def test_krylov_steps_dispatch_what_the_planner_charges():
    n = 12
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    b = torch.from_numpy(_rhs(n))
    state = ref.bicgstab_initial_state(b)
    out = tuple(torch.empty_like(t) for t in state)
    with _Count() as counted:   # the two SpMVs are one mv each here
        ref.bicgstab_iteration_matvec(state, lambda q: a @ q,
                                      dot=dot_for("uniform"), out=out)
    assert len(counted.launches) == BICGSTAB_STEP_LAUNCHES
    state, out = (torch.zeros(n), torch.dot(b, b)), torch.empty(n)
    for m in (1, 3, 8, 16):
        with _Count() as counted:   # m + 2 SpMVs, one mv each
            ref.gmres_cycle_matvec(state, lambda q: a @ q, b, m, out=out,
                                   proj=counted.kernel(plain_vdot))
        assert len(counted.launches) == GMRES_CYCLE_LAUNCHES(m), m
        # nothing is read on the host, so a CUDA graph can hold the cycle
        assert not any("_local_scalar_dense" in str(f) or "item" in str(f)
                       for f in counted.ops)
    _, tp = _pair("gmres", "convdiff_small")
    assert tp.step_launches() == GMRES_CYCLE_LAUNCHES(M)
    _, tb = _pair("bicgstab", "convdiff_small")
    assert tb.step_launches() == BICGSTAB_STEP_LAUNCHES


def test_host_loop_is_charged_per_kind(monkeypatch):
    from repro_torch.exec import planner
    o = planner.DISPATCH_OVERHEAD_S
    for kind in ("bicgstab", "gmres"):
        _, tp = _pair(kind, "convdiff_small", steps=6)
        by = {(c.tier, c.policy): c for c in plan_candidates(tp)}
        host, dev = by[("host_loop", None)], by[("device_loop", "IMP")]
        k = tp.step_launches()
        assert host.predicted_s - 6 * k * o == pytest.approx(
            dev.predicted_s - (6 * k + 1) * o)


# -- cache arrays and the planner ----------------------------------------------------

def test_krylov_cache_arrays_match_reference():
    for n, nnz, m in itertools.product((1, 100, 4096, 2**20),
                                       (0, 5, 5 * 4096, 20 * 2**20),
                                       (1, 8, 16, 31)):
        assert [vars(a) for a in tcp.bicgstab_arrays(n, nnz, 4)] == \
            [vars(a) for a in jcp.bicgstab_arrays(n, nnz, 4)]
        assert [vars(a) for a in tcp.gmres_arrays(n, m, nnz, 4)] == \
            [vars(a) for a in jcp.gmres_arrays(n, m, nnz, 4)]
    for name in sorted(jsp.REGISTRY):
        assert [vars(a) for a in tcp.bicgstab_arrays_for(generate(name))] \
            == [vars(a) for a in jcp.bicgstab_arrays_for(jsp.generate(name))]
        assert [vars(a) for a in tcp.gmres_arrays_for(generate(name), 16)] \
            == [vars(a) for a in jcp.gmres_arrays_for(jsp.generate(name),
                                                      16)]


@pytest.mark.parametrize("name", ["convdiff_small", "convdiff_16k",
                                  "skew_shift_8k", "fem_band_8k"])
@pytest.mark.parametrize("kind", ["bicgstab", "gmres"])
def test_krylov_candidates_match_reference(kind, name):
    jp, tp = _pair(kind, name, steps=12)
    for budget in (PROXY_ONCHIP_BYTES, 200_000, 600_000, 10**8):
        got = plan_candidates(tp, budget_bytes=budget)
        want = jplanner.plan_candidates(jp, budget_bytes=budget)

        def key(p):
            return (p.tier, p.policy, p.block_rows, p.cache, p.sync_every)

        assert sorted(map(key, got), key=repr) == sorted(
            (key(plan_from_reference(p.to_json())) for p in want), key=repr)
        assert got == sorted(got, key=lambda p: p.predicted_s)
        for p in got:   # through JSON to the reference and back
            jplan = JaxPlan.from_json(p.to_json())
            assert plan_from_reference(jplan.to_dict()) == p
            assert json.loads(jplan.to_json()) == json.loads(p.to_json())


def _sized(kind, side, **kw):
    """A problem of the chip_smoke cells' sizes (convdiff2d(side): n =
    side^2, nnz = 5n - 4 side) on zero planes: planning reads shapes."""
    n = side * side
    matrix = types.SimpleNamespace(shape=(n, n), nnz=5 * n - 4 * side,
                                   data=np.zeros(1, np.float32))
    data = torch.zeros((n, 5))
    cols = torch.zeros((n, 5), dtype=torch.int32)
    cls = BiCGStabProblem if kind == "bicgstab" else GMRESProblem
    return cls.from_ell(data, cols, torch.zeros(n), 4, matrix=matrix,
                        device="cpu", **kw)


def test_planner_regimes_on_the_h100():
    """The chip_smoke Krylov cells, from sizes alone (nothing is built)."""
    def resident(p):
        return {c.policy: c for c in plan_candidates(p)
                if c.tier == "resident"}

    small = resident(_sized("bicgstab", 512))
    assert small["MIX"].cache[-1].fraction == 1.0 and "VEC" in small
    large = resident(_sized("bicgstab", 768))
    assert 0.4 < large["MIX"].cache[-1].fraction < 0.55
    assert {c.name for c in large["MIX"].cache} == {
        "r", "s", "p", "v", "t", "rhat", "x", "A"}
    gsmall = resident(_sized("gmres", 448, m=16))
    assert set(gsmall) == {"MIX"}
    assert all(c.fraction == 1.0 for c in gsmall["MIX"].cache)
    assert resident(_sized("gmres", 1024, m=16)) == {}
    assert _sized("gmres", 1024, m=16).cacheable_arrays()[0].bytes == \
        17 * 4 * 2**20


def test_planner_charges_the_gmres_cycles_rounds(monkeypatch):
    """gmres-small (convdiff2d(448), m = 16, 4 cycles): its resident MIX
    plan carries 1 + 3m = 49 tagged rounds a cycle at GMRES_ROUND_SHARE_S,
    and is still the pick, also once the device loop's graph is kept
    (measured 0.97 ms against 5.6 ms for the kept device loop, PERF.md):
    the kept loop pays its 677 launches a cycle at GRAPH_LAUNCH_S. The
    loop tiers carry no round, and BiCGStab's three an iteration stay at
    KRYLOV_ROUND_S."""
    from repro_torch.core import perks
    from repro_torch.exec import planner
    from repro_torch.exec.krylov import GMRES_CYCLE_LAUNCHES
    p = _sized("gmres", 448, m=16)
    assert planner.krylov_round_s(p) == 49 * planner.GMRES_ROUND_SHARE_S
    assert planner.krylov_round_s(_sized("gmres", 448, m=8)) == \
        25 * planner.GMRES_ROUND_SHARE_S
    assert planner.krylov_round_s(_sized("bicgstab", 448)) == \
        3 * planner.KRYLOV_ROUND_S
    cands = plan_candidates(p)
    assert (cands[0].tier, cands[0].policy) == ("resident", "MIX")
    monkeypatch.setattr(perks, "graph_cached", lambda *a: True)
    kept = plan_candidates(p)
    assert (kept[0].tier, kept[0].policy) == ("resident", "MIX")
    loop = next(c for c in kept if c.tier == "device_loop")
    assert GMRES_CYCLE_LAUNCHES(16) == 677
    assert loop.predicted_s >= 4 * 677 * planner.GRAPH_LAUNCH_S
    monkeypatch.setattr(perks, "graph_cached", lambda *a: False)
    monkeypatch.setattr(planner, "GMRES_ROUND_SHARE_S", 0.0)
    free = {(c.tier, c.policy): c.predicted_s for c in plan_candidates(p)}
    for c in cands:
        rounds = 4 * 49 * 4.3e-6 if c.tier == "resident" else 0.0
        assert c.predicted_s == pytest.approx(free[c.tier, c.policy]
                                              + rounds, rel=1e-12)


# -- the problem surface --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bicgstab", "gmres"])
def test_krylov_problem_surface_matches_reference(kind):
    jp, tp = _pair(kind, "skew_shift_8k")
    assert tp.name == jp.name and tp.kind == jp.kind == kind
    assert [vars(a) for a in tp.cacheable_arrays()] == \
        [vars(a) for a in jp.cacheable_arrays()]
    assert vars(tp.halo_spec()) == vars(jp.halo_spec())
    assert tp.step_fn() is tp.step_fn()
    assert tp.initial_state() is tp.initial_state()
    assert tp.with_precision("uniform") is tp
    assert tp.batch_key() == tp.batch_key()
    with pytest.raises(NotImplementedError, match="distributed"):
        execute(tp, Plan(tier="distributed", shard_axis="data"))
    cls = type(tp)
    with pytest.raises(ValueError, match="ELL planes"):
        cls(b=np.zeros(4, np.float32), n_steps=1, device="cpu")
    with pytest.raises(ValueError, match="precision"):
        cls.from_ell(tp.data, tp.cols, tp.b, 2, device="cpu"
                     ).with_precision("double")


@pytest.mark.parametrize("kind", ["bicgstab", "gmres"])
def test_matvec_problems_run_the_loop_tiers(kind):
    csr = generate("convdiff_small")
    ell = csr.to_ell()
    b = _rhs(csr.shape[0], seed=6)
    d, c = _t(ell.data), _t(ell.cols)

    def mv(q):
        return ref.spmv_ell(d, c, q)

    cls = BiCGStabProblem if kind == "bicgstab" else GMRESProblem
    kw = {} if kind == "bicgstab" else {"m": M}
    steps = ITERS if kind == "bicgstab" else CYCLES
    q = cls.from_matvec(mv, b, steps, matrix=csr, device="cpu", **kw)
    p = cls.from_ell(ell.data, ell.cols, b, steps, matrix=csr,
                     device="cpu", **kw)
    cands = plan_candidates(q)
    assert sorted(c.tier for c in cands) == ["device_loop", "host_loop"]
    want = execute(p, Plan(tier="host_loop"))
    for pl in cands:
        got = execute(q, pl)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(NotImplementedError, match="ELL planes"):
        execute(q, Plan(tier="resident"))


@pytest.mark.parametrize("kind", ["bicgstab", "gmres"])
def test_tol_stops_the_loop_tiers_early(kind):
    steps = 200 if kind == "bicgstab" else 30
    jp, tp = _pair(kind, "convdiff_small", steps=steps, tol=1e-6)
    pl = plan_candidates(tp)[0]
    assert pl.sync_every == min(25, steps - 1)
    seen = []
    on_sync = tp.on_sync()
    from repro_torch.core import perks
    perks.chunked_loop(tp.step_fn(), steps, sync_every=5,
                       on_sync=lambda s, k: seen.append(k) or on_sync(s, k))(
        tp.initial_state())
    assert seen and seen[-1] < steps
    x, rr = execute(tp, Plan(tier="host_loop", sync_every=5))
    assert float(rr) < 1e-6 * float(torch.dot(tp.b, tp.b))


def test_same_shape_different_matrix_distinct_identity():
    n = 192
    b = _rhs(n)
    e1, e2 = (banded_spd(n, 4, seed=s).to_ell() for s in (20, 21))
    for cls, extra in ((CGProblem, {}), (BiCGStabProblem, {}),
                       (GMRESProblem, {"m": 8})):
        p1 = cls.from_ell(e1.data, e1.cols, b, 4, device="cpu", **extra)
        p2 = cls.from_ell(e2.data, e2.cols, b, 4, device="cpu", **extra)
        assert p1.name != p2.name, cls.__name__
        assert p1.batch_key() != p2.batch_key(), cls.__name__


# -- mixed precision and refinement ------------------------------------------------

def test_compensated_vdot_tracks_f64():
    """The reference's own cancellation vector. The port accumulates in
    float64 and rounds once, so it lands within 1e-6 of the float64 dot
    relative to its size; the reference's Neumaier scan (float32 products)
    does not meet that bound on this vector."""
    rng = np.random.default_rng(11)
    a = np.float32(rng.standard_normal(4096) * 1e4)
    c = np.float32(rng.standard_normal(4096))
    exact = float(np.asarray(a, np.float64) @ np.asarray(c, np.float64))
    comp = float(compensated_vdot(_t(a), _t(c)))
    naive = float(torch.dot(_t(a), _t(c)))
    scale = abs(exact) + 1e-12
    assert abs(comp - exact) / scale <= abs(naive - exact) / scale + 1e-9
    assert abs(comp - exact) / scale < 1e-6
    assert compensated_vdot(_t(a), _t(c)).dtype == torch.float32
    assert dot_for("mixed") is compensated_vdot


@pytest.mark.parametrize("kind", ["cg", "bicgstab", "gmres"])
def test_mixed_precision_plan_dimension(kind):
    e = banded_spd(192, 4, seed=12).to_ell()
    b = _rhs(192, seed=1)
    prob = {
        "cg": lambda: CGProblem.from_ell(e.data, e.cols, b, 10,
                                         device="cpu"),
        "bicgstab": lambda: BiCGStabProblem.from_ell(e.data, e.cols, b, 10,
                                                     device="cpu"),
        "gmres": lambda: GMRESProblem.from_ell(e.data, e.cols, b, 2, m=8,
                                               device="cpu"),
    }[kind]()
    xu, _ = execute(prob, Plan(tier="host_loop"))
    xm, rrm = execute(prob, Plan(tier="host_loop", precision="mixed"))
    xd, _ = execute(prob, Plan(tier="device_loop", precision="mixed"))
    scale = max(float(xu.abs().max()), 1e-12)
    assert float((xm - xu).abs().max()) / scale < 1e-3
    assert np.isfinite(float(rrm)) and torch.equal(xm, xd)
    with pytest.raises(NotImplementedError, match="mixed"):
        execute(prob.with_precision("mixed"),
                Plan(tier="resident", policy="MIX"))


@pytest.mark.parametrize("kind", ["cg", "bicgstab", "gmres"])
def test_solve_refined_improves_residual(kind):
    e = banded_spd(192, 4, seed=13).to_ell()
    b = _rhs(192, seed=2)
    cls = {"cg": CGProblem, "bicgstab": BiCGStabProblem,
           "gmres": GMRESProblem}[kind]
    steps, kw = {"cg": (12, {}), "bicgstab": (3, {}),
                 "gmres": (1, {"m": 4})}[kind]
    prob = cls.from_ell(e.data, e.cols, b, steps, device="cpu", **kw)
    _, rr0 = execute(prob, Plan(tier="host_loop"))
    x, rr2 = solve_refined(prob, Plan(tier="host_loop", precision="mixed"),
                           rounds=2)
    assert float(rr2) < float(rr0), (float(rr2), float(rr0))
    r = prob.b - ref.spmv_ell(prob.data, prob.cols, x)
    assert float(torch.dot(r, r)) == pytest.approx(float(rr2), rel=1e-4)
    with pytest.raises(ValueError, match="rounds"):
        solve_refined(prob, Plan(tier="host_loop"), rounds=0)


def test_the_chip_cells_are_the_reference_convdiff():
    """chip_smoke.py builds its Krylov cells with ``convdiff2d``: the same
    ELL planes as the reference's generator, K = 5 slots a row."""
    from repro.sparse.generate import convdiff2d as jax_convdiff2d
    got, want = convdiff2d(24).to_ell(), jax_convdiff2d(24).to_ell()
    assert got.data.shape == (576, 5)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.cols, want.cols)


# -- kept graphs of changed problems --------------------------------------------

@pytest.mark.parametrize("kind", ["cg", "bicgstab", "gmres"])
def test_changed_problems_share_the_kept_graph(kind, monkeypatch):
    """A mixed-precision copy is made once, and every solve_refined round
    runs its step function: the b-swapped rounds resolve to the first
    round's graph key (the device loop keys by step function and shapes)."""
    from repro_torch.core import perks
    e = banded_spd(192, 4, seed=14).to_ell()
    b = _rhs(192, seed=3)
    cls = {"cg": CGProblem, "bicgstab": BiCGStabProblem,
           "gmres": GMRESProblem}[kind]
    kw = {"m": 4} if kind == "gmres" else {}
    prob = cls.from_ell(e.data, e.cols, b, 3, device="cpu", **kw)
    mixed = prob.with_precision("mixed")
    assert prob.with_precision("mixed") is mixed
    assert mixed.with_precision("uniform") is mixed.with_precision("uniform")
    assert mixed.step_fn() is not prob.step_fn()
    copy = prob.with_rhs(_t(_rhs(192, seed=4)))
    assert copy.step_fn() is prob.step_fn()
    assert copy.with_precision("mixed").step_fn() is mixed.step_fn()
    assert perks._graph_key(copy.step_fn(), copy.initial_state(), 3) == \
        perks._graph_key(prob.step_fn(), prob.initial_state(), 3)
    seen = []
    real = perks.persistent

    def spy(step_fn, n_steps, config, *, on_sync=None):
        seen.append(step_fn)
        return real(step_fn, n_steps, config, on_sync=on_sync)

    monkeypatch.setattr(perks, "persistent", spy)
    solve_refined(prob, Plan(tier="device_loop", precision="mixed"), rounds=3)
    assert len(seen) == 3 and all(f is mixed.step_fn() for f in seen)


def test_kept_graph_replays_from_the_state_it_is_given(monkeypatch):
    """The kept path with a stand-in for CUDA graph capture: a b-swapped
    copy replays the original's graph (one capture in all) and gets its
    own answer, not the original's (its b is copied into the graph's
    input buffers), and an entry goes with its step function."""
    import collections
    import gc
    import weakref

    from repro_torch.core import perks
    captured = []

    def fake_capture(step_fn, x, n_steps):
        captured.append(x)
        step = weakref.ref(step_fn)    # a CUDA graph holds no Python object

        def loop():
            cur, bufs = x, perks._buffers(x)
            for k in range(n_steps):
                cur = step()(cur, bufs[k % 2])
            return cur

        out = perks._clone(loop())

        class Graph:
            def replay(self):
                perks._copy_into(out, loop())

        return Graph(), perks._buffers(x), out

    monkeypatch.setattr(perks, "capture", fake_capture)
    monkeypatch.setattr(perks, "_GRAPHS", collections.OrderedDict())
    e = banded_spd(192, 4, seed=15).to_ell()
    prob = CGProblem.from_ell(e.data, e.cols, _rhs(192, seed=5), 6,
                              device="cpu")
    copy = prob.with_rhs(_t(_rhs(192, seed=6)))
    for p in (prob, copy, prob):
        x, rr = p.finalize(perks._kept(p.step_fn(), p.initial_state(), 6))
        want = execute(p, Plan(tier="host_loop"))
        assert torch.equal(x, want[0]) and torch.equal(rr, want[1])
    assert len(captured) == 1 and len(perks._GRAPHS) == 1
    del prob, copy, p
    gc.collect()
    assert len(perks._GRAPHS) == 0, "the entry outlived its step function"
