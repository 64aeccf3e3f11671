"""The port's ML serving slice against the JAX reference: the SSD scan and
decode attention (plain versions and the reference's Pallas kernels),
``SSMScanProblem`` and ``DecodeAttentionProblem`` through ``plan`` ->
``execute`` on every single-device tier, the dense model's prefill and
decode step, and the ``Engine``.

Inputs are made with numpy from a seed; model parameters are the
reference's own init carried over by ``convert.params_from_reference``.
The reference's Pallas kernels run as its own tests run them on the CPU
(interpret mode); the port's wrappers run their plain versions because the
tensors lie on the CPU. Bounds are the reference's: the SSD scan at 1e-3
(float32) / 5e-2 (bf16), decode attention at rtol 1e-4 / atol 1e-5
(float32) / 5e-2 (bf16) (``tests/test_kernels_linalg.py``), the SSD tiers
at 1e-3 (``tests/test_ml_problems.py``). Identity of tokens with the
reference is asserted with ``compute_dtype=float32`` (a
``dataclasses.replace`` of the smoke config); at bf16 the logits are held
at 5e-2 and the tokens up to the first step where the reference's top-two
logit margin is below 5e-2, since a greedy argmax flips wherever two logits
are closer than the two packages' rounding. The CUDA kernels are held to
their plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.exec import DecodeAttentionProblem as JaxDecodeProblem
from repro.exec import Plan as JaxPlan
from repro.exec import SSMScanProblem as JaxSSMProblem
from repro.exec import execute as jax_execute
from repro.exec import plan as jax_plan
from repro.exec import plan_candidates as jax_plan_candidates
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.lm import Model as JaxModel
from repro.nn import attention as jattn
from repro.nn.param import count_params as jcount
from repro.nn.param import param_bytes as jparam_bytes
from repro.runtime.server import Engine as JaxEngine
from repro.runtime.server import Request as JaxRequest
from repro.runtime.server import ServeConfig as JaxServeConfig
from repro_torch import configs as tconfigs
from repro_torch.convert import (cache_from_reference, params_from_reference,
                                 plan_from_reference)
from repro_torch.exec import (DecodeAttentionProblem, Plan, SSMScanProblem,
                              execute, plan, plan_candidates)
from repro_torch.exec import planner
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as kssm
from repro_torch.models import lm
from repro_torch.models.lm import Model
from repro_torch.nn import attention as tattn
from repro_torch.nn.param import param_bytes
from repro_torch.runtime.server import Engine, Request, ServeConfig

TIERS = ("host_loop", "device_loop", "resident")
SSM_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
DECODE_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = 5e-2
CPU = "cpu"


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the SSD scan ---------------------------------------------------------------

def _ssd_inputs(bsz, t, h, p, n, seed=0):
    g = np.random.default_rng(seed)
    x = (0.5 * g.standard_normal((bsz, t, h, p))).astype(np.float32)
    dt = np.log1p(np.exp(g.standard_normal((bsz, t, h)))).astype(np.float32)
    a = (-np.exp(g.standard_normal(h))).astype(np.float32)
    b = (0.5 * g.standard_normal((bsz, t, n))).astype(np.float32)
    c = (0.5 * g.standard_normal((bsz, t, n))).astype(np.float32)
    d = g.standard_normal(h).astype(np.float32)
    return x, dt, a, b, c, d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [8, 64])
def test_ssd_scan_matches_reference(chunk, dtype):
    x, dt, a, b, c, d = _ssd_inputs(2, 64, 4, 8, 16)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jdt, jb, jc = (jnp.asarray(v).astype(jd) for v in (x, dt, b, c))
    want = jops.ssd_scan(jx, jdt, jnp.asarray(a), jb, jc, jnp.asarray(d),
                         chunk=chunk)
    oracle = jax.vmap(lambda x_, dt_, b_, c_: jref.ssm_scan(
        x_.astype(jnp.float32), dt_.astype(jnp.float32), jnp.asarray(a),
        b_.astype(jnp.float32), c_.astype(jnp.float32), jnp.asarray(d)))(
            jx, jdt, jb, jc)
    tx, tdt, tb, tc = (_t(np.asarray(v.astype(jnp.float32))).to(td)
                       for v in (jx, jdt, jb, jc))
    got = ops.ssd_scan(tx, tdt, _t(a), tb, tc, _t(d), chunk=chunk)
    assert got.dtype == td and got.shape == tx.shape
    tol = SSM_TOL[dtype]
    for w in (want, oracle):
        np.testing.assert_allclose(got.float().numpy(), _np(w), rtol=tol,
                                   atol=tol)


def test_ssm_scan_plain_matches_reference_oracle():
    x, dt, a, b, c, d = _ssd_inputs(1, 40, 3, 4, 8, seed=5)
    want = jref.ssm_scan(*(jnp.asarray(v) for v in (x[0], dt[0], a, b[0],
                                                    c[0], d)))
    got = ref.ssm_scan(*(_t(v) for v in (x[0], dt[0], a, b[0], c[0], d)))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    single = kssm.ssm_scan(*(_t(v) for v in (x[0], dt[0], a, b[0], c[0], d)),
                          chunk=7)
    np.testing.assert_allclose(single.numpy(), _np(want), rtol=1e-5,
                               atol=1e-5)


def _ssm_pair(t=64, h=2, p=4, n=8, chunk=16, seed=2):
    x, dt, a, b, c, d = _ssd_inputs(1, t, h, p, n, seed=seed)
    args = (x[0], dt[0], a, b[0], c[0], d)
    jprob = JaxSSMProblem(*(jnp.asarray(v) for v in args), chunk=chunk)
    tprob = SSMScanProblem(*args, chunk=chunk, device=CPU)
    return jprob, tprob


@pytest.mark.parametrize("t,chunk,eff", [(64, 16, 16), (60, 16, 15),
                                         (13, 8, 1)])
def test_ssm_problem_tiers_match_reference(t, chunk, eff):
    jprob, tprob = _ssm_pair(t=t, chunk=chunk)
    assert tprob.chunk_eff == jprob.chunk_eff == eff
    assert tprob.n_steps == jprob.n_steps
    want = _np(jprob.oracle())
    np.testing.assert_allclose(tprob.oracle().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    x0 = tprob.x.clone()
    for tier in TIERS:
        got = execute(tprob, Plan(tier=tier))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3,
                                   err_msg=tier)
        np.testing.assert_allclose(
            got.numpy(), _np(jax_execute(jprob, JaxPlan(tier=tier))),
            rtol=1e-3, atol=1e-3, err_msg=tier)
    assert torch.equal(tprob.x, x0)
    # the loop tiers run one step function: bit for bit
    assert torch.equal(execute(tprob, Plan(tier="host_loop")),
                       execute(tprob, Plan(tier="device_loop")))


def test_ssm_problem_cost_terms_match_reference():
    jprob, tprob = _ssm_pair(t=60)
    assert [(a.name, a.bytes, a.loads_per_step, a.stores_per_step)
            for a in tprob.cacheable_arrays()] == [
        (a.name, a.bytes, a.loads_per_step, a.stores_per_step)
        for a in jprob.cacheable_arrays()]
    assert tprob.resident_scratch_bytes() == jprob.resident_scratch_bytes()
    assert tprob.domain_bytes() == jprob.domain_bytes()
    assert tprob.name == jprob.name


def test_ssm_planner_structure_and_plan_json():
    _, tprob = _ssm_pair(t=256, chunk=32)
    cands = plan_candidates(tprob)
    assert cands[0].tier == "resident"
    assert {c.tier for c in cands} == set(TIERS)
    squeezed = plan_candidates(
        tprob, budget_bytes=tprob.resident_scratch_bytes() // 2)
    assert all(c.tier != "resident" for c in squeezed)
    # plans cross between the packages through their shared JSON schema
    jprob, _ = _ssm_pair()
    jp = jax_plan(jprob)
    tp = plan_from_reference(jp.to_json())
    assert tp.tier == jp.tier == "resident" and tp.to_json() == jp.to_json()
    assert JaxPlan.from_json(plan(tprob).to_json()).to_json() == \
        plan(tprob).to_json()
    _, small = _ssm_pair()
    np.testing.assert_allclose(execute(small, tp).numpy(),
                               _np(jprob.oracle()), rtol=1e-3, atol=1e-3)


# -- decode attention -----------------------------------------------------------

@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 2), (4, 1), (14, 2)])
@pytest.mark.parametrize("s", [96, 128])
def test_decode_attention_matches_reference(hq, hkv, s):
    g = np.random.default_rng(hq * 100 + s)
    bsz, dim = 2, 32
    q = g.standard_normal((bsz, hq, dim)).astype(np.float32)
    k = g.standard_normal((bsz, s, hkv, dim)).astype(np.float32)
    v = g.standard_normal((bsz, s, hkv, dim)).astype(np.float32)
    length = np.array([s, s // 3 + 1], np.int32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = _t(q), _t(k), _t(v)
    for ln in (None, length):
        jl = None if ln is None else jnp.asarray(ln)
        tl = None if ln is None else _t(ln)
        want = _np(jref.decode_attention(jq, jk, jv, length=jl))
        for got in (ref.decode_attention(tq, tk, tv, length=tl),
                    ops.decode_attention(tq, tk, tv, length=tl),
                    tattn.decode_attention(tq, tk, tv, length=tl)):
            np.testing.assert_allclose(got.numpy(), want, **DECODE_TOL)
        np.testing.assert_allclose(
            tattn.decode_attention(tq, tk, tv, length=tl).numpy(),
            _np(jattn.decode_attention(jq, jk, jv, length=jl)),
            **DECODE_TOL)
    # the Pallas kernel (interpret mode) computes the length=None case
    np.testing.assert_allclose(
        ops.decode_attention(tq, tk, tv).numpy(),
        _np(jops.decode_attention(jq, jk, jv, block_s=32)), **DECODE_TOL)


def test_decode_attention_bf16_matches_reference():
    g = np.random.default_rng(7)
    q = g.standard_normal((2, 14, 64)).astype(np.float32)
    k = g.standard_normal((2, 40, 2, 64)).astype(np.float32)
    v = g.standard_normal((2, 40, 2, 64)).astype(np.float32)
    length = np.array([40, 9], np.int32)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    tb = [_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
          for a in jb]
    for fn_t, fn_j in ((tattn.decode_attention, jattn.decode_attention),
                       (ref.decode_attention, jref.decode_attention)):
        got = fn_t(*tb, length=_t(length))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(
            got.float().numpy(), _np(fn_j(*jb, length=jnp.asarray(length))),
            rtol=BF16_TOL, atol=BF16_TOL)


def test_kernel_wrappers_refuse_mismatched_operands():
    x, dt, a, b, c, d = (_t(v) for v in _ssd_inputs(1, 8, 2, 4, 3))
    with pytest.raises(ValueError, match="do not fit"):
        ops.ssd_scan(x, dt, a, b[:, :4], c, d)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, dt, a, b, c, d, chunk=0)
    q, k = torch.zeros(2, 6, 8), torch.zeros(2, 5, 4, 8)
    with pytest.raises(ValueError, match="does not fit"):
        ops.decode_attention(q, k, k)           # 6 heads over 4 kv heads
    with pytest.raises(ValueError, match="length"):
        ops.decode_attention(q[:, :4], k, k, length=torch.ones(3,
                                                               dtype=torch.int32))


def test_rope_matches_reference():
    from repro.nn.rope import apply_rope as japply
    from repro_torch.nn.rope import apply_rope
    g = np.random.default_rng(4)
    x = g.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            apply_rope(_t(x), _t(pos), theta=theta).numpy(),
            _np(japply(jnp.asarray(x), jnp.asarray(pos), theta=theta)),
            rtol=1e-5, atol=1e-5)


def test_chunked_attention_matches_reference():
    g = np.random.default_rng(3)
    q = g.standard_normal((2, 64, 4, 16)).astype(np.float32)
    k = g.standard_normal((2, 64, 2, 16)).astype(np.float32)
    v = g.standard_normal((2, 64, 2, 16)).astype(np.float32)
    for window in (None, 20):
        want = jattn.chunked_attention(
            *(jnp.asarray(a) for a in (q, k, v)), window=window, q_chunk=16,
            kv_chunk=32)
        got = tattn.chunked_attention(_t(q), _t(k), _t(v), window=window,
                                      q_chunk=16, kv_chunk=32)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-5)


# -- configs and parameters -------------------------------------------------------

@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_configs_match_reference(arch):
    for jget, tget in ((jreg.get_config, tconfigs.get_config),
                       (jreg.get_smoke_config, tconfigs.get_smoke_config)):
        jc, tc = dataclasses.asdict(jget(arch)), dataclasses.asdict(tget(arch))
        for key in ("param_dtype", "compute_dtype"):
            assert str(tc.pop(key)).replace("torch.", "") == \
                jnp.dtype(jc.pop(key)).name
        assert tc == jc
    cfg = tconfigs.get_config(arch)
    if (cfg.family in ("dense", "ssm", "hybrid") and cfg.mla is None
            and cfg.moe is None):
        assert cfg.n_params() == jreg.get_config(arch).n_params()
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cfg.n_params()


def test_init_is_seeded_and_shaped_like_the_reference():
    cfg = tconfigs.get_smoke_config("qwen2-0.5b")
    model = Model(cfg)
    p1 = model.init(torch.Generator().manual_seed(0))
    p2 = model.init(torch.Generator().manual_seed(0))
    p3 = model.init(torch.Generator().manual_seed(1))
    jp = JaxModel(jreg.get_smoke_config("qwen2-0.5b")).init(jax.random.key(0))
    flat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    jspec = JaxModel(jreg.get_smoke_config("qwen2-0.5b")).params_spec()
    assert model.n_params() == jcount(jspec)
    assert param_bytes(model.params_spec()) == jparam_bytes(jspec)
    for path, leaf in flat.items():
        keys = [k.key for k in path]
        t1, t2, t3 = p1, p2, p3
        for k in keys:
            t1, t2, t3 = t1[k], t2[k], t3[k]
        assert tuple(t1.shape) == tuple(leaf.shape), keys
        assert torch.equal(t1, t2)
        if keys[-1] in ("scale",):
            assert torch.all(t1 == 1)
        elif keys[-1].startswith("b"):
            assert torch.all(t1 == 0)
        else:
            assert not torch.equal(t1, t3)
            # the reference's init scales: 0.02 for the table, fan-in for
            # the matrices
            std = 0.02 if keys[-1] == "table" else 1 / np.sqrt(
                leaf.shape[-2])
            assert abs(float(t1.std()) - std) < 0.25 * std


# -- the dense model ------------------------------------------------------------------

def _models(dtype="float32", arch="qwen2-0.5b"):
    jc = jreg.get_smoke_config(arch)
    tc = tconfigs.get_smoke_config(arch)
    if dtype == "float32":
        jc = dataclasses.replace(jc, compute_dtype=jnp.float32)
        tc = dataclasses.replace(tc, compute_dtype=torch.float32)
    jm, tm = JaxModel(jc), Model(tc)
    jp = jm.init(jax.random.key(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device=CPU)
    return jm, jp, tm, tp


def _prompts(vocab, b=2, s=6, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma-7b",
                                  "h2o-danube-1.8b"])
def test_prefill_and_decode_step_match_reference(arch, dtype):
    jm, jp, tm, tp = _models(dtype, arch)
    prompts = _prompts(jm.cfg.vocab, s=64 if arch == "h2o-danube-1.8b"
                       else 6)
    total = prompts.shape[1] + 5
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)},
                            cache_seq=total)
    cp = tm.compute_params(tp)
    tl, tcache = tm.prefill(cp, {"tokens": _t(prompts)}, cache_seq=total)
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=tol, atol=tol)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].float().numpy(),
                                   _np(jcache[key]), rtol=tol, atol=tol)
    assert int(tcache["pos"]) == int(jcache["pos"])
    # decode steps from the reference's cache, so each step is compared
    # on the same inputs
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    for _ in range(5):
        tc = cache_from_reference(jax.tree.map(np.asarray, jcache),
                                  device=CPU)
        jl, jcache = jm.decode_step(jp, jcache, tok)
        tl, _ = tm.decode_step(cp, tc, _t(np.asarray(tok)))
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=tol, atol=tol)
        tok = jnp.argmax(jl, -1).astype(jnp.int32)


def test_unported_model_parts_raise_naming_the_roadmap():
    for arch in ("whisper-base",):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Model(tconfigs.get_smoke_config(arch))
    for arch in ("minicpm3-4b", "qwen3-moe-235b-a22b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Model(tconfigs.get_smoke_config(arch)).params_spec()
    _, _, tm, tp = _models()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.prefill(tp, {"tokens": _t(_prompts(512)),
                        "vision_embeds": torch.zeros(2, 1, 64)})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.decode_loop(tp, tm.init_cache(2, 8), torch.zeros(2), 3,
                       temperature=1.0)


# -- DecodeAttentionProblem -----------------------------------------------------------

def _decode_pair(dtype="float32", b=2, prompt=6, n_steps=7, eos_id=None):
    jm, jp, tm, tp = _models(dtype)
    prompts = _prompts(jm.cfg.vocab, b=b, s=prompt)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)},
                            cache_seq=prompt + n_steps + 1)
    first = jnp.argmax(jl, -1).astype(jnp.int32)
    jprob = JaxDecodeProblem(model=jm, params=jp, cache=jcache,
                             first_tokens=first, n_steps=n_steps,
                             eos_id=eos_id)
    tcache = cache_from_reference(jax.tree.map(np.asarray, jcache),
                                  device=CPU)
    tprob = DecodeAttentionProblem(model=tm, params=tp, cache=tcache,
                                   first_tokens=np.asarray(first),
                                   n_steps=n_steps, eos_id=eos_id)
    return jprob, tprob


def test_decode_tiers_token_identical_to_reference():
    jprob, tprob = _decode_pair()
    want = np.asarray(jprob.oracle()[0])
    own, own_cache = tprob.oracle()
    np.testing.assert_array_equal(own.numpy(), want)
    k0 = tprob.cache["k"].clone()
    for tier in TIERS:
        toks, cache = execute(tprob, Plan(tier=tier))
        np.testing.assert_array_equal(toks.numpy(), want, err_msg=tier)
        assert torch.equal(toks, own)
        assert torch.equal(cache["k"], own_cache["k"])
        assert int(cache["pos"]) == int(own_cache["pos"])
        jtoks, _ = jax_execute(jprob, JaxPlan(tier=tier))
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert torch.equal(tprob.cache["k"], k0), "the problem's cache changed"


def test_decode_bf16_tokens_agree_until_a_near_tie():
    jprob, tprob = _decode_pair("bfloat16", n_steps=6)
    # the reference's logits per step, to find its top-two margins
    jm, jp = jprob.model, jprob.params
    cache, tok, margins = jprob.cache, jprob.first_tokens, []
    for _ in range(jprob.n_steps):
        lg, cache = jm.decode_step(jp, cache, tok)
        top2 = np.sort(np.asarray(lg), axis=-1)[:, -2:]
        margins.append((top2[:, 1] - top2[:, 0]).min())
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    close = [i for i, m in enumerate(margins) if m < BF16_TOL]
    upto = close[0] + 1 if close else jprob.n_steps
    want = np.asarray(jprob.oracle()[0])
    for tier in TIERS:
        toks, _ = execute(tprob, Plan(tier=tier))
        np.testing.assert_array_equal(toks.numpy()[:, :upto], want[:, :upto])


def test_decode_eos_contract_and_planner():
    jbase, base = _decode_pair(b=1, n_steps=8)
    want = np.asarray(base.oracle()[0])
    eos = int(want[0, -1])
    k = int(np.argmax(want[0] == eos))          # its first occurrence stops
    jprob, prob = _decode_pair(b=1, n_steps=8, eos_id=eos)
    pred, params = prob.convergence()
    state = prob.initial_state()
    assert not bool(pred(state[:3] + (torch.full_like(state[3], eos + 1),)
                         + state[4:], params))
    assert bool(pred(state[:3] + (torch.full_like(state[3], eos),)
                     + state[4:], params))
    k0 = prob.cache["k"].clone()
    for p in (Plan(tier="host_loop", sync_every=1),
              Plan(tier="device_loop", sync_every=1),
              Plan(tier="device_loop", sync_every=3)):
        toks, _ = execute(prob, p)
        np.testing.assert_array_equal(toks.numpy()[:, :k + 1],
                                      want[:, :k + 1])
    assert torch.equal(prob.cache["k"], k0)
    # planner: every tier without EOS, fused tiers first; no resident
    # candidate under EOS, whose pick carries sync points
    tiers = [c.tier for c in plan_candidates(base)]
    assert set(tiers) == set(TIERS) and tiers[0] in ("resident",
                                                     "device_loop")
    assert tiers[-1] == "host_loop"
    cands = plan_candidates(prob)
    assert all(c.tier != "resident" for c in cands)
    assert cands[0].sync_every is not None
    assert [c.tier for c in cands] == [
        c.tier for c in jax_plan_candidates(jprob)]


def test_decode_problem_surface():
    jprob, tprob = _decode_pair(eos_id=3)
    assert tprob.batch_key() == dataclasses.replace(tprob,
                                                    eos_id=9).batch_key()
    assert tprob.batch_key() != dataclasses.replace(
        tprob, n_steps=tprob.n_steps + 1).batch_key()
    names = [a.name for a in tprob.cacheable_arrays()]
    assert names == [a.name for a in jprob.cacheable_arrays()]
    kv = {a.name: a for a in tprob.cacheable_arrays()}["kv_cache"]
    jkv = {a.name: a for a in jprob.cacheable_arrays()}["kv_cache"]
    assert (kv.bytes, kv.stores_per_step) == (jkv.bytes, jkv.stores_per_step)
    assert tprob.resident_scratch_bytes() == jprob.resident_scratch_bytes()
    p = plan(dataclasses.replace(tprob, eos_id=None))
    assert p.tier == "resident"
    assert JaxPlan.from_json(p.to_json()).tier == "resident"


def test_decode_tiers_are_priced_without_the_attention_carry():
    # every tier of the port attends through the flash-decode kernel, so no
    # tier pays the attn_carry round trip: resident (the device loop's kept
    # graph) and the device loop are priced alike, and resident wins the
    # tie on its single barrier; the host loop pays n_steps dispatches
    _, tprob = _decode_pair(b=2, n_steps=6)
    cands = {c.tier: c for c in plan_candidates(tprob)}
    assert cands["resident"].predicted_s == pytest.approx(
        cands["device_loop"].predicted_s, rel=1e-12)
    assert plan_candidates(tprob)[0].tier == "resident"
    streamed = sum(a.bytes * (a.loads_per_step + a.stores_per_step)
                   for a in tprob.cacheable_arrays()
                   if a.name != "attn_carry")
    gap = cands["host_loop"].predicted_s - cands["device_loop"].predicted_s
    assert gap == pytest.approx(
        (tprob.n_steps - 1) * planner.DISPATCH_OVERHEAD_S, rel=1e-9)
    assert cands["device_loop"].predicted_s == pytest.approx(
        tprob.n_steps * streamed / planner._as_chip("h100").hbm_bw
        + planner.DISPATCH_OVERHEAD_S, rel=1e-9)


def test_decode_problems_over_one_weight_set_share_their_steps():
    # the kept CUDA graphs are keyed by step function: problems over the
    # same weights (the Engine's batches) must find them again
    _, a = _decode_pair("bfloat16")
    b = dataclasses.replace(a, first_tokens=a.first_tokens.flip(0))
    assert a.step_fn() is b.step_fn()
    assert a.model.compute_params(a.params) is a._cparams
    assert a.model.compute_params(a._cparams) is a._cparams
    assert a.model.memo(a._cparams, "tokens", lm.token_step) is a.step_fn()
    _, c = _decode_pair("bfloat16")           # another weight set
    assert c.step_fn() is not a.step_fn()


def test_decode_resident_is_decode_loop():
    _, tprob = _decode_pair(b=1, n_steps=5)
    toks, _ = execute(tprob, Plan(tier="resident"))
    loop, cache = tprob.model.decode_loop(tprob.model.compute_params(
        tprob.params), tprob.cache, tprob.first_tokens, tprob.n_steps)
    assert torch.equal(toks, loop)
    assert int(cache["pos"]) == int(tprob.cache["pos"]) + 5


# -- the Engine ---------------------------------------------------------------------------

@pytest.mark.parametrize("persistent", [True, False])
def test_engine_tokens_match_reference_engine(persistent):
    jm, jp, tm, tp = _models()
    outs = []
    for eng, req in ((JaxEngine(jm, jp, JaxServeConfig(
            max_batch=3, persistent=persistent)), JaxRequest),
                     (Engine(tm, tp, ServeConfig(
                         max_batch=3, persistent=persistent)), Request)):
        rng = np.random.default_rng(3)
        for n in (8, 5, 8):
            eng.submit(req(prompt=rng.integers(0, jm.cfg.vocab, n,
                                               dtype=np.int32),
                           max_new_tokens=5))
        out, stats = eng.run_batch()
        outs.append((out, stats))
    (jout, jstats), (tout, tstats) = outs
    np.testing.assert_array_equal(tout, jout)
    assert set(tstats) == set(jstats)
    assert tstats["mode"] == jstats["mode"]
    assert tstats["tier"] == jstats["tier"]


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    toks, stats = serve.main(["--arch", "qwen2-0.5b", "--smoke",
                              "--requests", "2", "--prompt-len", "8",
                              "--new-tokens", "4", "--device", "cpu"])
    assert toks.shape == (2, 4) and stats["tier"] == "resident"
    assert "generated: (2, 4)" in capsys.readouterr().out
    json.dumps(stats)
