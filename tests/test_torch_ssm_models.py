"""The port's SSM and hybrid model families against the JAX reference: the
SSD layer ops (``nn/ssd.py``), mamba2-780m and zamba2-1.2b (their smoke
configs) through prefill and decode, ``DecodeAttentionProblem`` on every
tier, the ``Engine`` in both modes, and the serving launcher.

Inputs are made with numpy from a seed; model parameters are the
reference's own initialisation, with keys that do not change from process
to process (``_reference_params``), carried over by
``convert.params_from_reference``. The port's wrappers run their plain
versions because the tensors lie on the CPU (``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold the CUDA kernels to them on the card). Bounds:
the layer ops, the prefill logits, every cache leaf (block by block, on
the reference's input to the block) and each decode step's logits and
cache at 1e-5 in float32 and 5e-2 in bf16 (the dense model's bounds in
``tests/test_torch_ml.py``); the final state of the per-step recurrence
against the chunked form at 1e-4 (two summation orders of one float32
function). Token identity with the reference is asserted with
``compute_dtype=float32``; prompt lengths are ones the reference's
``ssd_chunked`` accepts (a multiple of the chunk, or shorter).
"""
import dataclasses
import json
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.exec import DecodeAttentionProblem as JaxDecodeProblem
from repro.exec import Plan as JaxPlan
from repro.exec import execute as jax_execute
from repro.models import hybrid as jhy
from repro.models import mamba2 as jmb
from repro.models import transformer as jtfm
from repro.models.lm import Model as JaxModel
from repro.nn import param as jparam
from repro.nn import ssd as jssd
from repro.runtime.server import Engine as JaxEngine
from repro.runtime.server import Request as JaxRequest
from repro.runtime.server import ServeConfig as JaxServeConfig
from repro_torch import configs as tconfigs
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.exec import DecodeAttentionProblem, Plan, execute, plan
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as kssm
from repro_torch.models import hybrid, lm
from repro_torch.models import mamba2 as tmb
from repro_torch.models import transformer as ttfm
from repro_torch.models.lm import Model
from repro_torch.nn import ssd
from repro_torch.nn.param import tree_map
from repro_torch.runtime.server import Engine, Request, ServeConfig

ARCHS = ("mamba2-780m", "zamba2-1.2b")
TIERS = ("host_loop", "device_loop", "resident")
F32_TOL = 1e-5
BF16_TOL = 5e-2
CPU = "cpu"


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the SSD layer ops ---------------------------------------------------------------

def _ssd_inputs(bsz, t, h, p, n, seed=0):
    g = np.random.default_rng(seed)
    x = (0.5 * g.standard_normal((bsz, t, h, p))).astype(np.float32)
    dt = np.log1p(np.exp(g.standard_normal((bsz, t, h)))).astype(np.float32)
    a = (-np.exp(g.standard_normal(h))).astype(np.float32)
    b = (0.5 * g.standard_normal((bsz, t, n))).astype(np.float32)
    c = (0.5 * g.standard_normal((bsz, t, n))).astype(np.float32)
    d = g.standard_normal(h).astype(np.float32)
    return x, dt, a, b, c, d


# (B, T, H, P, N, chunk): the two smoke configs' SSD widths (mamba2-smoke
# and zamba2-smoke share them), a wider state, one chunk and several
SSD_CASES = [(2, 32, 16, 8, 16, 16), (2, 48, 16, 8, 16, 16),
             (1, 64, 4, 16, 32, 8), (2, 12, 16, 8, 16, 16)]


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_chunked_matches_reference(case, return_state):
    bsz, t, h, p, n, chunk = case
    args = _ssd_inputs(bsz, t, h, p, n)
    want = jssd.ssd_chunked(*map(jnp.asarray, args), chunk=chunk,
                            return_state=return_state)
    got = ssd.ssd_chunked(*map(_t, args), chunk=chunk,
                          return_state=return_state)
    if not return_state:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("t,chunk", [(37, 16), (40, 16), (7, 3)])
def test_ssd_chunked_ragged_last_chunk_is_the_recurrence(t, chunk):
    # the reference asserts T % chunk == 0; the port (kernel and plain
    # form) takes a shorter last chunk: the same function as the per-step
    # recurrence, y and the final state
    args = [_t(a) for a in _ssd_inputs(2, t, 4, 8, 16, seed=3)]
    y, h = ssd.ssd_chunked(*args, chunk=chunk, return_state=True)
    wy, wh = kssm.ssd_scan(*args, chunk=chunk, return_state=True)
    np.testing.assert_allclose(y.numpy(), wy.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h.numpy(), wh.numpy(), rtol=1e-4, atol=1e-4)
    # and a chunk that divides T gives the reference's result too
    y2, h2 = ssd.ssd_chunked(*args, chunk=1, return_state=True)
    np.testing.assert_allclose(y2.numpy(), wy.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h2.numpy(), wh.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_casts_y_as_the_reference(dtype):
    bsz, t, h, p, n, chunk = SSD_CASES[0]
    x, dt, a, b, c, d = _ssd_inputs(bsz, t, h, p, n, seed=5)
    jd = jnp.dtype(dtype)
    want_y, want_h = jssd.ssd_chunked(
        jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(a),
        jnp.asarray(b, jd), jnp.asarray(c, jd), jnp.asarray(d),
        chunk=chunk, return_state=True)
    td = getattr(torch, dtype)
    got_y, got_h = ssd.ssd_chunked(_t(x).to(td), _t(dt), _t(a),
                                   _t(b).to(td), _t(c).to(td), _t(d),
                                   chunk=chunk, return_state=True)
    assert got_y.dtype == td and got_h.dtype == torch.float32
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got_y.float().numpy(), _np(want_y), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got_h.numpy(), _np(want_h), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("n,chunk", [(16, 16), (32, 8)])
def test_plain_final_state_matches_reference(n, chunk):
    # kernels/ref.py's per-step recurrence and the scan wrapper's plain
    # version return the state the reference's chunked scan returns
    x, dt, a, b, c, d = _ssd_inputs(2, 32, 4, 8, n, seed=7)
    _, want_h = jssd.ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c, d)),
                                 chunk=chunk, return_state=True)
    y, h = kssm.ssd_scan(*map(_t, (x, dt, a, b, c, d)), chunk=chunk,
                         return_state=True)
    assert h.shape == (2, 4, n, 8) and h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), _np(want_h), rtol=1e-4, atol=1e-4)
    y1, h1 = ref.ssm_scan(*(_t(v[0]) if v.ndim > 1 else _t(v)
                            for v in (x, dt, a, b, c, d)), return_state=True)
    assert torch.equal(y1, y[0]) and torch.equal(h1, h[0])
    assert torch.equal(kssm.ssd_scan(*map(_t, (x, dt, a, b, c, d)),
                                     chunk=chunk), y)


def test_ssd_step_matches_reference():
    g = np.random.default_rng(11)
    bsz, h, p, n = 3, 16, 8, 16
    hp = g.standard_normal((bsz, h, n, p)).astype(np.float32)
    xt = g.standard_normal((bsz, h, p)).astype(np.float32)
    dtt = np.log1p(np.exp(g.standard_normal((bsz, h)))).astype(np.float32)
    a = (-np.exp(g.standard_normal(h))).astype(np.float32)
    bt = g.standard_normal((bsz, n)).astype(np.float32)
    ct = g.standard_normal((bsz, n)).astype(np.float32)
    d = g.standard_normal(h).astype(np.float32)
    args = (hp, xt, dtt, a, bt, ct, d)
    wh, wy = jssd.ssd_step(*map(jnp.asarray, args))
    th = _t(hp)
    gh, gy = ssd.ssd_step(th, *map(_t, args[1:]))
    for got, want in ((gh, wh), (gy, wy)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=F32_TOL,
                                   atol=F32_TOL)
    assert torch.equal(th, _t(hp)), "ssd_step wrote its input state"


@pytest.mark.parametrize("bias", [False, True])
def test_causal_conv1d_and_its_step_match_reference(bias):
    g = np.random.default_rng(13)
    bsz, t, ch, k = 2, 9, 24, 4
    x = g.standard_normal((bsz, t, ch)).astype(np.float32)
    w = g.standard_normal((k, ch)).astype(np.float32)
    bb = g.standard_normal(ch).astype(np.float32) if bias else None
    jb = None if bb is None else jnp.asarray(bb)
    tb = None if bb is None else _t(bb)
    np.testing.assert_allclose(
        ssd.causal_conv1d(_t(x), _t(w), tb).numpy(),
        _np(jssd.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jb)),
        rtol=F32_TOL, atol=F32_TOL)
    state = g.standard_normal((bsz, k - 1, ch)).astype(np.float32)
    ws, wo = jssd.causal_conv1d_step(jnp.asarray(state), jnp.asarray(x[:, 0]),
                                     jnp.asarray(w), jb)
    gs, go = ssd.causal_conv1d_step(_t(state), _t(x[:, 0]), _t(w), tb)
    np.testing.assert_allclose(gs.numpy(), _np(ws), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(go.numpy(), _np(wo), rtol=F32_TOL,
                               atol=F32_TOL)
    # the conv's steps from a zero window are the conv over the sequence
    st = torch.zeros((bsz, k - 1, ch))
    outs = []
    for i in range(t):
        st, o = ssd.causal_conv1d_step(st, _t(x[:, i]), _t(w), tb)
        outs.append(o)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               ssd.causal_conv1d(_t(x), _t(w), tb).numpy(),
                               rtol=F32_TOL, atol=F32_TOL)


# -- the models ------------------------------------------------------------------------

def _reference_params(jm, seed=0):
    """The reference's initialisation (its specs and ``_materialize``),
    each leaf's key folded from a CRC of its path. The reference's own
    ``init`` folds Python's ``hash`` of the path, which changes from one
    process to the next, and so would the weights of every test."""
    def leaf(path, spec):
        h = zlib.crc32(jax.tree_util.keystr(path).encode()) % (2**31)
        return jparam._materialize(
            jax.random.fold_in(jax.random.key(seed), h), spec)

    return jax.tree_util.tree_map_with_path(leaf, jm.params_spec(),
                                            is_leaf=jparam.is_spec)


def _models(arch, dtype="float32"):
    jc = jreg.get_smoke_config(arch)
    tc = tconfigs.get_smoke_config(arch)
    if dtype == "float32":
        jc = dataclasses.replace(jc, compute_dtype=jnp.float32)
        tc = dataclasses.replace(tc, compute_dtype=torch.float32)
    jm, tm = JaxModel(jc), Model(tc)
    jp = _reference_params(jm)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device=CPU)
    return jm, jp, tm, tp


def _tensor(a):
    """A reference array (bf16 too) as a CPU tensor."""
    return params_from_reference({"a": np.asarray(a)}, device=CPU)["a"]


def _blockwise(jm, jp, tm, cp, prompts):
    """Every block of the prefill, the port's and the reference's, run on
    the reference's own input to that block: (what, port, reference) for
    each block's output and the cache entries it makes (a Mamba2 block's
    conv window and final state h; a shared-attention application's
    residual stream, K and V)."""
    jcfg, tcfg = jm.cfg, tm.cfg
    b, s = prompts.shape
    jblock = jax.jit(lambda p, x: jmb.mamba_block(p, jcfg, x,
                                                  return_state=True))
    x = jtfm.embed_tokens(jp, jcfg, jnp.asarray(prompts))
    rows = []

    def mamba(name, jlp, tlp, x):
        jo, (jconv, jh) = jblock(jlp, x)
        to, (tconv, th) = tmb.mamba_block(tlp, tcfg, _tensor(x),
                                          return_state=True)
        rows.extend([(f"{name} out", to, jo), (f"{name} conv", tconv, jconv),
                     (f"{name} h", th, jh)])
        return x + jo.astype(x.dtype)

    if jcfg.family == "ssm":
        for i in range(jcfg.n_layers):
            x = mamba(f"layer {i}", jax.tree.map(lambda t: t[i], jp["layers"]),
                      tree_map(lambda t: t[i], cp["layers"]), x)
        return rows
    pos = jnp.broadcast_to(jnp.arange(s)[None, :], (b, s))
    jshared = jax.jit(lambda sp, x: jhy._shared_block(sp, jcfg, x, pos,
                                                      collect_kv=True))
    tpos, rope = ttfm.prompt_rope(tcfg, b, s, CPU)
    for a in range(hybrid.n_shared_apps(tcfg)):
        for j in range(tcfg.shared_attn_every):
            x = mamba(f"app {a} layer {j}",
                      jax.tree.map(lambda t: t[a, j], jp["layers"]),
                      tree_map(lambda t: t[a, j], cp["layers"]), x)
        jx, (jk, jv) = jshared(jp["shared_attn"], x)
        tx, tk, tv = ttfm.prefill_layer(cp["shared_attn"], tcfg, _tensor(x),
                                        tpos, rope)
        rows.extend([(f"app {a} shared x", tx, jx), (f"app {a} k", tk, jk),
                     (f"app {a} v", tv, jv)])
        x = jx
    for i in range(hybrid.n_tail(tcfg)):
        x = mamba(f"tail {i}", jax.tree.map(lambda t: t[i],
                                            jp["tail_layers"]),
                  tree_map(lambda t: t[i], cp["tail_layers"]), x)
    return rows


def _prompts(vocab, b=2, s=16, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_params_carry_over(arch):
    jm, jp, tm, tp = _models(arch)
    flat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    assert tm.n_params() == jm.n_params()
    jshapes = {jax.tree_util.keystr(k): v.shape for k, v in flat.items()}
    from repro_torch.nn.param import tree_items
    tshapes = {"".join(f"['{p}']" for p in path.split("/")): tuple(t.shape)
               for path, t in tree_items(tp)}
    assert tshapes == jshapes
    if arch == "zamba2-1.2b":
        cfg = tm.cfg
        assert tp["layers"]["in_proj"].shape[:2] == (
            hybrid.n_shared_apps(cfg), cfg.shared_attn_every)
        assert tp["tail_layers"]["in_proj"].shape[0] == hybrid.n_tail(cfg)
    spec = tm.cache_spec(3, 40)
    jspec = jm.cache_spec(3, 40)
    assert {k: tuple(t.shape) for k, t in spec.items()} == {
        k: tuple(v.shape) for k, v in jspec.items()}
    assert {k: str(t.dtype)[6:] for k, t in spec.items()} == {
        k: str(v.dtype) for k, v in jspec.items()}
    cache = tm.init_cache(3, 40, device=CPU)
    assert set(cache) == set(tm.cache_keys())
    assert all(not t.any() for t in cache.values())


def test_full_width_configs_build_and_count_like_the_reference():
    for arch in ARCHS:
        cfg, jcfg = tconfigs.get_config(arch), jreg.get_config(arch)
        assert Model(cfg).n_params() == JaxModel(jcfg).n_params()
        spec = Model(cfg).cache_spec(8, 544)
        assert {k: tuple(t.shape) for k, t in spec.items()} == {
            k: tuple(v.shape)
            for k, v in JaxModel(jcfg).cache_spec(8, 544).items()}
    # zamba2-1.2b: 6 super-blocks of 6 + a tail of 2
    cfg = tconfigs.get_config("zamba2-1.2b")
    assert (hybrid.n_shared_apps(cfg), cfg.shared_attn_every,
            hybrid.n_tail(cfg)) == (6, 6, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch, dtype):
    """The prefill's logits; every cache leaf block by block, each block on
    the reference's own input to it (over the whole zamba2 stack, seven
    blocks deep, independent float32 roundings grow to about the bound
    itself: 0.6-1.4 times 1e-5 over six weight draws, where each block
    stays under 0.1 times it); then three decode steps, each from the
    reference's cache: logits and every leaf of the new cache."""
    jm, jp, tm, tp = _models(arch, dtype)
    prompts = _prompts(jm.cfg.vocab, s=32)
    total = prompts.shape[1] + 4
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)},
                            cache_seq=total)
    cp = tm.compute_params(tp)
    tl, tcache = tm.prefill(cp, {"tokens": _t(prompts)}, cache_seq=total)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=tol, atol=tol)
    assert set(tcache) == set(jcache)
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        assert str(tcache[key].dtype)[6:] == str(jcache[key].dtype), key
    assert int(tcache["pos"]) == int(jcache["pos"]) == prompts.shape[1]
    rows = _blockwise(jm, jp, tm, cp, prompts)
    for what, got, want in rows:
        np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                                   atol=tol, err_msg=what)
    # the first block's input is the embedding itself: the prefill's own
    # leaves of that block are the blockwise run's, bit for bit
    first = {what: got for what, got, _ in rows}
    if arch == "mamba2-780m":
        assert torch.equal(tcache["conv"][0], first["layer 0 conv"])
        assert torch.equal(tcache["h"][0], first["layer 0 h"])
    else:
        assert torch.equal(tcache["conv"][0, 0], first["app 0 layer 0 conv"])
        assert torch.equal(tcache["h"][0, 0], first["app 0 layer 0 h"])
    # decode steps from the reference's cache, so each step is compared
    # on the same inputs; the port's step advances that cache in place
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    for _ in range(3):
        tc = cache_from_reference(jax.tree.map(np.asarray, jcache),
                                  device=CPU)
        before = {k: t.clone() for k, t in tc.items()}
        jl, jcache = jm.decode_step(jp, jcache, tok)
        tl, tnew = tm.decode_step(cp, tc, _t(np.asarray(tok)))
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=tol, atol=tol)
        for key in jcache:
            np.testing.assert_allclose(tnew[key].float().numpy(),
                                       _np(jcache[key]), rtol=tol, atol=tol,
                                       err_msg=key)
            if key != "pos":
                assert tnew[key] is tc[key], f"{key} not written in place"
        assert not torch.equal(tc["h"], before["h"])
        assert int(tc["pos"]) == int(before["pos"])
        tok = jnp.argmax(jl, -1).astype(jnp.int32)


def test_mamba2_forward_hidden_matches_reference():
    jm, jp, tm, tp = _models("mamba2-780m")
    prompts = _prompts(jm.cfg.vocab, s=32)
    jh, _ = jmb.forward_hidden(jp, jm.cfg, jnp.asarray(prompts))
    th, _ = tmb.forward_hidden(tm.compute_params(tp), tm.cfg, _t(prompts))
    np.testing.assert_allclose(th.numpy(), _np(jh), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_scalars_stay_float32_in_the_compute_params(arch):
    # the reference reads a_log, dt_bias and d_skip in float32 whatever the
    # compute dtype: with values bf16 cannot hold, the bf16 model still
    # follows the reference
    jm, jp, tm, _ = _models(arch, "bfloat16")
    g = np.random.default_rng(17)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("a_log", "dt_bias", "d_skip")):
            return leaf + jnp.asarray(
                0.3 * g.standard_normal(leaf.shape) + 1e-3, leaf.dtype)
        return leaf

    jp = jax.tree_util.tree_map_with_path(perturb, jp)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device=CPU)
    cp = tm.compute_params(tp)
    assert cp["layers"]["a_log"].dtype == torch.float32
    assert cp["layers"]["in_proj"].dtype == torch.bfloat16
    prompts = _prompts(jm.cfg.vocab, s=32)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(prompts)}, cache_seq=36)
    tl, _ = tm.prefill(cp, {"tokens": _t(prompts)}, cache_seq=36)
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=BF16_TOL,
                               atol=BF16_TOL)
    for what, got, want in _blockwise(jm, jp, tm, cp, prompts):
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   rtol=BF16_TOL, atol=BF16_TOL,
                                   err_msg=what)


def test_hybrid_ring_slots_follow_the_reference():
    # a prompt longer than a windowed ring: the slots are placed at
    # (s - keep) % c and each application writes its own slot a step
    arch = "zamba2-1.2b"
    jm, jp, tm, tp = _models(arch)
    jm = JaxModel(dataclasses.replace(jm.cfg, window=12))
    tm = Model(dataclasses.replace(tm.cfg, window=12))
    prompts = _prompts(jm.cfg.vocab, s=16)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)},
                            cache_seq=20)
    tl, tcache = tm.prefill(tp, {"tokens": _t(prompts)}, cache_seq=20)
    assert tcache["shared_k"].shape[2] == 12
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=F32_TOL,
                               atol=F32_TOL)
    for key in ("shared_k", "shared_v"):
        np.testing.assert_allclose(tcache[key].numpy(), _np(jcache[key]),
                                   rtol=F32_TOL, atol=F32_TOL)
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    for _ in range(3):
        jl, jcache = jm.decode_step(jp, jcache, tok)
        tl, tcache = tm.decode_step(tp, tcache, _t(np.asarray(tok)))
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=1e-4, atol=1e-4)
        tok = jnp.argmax(jl, -1).astype(jnp.int32)


def test_encdec_family_still_raises_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(tconfigs.get_smoke_config("whisper-base"))
    for arch in ARCHS:
        Model(tconfigs.get_config(arch))


# -- DecodeAttentionProblem -----------------------------------------------------------

def _decode_pair(arch, b=2, prompt=16, n_steps=5, eos_id=None):
    jm, jp, tm, tp = _models(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_tiers_token_identical_to_oracle_and_reference(arch):
    jprob, tprob = _decode_pair(arch)
    want = np.asarray(jprob.oracle()[0])
    own, own_cache = tprob.oracle()
    np.testing.assert_array_equal(own.numpy(), want)
    before = {k: t.clone() for k, t in tprob.cache.items()}
    for tier in TIERS:
        toks, cache = execute(tprob, Plan(tier=tier))
        np.testing.assert_array_equal(toks.numpy(), want, err_msg=tier)
        assert set(cache) == set(own_cache)
        for key in own_cache:
            assert torch.equal(cache[key], own_cache[key]), (tier, key)
        jtoks, _ = jax_execute(jprob, JaxPlan(tier=tier))
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    for key, t in before.items():
        assert torch.equal(tprob.cache[key], t), f"the problem's {key} changed"


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_eos_chunks_continue_the_state(arch):
    # a chunked device loop (the EOS contract's sync points) carries the
    # recurrent state across its chunks
    _, base = _decode_pair(arch, b=1, n_steps=6)
    want = base.oracle()[0].numpy()
    eos = int(want[0, -1])
    k = int(np.argmax(want[0] == eos))
    _, prob = _decode_pair(arch, b=1, n_steps=6, eos_id=eos)
    for p in (Plan(tier="host_loop", sync_every=1),
              Plan(tier="device_loop", sync_every=2),
              Plan(tier="device_loop", sync_every=4)):
        toks, _ = execute(prob, p)
        np.testing.assert_array_equal(toks.numpy()[:, :k + 1],
                                      want[:, :k + 1])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_problem_surface_matches_reference(arch):
    jprob, tprob = _decode_pair(arch, eos_id=3)
    jarr = {a.name: a for a in jprob.cacheable_arrays()}
    tarr = {a.name: a for a in tprob.cacheable_arrays()}
    assert list(tarr) == list(jarr)
    assert "ssm_state" in tarr
    assert ("attn_carry" in tarr) == (arch == "zamba2-1.2b")
    for name in ("kv_cache", "ssm_state", "attn_carry"):
        if name in jarr:
            t, j = tarr[name], jarr[name]
            assert (t.loads_per_step, t.stores_per_step) == (
                j.loads_per_step, j.stores_per_step), name
            assert t.bytes == j.bytes, name
    assert tprob._n_attn_layers() == jprob._n_attn_layers()
    assert tprob.resident_scratch_bytes() == jprob.resident_scratch_bytes()
    assert tprob.domain_bytes() == sum(
        int(np.asarray(v).nbytes) for v in jax.tree.leaves(jprob.cache))
    assert tprob.batch_key() == dataclasses.replace(tprob,
                                                    eos_id=9).batch_key()
    assert tprob.name.startswith(f"decode_{tprob.model.cfg.name}_b2_n5_")
    p = plan(dataclasses.replace(tprob, eos_id=None))
    assert p.tier == "resident"
    assert JaxPlan.from_json(p.to_json()).tier == "resident"
    pred, eos = tprob.convergence()
    state = tprob.initial_state()
    assert not bool(pred(state, eos))
    assert bool(pred(state[:-3] + (torch.full_like(state[-3], 3),)
                     + state[-2:], eos))


def test_decode_problems_share_steps_per_weight_set():
    _, a = _decode_pair("mamba2-780m")
    b = dataclasses.replace(a, first_tokens=a.first_tokens.flip(0))
    assert a.step_fn() is b.step_fn()
    assert a.model.memo(a._cparams, "tokens", lm.token_step) is a.step_fn()


# -- the Engine and the launcher ---------------------------------------------------------

@pytest.mark.parametrize("persistent", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_reference_engine(arch, persistent):
    jm, jp, tm, tp = _models(arch)
    outs = []
    for eng, req in ((JaxEngine(jm, jp, JaxServeConfig(
            max_batch=3, persistent=persistent)), JaxRequest),
                     (Engine(tm, tp, ServeConfig(
                         max_batch=3, persistent=persistent)), Request)):
        rng = np.random.default_rng(3)
        # left-padded to 16, a multiple of the smoke chunk: the padding is
        # carried into the state, as the reference carries it
        for n in (16, 11, 16):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve
    toks, stats = serve.main(["--arch", arch, "--smoke",
                              "--requests", "2", "--prompt-len", "16",
                              "--new-tokens", "4", "--device", "cpu"])
    assert toks.shape == (2, 4) and stats["tier"] == "resident"
    assert "generated: (2, 4)" in capsys.readouterr().out
    json.dumps(stats)
