"""A CPU model of ``csrc/ssm_scan.cu``'s arithmetic, held to the references.

The model, written here in plain torch, computes the SSD scan as the kernel
does: chunks cut into 16-row tiles with the rows past a chunk's end zero
(a ragged last chunk, chunks shorter than a tile), the scores c b^T kept on
the lower 16x16 tiles only, cum summed in the warp scan's order (four rows
a lane, the lanes' totals by Hillis-Steele steps of ``__shfl_up_sync``),
the upper triangle masked before exp, and every product (scores, intra,
cross, state update) as 3xTF32: each operand split as the kernel splits it
(hi by Veltkamp's split, t = v (2^13 + 1), hi = t - (t - v), on TF32's 11
significant bits; lo = v - hi, of which the tensor core reads the top 19
bits), lo b_hi + hi b_lo then hi b_hi summed in float32. ``tf32`` rounds
in bits as ``cvt.rna.tf32.f32`` does (the single-pass form, and the A/B
arm of the kernel built with ``-DSSM_CVT_RNA``).

It is held to the JAX reference ``repro.kernels.ref.ssm_scan`` and to the
port's ``ref.ssm_scan`` at the reference test's gate (rtol = atol 1e-3 for
float32 streams, 5e-2 for bf16) at mamba2-780m's SSD widths (H = 48,
P = 64, N = 128), T = 256, B = 2; and its error against a float64 run of
the recurrence is held within 4x that of the same chunked form with plain
float32 products.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

H, P, N = 48, 64, 128        # mamba2-780m's SSD widths
TILE = 16
LANES = 32
CHUNKS = [1, 8, 15, 16, 64, 128]
TOL = {"float32": 1e-3, "bfloat16": 5e-2}


def _inputs(bsz, t, seed=0):
    """The streams as ``chip_smoke.py``'s ``ssd_inputs`` makes them."""
    g = np.random.default_rng(seed)
    x = (0.5 * g.standard_normal((bsz, t, H, P))).astype(np.float32)
    dt = np.log1p(np.exp(g.standard_normal((bsz, t, H)))).astype(np.float32)
    a = (-np.exp(g.standard_normal(H))).astype(np.float32)
    b = (0.5 * g.standard_normal((bsz, t, N))).astype(np.float32)
    c = (0.5 * g.standard_normal((bsz, t, N))).astype(np.float32)
    d = g.standard_normal(H).astype(np.float32)
    return x, dt, a, b, c, d


def tf32(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 to 10 mantissa bits, to nearest with
    ties away from zero (half an ulp added to the magnitude's bits, the low
    13 bits cleared)."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def truncate_tf32(v: torch.Tensor) -> torch.Tensor:
    """The top 19 bits of float32 (what the tensor core reads of an
    operand)."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def veltkamp(v: torch.Tensor) -> torch.Tensor:
    """v rounded to 11 significant bits by Veltkamp's split, in float32."""
    t = v * 8193.0
    return t - (t - v)


def _split(v):
    hi = veltkamp(v)
    return hi, truncate_tf32(v - hi)


def mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b in float32 as the kernel forms it: ``split`` (3xTF32: the
    small terms, then the big), ``tf32`` (one TF32 pass) or ``f32``
    (plain)."""
    if mode == "f32":
        return a @ b
    if mode == "tf32":
        return tf32(a) @ tf32(b)
    ah, al = _split(a)
    bh, bl = _split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def warp_scan_cum(g: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over dim 0 (at most 128 rows) in the
    kernel's order: lane l sums rows 4l..4l+3 in turn, the lanes' totals
    scan by Hillis-Steele steps (offsets 1, 2, 4, 8, 16), and each row adds
    the inclusive total of the lane before its own."""
    rows = g.shape[0]
    pad = torch.zeros((4 * LANES,) + g.shape[1:], dtype=g.dtype)
    pad[:rows] = g
    lanes = pad.reshape((LANES, 4) + g.shape[1:])
    s = torch.empty_like(lanes)
    run = lanes[:, 0]
    s[:, 0] = run
    for e in range(1, 4):
        run = run + lanes[:, e]
        s[:, e] = run
    tot = run.clone()
    off = 1
    while off < LANES:
        shifted = torch.zeros_like(tot)
        shifted[off:] = tot[:-off]
        tot = torch.where(
            (torch.arange(LANES) >= off).reshape((LANES,) + (1,) * (tot.dim() - 1)),
            shifted + tot, tot)
        off *= 2
    ex = torch.zeros_like(tot)
    ex[1:] = tot[:-1]
    cum = ex[:, None] + s
    return cum.reshape((4 * LANES,) + g.shape[1:])[:rows]


def ssd_model(x, dt, a, b, c, d, chunk, mode="split"):
    """The kernel's SSD scan on float32 tensors: x (B,T,H,P), dt (B,T,H),
    a (H,), b/c (B,T,N), d (H,) -> y (B,T,H,P)."""
    bsz, t_len = x.shape[:2]
    cp = -(-chunk // TILE) * TILE          # the chunk's rows, padded
    rt = cp // TILE
    tiles = torch.kron(torch.tril(torch.ones(rt, rt)),
                       torch.ones(TILE, TILE)).bool()
    rows = torch.arange(cp)
    y = torch.empty_like(x)
    h = torch.zeros(bsz, H, N, P)
    for c0 in range(0, t_len, chunk):
        n_rows = min(chunk, t_len - c0)

        def tile(v):
            out = torch.zeros((bsz, cp) + v.shape[2:])
            out[:, :n_rows] = v[:, c0:c0 + n_rows]
            return out

        xk, dtk, bk, ck = tile(x), tile(dt), tile(b), tile(c)
        live = rows < n_rows
        cum = torch.stack([warp_scan_cum(g) for g in dtk * a])  # (B, cp, H)
        s = torch.where(tiles, mm(ck, bk.transpose(1, 2), mode), 0.0)
        mask = ((rows[None, :] <= rows[:, None]) & live[:, None])
        cum_h = cum.transpose(1, 2)                         # (B, H, cp)
        diff = cum_h[..., :, None] - cum_h[..., None, :]    # (B, H, i, j)
        m = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0))
                        * s[:, None] * dtk.transpose(1, 2)[..., None, :],
                        0.0)
        xh = xk.permute(0, 2, 1, 3)                         # (B, H, cp, P)
        intra = mm(m, xh, mode)
        cross = mm(ck[:, None].expand(-1, H, -1, -1), h, mode)
        ecum = torch.where(live[:, None], torch.exp(cum), 0.0).transpose(1, 2)
        yk = intra + ecum[..., None] * cross + d[:, None, None] * xh
        cl = cum[:, n_rows - 1]                             # (B, H)
        w = torch.where(live[:, None], torch.exp(cl[:, None] - cum) * dtk,
                        0.0)                                # (B, cp, H)
        wb = (w.transpose(1, 2)[..., None] * bk[:, None]).transpose(2, 3)
        h = torch.exp(cl)[..., None, None] * h + mm(wb, xh, mode)
        y[:, c0:c0 + n_rows] = yk.permute(0, 2, 1, 3)[:, :n_rows]
    return y


def _torch(*arrs, dtype):
    return [torch.from_numpy(v).to(getattr(torch, dtype)).float()
            for v in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_model_matches_the_references(chunk, dtype):
    x, dt, a, b, c, d = _inputs(2, 256)
    tx, tdt, tb, tc = _torch(x, dt, b, c, dtype=dtype)
    ta, td = torch.from_numpy(a), torch.from_numpy(d)
    got = ssd_model(tx, tdt, ta, tb, tc, td, chunk)
    jx, jdt, jb, jc = (jnp.asarray(v.numpy()) for v in (tx, tdt, tb, tc))
    want_jax = np.asarray(jax.vmap(lambda x_, dt_, b_, c_: jref.ssm_scan(
        x_, dt_, jnp.asarray(a), b_, c_, jnp.asarray(d)))(jx, jdt, jb, jc))
    want = torch.stack([ref.ssm_scan(tx[i], tdt[i], ta, tb[i], tc[i], td)
                        for i in range(2)])
    tol = TOL[dtype]
    out = got.to(getattr(torch, dtype)).float().numpy()
    for w in (want_jax, want.numpy()):
        np.testing.assert_allclose(out, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_split_products_within_4x_of_plain_float32(chunk):
    x, dt, a, b, c, d = _inputs(2, 256, seed=1)
    args = [torch.from_numpy(v) for v in (x, dt, a, b, c, d)]
    exact = torch.stack([ref.ssm_scan(*(v[i].double() if v.dim() > 1
                                        else v.double() for v in args))
                         for i in range(2)])
    err = {mode: (ssd_model(*args, chunk, mode=mode).double() - exact)
           .abs().max().item() for mode in ("split", "f32")}
    assert err["split"] <= 4 * err["f32"], err
    assert err["split"] < 1e-3, err


@pytest.mark.parametrize("t_len,chunk", [(250, 16), (250, 64), (250, 128),
                                         (37, 128)])
def test_ragged_last_chunk_matches_reference(t_len, chunk):
    x, dt, a, b, c, d = _inputs(1, t_len, seed=2)
    args = [torch.from_numpy(v) for v in (x, dt, a, b, c, d)]
    got = ssd_model(*args, min(chunk, t_len))
    want = ref.ssm_scan(*(v[0] if v.dim() > 1 else v for v in args))
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("rows", [1, 5, 31, 128])
def test_warp_scan_cum_is_a_cumulative_sum(rows):
    g = torch.from_numpy(-np.random.default_rng(rows).random((rows, 3))
                         .astype(np.float32))
    got = warp_scan_cum(g)
    np.testing.assert_allclose(got.numpy(), np.cumsum(g.double().numpy(), 0),
                               rtol=1e-5, atol=1e-6)
    # the first lane's four rows are summed in order, bit for bit
    run = g[0].clone()
    for e in range(1, min(rows, 4)):
        run = run + g[e]
        assert torch.equal(got[e], run)


@pytest.mark.parametrize("value,want", [
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),             # a tie: away from zero
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 2.0**-11 - 2.0**-23, 1.0),             # below the tie: down
    (3.0 + 2.0**-9 + 2.0**-10, 3.0 + 2.0**-8),    # up, into the next ulp
    (0.0, 0.0),
])
def test_tf32_rounding_matches_cvt_rna(value, want):
    v = torch.tensor([value], dtype=torch.float32)
    assert tf32(v).item() == want


def test_veltkamp_split_is_exact_on_tf32_bits():
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32) * 10.0**np.arange(-8, 8, 0.00390625
                                                                ).astype(np.float32))
    hi = veltkamp(v)
    bits = hi.view(torch.int32)
    assert torch.all((bits & 0x1FFF) == 0)                # TF32 bits only
    assert torch.equal(hi + (v - hi), v)                  # v = hi + lo
    # hi is v to nearest on 11 bits: within half a TF32 ulp
    ulp = torch.ldexp(torch.ones_like(v), torch.frexp(v).exponent - 11)
    assert torch.all((v - hi).abs() <= ulp / 2)
    # the lo the tensor core reads: within 2^-22 |v| of the exact lo
    lo = truncate_tf32(v - hi)
    assert torch.all(((v - hi) - lo).abs() <= 2.0**-22 * v.abs())
