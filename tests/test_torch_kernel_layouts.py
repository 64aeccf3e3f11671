"""The host side of the port's redesigned ``decode_attention`` and
``spmv_ell`` kernels, on the CPU: which kernel a call launches, how the KV
sequence is split and the K/V ring sized, how the ELL rows are cut into
runs, and the tensor-core kernel's rounding (float32 logits, the
unnormalised P in bf16) held to the JAX reference under the card's bf16
rule.

The CUDA kernels themselves run only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``); here the wrappers run their plain versions because
the tensors lie on the CPU.
"""
import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import ops
from repro_torch.kernels import spmv_ell as tspmv

H100_SMS = 132
SM_SMEM = 233472            # shared memory of one H100 SM
CTA_RESERVED = 1024         # reserved by the card for each CTA
# The card's bf16 rule for decode attention (chip_smoke.check_decode_bf16):
# rtol 5e-2 and an atol of 5e-2 times the output's rms.
BF16_RTOL = BF16_ATOL_RMS = 5e-2
# The reference's SpMV bound (tests/test_kernels_linalg.py) plus a relative
# term: the JAX reference sums a row's slots in its own order.
SPMV_TOL = dict(rtol=1e-5, atol=1e-5)


# -- which kernel, and how the sequence is split --------------------------------

@pytest.mark.parametrize("kernel", ["tensor_cores", "cuda_cores"])
def test_splits_cover_the_sequence_with_no_split_empty(kernel):
    unit = da.TILE if kernel == "tensor_cores" else da.THREADS
    for bsz in (1, 2, 8, 64):
        for hkv in (1, 2, 8, 16):
            for seq in (1, 63, 64, 65, 160, 1000, 4097, 32768):
                args = (bsz, hkv, seq, H100_SMS)
                splits, per = da.splits_for(*args, kernel=kernel)
                # shapes only: the same shapes give the same launch
                assert (splits, per) == da.splits_for(*args, kernel=kernel)
                assert per % unit == 0 and splits >= 1
                assert (splits - 1) * per < seq <= splits * per
                if kernel == "tensor_cores":
                    # at most one split a tile, and one CTA a SM
                    assert splits <= -(-seq // da.TILE)
                    assert splits == 1 or splits * hkv * bsz <= H100_SMS


def test_serve_and_long_shapes_split_as_documented():
    # qwen2-0.5b's decode: B = 8, Hkv = 2, D = 64
    tc = dict(kernel="tensor_cores")
    assert da.splits_for(8, 2, 160, H100_SMS, **tc) == (3, 64)
    assert da.splits_for(8, 2, 32768, H100_SMS, **tc) == (8, 4096)
    # the CUDA-core kernel keeps its 256-position rule: one split at S = 160
    assert da.splits_for(8, 2, 160, H100_SMS) == (1, 256)
    assert da.splits_for(8, 2, 32768, H100_SMS) == (16, 2048)


def test_kernel_rule_picks_from_dtype_and_shape():
    bf16, f32 = torch.bfloat16, torch.float32
    for dim in range(16, 257, 16):
        for group in range(1, 17):
            assert da.kernel_for(bf16, group, dim) == "tensor_cores"
            assert da.kernel_for(f32, group, dim) == "cuda_cores"
            assert da.kernel_for(bf16, group, dim, aligned=False) == \
                "cuda_cores"
    for dim in (8, 24, 72, 100, 272):
        assert da.kernel_for(bf16, 4, dim) == "cuda_cores"
    assert da.kernel_for(bf16, 17, 64) == "cuda_cores"
    assert da.kernel_for(torch.float16, 4, 64) == "cuda_cores"


def test_every_attention_config_decodes_on_the_tensor_cores():
    seen = set()
    for arch in ARCHS:
        cfg = get_config(arch)
        if cfg.head_dim < 16:          # the SSD model has no attention
            continue
        group = cfg.n_heads // cfg.n_kv_heads
        assert da.kernel_for(cfg.compute_dtype, group, cfg.head_dim) == \
            "tensor_cores", arch
        seen.add(cfg.head_dim)
    assert seen == {64, 80, 96, 128, 256}


@pytest.mark.parametrize("dim", list(range(16, 257, 16)))
def test_kv_ring_fits_the_card(dim):
    stages, smem = da.mma_layout(dim)
    assert stages in (3, 4, 8)
    assert smem <= da.SMEM_OPTIN
    # two CTAs a SM up to D = 128, one above
    assert (2 if dim <= 128 else 1) * (smem + CTA_RESERVED) <= SM_SMEM
    rs = 2 * dim + 16
    # query rows at an odd number of 16-byte chunks: ldmatrix's eight rows
    # of a matrix land in eight different bank groups
    assert (rs // 16) % 2 == 1
    assert smem == 128 + 16 * rs + 1024 + stages * 2 * da.TILE * 2 * dim
    # the four warps' merge rows ([m, l, acc] for 16 query rows) fit the ring
    assert 4 * 16 * (dim + 2) * 4 <= stages * 2 * da.TILE * 2 * dim


# -- the tensor-core kernel's rounding --------------------------------------

def _rounded_p(q, k, v, length):
    """Decode attention with the tensor-core kernel's rounding and none of
    its tiling: float32 logits of the bf16 operands, the unnormalised
    P = exp(s - max) rounded to bf16 before the value product and the sum,
    the division last. (The plain version rounds the logits to bf16 and
    casts the normalised P.)"""
    grp = q.shape[1] // k.shape[2]
    kf, vf = (t.float().repeat_interleave(grp, dim=2) for t in (k, v))
    sc = torch.einsum("bhd,bshd->bhs", q.float(), kf) / math.sqrt(q.shape[2])
    if length is not None:
        pos = torch.arange(k.shape[1])[None, None, :]
        sc = sc.masked_fill(pos >= length[:, None, None], -math.inf)
    p = torch.exp(sc - sc.max(dim=-1, keepdim=True).values)
    p = p.bfloat16().float()
    out = torch.einsum("bhs,bshd->bhd", p, vf) / p.sum(-1, keepdim=True)
    return out.bfloat16()


@pytest.mark.parametrize("dim", [64, 80, 128, 256])
@pytest.mark.parametrize("hq,hkv", [(14, 2), (40, 8)])
@pytest.mark.parametrize("s", [1, 65, 160, 1000])
def test_tensor_core_arithmetic_meets_the_bf16_rule(dim, hq, hkv, s):
    g = np.random.default_rng(dim + 7 * hq + s)
    shapes = ((2, hq, dim), (2, s, hkv, dim), (2, s, hkv, dim))
    q, k, v = (torch.from_numpy(g.standard_normal(sh).astype(np.float32))
               .bfloat16() for sh in shapes)
    for ln in (None, [1, s], [s // 3 + 1, s]):
        length = None if ln is None else torch.tensor(ln, dtype=torch.int32)
        got = _rounded_p(q, k, v, length).float().numpy()
        want = np.asarray(jref.decode_attention(
            *(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
            length=None if ln is None else jnp.asarray(ln, jnp.int32)))
        rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                                   atol=BF16_ATOL_RMS * rms)


# -- spmv_ell: runs, slot order ------------------------------------------------

def test_run_rows_fit_two_runs_in_a_cta():
    for k in range(0, 1200):
        r = tspmv.run_rows(k)
        smem = 2 * 2 * 4 * (-(-r * k // 4) * 4)   # two runs, both planes
        assert 1 <= r <= tspmv.RUN_ROWS and smem <= tspmv.SMEM_OPTIN
        if r >= 32:
            assert r % 32 == 0
        if 16 * k * tspmv.RUN_ROWS <= tspmv.RUN_SMEM:
            assert r == tspmv.RUN_ROWS
        if k <= 453:
            assert r >= 32


def test_spmv_takes_no_block_size():
    assert list(inspect.signature(ops.spmv).parameters) == ["data", "cols",
                                                            "x"]
    assert list(inspect.signature(tspmv.spmv_ell).parameters) == [
        "data", "cols", "x"]


@pytest.mark.parametrize("k", [0, 1, 3, 5, 7, 9])
@pytest.mark.parametrize("n", [1, 255, 257, 4099])
def test_spmv_ell_sums_in_slot_order(k, n):
    g = np.random.default_rng(k * 10000 + n)
    data = g.standard_normal((n, k)).astype(np.float32)
    cols = g.integers(0, n, (n, k)).astype(np.int32)
    data[:, k // 2:] *= g.random((n, k - k // 2)) < 0.5   # some padding
    cols[data == 0] = 0
    x = g.standard_normal(n).astype(np.float32)
    acc = np.zeros(n, np.float32)
    for j in range(k):          # float32, each product rounded before the add
        acc = acc + data[:, j] * x[cols[:, j]]
    got = ops.spmv(torch.from_numpy(data), torch.from_numpy(cols),
                   torch.from_numpy(x))
    assert np.array_equal(got.numpy(), acc)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.spmv_ell(
            jnp.asarray(data), jnp.asarray(cols), jnp.asarray(x))),
        **SPMV_TOL)
