"""The launch geometry of the loop tiers' step kernel (``csrc/stencil_step.cu``,
``kernels/stencil2d.py:step_layout``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Here: its tiles cover every cell of every instance exactly once; its ring
holds the 2r + 1 rows in use and the rows in flight; its shared memory fits
a CTA; its C constants and compiled shapes match the Python ones and the
Table-III specs; and a numpy run of its schedule (the ring's fills and
slots, each thread's reads at the kernel's offsets, its stores) is bit-equal
to the plain ``ref.stencil_step`` and to the JAX reference's step, reads
no row before it is copied and overwrites no row still in use.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.common import get_spec as jax_get_spec
from repro_torch.kernels import _build, ref, stencil2d
from repro_torch.kernels.common import (BENCHMARKS, StencilSpec, _box, _star,
                                        get_spec)
from repro_torch.kernels.stencil2d import (STEP_FILL, STEP_PREFETCH,
                                           STEP_THREADS, step_layout)

SOURCE = (Path(stencil2d.__file__).parent / "csrc" / "stencil_step.cu"
          ).read_text()
NAMES = sorted(BENCHMARKS)
LIMIT = 232448 - stencil2d.PERKS_STATIC_SMEM


def _wide(ndim: int, radius: int, box: bool = False) -> StencilSpec:
    """A spec of radius up to 8 that is none of the compiled shapes (the
    kernel's runtime path), with distinct weights."""
    offs = (_box if box else _star)(ndim, radius)
    w = tuple(float(np.float32(0.5 / (k + 2))) for k in range(len(offs)))
    return StencilSpec(f"wide{ndim}d{radius}{'b' if box else ''}", ndim,
                       tuple(offs), w)


#: specs of the runtime path, radius 3 to STENCIL_MAX_RADIUS = 8
WIDE = [_wide(2, 8), _wide(2, 7), _wide(3, 3), _wide(3, 8), _wide(2, 3, True)]
#: ragged shapes: P not a multiple of V, H < tile + 2r, planes not
#: multiples of the tile
SHAPES = {2: [(40, 70), (7, 9), (19, 130), (64, 520)],
          3: [(12, 10, 14), (5, 19, 23), (9, 33, 66), (20, 17, 40)]}


def _cases():
    """(name, spec, shape) for every shape that holds the spec's stencil
    (the plain version needs every axis longer than 2r)."""
    for spec in [get_spec(n) for n in NAMES] + WIDE:
        fit = [s for s in SHAPES[spec.ndim] if min(s) > 2 * spec.radius]
        for shape in fit[:2] if spec in WIDE else fit:
            yield spec.name, spec, shape


CASES = list(_cases())
IDS = [f"{n}-{'x'.join(map(str, s))}" for n, _, s in CASES]


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, name
    return int(m.group(1))


# -- the C source against the Python side --------------------------------------


def test_c_constants_match_the_python_ones():
    assert _constant("STEP_THREADS") == STEP_THREADS
    assert _constant("STEP_PREFETCH") == STEP_PREFETCH
    assert _constant("STEP_FILL") == STEP_FILL
    fields = re.search(r"struct StepArgs \{(.*?)\};", SOURCE, re.S).group(1)
    names = re.findall(r"int (\w+);", fields)
    assert names == [f for f, _ in _build.StepArgs._fields_]
    assert "STEP_STREAM_ROWS" not in SOURCE
    common = (Path(stencil2d.__file__).parent / "csrc" /
              "stencil_common.cuh").read_text()
    assert "step_rows" not in common and "sum_flat" not in common


def _c_at(fam: str, nd: int, R: int, k: int) -> tuple[int, ...]:
    """``Shape<F, ND, R>::at(k)`` of the C source, transcribed."""
    if fam == "STEP_STAR":
        if k == 0:
            return (0,) * nd
        m = k - 1
        rem = m % (2 * R)
        d = rem // 2 + 1
        o = [0] * nd
        o[m // (2 * R)] = d if rem % 2 else -d
        return tuple(o)
    if fam == "STEP_BOX":
        b = 2 * R + 1
        return ((k // b - R, k % b - R) if nd == 2 else
                (k // (b * b) - R, (k // b) % b - R, k % b - R))
    if fam == "STEP_3D17":
        t = re.search(r"constexpr int t\[17\]\[3\] = \{(.*?)\};", SOURCE,
                      re.S).group(1)
        rows = re.findall(r"\{(-?\d+), (-?\d+), (-?\d+)\}", t)
        return tuple(int(v) for v in rows[k])
    seen = 0
    for j in range(27):
        o = (j // 9 - 1, (j // 3) % 3 - 1, j % 3 - 1)
        if sum(map(abs, o)) <= 2:
            if seen == k:
                return o
            seen += 1
    raise AssertionError(k)


def _c_n(fam: str, nd: int, R: int) -> int:
    return {"STEP_STAR": 1 + 2 * nd * R, "STEP_BOX": (2 * R + 1) ** nd,
            "STEP_3D17": 17, "STEP_POISSON": 19}[fam]


def test_compiled_shapes_are_the_table_iii_specs_in_order():
    macro = re.search(r"#define STEP_SHAPES\(X\)(.*?)\n\n", SOURCE,
                      re.S).group(1)
    shapes = re.findall(r"X\((STEP_\w+), (\d), (\d)\)", macro)
    assert len(shapes) == len(BENCHMARKS)
    for (fam, nd, R), spec in zip(shapes, BENCHMARKS.values()):
        nd, R = int(nd), int(R)
        assert (nd, R) == (spec.ndim, spec.radius), spec.name
        got = tuple(_c_at(fam, nd, R, k) for k in range(_c_n(fam, nd, R)))
        assert got == spec.offsets, spec.name
    # the queue holds exactly the specs whose off-centre rows are on the
    # leading axis
    for (fam, _, _), spec in zip(shapes, BENCHMARKS.values()):
        star0 = all(all(c == 0 for c in o[1:]) for o in spec.offsets
                    if o[0] != 0)
        assert star0 == (fam in ("STEP_STAR", "STEP_3D17")), spec.name


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype_bytes", [4, 2])
def test_windows_stay_inside_a_ring_row(name, dtype_bytes):
    """Each point group's 16-byte chunks (the C source's floordiv of its
    in-row reach) cover the points' cells and lie inside the ring row."""
    spec = get_spec(name)
    V, r = 16 // dtype_bytes, spec.radius
    ra = -(-r // V) * V
    CB, CE = -((r + V - 1) // V), (V - 1 + r) // V
    groups = {}
    for o in spec.offsets:
        d2 = o[-1]
        key = o[:-1]
        lo, hi = groups.get(key, (r + 1, -r - 1))
        groups[key] = (min(lo, d2), max(hi, d2))
    for (lo, hi) in groups.values():
        c0, c1 = lo // V, (V - 1 + hi) // V
        assert CB <= c0 and c1 <= CE
        for v in range(V):
            for d2 in range(lo, hi + 1):
                assert c0 * V <= v + d2 < (c1 + 1) * V
        # a lane's chunks from its own, at ra + lane * V in a row of
        # lanes * V + 2 ra cells
        assert -ra <= c0 * V and (c1 + 1) * V <= V + ra


# -- the geometry ----------------------------------------------------------------


@pytest.mark.parametrize("dtype_bytes", [4, 2])
@pytest.mark.parametrize("name,spec,shape", CASES, ids=IDS)
def test_layout_ring_and_shared_memory(name, spec, shape, dtype_bytes):
    for b in (1, 3):
        lay = step_layout(spec, shape, dtype_bytes, b)
        r = spec.radius
        assert lay.slots >= 2 * r + 1 + STEP_PREFETCH
        assert lay.smem <= LIMIT
        assert 1 <= lay.threads <= STEP_THREADS
        assert lay.vec * dtype_bytes == 16 and lay.ra % lay.vec == 0
        assert lay.ra >= r and lay.span == lay.lanes * lay.vec + 2 * lay.ra
        ry = r if spec.ndim == 3 else 0
        assert lay.slot == (lay.rows + 2 * ry) * lay.span
        assert (lay.slot // lay.span) * (lay.span // lay.vec) <= (
            STEP_FILL * lay.threads)
        assert lay.grid[2] == b and lay.grid[1] <= 65535
        assert lay.row_aligned == (shape[-1] * dtype_bytes % 16 == 0)


@pytest.mark.parametrize("dtype_bytes", [4, 2])
@pytest.mark.parametrize("name,spec,shape", CASES, ids=IDS)
def test_tiles_cover_every_cell_once(name, spec, shape, dtype_bytes):
    for b in (1, 3):
        lay = step_layout(spec, shape, dtype_bytes, b)
        H, W = shape[0], shape[-1]
        D1 = shape[1] if spec.ndim == 3 else 1
        seen = np.zeros((b, H, D1, W), np.int64)
        t = np.arange(lay.threads)
        ly, lx = t // lay.lanes, t % lay.lanes
        for z in range(b):
            for tile in range(lay.grid[0]):
                tyi, txi = divmod(tile, lay.tiles_x)
                oy = tyi * lay.rows + ly
                for sg in range(lay.grid[1]):
                    s0 = sg * lay.seg
                    for v in range(lay.vec):
                        ox = txi * lay.lanes * lay.vec + lx * lay.vec + v
                        keep = (oy < D1) & (ox < W)
                        for i in range(s0, min(H, s0 + lay.seg)):
                            np.add.at(seen[z, i], (oy[keep], ox[keep]), 1)
        assert (seen == 1).all()


def test_main_path_layouts():
    """The loop tiers' full shapes: 2D 8192^2 and 3D 256^3, f32 and bf16."""
    for name in NAMES:
        spec = get_spec(name)
        shape = (8192, 8192) if spec.ndim == 2 else (256, 256, 256)
        for db in (4, 2):
            lay = step_layout(spec, shape, db)
            assert lay.row_aligned and lay.smem <= 96 * 1024
            tiles = lay.tiles_x * lay.tiles_y
            # at least two CTAs an SM, segments no shorter than
            # STEP_MIN_SEG rows
            assert lay.seg >= stencil2d.STEP_MIN_SEG
            assert tiles * lay.segs >= 132 * 2
    lay = step_layout(get_spec("2ds25pt"), (8192, 8192), 4)
    assert (lay.lanes, lay.rows, lay.ra, lay.slots) == (128, 1, 8, 16)


def test_layout_that_fits_nothing_raises_naming_spec_and_shape():
    spec = get_spec("3d27pt")
    with pytest.raises(ValueError, match=r"3d27pt on \(64, 64, 64\)"):
        step_layout(spec, (64, 64, 64), 4, limit=4096)
    with pytest.raises(ValueError, match="wide2d8"):
        step_layout(WIDE[0], (64, 64), 4, limit=1024)


# -- a numpy run of the kernel's schedule -------------------------------------


def run_model(x: np.ndarray, spec: StencilSpec, aligned: bool,
              sms: int = 132) -> np.ndarray:
    """One step of ``x`` (``[B, ...]`` float32) as ``csrc/stencil_step.cu``
    runs it: every CTA's ring fills (16-byte chunks a thread, or cell by
    cell), its slots, each thread's reads at the kernel's offsets and its
    stores. Asserts that every read slot holds the row the read wants, no
    fill overwrites a row still in use, and every cell is stored once."""
    B, dom = x.shape[0], x.shape[1:]
    nd, r = spec.ndim, spec.radius
    ry = r if nd == 3 else 0
    H, W = dom[0], dom[-1]
    D1 = dom[1] if nd == 3 else 1
    lay = step_layout(spec, tuple(dom), 4, B, sms)
    V, T = lay.vec, lay.threads
    xv = x.reshape(B, H, D1, W)
    out = np.full((B, H, D1, W), np.nan, np.float32)
    stores = np.zeros((B, H, D1, W), np.int64)
    offs = [(o[0], o[1] if nd == 3 else 0, o[-1]) for o in spec.offsets]
    w = [np.float32(v) for v in spec.weights]
    tid = np.arange(T)
    ly, lx = tid // lay.lanes, tid % lay.lanes
    cpr, nrows = lay.span // V, lay.slot // lay.span
    for z in range(B):
        for tile in range(lay.grid[0]):
            tyi, txi = divmod(tile, lay.tiles_x)
            x0, y0 = txi * lay.lanes * V, tyi * lay.rows
            oy, ox = y0 + ly, x0 + lx * V
            own = (ly + ry) * lay.span + lay.ra + lx * V
            for sg in range(lay.grid[1]):
                s0 = sg * lay.seg
                s1 = min(H, s0 + lay.seg)
                ring = np.full((lay.slots, lay.slot), np.nan, np.float32)
                label = np.full(lay.slots, -10**9)

                def fill(L, sl, j):
                    assert label[sl] < j, "a fill overwrote a row in use"
                    label[sl] = L
                    ring[sl] = np.nan
                    plane = s0 - r + L
                    if not (0 <= plane < H and plane < s1 + r):
                        return
                    if aligned:
                        for q in range(STEP_FILL):
                            idx = tid + q * T
                            row, ch = idx // cpr, idx % cpr
                            gy, gx = y0 - ry + row, x0 - lay.ra + ch * V
                            ok = ((idx < nrows * cpr) & (gy >= 0) & (gy < D1)
                                  & (gx >= 0) & (gx < W))
                            for c in range(V):
                                ring[sl, (row * lay.span + ch * V + c)[ok]] = \
                                    xv[z, plane, gy[ok], gx[ok] + c]
                    else:
                        e = np.arange(lay.slot)
                        row, c = e // lay.span, e % lay.span
                        gy, gx = y0 - ry + row, x0 - lay.ra + c
                        ok = (gy >= 0) & (gy < D1) & (gx >= 0) & (gx < W)
                        ring[sl, e[ok]] = xv[z, plane, gy[ok], gx[ok]]

                fs = 0
                for L in range(2 * r + STEP_PREFETCH):
                    fill(L, fs, -1)
                    fs = (fs + 1) % lay.slots
                cs = 0
                for j in range(s1 - s0):
                    i = s0 + j
                    fill(j + 2 * r + STEP_PREFETCH, fs, j)
                    fs = (fs + 1) % lay.slots

                    def read(d0, d1, d2, v):
                        sl = cs + d0 + r
                        sl = sl - lay.slots if sl >= lay.slots else sl
                        assert label[sl] == j + d0 + r, "read before its copy"
                        col = lay.ra + lx * V + v + d2
                        assert ((col >= 0) & (col < lay.span)).all()
                        assert 0 <= (ly + ry + d1).min() and (
                            ly + ry + d1).max() < nrows
                        return ring[sl, own + d1 * lay.span + v + d2]

                    for v in range(V):
                        ctr = read(0, 0, 0, v)
                        if i < r or i >= H - r:
                            val = ctr
                        else:
                            acc = None
                            for (d0, d1, d2), wk in zip(offs, w):
                                t = read(d0, d1, d2, v) * wk
                                acc = t if acc is None else acc + t
                            cin = (ox + v >= r) & (ox + v < W - r)
                            if nd == 3:
                                cin &= (oy >= r) & (oy < D1 - r)
                            val = np.where(cin, acc, ctr)
                        keep = (oy < D1) & (ox + v < W)
                        out[z, i, oy[keep], ox[keep] + v] = val[keep]
                        stores[z, i, oy[keep], ox[keep] + v] += 1
                    cs = (cs + 1) % lay.slots
    assert (stores == 1).all()
    return out.reshape(x.shape)


@pytest.mark.parametrize("name,spec,shape", CASES, ids=IDS)
def test_kernel_model_is_bit_equal_to_the_plain_step(name, spec, shape):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3,) + shape).astype(np.float32)
    want = ref.stencil_step(torch.from_numpy(x), spec).numpy()
    aligned = shape[-1] * 4 % 16 == 0
    for al in {aligned, False}:
        np.testing.assert_array_equal(run_model(x, spec, al), want)
    # few SMs: longer segments, the same bits
    np.testing.assert_array_equal(run_model(x[:1], spec, False, sms=2),
                                  want[:1])


@pytest.mark.parametrize("name", NAMES)
def test_kernel_model_matches_the_jax_reference(name):
    """The model of the kernel's schedule against the JAX package's step on
    the same numpy domain (atol 5e-6, the reference's stencil bound)."""
    spec = get_spec(name)
    shape = (40, 72) if spec.ndim == 2 else (12, 10, 16)
    x = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_get_spec(name).apply(jnp.asarray(x)))
    got = run_model(x[None], spec, True)[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)
