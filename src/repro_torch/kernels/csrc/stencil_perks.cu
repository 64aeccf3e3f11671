// The PERKS one-step kernel: `steps` Jacobi steps in one cooperative
// launch, one grid.sync() a step, with the leading `R` planes (rows in 2D)
// of the domain kept in shared memory for the kernel's whole life.
//
// Replaces: src/repro/kernels/stencil2d.py:stencil_perks (`_perks_kernel`,
// fuse_steps=1) with R < H. With every row cached (stencil_perks at R = H
// and stencil2d.py:stencil_resident) the wrapper runs
// csrc/stencil_resident.cu instead, where that kernel holds the domain.
//
// The TPU kernel runs its grid in order on one core and updates the domain
// in place, carrying overwritten rows in VMEM. Here 132 SMs run at once:
//   * the cached planes [0, R) are cut into `nbz` contiguous bands of at
//     least r planes and, where a plane is wider than a CTA's registers
//     hold (3D), each band into `nby` slabs of at least r plane rows: one
//     box a CTA, planes [b0, b1) x plane rows [y0, y1) x all columns,
//     stored with r halo plane rows on each cut side; a box lives in
//     shared memory from the prologue (one load) to the epilogue (one
//     store);
//   * each step a CTA first refreshes its halo plane rows from device
//     memory (its neighbours published them the step before), then updates
//     its box a block of planes at a time: the new values are held in
//     registers (ONE_CELLS a thread) until the whole block has been read,
//     then written r planes from their old place (below, blocks bottom-up,
//     on even steps; above, top-down, on odd ones), so no block overwrites
//     a plane a later block reads and a box costs (planes + r) stored
//     planes; every point of a cell is a shared-memory load at a fixed
//     offset from it, but on the box's first and last r planes, which read
//     the planes beyond the box from device memory. Then the CTA publishes
//     the r-deep faces of its box on both cut axes to the step's output
//     buffer, where its neighbours and the streamed rows read them after
//     grid.sync();
//   * the uncached rows [R, H) stream every step between two device-memory
//     ping-pong buffers (step 0 reads the caller's x, so x is never
//     written). They are cut into `nseg` contiguous strips and each plane
//     into tiles of sy plane rows by sx columns; a unit is one strip of one
//     tile, and CTA b walks units b, b + grid, ... (with nseg = k * grid /
//     tiles each CTA keeps one strip), each from its top row to its bottom
//     one. A window of `slots` = 2r + 1 + PERKS_STREAM_ROWS tile rows, each
//     widened by the r halo (columns from a 16-byte boundary), is a ring in
//     shared memory that the CTA's last warp feeds by bulk copies (TMA
//     without a tensor map, one a plane row) completing on each slot's
//     full mbarrier, as soon as the slot's empty mbarrier says every
//     computing warp is done with it: up to PERKS_STREAM_ROWS rows ahead of
//     use, across units, the step's first `slots` rows while the box is
//     updated. A streamed cell is read from device memory once a step (its
//     tile's halo aside), its vertical neighbours from the window;
//   * the other 15 warps compute the rows with no block-wide barrier: each
//     waits for a row's window row, computes its cells of the row (at most
//     ONE_TILE_CELLS a thread, neighbouring threads neighbouring columns,
//     stored as coalesced row runs) and frees the slot of the row 2r above;
//   * grid.sync() is the barrier between steps (the paper's Fig. 3, right);
//   * a batch of B domains is one launch of grid (ctas, B): lane b's CTAs
//     (x, b) hold its boxes and walk its units, laid out as for one domain
//     on `ctas` CTAs (stencil2d.lane_ctas); one grid.sync() serves all.
//
// Cells are float or __nv_bfloat16 (one instance each, chosen at launch).
// Every update sums its terms in the spec's order with the rounding of
// stencil_common.cuh, so the result is the plain version's bit for bit.
//
// Bound on the H100: device memory, the streamed rows read (with their
// tiles' halos) and written once a step, the boxes' faces and halo rows a
// step, the cached planes one load and one store in all
// (core/cache_policy.py:gm_bytes_perks). The window keeps up to
// PERKS_STREAM_ROWS rows in flight a CTA; the box update and the rows'
// loads and sums from shared memory are what is left besides the bytes.
// Each spec's point count is a compile-time constant
// (STENCIL_DISPATCH_NPTS), so the point loops unroll.
#include <cooperative_groups.h>

#include "stencil_async.cuh"
#include "stencil_common.cuh"

namespace cg = cooperative_groups;

// Threads of a CTA and the new values one thread holds while a block of box
// planes is updated in place: a box's plane slab has at most
// ONE_THREADS * ONE_CELLS cells (stencil2d.PERKS_MAX_ROW_CELLS).
constexpr int ONE_THREADS = 512;
constexpr int ONE_CELLS = 40;
// The streamed rows: the last warp feeds the window, the others
// (STREAM_THREADS threads) compute its rows, at most ONE_TILE_CELLS cells of
// a tile row a thread; the window holds PERKS_STREAM_ROWS rows ahead of the
// 2r + 1 in use.
constexpr int STREAM_WARPS = ONE_THREADS / 32 - 1;
constexpr int STREAM_THREADS = STREAM_WARPS * 32;
constexpr int ONE_TILE_CELLS = 4;
constexpr int PERKS_STREAM_ROWS = 5;
constexpr int PERKS_MAX_SLOTS = 2 * STENCIL_MAX_RADIUS + 1 + PERKS_STREAM_ROWS;
// A window wait that lasts this many cycles (seconds) is a fault.
constexpr long long PERKS_WAIT_CYCLES = 1LL << 34;

// Built with -DPERKS_PROFILE, every CTA (of every lane) sums the clock
// cycles of a step's phases: thread 0 (a computing warp) 0 the box (and the
// window's first copies), 1 waiting for window rows, 2 computing and
// storing rows and freeing slots, 3 grid.sync() (and the feeder's last
// rows); the feeder's lane 0 4 waiting for a free slot, 5 its whole walk
// after the box; stencil_perks_profile reads and clears them.
#ifdef PERKS_PROFILE
__device__ unsigned long long perks_cycles[6];
#define PERKS_MARK(kind)                         \
    do {                                         \
        if (threadIdx.x == 0) {                  \
            const long long t_ = clock64();      \
            prof_[kind] += t_ - t0_;             \
            t0_ = t_;                            \
        }                                        \
    } while (0)
#define PERKS_TIME(kind, ...)                                 \
    do {                                                      \
        const long long s_ = clock64();                       \
        __VA_ARGS__;                                          \
        if ((threadIdx.x & 31) == 0) prof_[kind] += clock64() - s_; \
    } while (0)
#else
#define PERKS_MARK(kind) do {} while (0)
#define PERKS_TIME(kind, ...) do { __VA_ARGS__; } while (0)
#endif

// Passed by value from the host (ctypes mirrors it; lin and async are
// filled by stencil_perks_launch).
struct PerksArgs {
    int steps;
    int R;            // cached planes [0, R)
    int nbz, nby;     // boxes: nbz bands of planes by nby slabs of plane rows
    int box_bytes;    // shared memory of the boxes' region; the window follows
    int sy, sx;       // a streamed tile: plane rows (1 in 2D), columns
    int left, wx;     // its window: columns from max(0, x0 - left), wx wide
    int wy;           // and plane rows from max(0, y0 - r), wy of them
    int nseg;         // strips of the streamed rows
    int slots;        // window rows: 2r + 1 + PERKS_STREAM_ROWS
    int async;        // 1: window rows by bulk copies (else loads through L2)
    int lin[STENCIL_MAX_POINTS];   // point k at d1 * wx + d2 in a window row
};

// A unit of the streamed rows: window row m < n of it is row s0 - r + m of
// tile plane rows [ty0, ty1) x columns [tx0, tx1); u >= units: none left.
struct Cursor {
    int u, m, n, s0, ty0, ty1, tx0, tx1;
};

// The value of type T at byte address p.
template <typename T>
__device__ __forceinline__ T at(const unsigned char* p) {
    return *reinterpret_cast<const T*>(p);
}

// The sum at a cell of a window row at byte address c, point k at c +
// off[k] (bytes); NPTS == 0 takes the count and weights from the spec.
template <int NPTS, typename T>
__device__ __forceinline__ T window_sum(const unsigned char* c, const int* off,
                                        const StencilArgs& a,
                                        const SpecShared& s) {
    if (NPTS > 0) {
        T acc = term(at<T>(c + off[0]), a.w[0]);
#pragma unroll
        for (int k = 1; k < (NPTS > 0 ? NPTS : 1); ++k)
            acc = plus(acc, term(at<T>(c + off[k]), a.w[k]));
        return acc;
    }
    T acc = term(at<T>(c + off[0]), s.w[0]);
    for (int k = 1; k < a.npts; ++k) acc = plus(acc, term(at<T>(c + off[k]), s.w[k]));
    return acc;
}

// The sum at box cell idx, point k at box[idx + (lin[k] & m)] (m = 0:
// every term reads the cell itself, a frozen, idle or edge cell's sum that
// the caller drops).
template <int NPTS, typename T>
__device__ __forceinline__ T box_sum(const T* box, int idx, int m, const int* lin,
                                     const StencilArgs& a, const SpecShared& s) {
    if (NPTS > 0) {
        T acc = term(box[idx + (lin[0] & m)], a.w[0]);
#pragma unroll
        for (int k = 1; k < (NPTS > 0 ? NPTS : 1); ++k)
            acc = plus(acc, term(box[idx + (lin[k] & m)], a.w[k]));
        return acc;
    }
    T acc = term(box[idx + (lin[0] & m)], s.w[0]);
    for (int k = 1; k < a.npts; ++k) acc = plus(acc, term(box[idx + (lin[k] & m)], s.w[k]));
    return acc;
}

// The sum at plane jj (box-relative, planes at box + (jj + off) * SP) and
// stored cell c of a box's first or last r planes: a point on a plane
// beyond the box reads it from src (at src + jj' * P for box plane jj').
template <typename T>
__device__ __forceinline__ T box_sum_edge(const T* box, int off, int jj, int c,
                                          int n, int SP, const T* __restrict__ src,
                                          const StencilArgs& a, const SpecShared& s) {
    auto at_ = [&](int k) -> T {
        const int j = jj + s.d0[k], cc = c + s.dc[k];
        return (j >= 0 && j < n) ? box[(j + off) * SP + cc]
                                 : ldcg(src + (long long)j * a.P + cc);
    };
    T acc = term(at_(0), s.w[0]);
#pragma unroll 1
    for (int k = 1; k < a.npts; ++k) acc = plus(acc, term(at_(k), s.w[k]));
    return acc;
}

template <int NPTS, typename T>
__global__ void __launch_bounds__(ONE_THREADS, 1)
stencil_perks_kernel(const T* __restrict__ x, T* buf0, T* buf1, StencilArgs a,
                     PerksArgs g) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ SpecShared s;
    __shared__ int lin[STENCIL_MAX_POINTS];
    if (threadIdx.x < STENCIL_MAX_POINTS) lin[threadIdx.x] = g.lin[threadIdx.x];
    load_spec(a, s);
    cg::grid_group grid = cg::this_grid();
    x = lane_domain(x, a);
    buf0 = lane_domain(buf0, a);
    buf1 = lane_domain(buf1, a);

    const int P = a.P, r = a.r, H = a.H, D1 = a.D1, D2 = a.D2;
    const int tid = threadIdx.x;
    const bool is3 = a.ndim == 3;

    // This CTA's box: planes [b0, b1) x plane rows [y0, y1), stored with
    // the plane rows [ylo, yhi): SP cells a plane, the NU updated ones from
    // cofs.
    int b0 = 0, b1 = 0, y0 = 0, y1 = D1;
    if ((int)blockIdx.x < g.nbz * g.nby) {
        const int bz = blockIdx.x / g.nby, by = blockIdx.x - bz * g.nby;
        b0 = (int)((long long)bz * g.R / g.nbz);
        b1 = (int)((long long)(bz + 1) * g.R / g.nbz);
        y0 = by * D1 / g.nby;
        y1 = (by + 1) * D1 / g.nby;
    }
    const int nrows = b1 - b0;
    const int ylo = max(0, y0 - r), yhi = min(D1, y1 + r);
    const int SP = (yhi - ylo) * D2, cofs = (y0 - ylo) * D2, NU = (y1 - y0) * D2;
    const int halo = SP - NU;            // halo cells of a stored plane
    T* box = reinterpret_cast<T*>(smem_raw);
    T* win = reinterpret_cast<T*>(smem_raw + g.box_bytes);
    // point k of a box cell at box offset d0 * SP + d1 * D2 + d2
    __shared__ int blin[STENCIL_MAX_POINTS];
    if (tid < a.npts) blin[tid] = a.d0[tid] * SP + a.dc[tid];
    int kb = (ONE_CELLS * ONE_THREADS) / max(NU, 1);
    kb = max(1, min(kb, PERKS_MAX_BLOCK_ROWS));
    const FastDiv byD2(D2);
#ifdef PERKS_PROFILE
    long long prof_[6] = {0, 0, 0, 0, 0, 0};
    long long t0_ = clock64();
#endif

    // The streamed units and the window: warp STREAM_WARPS feeds it, the
    // other warps compute its rows.
    const int warp = tid >> 5, lane = tid & 31;
    const bool feeder = warp == STREAM_WARPS;
    const int streamed = H - g.R;
    const int nx = (D2 + g.sx - 1) / g.sx, ny = (D1 + g.sy - 1) / g.sy;
    const int units = streamed > 0 ? g.nseg * nx * ny : 0;
    const int Q = g.slots, slot = g.wy * g.wx;
    auto unit_at = [&](Cursor& c, int u) {
        c.u = u;
        c.m = 0;
        if (u >= units) return;
        const int sg = u % g.nseg, tile = u / g.nseg;
        const int tyi = tile / nx, txi = tile - tyi * nx;
        c.s0 = g.R + (int)((long long)sg * streamed / g.nseg);
        c.n = g.R + (int)((long long)(sg + 1) * streamed / g.nseg) - c.s0 + 2 * r;
        c.ty0 = tyi * g.sy;
        c.ty1 = min(D1, c.ty0 + g.sy);
        c.tx0 = txi * g.sx;
        c.tx1 = min(D2, c.tx0 + g.sx);
    };
    auto advance = [&](Cursor& c) {
        if (c.u < units && ++c.m == c.n) unit_at(c, c.u + gridDim.x);
    };
    // Window rows a step: every unit's rows and r above and below.
    int loads = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
        Cursor c;
        unit_at(c, u);
        loads += c.n;
    }
    // Slot sl's mbarriers: full (the feeder's copy landed; one arrival and
    // the copy's bytes) and empty (every computing warp is done with it).
    __shared__ __align__(8) unsigned long long bars[2 * PERKS_MAX_SLOTS];
    auto full_bar = [&](int sl) { return smem_u32(&bars[2 * sl]); };
    auto empty_bar = [&](int sl) { return smem_u32(&bars[2 * sl + 1]); };
    if (tid < Q) {
        mbar_init(full_bar(tid), 1);
        mbar_init(empty_bar(tid), STREAM_WARPS);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // After the window: the byte offsets of every point from a cell of the
    // window row in slot own, its d0 rows wrapping around the ring.
    int* offtab = reinterpret_cast<int*>(win + (size_t)Q * slot);
    for (int e = tid; e < Q * STENCIL_MAX_POINTS; e += ONE_THREADS) {
        const int own = e / STENCIL_MAX_POINTS, k = e - own * STENCIL_MAX_POINTS;
        if (k < a.npts) {
            int sl = own + s.d0[k];
            sl += sl < 0 ? Q : (sl >= Q ? -Q : 0);
            offtab[e] = (int)sizeof(T) * ((sl - own) * slot + lin[k]);
        }
    }
    // The feeder's next window row goes into slot fs (its fill fp of that
    // slot modulo 2, the ring wrapped once in fw); the computing warps' next
    // one is in slot hd (fill hp). The slots run on across steps.
    int fs = 0, fp = 0, hd = 0, hp = 0;
    bool fw = false;
    // A window row of a unit: plane rows [ya, yb) within r of the tile,
    // columns [xa, xb) from max(0, tx0 - left) (with bulk copies from and
    // to 16-byte boundaries) to tx1 + r, window cell (y - ya) * wx + x - xa.
    // Load ci into slot fs.
    auto feed = [&](Cursor& ci, const T* src, bool wait_free) {
        if (wait_free && fw) {
            PERKS_TIME(4, {
                if (lane == 0) mbar_wait_or_trap(empty_bar(fs), fp ^ 1, PERKS_WAIT_CYCLES);
                __syncwarp();
            });
        }
        const int j = ci.s0 - r + ci.m;
        const uint32_t full = full_bar(fs);
        if (ci.u >= units || j < 0 || j >= H) {
            if (lane == 0) mbar_arrive(full);
        } else {
            const int ya = is3 ? max(0, ci.ty0 - r) : 0;
            const int yb = is3 ? min(D1, ci.ty1 + r) : 1;
            const int xa = max(0, ci.tx0 - g.left);
            T* w = win + (size_t)fs * slot;
            const T* row = src + (size_t)j * P + ya * D2 + xa;
            if (g.async) {
                constexpr int V = 16 / sizeof(T);
                const int xb = min(D2, (min(D2, ci.tx1 + r) + V - 1) / V * V);
                const uint32_t bytes = (uint32_t)((xb - xa) * sizeof(T));
                if (lane == 0) mbar_expect_tx(full, bytes * (yb - ya));
                __syncwarp();
                for (int p = lane; p < yb - ya; p += 32)
                    bulk_copy(smem_u32(w + p * g.wx), row + (size_t)p * D2, bytes,
                              full);
            } else {
                const int wd = min(D2, ci.tx1 + r) - xa, n = (yb - ya) * wd;
                for (int e = lane; e < n; e += 32) {
                    const int yy = e / wd, xx = e - yy * wd;
                    w[yy * g.wx + xx] = ldcg(row + (size_t)yy * D2 + xx);
                }
                __syncwarp();
                if (lane == 0) mbar_arrive(full);
            }
        }
        advance(ci);
        if (++fs == Q) {
            fs = 0;
            fp ^= 1;
            fw = true;
        }
    };

    // Prologue: the box's one load from device memory; its planes start at
    // box + jj * SP (off = 0) and move r planes at every step.
    int off = 0;
    for (int e = tid; e < nrows * SP; e += ONE_THREADS) {
        const int jj = e / SP;
        box[e] = x[(size_t)(b0 + jj) * P + ylo * D2 + (e - jj * SP)];
    }
    __syncthreads();



    for (int k = 0; k < g.steps; ++k) {
        const T* src = (k == 0) ? x : ((k & 1) ? buf0 : buf1);
        T* dst = (k & 1) ? buf1 : buf0;
        // The window's first rows (every slot is free), in flight while
        // the box is updated.
        const int pre = min(Q, loads);
        if (feeder) {
            Cursor ci;
            unit_at(ci, blockIdx.x);
            for (int l = 0; l < pre; ++l) feed(ci, src, false);
            // the planes beyond the box, which its first and last r planes
            // read from src, into L2 ahead of the box update
            if (g.async && nrows > 0)
                for (int p = lane; p < 2 * r; p += 32) {
                    const int j = p < r ? b0 - r + p : b1 + p - r;
                    if (j >= 0 && j < H)
                        bulk_prefetch_l2(src + (size_t)j * P + ylo * D2,
                                         (uint32_t)(SP * sizeof(T)));
                }
        }

        if (nrows > 0) {
            // The halo plane rows, published by the neighbouring boxes, at
            // the planes' present place.
            if (halo > 0) {
                for (int e = tid; e < nrows * halo; e += ONE_THREADS) {
                    const int jj = e / halo, q = e - jj * halo;
                    const int c = q < cofs ? q : q + NU;
                    box[(size_t)(jj + off) * SP + c] =
                        ldcg(src + (size_t)(b0 + jj) * P + ylo * D2 + c);
                }
                __syncthreads();
            }
            // The box update: blocks of planes [j0, j1) (box-relative) read
            // the old planes at box + (jj + off) * SP, every point at a
            // fixed offset from its cell (the first and last r planes read
            // the planes beyond the box from src), compute into registers,
            // and after one __syncthreads write the new values r planes
            // from their old place (no = r: below, bottom-up; no = 0:
            // above, top-down), so no block overwrites a plane a later one
            // reads.
            const int no = off == 0 ? r : 0;
            const int nblk = (nrows + kb - 1) / kb;
            for (int bi = 0; bi < nblk; ++bi) {
                const int blk = no > off ? nblk - 1 - bi : bi;
                const int j0 = blk * kb, j1 = min(nrows, j0 + kb), nr = j1 - j0;
                // Thread tid takes updated cells tid, tid + ONE_THREADS, ...
                // of the block, found by stepping (plane, cell).
                const int ii0 = tid / NU, q0 = tid - ii0 * NU;
                T v[ONE_CELLS];
                {
                    int ii = ii0, q = q0;
#pragma unroll
                    for (int m = 0; m < ONE_CELLS; ++m) {
                        if (m % 4 == 0 && ii >= nr) break;
                        const int jj = j0 + min(ii, nr - 1);
                        const int yq = byD2.div(q), xq = q - yq * D2;
                        const int yy = y0 + yq;
                        const bool in = ii < nr && row_interior(b0 + jj, a)
                                        && xq >= r && xq < D2 - r
                                        && (!is3 || (yy >= r && yy < D1 - r));
                        const bool edge = jj < r || jj >= nrows - r;
                        const int idx = (jj + off) * SP + cofs + q;
                        // a frozen, idle or edge cell sums at itself and drops
                        // the sum; the box's first and last r planes read the
                        // planes beyond it from src
                        const T sum = box_sum<NPTS>(box, idx, in && !edge ? -1 : 0,
                                                    blin, a, s);
                        v[m] = in && !edge ? sum : box[idx];
                        if (in && edge)
                            v[m] = box_sum_edge(box, off, jj, cofs + q, nrows, SP,
                                                src + (size_t)b0 * P + ylo * D2,
                                                a, s);
                        q += ONE_THREADS;
                        while (q >= NU) { q -= NU; ++ii; }
                    }
                }
                __syncthreads();
                {
                    int ii = ii0, q = q0;
#pragma unroll
                    for (int m = 0; m < ONE_CELLS; ++m) {
                        if (m % 4 == 0 && ii >= nr) break;
                        if (ii < nr)
                            box[(size_t)(j0 + ii + no) * SP + cofs + q] = v[m];
                        q += ONE_THREADS;
                        while (q >= NU) { q -= NU; ++ii; }
                    }
                }
            }
            off = no;
            __syncthreads();
            // Publish the box's faces for the neighbours' next step: its
            // first and last r planes, and (cut in plane rows) its first
            // and last r plane rows of the planes between.
            const T* cur = box + (size_t)off * SP + cofs;
            const int top_end = min(r, nrows), bot = max(nrows - r, top_end);
            for (int e = tid; e < top_end * NU; e += ONE_THREADS) {
                const int jj = e / NU, q = e - jj * NU;
                dst[(size_t)(b0 + jj) * P + y0 * D2 + q] = cur[(size_t)jj * SP + q];
            }
            for (int e = tid; e < (nrows - bot) * NU; e += ONE_THREADS) {
                const int jj = bot + e / NU, q = e % NU;
                dst[(size_t)(b0 + jj) * P + y0 * D2 + q] = cur[(size_t)jj * SP + q];
            }
            if (g.nby > 1) {
                const int ra = min(r, y1 - y0) * D2;   // cells of r plane rows
                const int per = (y0 > 0 ? ra : 0) + (y1 < D1 ? ra : 0);
                for (int e = tid; e < (bot - top_end) * per; e += ONE_THREADS) {
                    const int jj = top_end + e / per, q0 = e % per;
                    const int q = (y0 > 0 && q0 < ra) ? q0
                                                      : NU - ra + (q0 - (y0 > 0 ? ra : 0));
                    dst[(size_t)(b0 + jj) * P + y0 * D2 + q] = cur[(size_t)jj * SP + q];
                }
            }
        }
        PERKS_MARK(0);

        // Streamed rows [R, H): the feeder keeps the window's slots filled
        // as they are freed; each computing warp waits for a row's window
        // row, computes the row once its rows r below have landed, and
        // frees the slot of the row 2r above.
        if (feeder) {
            Cursor ci;
            unit_at(ci, blockIdx.x);
            for (int l = 0; l < pre; ++l) advance(ci);
            PERKS_TIME(5, for (int l = pre; l < loads; ++l) feed(ci, src, true));
        } else {
            // A computing thread's cells of the computed unit's tile rows
            // (ncell of them; ncell_max the tile row's cells): byte offset in
            // a window row of the cell (wpos) and of where its sum reads
            // (spos: the cell itself if it is interior, else a window
            // position r in from the window row's edges, whose every
            // neighbour lies in the window; the sum is then dropped),
            // in-plane offset, and whether each is an interior cell of the
            // plane (cin, as bits).
            int wpos[ONE_TILE_CELLS], spos[ONE_TILE_CELLS];
            unsigned gofs[ONE_TILE_CELLS];
            int ncell = 0, ncell_max = 0;
            unsigned cin = 0;
            Cursor cc;
            unit_at(cc, blockIdx.x);
            for (int l = 0; l < loads; ++l) {
                if (cc.m == 0) {
                    // an idle slot (past the tile's cells) reads the tile's
                    // first cell and stores nothing
                    const int nxt = cc.tx1 - cc.tx0, n = (cc.ty1 - cc.ty0) * nxt;
                    const int oy = is3 ? max(0, cc.ty0 - r) : 0;
                    const int ox = max(0, cc.tx0 - g.left);
                    const int safe = (int)sizeof(T) * ((is3 ? r * g.wx : 0) + r);
                    ncell = 0;
                    ncell_max = n;
                    cin = 0;
#pragma unroll
                    for (int q = 0; q < ONE_TILE_CELLS; ++q) {
                        const int e0 = tid + q * STREAM_THREADS;
                        const int e = e0 < n ? e0 : 0;
                        const int yy = e / nxt, y = cc.ty0 + yy;
                        const int xg = cc.tx0 + e - yy * nxt;
                        const bool in = e0 < n && xg >= r && xg < D2 - r
                                        && (!is3 || (y >= r && y < D1 - r));
                        wpos[q] = (int)sizeof(T) * ((y - oy) * g.wx + (xg - ox));
                        spos[q] = in ? wpos[q] : safe;
                        gofs[q] = (unsigned)(y * D2 + xg);
                        ncell += e0 < n;
                        cin |= (unsigned)in << q;
                    }
                }
                mbar_wait_or_trap(full_bar(hd), hp, PERKS_WAIT_CYCLES);
                PERKS_MARK(1);
                if (cc.m >= 2 * r) {
                    const int j = cc.s0 + cc.m - 2 * r;
                    const unsigned in = row_interior(j, a) ? cin : 0u;
                    // the row's own window row (slot own); its points read
                    // d0 rows of the ring from it, wrapping where they pass
                    // the ring's ends
                    int own = hd - r;
                    own += own < 0 ? Q : 0;
                    const unsigned char* rowb = reinterpret_cast<const unsigned char*>(
                        win + own * slot);
                    T* drow = dst + (size_t)j * P;
                    // the points' byte offsets from a cell of this window row
                    int off[NPTS > 0 ? NPTS : STENCIL_MAX_POINTS];
#pragma unroll
                    for (int k = 0; k < (NPTS > 0 ? NPTS : STENCIL_MAX_POINTS); ++k) {
                        if (NPTS == 0 && k >= a.npts) break;
                        off[k] = offtab[own * STENCIL_MAX_POINTS + k];
                    }
                    // every sum first (no branch between cells, so their
                    // loads interleave), then the stores
                    T v[ONE_TILE_CELLS];
#pragma unroll
                    for (int q = 0; q < ONE_TILE_CELLS; ++q) {
                        if (q * STREAM_THREADS >= ncell_max) break;
                        const T sum = window_sum<NPTS, T>(rowb + spos[q], off, a, s);
                        v[q] = ((in >> q) & 1u) ? sum : at<T>(rowb + wpos[q]);
                    }
#pragma unroll
                    for (int q = 0; q < ONE_TILE_CELLS; ++q) {
                        if (q * STREAM_THREADS >= ncell_max) break;
                        if (q < ncell) drow[gofs[q]] = v[q];
                    }
                }
                // the row 2r above is done with (every row read it)
                __syncwarp();
                if (lane == 0 && l >= 2 * r) {
                    int old = hd - 2 * r;
                    old += old < 0 ? Q : 0;
                    mbar_arrive(empty_bar(old));
                }
                advance(cc);
                if (++hd == Q) {
                    hd = 0;
                    hp ^= 1;
                }
                PERKS_MARK(2);
            }
            // free the step's last 2r window rows
            if (lane == 0)
                for (int l = max(0, loads - 2 * r); l < loads; ++l) {
                    int old = hd - (loads - l);
                    old += old < 0 ? Q : 0;
                    mbar_arrive(empty_bar(old));
                }
        }
        // this step's stores are read by the next step's bulk copies (the
        // async proxy)
        asm volatile("fence.proxy.async;" ::: "memory");
        grid.sync();
        PERKS_MARK(3);
    }
#ifdef PERKS_PROFILE
    if (lane == 0 && (warp == 0 || feeder))
        for (int k = 0; k < 6; ++k)
            atomicAdd(&perks_cycles[k], (unsigned long long)prof_[k]);
#endif

    // Epilogue: the box's one store, into the buffer the last step wrote.
    if (nrows > 0 && g.steps > 0) {
        T* fin = ((g.steps - 1) & 1) ? buf1 : buf0;
        for (int e = tid; e < nrows * NU; e += ONE_THREADS) {
            const int jj = e / NU, q = e - jj * NU;
            fin[(size_t)(b0 + jj) * P + y0 * D2 + q] =
                box[(size_t)(jj + off) * SP + cofs + q];
        }
    }
}

template <int NPTS>
static void kernel_f32(const void** out) {
    *out = (const void*)stencil_perks_kernel<NPTS, float>;
}

template <int NPTS>
static void kernel_bf16(const void** out) {
    *out = (const void*)stencil_perks_kernel<NPTS, __nv_bfloat16>;
}

static const void* perks_kernel(int npts, int dtype) {
    const void* f = nullptr;
    if (dtype == STENCIL_BF16) {
        STENCIL_DISPATCH_NPTS(npts, kernel_bf16, &f)
    } else {
        STENCIL_DISPATCH_NPTS(npts, kernel_f32, &f)
    }
    return f;
}

// The kernel's threads, new values a thread holds, window rows in flight
// and tile cells a thread computes (checked by the wrapper against
// stencil2d.ONE_THREADS, ONE_CELLS, PERKS_STREAM_ROWS and ONE_TILE_CELLS).
extern "C" int stencil_perks_shape(int* threads, int* cells, int* ahead,
                                   int* tile_cells) {
    *threads = ONE_THREADS;
    *cells = ONE_CELLS;
    *ahead = PERKS_STREAM_ROWS;
    *tile_cells = ONE_TILE_CELLS;
    return 0;
}

#ifdef PERKS_PROFILE
extern "C" int stencil_perks_profile(unsigned long long* out) {
    cudaError_t e = cudaMemcpyFromSymbol(out, perks_cycles, sizeof(perks_cycles));
    if (e != cudaSuccess) return (int)e;
    const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(perks_cycles, zero, sizeof(zero));
}
#endif

// The card's opt-in shared memory per block and the kernel's static shared
// memory. The wrapper checks the static part against PERKS_STATIC_SMEM of
// stencil2d.py, the one reserve the planner and the wrapper both subtract.
extern "C" int stencil_perks_smem(int npts, int dtype, int* optin,
                                  int* static_bytes) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, perks_kernel(npts, dtype));
    if (e != cudaSuccess) return (int)e;
    *static_bytes = (int)attr.sharedSizeBytes;
    return 0;
}

// Co-resident CTAs for `smem_bytes` of dynamic shared memory: the largest
// grid a cooperative launch accepts.
extern "C" int stencil_perks_max_ctas(int npts, int dtype, int smem_bytes,
                                      int* out) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const void* f = perks_kernel(npts, dtype);
    e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, ONE_THREADS,
                                                      smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    *out = per_sm * sms;
    return 0;
}

// Launches `grid` CTAs for each of `lanes` stacked domains on `stream` for
// elements of type `dtype` (STENCIL_F32 or STENCIL_BF16); returns the
// cudaError_t of the launch (0 = success) and sets *async to whether the
// window rows are bulk copies: the
// buffers and row strides on 16-byte boundaries, and every window's columns
// from one (the layout's tile columns, left halo and window width are
// 16-byte multiples).
extern "C" int stencil_perks_launch(const void* x, void* buf0, void* buf1,
                                    StencilArgs a, PerksArgs g, int dtype,
                                    int grid, int lanes, int smem_bytes,
                                    cudaStream_t stream, int* async) {
    const void* f = perks_kernel(a.npts, dtype);
    const int eb = dtype == STENCIL_BF16 ? 2 : 4;
    for (int k = 0; k < a.npts; ++k) g.lin[k] = a.d1[k] * g.wx + a.d2[k];
    g.async = (uintptr_t)x % 16 == 0 && (uintptr_t)buf0 % 16 == 0
              && (uintptr_t)buf1 % 16 == 0 && ((long long)a.D2 * eb) % 16 == 0
              && (g.sx * eb) % 16 == 0 && (g.left * eb) % 16 == 0
              && (g.wx * eb) % 16 == 0 && g.box_bytes % 16 == 0;
    *async = g.async;
    cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {(void*)&x, (void*)&buf0, (void*)&buf1, (void*)&a, (void*)&g};
    e = cudaLaunchCooperativeKernel(f, dim3(grid, lanes), dim3(ONE_THREADS),
                                    args, (size_t)smem_bytes, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
