// Deep temporal blocking on Hopper: `steps` Jacobi steps in one cooperative
// launch, t steps per pass over device memory, with the leading `R` rows of
// the domain kept in shared memory for the kernel's whole life.
//
// Replaces: src/repro/kernels/stencil2d.py:stencil_perks_deep
// (`_deep_kernel`, the deep wavefront schedule). The shallow schedule
// (stencil_perks with fuse_steps > 1) is csrc/stencil_shallow.cu.
//
// The TPU kernel runs its grid in order on one core and holds whole rows
// in VMEM; one 8192-wide float32 row is 32 KiB and a CTA has 227 KB, so
// here the trailing dimensions are tiled and every CTA works at once:
//   * one grid.sync() per pass, ceil(steps / t) in all; a pass reads the
//     domain at level k from one device-memory ping-pong buffer and writes
//     level k + t to the other (pass 0 reads the caller's x, which is never
//     written); the last pass takes steps % t when t does not divide steps;
//   * cached bands (stencil_band.cuh): the rows [0, R) are cut into `nb`
//     contiguous bands, one per CTA, kept in shared memory from the
//     prologue to the epilogue. Each pass a CTA loads r*ct rows of level-k
//     halo above and below its band from the source buffer (the neighbours'
//     published borders, or the streamed rows), advances the window ct
//     steps in place over a shrinking range (the r-row ring of
//     inplace_step), and publishes its top and bottom r*t rows to the
//     destination buffer;
//   * the streamed rows: units of one strip of the trailing dimensions by
//     one segment of output rows, spread over the CTAs. A
//     unit is a pipeline of levels with no block-wide barrier inside its
//     row walk: warp 0 keeps level-0 rows in flight into a ring of
//     2r + 1 + stencil2d.DEEP_PREFETCH slots (TMA boxes completing on an
//     mbarrier; loads through L2 where TMA's alignment does not hold), and
//     the other 31 warps share the cells of levels 1..ct (whole warps a
//     level up to 15 levels, cells cut evenly beyond), each level
//     widened by r*(ct - k) on each side and held in a ring of 2r + 3
//     slots (2r + 2 where those do not fit, and level 0 then 2r + 1 at
//     least: stencil2d.deep_rings). Producer and consumer meet on each
//     slot's full and empty mbarrier. At tick T level k computes row
//     T - k (r + 1): the rows it reads were written at tick T - 1 or
//     before, so every level works at once (a lag of r would chain the
//     levels one after the other within a tick), and with 2r + 2 slots or
//     more the slot it fills was freed at tick T - 1 or before; a warp
//     holding several levels computes them lowest first, and no wait
//     closes a cycle.
//     Level ct writes its row straight to device memory. A segment reads
//     r*ct warm-up rows above and below its rows, and each strip an r*t
//     side halo: the only work done twice;
//   * the outermost r cells on every axis stay frozen: a window that
//     reaches the domain border does not shrink there (the reference's
//     `advance`), and frozen cells are copied from the level below;
//   * a batch of B domains is one launch of grid (ctas, B): lane b's CTAs
//     (x, b) hold its bands and walk its units, laid out as for one domain
//     on `ctas` CTAs (stencil2d.lane_ctas), and one grid.sync() a pass
//     serves every lane. The level-0 tensor maps are rank 4 with the lane
//     outermost, so a box past a lane's last row reads as 0, as it does
//     alone, and never as the next lane's first rows.
// Every update sums its terms in the spec's order with the rounding of
// stencil_common.cuh, so each pass gives the bits of t single steps.
//
// Bound on the H100: device memory, the streamed rows read and written once
// a pass plus the strips' side halo re-reads and the segments' warm-up rows
// (the planner's byte model, core/cache_policy.py:gm_bytes_tb); the least
// is gm_bytes_deep. At large t the float32 arithmetic (2 * npoints a cell a
// step) takes over, and before it the shared memory the levels read and
// write (npoints loads and one store a cell a level). The bands are still
// simple: every level is a pass over shared memory between two
// __syncthreads.
#include <cooperative_groups.h>
#include <cuda.h>
#include <stdint.h>
#include <string.h>

#include "stencil_async.cuh"
#include "stencil_band.cuh"

namespace cg = cooperative_groups;

// ---- Hopper's asynchronous copies: the mbarriers of stencil_async.cuh,
// TMA tensor loads completing on one, and cuTensorMapEncodeTiled looked
// up through the CUDA runtime, so that the library links nothing beyond it
// (csrc/decode_attn.cu has its own 2D ones).

// One box of the 4D tensor map `map` at (c0, c1, c2, c3), innermost first;
// cells outside the tensor read as 0.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
    asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier"
                 "::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
                    "r"(c1), "r"(c2), "r"(c3), "r"(bar)
                 : "memory");
}

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, or nullptr where it cannot be had.
static EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult res;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                    cudaEnableDefault, &res) == cudaSuccess
            && res == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// Passed by value from the host (ctypes mirrors this layout).
struct TbArgs {
    int steps;       // time steps in all
    int t;           // steps per pass (the last pass takes steps % t)
    int R;           // cached rows [0, R)
    int nb;          // bands the cached rows are cut into, one per CTA
    int sy, sx;      // a strip: plane rows (3D; 1 in 2D) by columns
    int rows;        // rows of a segment
    int band_bytes;  // shared memory of the band region; the scratch follows
    int q0, q;       // ring depths of level 0 and of levels 1..t-1
    int h0, w0;      // level 0's columns [x0 - h0, x0 - h0 + w0)
};

// ---- the deep schedule ----------------------------------------------------

// Warps of a CTA that compute levels (warp 0 loads level 0), and the cells
// a lane computes together in the row loop.
#define DEEP_WARPS (PERKS_THREADS / 32 - 1)
constexpr int kDeepUnroll = 2;
// A pipeline wait that lasts this many cycles (seconds) is a fault.
#define DEEP_WAIT_CYCLES (1LL << 34)

__device__ __forceinline__ void deep_wait(uint32_t bar, int phase) {
    mbar_wait_or_trap(bar, phase & 1, DEEP_WAIT_CYCLES);
}

// Built with -DDEEP_PROFILE (scripts/kernel_variants.py --kernels
// deep_profile), the deep schedule sums the clock cycles its warps spend
// (lane 0 of each): 0 the loader waiting for a free slot, 1 level warps
// waiting for their input rows, 2 level warps waiting for a free slot,
// 3 level warps in all, 4 the loader in all; stencil_tb_profile reads and
// clears them.
#ifdef DEEP_PROFILE
__device__ unsigned long long deep_cycles[5];
#define DEEP_TIME(kind, stmt)                                             \
    do {                                                                  \
        const long long c0_ = clock64();                                  \
        stmt;                                                             \
        if ((threadIdx.x & 31) == 0)                                      \
            atomicAdd(&deep_cycles[kind],                                 \
                      (unsigned long long)(clock64() - c0_));             \
    } while (0)
#else
#define DEEP_TIME(kind, stmt) stmt
#endif

// n / q and n % q by one multiply-high, for the ring slots and phases of
// each row (a division would cost more than a row's cells): exact for
// 0 <= n < 2^23 and 2 <= q < 80 (stencil2d.DEEP_MAX_ROWS, deep_rings).
struct RingDiv {
    int q;
    uint32_t m;
    __device__ explicit RingDiv(int q_) : q(q_), m(0xFFFFFFFFu / (uint32_t)q_ + 1) {}
    __device__ int div(int n) const { return (int)__umulhi((uint32_t)n, m); }
    __device__ int mod(int n) const { return n - div(n) * q; }
};

// The levels of one deep pass of ct steps over a strip of sy x sx cells (sy
// = 1 in 2D). Level k (1..ct) covers the strip widened by r*(ct - k) on each
// side; level 0, the rows read from device memory, whatever ct is, covers
// columns [x0 - h0, x0 - h0 + w0) (cache_policy.deep_window: r*t and more,
// from a 16-byte column, as TMA wants) and plane rows y0 -+ r*t, so its TMA
// box is the same every pass. Windows are not clamped to the domain: a
// cell outside it is neither loaded nor computed. Level k < ct lives in a
// ring of depth(k) slots of one row each; a slot of level 0 starts on a
// 128-byte boundary (a TMA destination).
struct DeepGeo {
    int ct, r, t, is3, sy, sx, q0, q, h0, w0;
    RingDiv div0, div;   // by q0 and by q
    __device__ int halo(int k) const { return k == 0 ? r * t : r * (ct - k); }
    __device__ int width(int k) const { return k == 0 ? w0 : sx + 2 * halo(k); }
    __device__ int height(int k) const { return is3 ? sy + 2 * halo(k) : 1; }
    __device__ int area(int k) const { return width(k) * height(k); }
    __device__ int depth(int k) const { return k == 0 ? q0 : q; }
    __device__ const RingDiv& ring(int k) const { return k == 0 ? div0 : div; }
    __device__ int slot_bytes(int k, int eb) const {
        const int al = k == 0 ? 128 : 16;
        return (area(k) * eb + al - 1) / al * al;
    }
    // offset of level k's window in level k - 1's, along the columns and
    // the plane rows
    __device__ int inset_x(int k) const { return k == 1 ? h0 - halo(1) : r; }
    __device__ int inset_y(int k) const { return k == 1 ? halo(0) - halo(1) : r; }
    // rows [lo(k), hi(k)) of level k for the output rows [s0, s1)
    __device__ int lo(int k, int s0) const { return max(0, s0 - r * (ct - k)); }
    __device__ int hi(int k, int s1, int H) const { return min(H, s1 + r * (ct - k)); }
};

// Shared memory of a deep pass from a 128-byte boundary: the rings of levels
// 0..ct-1, a full and an empty mbarrier per slot, each ring's byte offset
// (stencil2d.deep_scratch_bytes counts the same for ct = t).
struct DeepSmem {
    unsigned char* base;
    uint64_t* bars;
    int* ring_off;
    int q0, q;
    __device__ DeepSmem(unsigned char* raw, const DeepGeo& G, int eb)
        : q0(G.q0), q(G.q) {
        const uint32_t u = smem_u32(raw);
        base = raw + (((u + 127u) & ~127u) - u);
        int off = 0, slots = 0;
        for (int k = 0; k < G.ct; ++k) {
            off += G.depth(k) * G.slot_bytes(k, eb);
            slots += G.depth(k);
        }
        bars = reinterpret_cast<uint64_t*>(base + off);
        ring_off = reinterpret_cast<int*>(bars + 2 * slots);
    }
    __device__ uint32_t full(int k, int s) const {
        return smem_u32(bars + 2 * (k == 0 ? s : q0 + (k - 1) * q + s));
    }
    __device__ uint32_t empty(int k, int s) const { return full(k, s) + 8; }
};

// How the level warps share the cells of levels 1..ct laid end to end
// (tot cells): warp w computes cells [cell(w), cell(w + 1)). Up to
// DEEP_WARPS / 2 levels, every level gets whole warps, as many as its share
// of the cells (at least one; the warps left over go to the lowest levels,
// the widest), so no warp pays two levels' waits and set-up a tick; deeper,
// or where a level would have more warps than cells, the cells are cut
// evenly over min(DEEP_WARPS, tot) warps and a warp may hold the end of one
// level and the start of the next.
struct DeepSplit {
    const DeepGeo& G;
    int tot, nw, whole, extra;
    __device__ explicit DeepSplit(const DeepGeo& g) : G(g), tot(0), extra(0) {
        for (int k = 1; k <= G.ct; ++k) tot += G.area(k);
        int used = 0;
        for (int k = 1; k <= G.ct; ++k) used += base(k);
        extra = DEEP_WARPS - used;
        whole = 2 * G.ct <= DEEP_WARPS && used <= DEEP_WARPS;
        for (int k = 1; k <= G.ct; ++k)   // every warp a cell at least
            whole = whole && share(k) <= G.area(k);
        nw = whole ? DEEP_WARPS : min(DEEP_WARPS, tot);
    }
    __device__ int base(int k) const {
        return max(1, (int)((long long)DEEP_WARPS * G.area(k) / tot));
    }
    // the warps of level k (whole levels)
    __device__ int share(int k) const { return base(k) + (k <= extra ? 1 : 0); }
    __device__ int cell(int w) const {
        if (!whole) return (int)((long long)w * tot / nw);
        int A = 0;
        for (int k = 1; k <= G.ct; ++k) {
            const int g = share(k);
            if (w < g) return A + (int)((long long)w * G.area(k) / g);
            w -= g;
            A += G.area(k);
        }
        return tot;
    }
    __device__ int owner(int c) const {
        return ((c + 1) * nw + tot - 1) / tot - 1;
    }
    __device__ int warps(int k) const {
        if (whole) return share(k);
        int A = 0;
        for (int j = 1; j < k; ++j) A += G.area(j);
        return owner(A + G.area(k) - 1) - owner(A) + 1;
    }
};

// Warp 0: level-0 rows [lo(0), hi(0)) of the window into their ring, q0
// rows ahead of use at most. By TMA where the buffers allow (2D: boxes of
// 128 bytes along the row; 3D: one box of the window; the lane blockIdx.y
// the outermost coordinate; cells outside the domain read as 0), else by
// loads through L2 and stores, each lane then arriving on the slot's full
// barrier.
template <typename T>
__device__ __forceinline__ void deep_load(const DeepGeo& G, const DeepSmem& m,
                          const CUtensorMap* map, int tma, const T* src,
                          int x0, int y0, int s0, int s1, const StencilArgs& a) {
    const int lane = threadIdx.x & 31;
    const int W = G.width(0), area = G.area(0);
    const int slot = G.slot_bytes(0, sizeof(T));
    const int gx0 = x0 - G.h0, gy0 = G.is3 ? y0 - G.halo(0) : 0;
    const int lo = G.lo(0, s0), hi = G.hi(0, s1, a.H);
    const RingDiv& q0 = G.div0;
    for (int j = lo; j < hi; ++j) {
        const int n = j - lo, sl = q0.mod(n);
        if (n >= G.q0) DEEP_TIME(0, deep_wait(m.empty(0, sl), q0.div(n) - 1));
        unsigned char* d = m.base + sl * slot;
        const uint32_t full = m.full(0, sl);
        if (tma) {
            const int bw = G.is3 ? W : 128 / (int)sizeof(T);
            if (lane == 0) mbar_expect_tx(full, area * sizeof(T));
            __syncwarp();
            for (int b = lane; b * bw < W; b += 32)
                tma_load_4d(smem_u32(d) + b * 128, map, gx0 + b * bw, gy0, j,
                            (int)blockIdx.y, full);
        } else {
            T* row = reinterpret_cast<T*>(d);
            const T* srow = src + (size_t)j * a.P;
            int y = 0, x = lane;
            while (x >= W) { x -= W; ++y; }
            for (int c = lane; c < area; c += 32) {
                const int gx = gx0 + x, gy = gy0 + y;
                if (gx >= 0 && gx < a.D2 && gy >= 0 && gy < a.D1)
                    row[c] = ldcg(srow + gy * a.D2 + gx);
                x += 32;
                while (x >= W) { x -= W; ++y; }
            }
            mbar_arrive(full);
        }
    }
}

// Row i of level k over cells [cb, ce) of its window, from level k - 1's
// ring: wait for level k - 1's rows up to i + r and for this row's slot,
// compute (a lane's cells are fixed, the row is the loop counter: no
// division per cell), then arrive on the row's full barrier and release
// row i - r of level k - 1. Level ct writes device memory instead.
template <int NPTS, typename T>
__device__ __forceinline__ void deep_row(const DeepGeo& G, const DeepSmem& m,
                                         int k, int i, int cb, int ce,
                                         int x0, int y0, int s0, int s1,
                                         T* dst, const StencilArgs& a,
                                         const SpecShared& s) {
    const int r = G.r, lane = threadIdx.x & 31, eb = sizeof(T);
    const int lo_in = G.lo(k - 1, s0), hi_in = G.hi(k - 1, s1, a.H);
    const RingDiv& qi = G.ring(k - 1);
    const int q_in = qi.q, w_in = G.width(k - 1);
    const int sz_in = G.slot_bytes(k - 1, eb) / eb;
    const T* in = reinterpret_cast<const T*>(m.base + m.ring_off[k - 1]);
    // each level-0 row completes on its own barrier (TMA lands rows in no
    // order), so a level's first row waits for every row it reads and each
    // later row for the one new row
    for (int n = i == G.lo(k, s0) ? 0 : min(i + r, hi_in - 1) - lo_in;
         n <= min(i + r, hi_in - 1) - lo_in; ++n)
        DEEP_TIME(1, deep_wait(m.full(k - 1, qi.mod(n)), qi.div(n)));
    T* out = nullptr;
    int so = 0;
    if (k < G.ct) {
        const int n = i - G.lo(k, s0);
        so = G.div.mod(n);
        if (n >= G.q)
            DEEP_TIME(2, deep_wait(m.empty(k, so), G.div.div(n) - 1));
        out = reinterpret_cast<T*>(m.base + m.ring_off[k])
              + so * (G.slot_bytes(k, eb) / eb);
    }
    // offsets in the ring below, relative to a cell's y * w_in + x: of the
    // cell itself, and of each point (rows i - r .. i + r follow the slot
    // of row i - r round the ring)
    const int d = G.inset_x(k), dy = G.is3 ? G.inset_y(k) : 0;
    const int self = qi.mod(i - lo_in) * sz_in + dy * w_in + d;
    const bool row_in = row_interior(i, a);
    constexpr int NP = NPTS > 0 ? NPTS : 1;
    int off[NP];
    float w[NP];
    const int sb = row_in ? qi.mod(i - r - lo_in) : 0;
    if (NPTS > 0 && row_in) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
            int sl = sb + s.d0[p] + r;
            if (sl >= q_in) sl -= q_in;
            off[p] = sl * sz_in + (s.d1[p] + dy) * w_in + s.d2[p] + d;
            w[p] = s.w[p];
        }
    }
    const int D1 = a.D1, D2 = a.D2;
    const bool is3 = G.is3;
    const int wk = G.width(k), hk = G.halo(k);
    const int gx0 = x0 - hk, gy0 = is3 ? y0 - hk : 0;
    T* drow = dst + (size_t)i * a.P;
    // the stencil at a cell whose own offset in the ring below is ii
    auto sum = [&](int ii) -> T {
        T v;
        if (NPTS > 0) {
            v = term(in[off[0] + ii], w[0]);
#pragma unroll
            for (int p = 1; p < NP; ++p)
                v = plus(v, term(in[off[p] + ii], w[p]));
        } else {
            for (int p = 0; p < a.npts; ++p) {
                int sl = sb + s.d0[p] + r;
                if (sl >= q_in) sl -= q_in;
                const T e = term(in[sl * sz_in + (s.d1[p] + dy) * w_in
                                    + s.d2[p] + d + ii], s.w[p]);
                v = p == 0 ? e : plus(v, e);
            }
        }
        return v;
    };
    if (!is3 && row_in && gx0 + cb >= r && gx0 + ce <= D2 - r) {
        // 2D, every cell interior: no test a cell
        const int c0 = cb + lane;
        if (out) {
#pragma unroll kDeepUnroll
            for (int c = c0; c < ce; c += 32) out[c] = sum(c);
        } else {
#pragma unroll kDeepUnroll
            for (int c = c0; c < ce; c += 32) drow[gx0 + c] = sum(c);
        }
    } else {
        int y = 0, x = cb + lane;
        if (is3) { y = x / wk; x -= y * wk; }
        for (int c = cb + lane; c < ce; c += 32) {
            const int gx = gx0 + x, gy = gy0 + y;
            if (gx >= 0 && gx < D2 && gy >= 0 && gy < D1) {
                const int ii = y * w_in + x;
                const T v = row_in && gx >= r && gx < D2 - r
                                    && (!is3 || (gy >= r && gy < D1 - r))
                                ? sum(ii) : in[self + ii];
                if (out)
                    out[c] = v;
                else
                    drow[gy * D2 + gx] = v;
            }
            x += 32;
            if (is3)
                while (x >= wk) { x -= wk; ++y; }
        }
    }
    __syncwarp();
    if (lane == 0) {
        if (out) mbar_arrive(m.full(k, so));
        const int n = i - r - lo_in;
        if (n >= 0) mbar_arrive(m.empty(k - 1, qi.mod(n)));
    }
}

// A level warp's share of a unit: at tick tk, row tk - k (r + 1) of each of
// its levels kA..kB (cells [c0, c1) of the levels laid end to end, level kA
// starting at A0), lowest level first.
template <int NPTS, typename T>
__device__ __forceinline__ void deep_levels(const DeepGeo& G,
                                            const DeepSmem& m, int kA, int kB,
                                            int A0, int c0, int c1, int x0,
                                            int y0, int s0, int s1, T* dst,
                                            const StencilArgs& a,
                                            const SpecShared& s) {
    const int r = G.r;
    int t_lo = 1 << 30, t_hi = -1;
    for (int k = kA; k <= kB; ++k) {
        t_lo = min(t_lo, G.lo(k, s0) + k * (r + 1));
        t_hi = max(t_hi, G.hi(k, s1, a.H) - 1 + k * (r + 1));
    }
    for (int tk = t_lo; tk <= t_hi; ++tk) {
        for (int k = kA, A = A0; k <= kB; A += G.area(k), ++k) {
            const int i = tk - k * (r + 1);
            if (i >= G.lo(k, s0) && i < G.hi(k, s1, a.H))
                deep_row<NPTS>(G, m, k, i, max(c0 - A, 0),
                               min(c1 - A, G.area(k)), x0, y0, s0, s1, dst,
                               a, s);
        }
    }
}

// One deep pass of the streamed rows [R, H): units of one strip by one
// segment of g.rows output rows, one at a time per CTA. In a unit every
// level is a stage of a pipeline: warp 0 loads level-0 rows, each compute
// warp takes its cells of levels kA..kB and, at tick tk, computes row
// tk - k (r + 1) of each level k it holds, lowest level first; producer and
// consumer meet only on the ring slots' mbarriers. The one __syncthreads
// pair is between units (the barriers are set up afresh for each).
template <int NPTS, typename T>
__device__ __forceinline__ void deep_pass(unsigned char* raw, int ct, const CUtensorMap* map,
                          int tma, const T* src, T* dst, const StencilArgs& a,
                          const SpecShared& s, const TbArgs& g) {
    const int r = a.r, H = a.H, tid = threadIdx.x, warp = tid >> 5;
    const DeepGeo G{ct, r, g.t, a.ndim == 3, g.sy, g.sx, g.q0, g.q, g.h0, g.w0,
                    RingDiv(g.q0), RingDiv(g.q)};
    const DeepSmem m(raw, G, sizeof(T));
    const int nx = (a.D2 + G.sx - 1) / G.sx, ny = (a.D1 + G.sy - 1) / G.sy;
    const int tiles = nx * ny;
    const int units = tiles * ((H - g.R + g.rows - 1) / g.rows);
    const DeepSplit split(G);
    const int cw = warp - 1;
    const bool computes = cw >= 0 && cw < split.nw;
    const int c0 = computes ? split.cell(cw) : 0;
    const int c1 = computes ? split.cell(cw + 1) : 0;
    int kA = 0, kB = -1, A0 = 0;   // this warp's levels; level kA starts at A0
    for (int k = 1, A = 0; k <= ct; A += G.area(k), ++k) {
        if (c0 < A + G.area(k) && c1 > A) {
            if (kA == 0) { kA = k; A0 = A; }
            kB = k;
        }
    }
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int seg = u / tiles, tile = u - seg * tiles, ty = tile / nx;
        const int y0 = ty * G.sy, x0 = (tile - ty * nx) * G.sx;
        const int s0 = g.R + seg * g.rows, s1 = min(H, s0 + g.rows);
        if (tid < ct) {   // level tid's ring offset and barriers
            const int k = tid;
            int off = 0;
            for (int j = 0; j < k; ++j) off += G.depth(j) * G.slot_bytes(j, sizeof(T));
            m.ring_off[k] = off;
            const uint32_t fc = k == 0 ? (tma ? 1 : 32) : split.warps(k);
            const uint32_t ec = split.warps(k + 1);
            for (int sl = 0; sl < G.depth(k); ++sl) {
                mbar_init(m.full(k, sl), fc);
                mbar_init(m.empty(k, sl), ec);
            }
            asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        }
        __syncthreads();
        if (warp == 0) {
            DEEP_TIME(4, deep_load(G, m, map, tma, src, x0, y0, s0, s1, a));
        } else if (kA > 0) {
            DEEP_TIME(3, deep_levels<NPTS>(G, m, kA, kB, A0, c0, c1, x0, y0,
                                           s0, s1, dst, a, s));
        }
        __syncthreads();
        if (tid < ct) {
            for (int sl = 0; sl < G.depth(tid); ++sl) {
                mbar_inval(m.full(tid, sl));
                mbar_inval(m.empty(tid, sl));
            }
        }
    }
}

// The deep schedule's level-0 tensor maps over x, buf0 and buf1 (a pass
// reads one of them), each passed as a __grid_constant__ parameter.
struct TbMaps {
    CUtensorMap m[3];
};

template <int NPTS, typename T>
__global__ void __launch_bounds__(PERKS_THREADS, 1)
stencil_tb_kernel(const T* x, T* buf0, T* buf1, StencilArgs a, TbArgs g,
                  const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map0,
                  const __grid_constant__ CUtensorMap map1, int tma) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ SpecShared s;
    __shared__ const T* rows[PERKS_MAX_BLOCK_ROWS + 2 * STENCIL_MAX_RADIUS];
    load_spec(a, s);
    cg::grid_group grid = cg::this_grid();
    x = lane_domain(x, a);
    buf0 = lane_domain(buf0, a);
    buf1 = lane_domain(buf1, a);

    const int P = a.P, R = g.R, t = g.t;
    const int rt = a.r * t, tid = threadIdx.x, b = blockIdx.x;
    int b0 = 0, b1 = 0;
    if (b < g.nb) {
        b0 = (int)((long long)b * R / g.nb);
        b1 = (int)((long long)(b + 1) * R / g.nb);
    }
    const int nrows = b1 - b0;
    // band region: r*t halo rows, the band, r*t halo rows, the r-row ring
    T* band_base = reinterpret_cast<T*>(smem_raw);

    // Prologue: the band's one load from device memory.
    for (int e = tid; e < nrows * P; e += blockDim.x)
        band_base[(size_t)rt * P + e] = x[(size_t)b0 * P + e];
    __syncthreads();

    const int passes = (g.steps + t - 1) / t;
    for (int p = 0; p < passes; ++p) {
        const int ct = min(t, g.steps - p * t);
        const T* src = (p == 0) ? x : ((p & 1) ? buf0 : buf1);
        T* dst = (p & 1) ? buf1 : buf0;
        if (nrows > 0)
            band_pass<NPTS, PERKS_THREADS, PERKS_CELLS_PER_THREAD>(
                band_base, b0, b1, rt, ct, src, dst, a, s, rows);
        if (R < a.H)
            deep_pass<NPTS>(smem_raw + g.band_bytes, ct,
                            p == 0 ? &map_x : ((p & 1) ? &map0 : &map1),
                            tma, src, dst, a, s, g);
        // this pass's stores are read by the next pass's TMA loads (the
        // async proxy)
        if (tma) asm volatile("fence.proxy.async;" ::: "memory");
        grid.sync();
    }

    // Epilogue: the band's one store, into the buffer the last pass wrote.
    if (nrows > 0 && passes > 0) {
        T* fin = ((passes - 1) & 1) ? buf1 : buf0;
        for (int e = tid; e < nrows * P; e += blockDim.x)
            fin[(size_t)b0 * P + e] = band_base[(size_t)rt * P + e];
    }
}

template <int NPTS>
static void kernel_f32(const void** out) {
    *out = (const void*)stencil_tb_kernel<NPTS, float>;
}

template <int NPTS>
static void kernel_bf16(const void** out) {
    *out = (const void*)stencil_tb_kernel<NPTS, __nv_bfloat16>;
}

static const void* tb_kernel(int npts, int dtype) {
    const void* f = nullptr;
    if (dtype == STENCIL_BF16) {
        STENCIL_DISPATCH_NPTS(npts, kernel_bf16, &f)
    } else {
        STENCIL_DISPATCH_NPTS(npts, kernel_f32, &f)
    }
    return f;
}

#ifdef DEEP_PROFILE
extern "C" int stencil_tb_profile(unsigned long long* out) {
    cudaError_t e = cudaMemcpyFromSymbol(out, deep_cycles, sizeof(deep_cycles));
    if (e != cudaSuccess) return (int)e;
    const unsigned long long zero[5] = {0, 0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(deep_cycles, zero, sizeof(zero));
}
#endif

// Widest cached row (cells) the in-place band update holds in registers.
extern "C" int stencil_tb_max_row_cells(void) {
    return PERKS_CELLS_PER_THREAD * PERKS_THREADS;
}

// The card's opt-in shared memory per block and the kernel's static shared
// memory (checked by the wrapper against stencil2d.PERKS_STATIC_SMEM).
extern "C" int stencil_tb_smem(int npts, int dtype, int* optin, int* static_bytes) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, tb_kernel(npts, dtype));
    if (e != cudaSuccess) return (int)e;
    *static_bytes = (int)attr.sharedSizeBytes;
    return 0;
}

// Co-resident CTAs for `smem_bytes` of dynamic shared memory.
extern "C" int stencil_tb_max_ctas(int npts, int dtype, int smem_bytes, int* out) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const void* f = tb_kernel(npts, dtype);
    e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, PERKS_THREADS,
                                                      smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    *out = per_sm * sms;
    return 0;
}

// The deep schedule loads level 0 by TMA when the three buffers start on
// 16-byte boundaries, the row strides are multiples of 16 bytes, every box
// starts on a 16-byte column (TMA faults on one that does not) and the box
// fits (2D: 128-byte boxes tiling the window's width; 3D: one box of the
// window, at most 256 x 256). Each map spans the `lanes` stacked domains,
// the lane outermost (one lane's box is 1 deep there). Sets *use to 1 and
// fills `maps` then; returns a cudaError_t if a map that should encode does
// not.
static int deep_maps(TbMaps* maps, const void* x, const void* buf0,
                     const void* buf1, const StencilArgs& a, const TbArgs& g,
                     int dtype, int lanes, int* use) {
    *use = 0;
    const int eb = dtype == STENCIL_BF16 ? 2 : 4;
    const int W = g.w0, Y = a.ndim == 3 ? g.sy + 2 * a.r * g.t : 1;
    const int bw = a.ndim == 3 ? W : 128 / eb;
    const void* bufs[3] = {x, buf0, buf1};
    for (const void* b : bufs)
        if ((uintptr_t)b % 16) return 0;
    if ((g.sx * eb) % 16 || (g.h0 * eb) % 16
        || W % bw || (bw * eb) % 16 || bw > 256 || Y > 256
        || ((long long)a.D2 * eb) % 16 || ((long long)a.P * eb) % 16)
        return 0;
    const EncodeTiledFn enc = encode_tiled();
    if (!enc) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[4] = {(cuuint64_t)a.D2, (cuuint64_t)a.D1,
                                (cuuint64_t)a.H, (cuuint64_t)lanes};
    const cuuint64_t strides[3] = {(cuuint64_t)a.D2 * eb, (cuuint64_t)a.P * eb,
                                   (cuuint64_t)a.H * a.P * eb};
    const cuuint32_t box[4] = {(cuuint32_t)bw, (cuuint32_t)Y, 1, 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    for (int i = 0; i < 3; ++i)
        if (enc(&maps->m[i], dtype == STENCIL_BF16
                                 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(bufs[i]), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
            return (int)cudaErrorInvalidValue;
    *use = 1;
    return 0;
}

// Launches `grid` CTAs for each of `lanes` stacked domains on `stream` for
// elements of type `dtype` (STENCIL_F32 or STENCIL_BF16); returns the
// cudaError_t of the launch (0 = success) and sets *tma to whether level 0
// is loaded by TMA.
extern "C" int stencil_tb_launch(const void* x, void* buf0, void* buf1,
                                 StencilArgs a, TbArgs g, int dtype, int grid,
                                 int lanes, int smem_bytes,
                                 cudaStream_t stream, int* tma) {
    const void* f = tb_kernel(a.npts, dtype);
    TbMaps maps;
    memset(&maps, 0, sizeof maps);
    int use = 0;
    const int err = deep_maps(&maps, x, buf0, buf1, a, g, dtype, lanes, &use);
    if (err) return err;
    *tma = use;
    cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {(void*)&x,         (void*)&buf0,      (void*)&buf1,
                    (void*)&a,         (void*)&g,         (void*)&maps.m[0],
                    (void*)&maps.m[1], (void*)&maps.m[2], (void*)&use};
    e = cudaLaunchCooperativeKernel(f, dim3(grid, lanes), dim3(PERKS_THREADS),
                                    args, (size_t)smem_bytes, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
