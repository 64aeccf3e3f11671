// Shallow temporal blocking on Hopper: `steps` Jacobi steps in one
// cooperative launch, t steps per pass over device memory, in independent
// tiles that recompute an r*t halo, with the leading `R` rows of the domain
// kept in shared memory for the kernel's whole life.
//
// Replaces: src/repro/kernels/stencil2d.py:stencil_perks with fuse_steps > 1
// (`_perks_kernel`, the shallow schedule). The deep schedule is
// csrc/stencil_tb.cu.
//
// The TPU kernel runs its grid in order on one core and holds whole rows in
// VMEM with an r*t window recompute; here every CTA works at once:
//   * one grid.sync() per pass, ceil(steps / t) in all; a pass reads level
//     k from one device-memory ping-pong buffer and writes level k + t to
//     the other (pass 0 reads the caller's x, never written); the last
//     pass takes steps % t;
//   * cached bands (stencil_band.cuh), as in the deep schedule;
//   * the streamed rows [R, H) in tiles of `rows` rows by sy plane rows (3D)
//     by sx columns, spread over the CTAs. A tile's window (the tile widened
//     by r*ct on every side, clamped to the domain; its columns from a
//     16-byte boundary) is copied into shared memory by 16-byte cp.async
//     while the previous tile's levels 2..ct run (loads through L2 where
//     the rows are not 16-byte aligned; after them where three buffers do
//     not fit); level k is computed over the tile widened by r*(ct - k)
//     into one of two buffers, and level ct straight to device memory in
//     row runs;
//   * a thread owns units of one in-plane cell of the window (a column in
//     2D) by one segment of rows, fixed for the kernel's life: it walks its
//     segment's rows, so a cell's address is a loop counter (no division a
//     cell) and the interior tests are made once a level and unit. One
//     __syncthreads a level;
//   * the outermost r cells on every axis stay frozen (copied from the
//     level below);
//   * a batch of B domains is one launch of grid (ctas, B): lane b's CTAs
//     (x, b) hold its bands and walk its tiles, laid out as for one domain
//     on `ctas` CTAs (stencil2d.lane_ctas); one grid.sync() serves all.
// Every update sums its terms in the spec's order with the rounding of
// stencil_common.cuh, so each pass gives the bits of t single steps.
//
// Bound on the H100: device memory, the streamed rows read with the tiles'
// halos and written once a pass (core/cache_policy.py:gm_bytes_tb), until
// the levels' shared-memory traffic (npoints loads and one store a cell a
// level) and float32 arithmetic over the tiles' recomputed halos take over,
// as they do on a 2D 5-point stencil at t = 4.
#include <cooperative_groups.h>

#include "stencil_band.cuh"

namespace cg = cooperative_groups;

// Threads of one CTA, the units one thread may own, and the new values a
// thread holds while a cached band is updated in place (SHALLOW_THREADS *
// SHALLOW_CELLS is stencil2d.PERKS_MAX_ROW_CELLS).
constexpr int SHALLOW_THREADS = 512;
constexpr int SHALLOW_UNITS = 4;
constexpr int SHALLOW_CELLS =
    PERKS_CELLS_PER_THREAD * PERKS_THREADS / SHALLOW_THREADS;

// Passed by value from the host (ctypes mirrors it; lin and async are
// filled by stencil_shallow_launch).
struct ShallowArgs {
    int steps, t;     // time steps in all, steps per pass
    int R, nb;        // cached rows [0, R), cut into nb bands
    int sy, sx;       // a tile's plane rows (3D; 1 in 2D) and columns
    int rows;         // a tile's rows
    int left, wx;     // the window: columns from max(0, x0 - left), wx
    int wy;           // of them, and wy plane rows from max(0, y0 - r t) (3D)
    int segs;         // row segments of a level
    int prefetch;     // 1: a tile's window is copied while the last tile's
                      // levels 2..ct run (buffers X, A, B); 0: once they
                      // are done (X and A, X taking every second level)
    int band_bytes;   // shared memory of the band region; the buffers follow
    int buf_cells;    // cells of one tile buffer
    int async;        // 1: windows by 16-byte cp.async
    int lin[STENCIL_MAX_POINTS];   // point k at d0 * wy * wx + d1 * wx + d2
};

// A tile: rows [s0, s1), plane rows [y0, y1), columns [x0, x1), and the
// origin of its window in the domain (clamped to it): window cell
// (i - oi, y - oy, x - ox) holds domain cell (i, y, x).
struct Tile {
    int s0, s1, y0, y1, x0, x1, oi, oy, ox;
};

__device__ __forceinline__ Tile tile_at(int tile, int nx, int ny,
                                        const StencilArgs& a,
                                        const ShallowArgs& g) {
    const int txi = tile % nx, rest = tile / nx;
    const int tyi = rest % ny, ti = rest / ny;
    const int rt = a.r * g.t;
    Tile tl;
    tl.s0 = g.R + ti * g.rows;
    tl.s1 = min(a.H, tl.s0 + g.rows);
    tl.y0 = tyi * g.sy;
    tl.y1 = min(a.D1, tl.y0 + g.sy);
    tl.x0 = txi * g.sx;
    tl.x1 = min(a.D2, tl.x0 + g.sx);
    tl.oi = max(0, tl.s0 - rt);
    tl.oy = a.ndim == 3 ? max(0, tl.y0 - rt) : 0;
    tl.ox = max(0, tl.x0 - g.left);
    return tl;
}

// Level 0 of tile tl for a pass of ct steps into X: rows, plane rows and
// columns within r*ct of the tile (async: the columns from and to 16-byte
// boundaries), window cell (i - oi) * wy * wx + (y - oy) * wx + x - ox. A
// warp takes a row (and plane row) at a time, its lanes the columns.
template <typename T>
__device__ __forceinline__ void shallow_load(T* X, const Tile& tl, int ct,
                                             const T* src, const StencilArgs& a,
                                             const ShallowArgs& g) {
    const int h = a.r * ct, is3 = a.ndim == 3;
    const int area = g.wy * g.wx;
    const int i0 = max(0, tl.s0 - h), i1 = min(a.H, tl.s1 + h);
    const int ya = is3 ? max(0, tl.y0 - h) : 0;
    const int yb = is3 ? min(a.D1, tl.y1 + h) : 1;
    int xa = max(0, tl.x0 - h), xb = min(a.D2, tl.x1 + h);
    const int base = -tl.oi * area - tl.oy * g.wx - tl.ox;
    const int ny = yb - ya, planes = (i1 - i0) * ny;
    const FastDiv byny(ny);
    const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    constexpr int V = 16 / sizeof(T);
    if (g.async) {
        xa = xa / V * V;
        xb = min(a.D2, (xb + V - 1) / V * V);
    }
    for (int p = threadIdx.x >> 5; p < planes; p += warps) {
        const int ii = byny.div(p), i = i0 + ii, y = ya + p - ii * ny;
        T* drow = X + base + i * area + y * g.wx;
        const T* srow = src + (size_t)i * a.P + y * a.D2;
        if (g.async) {
            for (int xx = xa + lane * V; xx < xb; xx += 32 * V)
                cp_async16(drow + xx, srow + xx);
        } else {
            for (int xx = xa + lane; xx < xb; xx += 32)
                drow[xx] = ldcg(srow + xx);
        }
    }
}

// The sum at window cell idx of in.
template <int NPTS, typename T>
__device__ __forceinline__ T tile_sum(const T* __restrict__ in, int idx,
                                      const ShallowArgs& g, const StencilArgs& a,
                                      const SpecShared& s, const int* lin) {
    if (NPTS > 0) {
        T acc = term(in[idx + g.lin[0]], a.w[0]);
#pragma unroll
        for (int k = 1; k < (NPTS > 0 ? NPTS : 1); ++k)
            acc = plus(acc, term(in[idx + g.lin[k]], a.w[k]));
        return acc;
    }
    T acc = term(in[idx + lin[0]], s.w[0]);
    for (int k = 1; k < a.npts; ++k) acc = plus(acc, term(in[idx + lin[k]], s.w[k]));
    return acc;
}

// One unit's rows [ra, rb) of a level: frozen rows [ra, ia) and [ib, rb)
// copied, interior rows [ia, ib) summed; from window cell idx of in, to
// out[0], out[os], ... (the next level's buffer, or device memory).
template <int NPTS, typename T>
__device__ __forceinline__ void tile_column(const T* __restrict__ in,
                                            T* __restrict__ out, int os,
                                            int idx, int ra, int ia, int ib,
                                            int rb, int area,
                                            const ShallowArgs& g,
                                            const StencilArgs& a,
                                            const SpecShared& s, const int* lin) {
    int i = ra;
    for (; i < ia; ++i, idx += area, out += os) *out = in[idx];
#pragma unroll 2
    for (; i < ib; ++i, idx += area, out += os)
        *out = tile_sum<NPTS>(in, idx, g, a, s, lin);
    for (; i < rb; ++i, idx += area, out += os) *out = in[idx];
}

template <int NPTS, typename T>
__global__ void __launch_bounds__(SHALLOW_THREADS, 1)
stencil_shallow_kernel(const T* x, T* buf0, T* buf1, StencilArgs a,
                       ShallowArgs g) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ SpecShared s;
    __shared__ const T* rows[PERKS_MAX_BLOCK_ROWS + 2 * STENCIL_MAX_RADIUS];
    __shared__ int lin[STENCIL_MAX_POINTS];
    if (threadIdx.x < STENCIL_MAX_POINTS) lin[threadIdx.x] = g.lin[threadIdx.x];
    load_spec(a, s);
    cg::grid_group grid = cg::this_grid();
    x = lane_domain(x, a);
    buf0 = lane_domain(buf0, a);
    buf1 = lane_domain(buf1, a);

    const int P = a.P, r = a.r, H = a.H, R = g.R, t = g.t, D1 = a.D1, D2 = a.D2;
    const int rt = r * t, tid = threadIdx.x, is3 = a.ndim == 3;
    int b0 = 0, b1 = 0;
    if ((int)blockIdx.x < g.nb) {
        b0 = (int)((long long)blockIdx.x * R / g.nb);
        b1 = (int)((long long)(blockIdx.x + 1) * R / g.nb);
    }
    const int nrows = b1 - b0;
    // band region: r*t halo rows, the band, r*t halo rows, the r-row ring;
    // then the tile buffers: X (level 0), A and B (levels 1..ct-1; B is X
    // without prefetch)
    T* band_base = reinterpret_cast<T*>(smem_raw);
    T* X = reinterpret_cast<T*>(smem_raw + g.band_bytes);
    T* A = X + g.buf_cells;
    T* B = g.prefetch ? A + g.buf_cells : X;

    const int area = g.wy * g.wx;
    const int nx = (D2 + g.sx - 1) / g.sx, ny = (D1 + g.sy - 1) / g.sy;
    const int ntiles = R < H ? (H - R + g.rows - 1) / g.rows * nx * ny : 0;
    // this thread's units: window plane cell (cy, cx), row segment sg
    int ucy[SHALLOW_UNITS], ucx[SHALLOW_UNITS], usg[SHALLOW_UNITS];
#pragma unroll
    for (int m = 0; m < SHALLOW_UNITS; ++m) {
        const int u = tid + m * SHALLOW_THREADS;
        const int sg = u / area, sl = u - sg * area;
        usg[m] = u < area * g.segs ? sg : g.segs;
        ucy[m] = sl / g.wx;
        ucx[m] = sl - ucy[m] * g.wx;
    }

    // Prologue: the band's one load from device memory.
    for (int e = tid; e < nrows * P; e += blockDim.x)
        band_base[(size_t)rt * P + e] = x[(size_t)b0 * P + e];
    __syncthreads();

    const int passes = (g.steps + t - 1) / t;
    for (int p = 0; p < passes; ++p) {
        const int ct = min(t, g.steps - p * t);
        const T* src = (p == 0) ? x : ((p & 1) ? buf0 : buf1);
        T* dst = (p & 1) ? buf1 : buf0;
        int tile = blockIdx.x;
        if (tile < ntiles)
            shallow_load(X, tile_at(tile, nx, ny, a, g), ct, src, a, g);
        if (nrows > 0)
            band_pass<NPTS, SHALLOW_THREADS, SHALLOW_CELLS>(
                band_base, b0, b1, rt, ct, src, dst, a, s, rows);
        for (; tile < ntiles; tile += gridDim.x) {
            if (g.async) cp_async_wait();
            __syncthreads();
            const Tile tl = tile_at(tile, nx, ny, a, g);
            const int nxt = tile + gridDim.x;
            for (int k = 1; k <= ct; ++k) {
                // level 0 in X; level k < ct in A (k odd), else B (or X
                // without prefetch); level ct to device memory
                const T* in = k == 1 ? X : (((k - 1) & 1) ? A : B);
                T* out = (k & 1) ? A : B;
                const int e = r * (ct - k);   // level k's reach beyond the tile
                const int lo = max(0, tl.s0 - e), hi = min(H, tl.s1 + e);
                const int ylo = is3 ? max(0, tl.y0 - e) : 0;
                const int yhi = is3 ? min(D1, tl.y1 + e) : 1;
                const int xlo = max(0, tl.x0 - e), xhi = min(D2, tl.x1 + e);
                const int per = (hi - lo + g.segs - 1) / g.segs;
#pragma unroll
                for (int m = 0; m < SHALLOW_UNITS; ++m) {
                    const int y = tl.oy + ucy[m], xx = tl.ox + ucx[m];
                    if (usg[m] >= g.segs || xx < xlo || xx >= xhi || y < ylo
                        || y >= yhi)
                        continue;
                    const int ra = lo + usg[m] * per, rb = min(hi, ra + per);
                    if (ra >= rb) continue;
                    const bool col_in = xx >= r && xx < D2 - r
                                        && (!is3 || (y >= r && y < D1 - r));
                    const int ia = col_in ? min(max(ra, r), rb) : rb;
                    const int ib = col_in ? max(min(rb, H - r), ia) : rb;
                    const int idx = (ra - tl.oi) * area + ucy[m] * g.wx + ucx[m];
                    if (k < ct)
                        tile_column<NPTS>(in, out + idx, area, idx, ra, ia, ib,
                                          rb, area, g, a, s, lin);
                    else
                        tile_column<NPTS>(in, dst + (size_t)ra * P + y * D2 + xx,
                                          P, idx, ra, ia, ib, rb, area, g, a,
                                          s, lin);
                }
                if (k == 1 && g.prefetch && nxt < ntiles) {
                    __syncthreads();   // X is read by level 1 only
                    shallow_load(X, tile_at(nxt, nx, ny, a, g), ct, src, a, g);
                } else if (k < ct) {
                    __syncthreads();
                }
            }
            if (!g.prefetch && nxt < ntiles) {
                __syncthreads();
                shallow_load(X, tile_at(nxt, nx, ny, a, g), ct, src, a, g);
            }
        }
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
    *out = (const void*)stencil_shallow_kernel<NPTS, float>;
}

template <int NPTS>
static void kernel_bf16(const void** out) {
    *out = (const void*)stencil_shallow_kernel<NPTS, __nv_bfloat16>;
}

static const void* shallow_kernel(int npts, int dtype) {
    const void* f = nullptr;
    if (dtype == STENCIL_BF16) {
        STENCIL_DISPATCH_NPTS(npts, kernel_bf16, &f)
    } else {
        STENCIL_DISPATCH_NPTS(npts, kernel_f32, &f)
    }
    return f;
}

// The kernel's thread count, the units a thread may own and the widest
// cached row (checked by the wrapper against stencil2d.SHALLOW_THREADS,
// SHALLOW_UNITS and PERKS_MAX_ROW_CELLS).
extern "C" int stencil_shallow_shape(int* threads, int* units, int* row_cells) {
    *threads = SHALLOW_THREADS;
    *units = SHALLOW_UNITS;
    *row_cells = SHALLOW_CELLS * SHALLOW_THREADS;
    return 0;
}

// The card's opt-in shared memory per block and the kernel's static shared
// memory (checked by the wrapper against stencil2d.PERKS_STATIC_SMEM).
extern "C" int stencil_shallow_smem(int npts, int dtype, int* optin,
                                    int* static_bytes) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, shallow_kernel(npts, dtype));
    if (e != cudaSuccess) return (int)e;
    *static_bytes = (int)attr.sharedSizeBytes;
    return 0;
}

// Co-resident CTAs for `smem_bytes` of dynamic shared memory.
extern "C" int stencil_shallow_max_ctas(int npts, int dtype, int smem_bytes,
                                        int* out) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const void* f = shallow_kernel(npts, dtype);
    e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, SHALLOW_THREADS,
                                                      smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    *out = per_sm * sms;
    return 0;
}

// Launches `grid` CTAs for each of `lanes` stacked domains on `stream` for
// elements of type `dtype`; returns the cudaError_t of the launch (0 =
// success) and sets *async to whether the tile windows are copied by
// cp.async: the buffers and row strides on
// 16-byte boundaries and every window's columns from one (the layout's
// strip and left halo are 16-byte multiples).
extern "C" int stencil_shallow_launch(const void* x, void* buf0, void* buf1,
                                      StencilArgs a, ShallowArgs g, int dtype,
                                      int grid, int lanes, int smem_bytes,
                                      cudaStream_t stream, int* async) {
    const void* f = shallow_kernel(a.npts, dtype);
    const int eb = dtype == STENCIL_BF16 ? 2 : 4;
    for (int k = 0; k < a.npts; ++k)
        g.lin[k] = (a.d0[k] * g.wy + a.d1[k]) * g.wx + a.d2[k];
    g.async = (uintptr_t)x % 16 == 0 && (uintptr_t)buf0 % 16 == 0
              && (uintptr_t)buf1 % 16 == 0 && ((long long)a.D2 * eb) % 16 == 0
              && (g.sx * eb) % 16 == 0 && (g.left * eb) % 16 == 0
              && (g.wx * eb) % 16 == 0 && (g.buf_cells * eb) % 16 == 0
              && g.band_bytes % 16 == 0;
    *async = g.async;
    cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {(void*)&x, (void*)&buf0, (void*)&buf1, (void*)&a, (void*)&g};
    e = cudaLaunchCooperativeKernel(f, dim3(grid, lanes),
                                    dim3(SHALLOW_THREADS), args,
                                    (size_t)smem_bytes, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
