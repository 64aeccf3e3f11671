// Temporal blocking on Hopper: `steps` Jacobi steps in one cooperative
// launch, t steps per pass over device memory, with the leading `R` rows of
// the domain kept in shared memory for the kernel's whole life.
//
// Replaces: src/repro/kernels/stencil2d.py:stencil_perks with fuse_steps > 1
// (`_perks_kernel`, the shallow schedule) and stencil2d.py:stencil_perks_deep
// (`_deep_kernel`, the deep wavefront schedule).
//
// The TPU kernels run their grid in order on one core and hold whole rows
// in VMEM; one 8192-wide float32 row is 32 KiB and a CTA has 227 KB, so
// here the trailing dimensions are tiled and every CTA works at once:
//   * one grid.sync() per pass, ceil(steps / t) in all; a pass reads the
//     domain at level k from one device-memory ping-pong buffer and writes
//     level k + t to the other (pass 0 reads the caller's x, which is never
//     written); the last pass takes steps % t when t does not divide steps;
//   * cached bands, both schedules: the rows [0, R) are cut into `nb`
//     contiguous bands, one per CTA, kept in shared memory from the
//     prologue to the epilogue. Each pass a CTA loads r*ct rows of level-k
//     halo above and below its band from the source buffer (the neighbours'
//     published borders, or the streamed rows), advances the window ct
//     steps in place over a shrinking range (the r-row ring of
//     inplace_step), and publishes its top and bottom r*t rows to the
//     destination buffer;
//   * shallow schedule, the streamed rows [R, H): independent tiles of
//     `rows` rows by one strip of the trailing dimensions. A tile is loaded
//     with an r*ct halo on every side, advanced ct steps in shared memory
//     between two buffers over a shrinking trapezoid, and its interior is
//     written back (the GPU form of the TPU's r*t window recompute);
//   * deep schedule, the streamed rows: each CTA owns strips of the
//     trailing dimensions, widened by r*(ct - k) at level k, and walks the
//     rows from R - r*ct (the last band's published rows) to H in blocks of
//     `rows` rows. Each level k < ct keeps a ring of rows + 2r strip-rows,
//     so level k of a block is computed from level k - 1 as soon as the
//     rows below it are; a row leaves level ct and is written once. There
//     is no recompute along the rows, only in the strips' side halos;
//   * the outermost r cells on every axis stay frozen: a window that
//     reaches the domain border does not shrink there (the reference's
//     `advance`), and frozen cells are copied from the level below.
// Every update sums its terms in the spec's order with the rounding of
// stencil_common.cuh, so each pass gives the bits of t single steps.
//
// Bound on the H100: device memory, the streamed rows read and written once
// a pass plus the halo re-reads of the tiles or strips (the planner's byte
// model, core/cache_policy.py:gm_bytes_tb); the least is gm_bytes_deep. At
// large t the float32 arithmetic (2 * npoints a cell a step) takes over.
// This first version is simple: every level is a pass over shared memory
// with two __syncthreads, and cells are found by integer division.
#include <cooperative_groups.h>

#include "stencil_common.cuh"

namespace cg = cooperative_groups;

// Passed by value from the host (ctypes mirrors this layout).
struct TbArgs {
    int steps;       // time steps in all
    int t;           // steps per pass (the last pass takes steps % t)
    int R;           // cached rows [0, R)
    int nb;          // bands the cached rows are cut into, one per CTA
    int deep;        // 0: shallow tiles, 1: deep strip walkers
    int sy, sx;      // a strip: plane rows (3D; 1 in 2D) by columns
    int rows;        // shallow: rows of a tile; deep: rows of a block
    int band_bytes;  // shared memory of the band region; the scratch follows
};

__device__ __forceinline__ int shrink_lo(int g0, int k, int r) {
    return g0 == 0 ? 0 : g0 + k * r;
}

__device__ __forceinline__ int shrink_hi(int g1, int k, int r, int n) {
    return g1 == n ? n : g1 - k * r;
}

// One step of whole rows [lo, hi) updated in place in shared memory. Rows
// [w0, w1) of the domain are held at win + (j - w0) * P (lo..hi lies inside);
// rows outside the window are read from src in device memory. A block of
// rows [i, i1) at a time: read the old rows i-r .. i1-1+r (above the block
// from the ring, the rest from the window or src), compute into registers,
// then save the old rows the next block still needs into the r-row ring and
// write the new rows over the old. rows[] is a shared table of
// PERKS_MAX_BLOCK_ROWS + 2 * STENCIL_MAX_RADIUS pointers. The caller
// synchronises before it reads the window.
template <int NPTS, typename T>
__device__ __forceinline__ void inplace_step(T* win, int w0, int w1, int lo, int hi,
                                             T* ring, const T* src,
                                             const StencilArgs& a, const SpecShared& s,
                                             const T** rows) {
    const int P = a.P, r = a.r, H = a.H, tid = threadIdx.x;
    int kb = (PERKS_CELLS_PER_THREAD * PERKS_THREADS) / P;
    kb = max(1, min(kb, PERKS_MAX_BLOCK_ROWS));
    for (int i = lo; i < hi; i += kb) {
        const int i1 = min(i + kb, hi);
        const int nr = i1 - i;
        for (int q = tid; q < nr + 2 * r; q += blockDim.x) {
            const int j = i - r + q;
            const T* p = nullptr;
            if (j >= lo && j < i)
                p = ring + (size_t)(j % r) * P;
            else if (j >= w0 && j < w1)
                p = win + (size_t)(j - w0) * P;
            else if (j >= 0 && j < H)
                p = src + (size_t)j * P;
            rows[q] = p;
        }
        __syncthreads();
        // Thread tid takes cells tid, tid + T, ... of the block, found by
        // stepping (row, cell) rather than dividing for each.
        const int ii0 = tid / P, c0 = tid - ii0 * P;
        T v[PERKS_CELLS_PER_THREAD];
        {
            int ii = ii0, c = c0;
#pragma unroll
            for (int q = 0; q < PERKS_CELLS_PER_THREAD; ++q) {
                if (ii < nr)
                    v[q] = (row_interior(i + ii, a) && col_interior(c, a))
                               ? sum_rows<NPTS>(rows + ii, r, c, s.dc, s, a.npts)
                               : rows[ii + r][c];
                c += PERKS_THREADS;
                while (c >= P) { c -= P; ++ii; }
            }
        }
        __syncthreads();
        {
            int ii = ii0, c = c0;
#pragma unroll
            for (int q = 0; q < PERKS_CELLS_PER_THREAD; ++q) {
                if (ii < nr) {
                    const int row = i + ii;
                    T* own = win + (size_t)(row - w0) * P;
                    if (row >= i1 - r)
                        ring[(size_t)(row % r) * P + c] = own[c];
                    own[c] = v[q];
                }
                c += PERKS_THREADS;
                while (c >= P) { c -= P; ++ii; }
            }
        }
    }
}

// One pass of a cached band [b0, b1): level k -> k + ct in place.
template <int NPTS, typename T>
__device__ void band_pass(T* band_base, int b0, int b1, int rt, int ct,
                          const T* src, T* dst, const StencilArgs& a,
                          const SpecShared& s, const T** rows) {
    const int P = a.P, r = a.r, H = a.H, tid = threadIdx.x;
    const int nrows = b1 - b0;
    const int w0 = max(0, b0 - r * ct), w1 = min(H, b1 + r * ct);
    T* win = band_base + (size_t)(w0 - b0 + rt) * P;   // row j at win + (j - w0) * P
    T* ring = band_base + (size_t)(2 * rt + nrows) * P;
    for (int e = tid; e < (b0 - w0) * P; e += blockDim.x)
        win[e] = ldcg(src + (size_t)w0 * P + e);
    T* below = win + (size_t)(b1 - w0) * P;
    for (int e = tid; e < (w1 - b1) * P; e += blockDim.x)
        below[e] = ldcg(src + (size_t)b1 * P + e);
    __syncthreads();
    for (int k = 1; k <= ct; ++k) {
        inplace_step<NPTS>(win, w0, w1, shrink_lo(w0, k, r), shrink_hi(w1, k, r, H),
                           ring, src, a, s, rows);
        __syncthreads();
    }
    // Publish the band's top and bottom r*t rows for the next pass.
    const T* band = band_base + (size_t)rt * P;
    const int top_end = min(b0 + rt, b1);
    for (int e = tid; e < (top_end - b0) * P; e += blockDim.x)
        dst[(size_t)b0 * P + e] = band[e];
    const int bot = max(b1 - rt, top_end);
    for (int e = tid; e < (b1 - bot) * P; e += blockDim.x)
        dst[(size_t)bot * P + e] = band[(size_t)(bot - b0) * P + e];
}

// One shallow pass of the streamed rows: independent tiles, each loaded
// with an h = r*ct halo and advanced ct steps between buffers A and B.
template <int NPTS, typename T>
__device__ void shallow_pass(T* A, T* B, int ct, const T* src, T* dst,
                             const StencilArgs& a, const SpecShared& s,
                             const TbArgs& g, int* lin) {
    const int r = a.r, H = a.H, D1 = a.D1, D2 = a.D2, P = a.P, R = g.R;
    const int tid = threadIdx.x;
    const bool is3 = a.ndim == 3;
    const int h = r * ct, hy = is3 ? h : 0;
    const int nrt = (H - R + g.rows - 1) / g.rows;
    const int ny = (D1 + g.sy - 1) / g.sy, nx = (D2 + g.sx - 1) / g.sx;
    const int ntiles = nrt * ny * nx;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int txi = tile % nx, tyi = (tile / nx) % ny, ti = tile / (nx * ny);
        const int s0 = R + ti * g.rows, s1 = min(H, s0 + g.rows);
        const int y0 = tyi * g.sy, y1 = min(D1, y0 + g.sy);
        const int x0 = txi * g.sx, x1 = min(D2, x0 + g.sx);
        const int gr0 = max(0, s0 - h), gr1 = min(H, s1 + h);
        const int gy0 = max(0, y0 - hy), gy1 = min(D1, y1 + hy);
        const int gx0 = max(0, x0 - h), gx1 = min(D2, x1 + h);
        const int wx = gx1 - gx0, area = (gy1 - gy0) * wx;
        const int n = (gr1 - gr0) * area;
        for (int e = tid; e < n; e += blockDim.x) {
            const int i = e / area, rem = e - i * area;
            const int y = rem / wx, xx = rem - y * wx;
            A[e] = ldcg(src + (size_t)(gr0 + i) * P + (gy0 + y) * D2 + gx0 + xx);
        }
        if (tid < a.npts) lin[tid] = s.d0[tid] * area + s.d1[tid] * wx + s.d2[tid];
        __syncthreads();
        for (int k = 1; k <= ct; ++k) {
            const T* in = (k & 1) ? A : B;
            T* out = (k & 1) ? B : A;
            const int rl = shrink_lo(gr0, k, r), rh = shrink_hi(gr1, k, r, H);
            const int yl = is3 ? shrink_lo(gy0, k, r) : gy0;
            const int yh = is3 ? shrink_hi(gy1, k, r, D1) : gy1;
            const int xl = shrink_lo(gx0, k, r), xh = shrink_hi(gx1, k, r, D2);
            const int nxk = xh - xl, ak = (yh - yl) * nxk, m = (rh - rl) * ak;
            for (int e = tid; e < m; e += blockDim.x) {
                const int ii = e / ak, rem = e - ii * ak;
                const int yy = rem / nxk, xx = rem - yy * nxk;
                const int i = rl + ii, y = yl + yy, x = xl + xx;
                const int idx = (i - gr0) * area + (y - gy0) * wx + (x - gx0);
                out[idx] = cell_interior(i, y, x, a) ? sum_at<NPTS>(in, idx, lin, s, a.npts)
                                                     : in[idx];
            }
            __syncthreads();
        }
        const T* fin = (ct & 1) ? B : A;
        const int nxo = x1 - x0, ao = (y1 - y0) * nxo, m = (s1 - s0) * ao;
        for (int e = tid; e < m; e += blockDim.x) {
            const int ii = e / ao, rem = e - ii * ao;
            const int yy = rem / nxo, xx = rem - yy * nxo;
            const int i = s0 + ii, y = y0 + yy, x = x0 + xx;
            dst[(size_t)i * P + y * D2 + x] =
                fin[(i - gr0) * area + (y - gy0) * wx + (x - gx0)];
        }
        __syncthreads();
    }
}

// One deep pass of the streamed rows: strip walkers with a ring of
// rows + 2r strip-rows for each level below ct.
template <int NPTS, typename T>
__device__ void deep_pass(T* scr, int ct, const T* src, T* dst,
                          const StencilArgs& a, const SpecShared& s,
                          const TbArgs& g, const T** rows, int* lin) {
    const int r = a.r, H = a.H, D1 = a.D1, D2 = a.D2, P = a.P, R = g.R;
    const int tid = threadIdx.x;
    const bool is3 = a.ndim == 3;
    const int B = g.rows, Q = B + 2 * r;
    const int a0 = max(0, R - r * ct);      // first row walked
    const int ny = (D1 + g.sy - 1) / g.sy, nx = (D2 + g.sx - 1) / g.sx;
    const int nblocks = (H - a0 + ct * r + B - 1) / B;
    for (int strip = blockIdx.x; strip < ny * nx; strip += gridDim.x) {
        const int y0 = (strip / nx) * g.sy, y1 = min(D1, y0 + g.sy);
        const int x0 = (strip % nx) * g.sx, x1 = min(D2, x0 + g.sx);
        for (int n = 0; n < nblocks; ++n) {
            const int base = a0 + n * B;
            // level 0: rows [base, base + B) of the widest window, from src
            const int h0 = r * ct, hy0 = is3 ? h0 : 0;
            int gy0 = max(0, y0 - hy0), gx0 = max(0, x0 - h0);
            int wx = min(D2, x1 + h0) - gx0;
            int area = (min(D1, y1 + hy0) - gy0) * wx;
            {
                const int i1 = min(base + B, H);
                const int m = (i1 - base) * area;
                for (int e = tid; e < m; e += blockDim.x) {
                    const int ii = e / area, rem = e - ii * area;
                    const int y = rem / wx, xx = rem - y * wx;
                    const int i = base + ii;
                    scr[(size_t)(i % Q) * area + rem] =
                        ldcg(src + (size_t)i * P + (gy0 + y) * D2 + gx0 + xx);
                }
                __syncthreads();
            }
            size_t off = 0;                  // ring of level k - 1
            for (int k = 1; k <= ct; ++k) {
                const int hk = r * (ct - k), hyk = is3 ? hk : 0;
                const int gy0k = max(0, y0 - hyk), gx0k = max(0, x0 - hk);
                const int wxk = min(D2, x1 + hk) - gx0k;
                const int areak = (min(D1, y1 + hyk) - gy0k) * wxk;
                const size_t offk = off + (size_t)Q * area;
                const int lo = a0 == 0 ? 0 : a0 + k * r;
                int i0 = max(base - k * r, lo);
                if (k == ct) i0 = max(i0, R);
                const int i1 = min(base + B - k * r, H);
                if (i1 > i0) {
                    const T* ring_in = scr + off;
                    for (int q = tid; q < i1 - i0 + 2 * r; q += blockDim.x) {
                        const int j = i0 - r + q;
                        rows[q] = (j >= 0 && j < H) ? ring_in + (size_t)(j % Q) * area
                                                    : nullptr;
                    }
                    if (tid < a.npts) lin[tid] = s.d1[tid] * wx + s.d2[tid];
                    __syncthreads();
                    const int m = (i1 - i0) * areak;
                    for (int e = tid; e < m; e += blockDim.x) {
                        const int ii = e / areak, rem = e - ii * areak;
                        const int yy = rem / wxk, xx = rem - yy * wxk;
                        const int i = i0 + ii, y = gy0k + yy, x = gx0k + xx;
                        const int c = (y - gy0) * wx + (x - gx0);
                        const T v = cell_interior(i, y, x, a)
                                        ? sum_rows<NPTS>(rows + ii, r, c, lin, s, a.npts)
                                        : rows[ii + r][c];
                        if (k < ct)
                            scr[offk + (size_t)(i % Q) * areak + rem] = v;
                        else
                            dst[(size_t)i * P + y * D2 + x] = v;
                    }
                    __syncthreads();
                }
                off = offk;
                gy0 = gy0k;
                gx0 = gx0k;
                wx = wxk;
                area = areak;
            }
        }
    }
}

template <int NPTS, typename T>
__global__ void __launch_bounds__(PERKS_THREADS, 1)
stencil_tb_kernel(const T* x, T* buf0, T* buf1, StencilArgs a, TbArgs g) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ SpecShared s;
    __shared__ const T* rows[PERKS_MAX_BLOCK_ROWS + 2 * STENCIL_MAX_RADIUS];
    __shared__ int lin[STENCIL_MAX_POINTS];
    load_spec(a, s);
    cg::grid_group grid = cg::this_grid();

    const int P = a.P, r = a.r, H = a.H, R = g.R, t = g.t;
    const int rt = r * t, tid = threadIdx.x, b = blockIdx.x;
    int b0 = 0, b1 = 0;
    if (b < g.nb) {
        b0 = (int)((long long)b * R / g.nb);
        b1 = (int)((long long)(b + 1) * R / g.nb);
    }
    const int nrows = b1 - b0;
    // band region: r*t halo rows, the band, r*t halo rows, the r-row ring
    T* band_base = reinterpret_cast<T*>(smem_raw);
    T* scr = reinterpret_cast<T*>(smem_raw + g.band_bytes);
    // shallow: the two tile buffers, each of the widest window
    const size_t cap = (size_t)min(H, g.rows + 2 * rt) *
                       (a.ndim == 3 ? min(a.D1, g.sy + 2 * rt) : 1) *
                       min(a.D2, g.sx + 2 * rt);

    // Prologue: the band's one load from device memory.
    for (int e = tid; e < nrows * P; e += blockDim.x)
        band_base[(size_t)rt * P + e] = x[(size_t)b0 * P + e];
    __syncthreads();

    const int passes = (g.steps + t - 1) / t;
    for (int p = 0; p < passes; ++p) {
        const int ct = min(t, g.steps - p * t);
        const T* src = (p == 0) ? x : ((p & 1) ? buf0 : buf1);
        T* dst = (p & 1) ? buf1 : buf0;
        if (nrows > 0) band_pass<NPTS>(band_base, b0, b1, rt, ct, src, dst, a, s, rows);
        if (R < H) {
            if (g.deep)
                deep_pass<NPTS>(scr, ct, src, dst, a, s, g, rows, lin);
            else
                shallow_pass<NPTS>(scr, scr + cap, ct, src, dst, a, s, g, lin);
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

// Launches on `stream` for elements of type `dtype` (STENCIL_F32 or
// STENCIL_BF16); returns the cudaError_t of the launch (0 = success).
extern "C" int stencil_tb_launch(const void* x, void* buf0, void* buf1,
                                 StencilArgs a, TbArgs g, int dtype, int grid,
                                 int smem_bytes, cudaStream_t stream) {
    const void* f = tb_kernel(a.npts, dtype);
    cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {(void*)&x, (void*)&buf0, (void*)&buf1, (void*)&a, (void*)&g};
    e = cudaLaunchCooperativeKernel(f, dim3(grid), dim3(PERKS_THREADS), args,
                                    (size_t)smem_bytes, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
