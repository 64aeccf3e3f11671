// The whole domain in shared memory for all `steps` Jacobi steps of one
// cooperative launch: PERKS with every row cached.
//
// Replaces: src/repro/kernels/stencil2d.py:stencil_resident
// (`_resident_kernel`).
//
// The TPU kernel runs its grid in order on one core and updates the domain
// in place in VMEM. Here 132 SMs run at once:
//   * the H rows are cut into `nb` contiguous bands of at least r rows, one
//     per CTA (stencil2d.band_layout), each in shared memory from the
//     prologue (one load) to the epilogue (one store);
//   * a step computes the band's new values into registers, a block of
//     rows at a time, reading the old ones from shared memory; after one
//     __syncthreads the block is written back r rows below its old place
//     (even steps, blocks bottom-up) or above it (odd steps, top-down), so
//     a block never overwrites a row a later block still reads: no ring of
//     old rows and no table of row pointers. A thread's cells are the
//     block's cells tid, tid + RES_THREADS, ..., its (row, plane row,
//     column) carried along, so a cell's address and its tests take a few
//     integer operations and no division, and a slot has no branch (a
//     frozen or idle slot sums at a cell in bounds and drops the sum), so
//     the compiler interleaves the slots' shared-memory loads and sums
//     (branches between the slots serialised them, PERF.md);
//   * the neighbours' published r-row borders are copied by cp.async into r
//     halo rows above and below the band after each grid barrier, at
//     either of its two places (the band and 3r rows), so every term is a
//     shared-memory load at a fixed offset from its cell. Where those 2r
//     more rows do not fit (domains at the one-step kernel's capacity,
//     stencil2d.resident_layout), the band's first and last r rows read
//     the rows outside it from device memory instead;
//   * each step a band writes only its r-row top and bottom borders to
//     device memory (from registers), where its neighbours read them after
//     grid.sync(), the paper's barrier (Fig. 3, right);
//   * a batch of B domains is one launch of grid (ctas, B): lane b's CTAs
//     (x, b) hold its bands, laid out as for one domain on `ctas` CTAs
//     (stencil2d.lane_ctas), and one grid.sync() a step serves every lane.
//
// Bound on the H100: device memory is touched twice (the domain in and
// out); each step costs the band's shared-memory traffic (npoints loads and
// one store a cell), its float32 arithmetic, the halo rows' trip through L2
// and one grid-wide barrier. On the main cell the instructions around the
// sums (a cell's tests and addresses) bound it (-DRES_PROFILE, PERF.md). Each spec's point count is a compile-time
// constant (STENCIL_DISPATCH_NPTS), so the point loops unroll; the points'
// offsets and weights are kernel parameters (constant-bank operands).
#include <cooperative_groups.h>

#include "stencil_common.cuh"

namespace cg = cooperative_groups;

// Threads of one CTA and the new values one thread holds in registers (a
// block of rows is at most RES_THREADS * RES_CELLS cells, which must be at
// least stencil2d.PERKS_MAX_ROW_CELLS).
constexpr int RES_THREADS = 512;
constexpr int RES_CELLS = 40;
// Slots a thread runs without a branch between them (the loads and sums of
// a group interleave); a thread stops after the group holding its last cell.
constexpr int RES_GROUP = 4;

// Built with -DRES_PROFILE, thread 0 of every CTA (of every lane) sums the
// clock cycles of a step's phases: 0 computing blocks (each up to its
// __syncthreads), 1 writing them back, 2 the grid barrier, 3 the halo
// copies; stencil_resident_profile reads and clears them.
#ifdef RES_PROFILE
__device__ unsigned long long res_cycles[4];
#define RES_MARK(kind)                                                    \
    do {                                                                  \
        if (threadIdx.x == 0) {                                           \
            const long long t_ = clock64();                               \
            atomicAdd(&res_cycles[kind], (unsigned long long)(t_ - t0_)); \
            t0_ = t_;                                                     \
        }                                                                 \
    } while (0)
#else
#define RES_MARK(kind) do {} while (0)
#endif

// Passed by value from the host (ctypes mirrors it; lin is filled by
// stencil_resident_launch).
struct ResArgs {
    int steps;
    int nb;     // bands, one per CTA
    int kb;     // rows a block
    int safe;   // halo rows: every cell in [safe, cells - safe) of the
    int cells;  // band's storage has its neighbours in it
    int halo;   // 1: the halo rows in shared memory, 0: read from device memory
    int async;  // 1: the halo rows copied by 16-byte cp.async
    int lin[STENCIL_MAX_POINTS];   // point k at (d0 * P + dc) * sizeof(T) bytes
};

// The sum at a cell whose old value is S[idx], every neighbour in shared
// memory, its points at byte offsets g.lin (one add a term); with m = 0
// every term reads S[idx] itself (a frozen or idle slot without halo rows:
// the loads stay in bounds and the caller drops the sum).
template <int NPTS, typename T>
__device__ __forceinline__ T res_sum(const T* S, int idx, int m,
                                     const ResArgs& g, const StencilArgs& a,
                                     const SpecShared& s) {
    const unsigned char* b = reinterpret_cast<const unsigned char*>(S + idx);
    auto at = [&](int off) { return *reinterpret_cast<const T*>(b + off); };
    if (NPTS > 0) {
        T acc = term(at(g.lin[0] & m), a.w[0]);
#pragma unroll
        for (int k = 1; k < (NPTS > 0 ? NPTS : 1); ++k)
            acc = plus(acc, term(at(g.lin[k] & m), a.w[k]));
        return acc;
    }
    T acc = term(S[idx + (s.lin[0] & m)], s.w[0]);
    for (int k = 1; k < a.npts; ++k)
        acc = plus(acc, term(S[idx + (s.lin[k] & m)], s.w[k]));
    return acc;
}

// Shift mode: the sum at row j (band-relative, of n rows held from row off
// of S), in-row cell c, where some neighbour rows lie outside the band and
// are read from device memory (src, row b0 + j). A loop, not unrolled: the
// first and last r rows of a band take it, and only in shift mode.
template <typename T>
__device__ __forceinline__ T res_sum_edge(const T* S, int off, int j, int c,
                                          int n, int b0,
                                          const T* __restrict__ src,
                                          const StencilArgs& a,
                                          const SpecShared& s) {
    auto at = [&](int k) -> T {
        const int jj = j + s.d0[k], cc = c + s.dc[k];
        return (jj >= 0 && jj < n) ? S[(jj + off) * a.P + cc]
                                   : ldcg(src + (size_t)(b0 + jj) * a.P + cc);
    };
    T acc = term(at(0), s.w[0]);
#pragma unroll 1
    for (int k = 1; k < a.npts; ++k) acc = plus(acc, term(at(k), s.w[k]));
    return acc;
}

// Copy cells [g0, g0 + len) of device memory to S + s0 (halo rows): by
// 16-byte cp.async where the rows are aligned, else by loads through L2.
template <typename T>
__device__ __forceinline__ void res_copy(T* S, int s0, const T* src, size_t g0,
                                         int len, int async) {
    if (async) {
        constexpr int V = 16 / sizeof(T);
        for (int e = threadIdx.x * V; e < len; e += blockDim.x * V)
            cp_async16(S + s0 + e, src + g0 + e);
    } else {
        for (int e = threadIdx.x; e < len; e += blockDim.x)
            S[s0 + e] = ldcg(src + g0 + e);
    }
}

template <int NPTS, bool HALO, typename T>
__global__ void __launch_bounds__(RES_THREADS, 1)
stencil_resident_kernel(const T* __restrict__ x, T* buf0, T* buf1,
                        StencilArgs a, ResArgs g) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ SpecShared s;
    load_spec(a, s);
    cg::grid_group grid = cg::this_grid();
    T* S = reinterpret_cast<T*>(smem_raw);
    x = lane_domain(x, a);
    buf0 = lane_domain(buf0, a);
    buf1 = lane_domain(buf1, a);

    const int P = a.P, r = a.r, H = a.H, D1 = a.D1, D2 = a.D2, tid = threadIdx.x;
    const bool is3 = a.ndim == 3;
    int b0 = 0, b1 = 0;
    if ((int)blockIdx.x < g.nb) {
        b0 = (int)((long long)blockIdx.x * H / g.nb);
        b1 = (int)((long long)(blockIdx.x + 1) * H / g.nb);
    }
    const int n = b1 - b0, kb = g.kb;
    const int nblk = n > 0 ? (n + kb - 1) / kb : 0;
    // band-relative rows [rlo, rhi) are interior rows of the domain; without
    // halo rows, [flo, fhi) of them read no row outside the band
    const int rlo = max(r - b0, 0), rhi = min(H - r - b0, n);
    const int flo = HALO ? rlo : max(rlo, r), fhi = HALO ? rhi : min(rhi, n - r);
    // a thread's cells: the block's cells tid, tid + RES_THREADS, ...; the
    // flat index idx = (row + off) * P + in-row cell steps by RES_THREADS
    // and carries the in-row position (plane row y, column x) along
    const int cs = RES_THREADS % P;
    int ys = cs / D2, xs = cs - ys * D2;
    const int c00 = tid % P;
    int y00 = c00 / D2, x00 = c00 - y00 * D2;
    const FastDiv byP(P);
    // Row j of the band at S[(j + off) * P], off alternating between two
    // positions r rows apart: with halo rows r and 2r (rows -r .. n + r - 1,
    // the halo rows included, at the same offset), without 0 and r.
    const int base = HALO ? r : 0;
    int off = base;

    // Prologue: the band (and its halo rows), the one load of the domain.
    {
        const int lo = HALO ? max(0, b0 - r) : b0;
        const int hi = HALO ? min(H, b1 + r) : b1;
        if (n > 0)
            for (int e = tid; e < (hi - lo) * P; e += blockDim.x)
                S[(lo - b0 + off) * P + e] = x[(size_t)lo * P + e];
    }
    __syncthreads();

    T v[RES_CELLS];
#ifdef RES_PROFILE
    long long t0_ = clock64();
#endif
    for (int k = 0; k < g.steps; ++k) {
        const T* src = (k == 0) ? x : ((k & 1) ? buf0 : buf1);
        T* dst = (k & 1) ? buf1 : buf0;
        const bool last = k == g.steps - 1;
        // the new rows go r rows below the old (bottom-up) or above them
        // (top-down), so a block never overwrites a row a later one reads
        const int no = off == base ? base + r : base;
        const int fast0 = (flo + off) * P, fast1 = (fhi + off) * P;
        for (int bi = 0; bi < nblk; ++bi) {
            const int blk = no < off ? bi : nblk - 1 - bi;
            const int j0 = blk * kb, j1 = min(n, j0 + kb);
            // opaque to the compiler once a block: it would otherwise hoist
            // every slot's coordinates out of the step loop and spill them
            asm volatile("" : "+r"(ys), "+r"(xs), "+r"(y00), "+r"(x00));
            const int end = (j1 + off) * P, idx0 = (j0 + off) * P + tid;
            const int fend = min(end, fast1);
            // the slots this thread fills: they stop in groups of
            // RES_GROUP, within which they have no branch
            const int used = max(0, end - idx0 + RES_THREADS - 1) / RES_THREADS;
            int idx = idx0, y = y00, xx = x00;
#pragma unroll
            for (int sl = 0; sl < RES_CELLS; ++sl) {
                if (sl % RES_GROUP == 0 && sl >= used) break;
                const bool act = idx < end;
                const bool col_in = xx >= r && xx < D2 - r
                                    && (!is3 || (y >= r && y < D1 - r));
                const bool fast = col_in && idx >= fast0 && idx < fend;
                if (HALO) {
                    // an idle or frozen slot sums at a cell whose
                    // neighbours are in the storage, and drops the sum
                    const T sum = res_sum<NPTS>(
                        S, min(max(idx, g.safe), g.cells - 1 - g.safe), -1,
                        g, a, s);
                    v[sl] = fast ? sum : S[act ? idx : 0];
                } else {
                    const T sum = res_sum<NPTS>(S, act ? idx : 0,
                                                fast ? -1 : 0, g, a, s);
                    v[sl] = fast ? sum : S[act ? idx : 0];
                    if (act && !fast && col_in) {
                        const int j = byP.div(idx) - off;
                        if (j >= rlo && j < rhi)
                            v[sl] = res_sum_edge(S, off, j, idx - (j + off) * P,
                                                 n, b0, src, a, s);
                    }
                }
                idx += RES_THREADS;
                xx += xs;
                y += ys;
                if (xx >= D2) { xx -= D2; ++y; }
                if (y >= D1) y -= D1;
            }
            // Every thread has read the block: write it back r rows
            // shifted (to device memory on the last step) and publish the
            // band's border rows for the neighbours.
            if (!last) __syncthreads();
            RES_MARK(0);
            T* out = dst + ((long long)b0 - off) * P;   // row j at out[idx]
            const int bord0 = (r + off) * P, bord1 = (n - r + off) * P;
            const int shift = (no - off) * P;
            idx = idx0;
#pragma unroll
            for (int sl = 0; sl < RES_CELLS; ++sl) {
                if (sl % RES_GROUP == 0 && sl >= used) break;
                if (idx < end) {
                    if (last || idx < bord0 || idx >= bord1) out[idx] = v[sl];
                    if (!last) S[idx + shift] = v[sl];
                }
                idx += RES_THREADS;
            }
            RES_MARK(1);
        }
        if (last) break;
        grid.sync();
        RES_MARK(2);
        off = no;
        if (HALO && n > 0) {
            // the neighbours' new borders, into the halo rows at the new
            // offset (rows the last step read, or none)
            if (b0 > 0) {
                const int t0 = max(0, b0 - r);
                res_copy(S, (t0 - b0 + off) * P, dst, (size_t)t0 * P,
                         (b0 - t0) * P, g.async);
            }
            if (b1 < H)
                res_copy(S, (n + off) * P, dst, (size_t)b1 * P,
                         (min(H, b1 + r) - b1) * P, g.async);
            if (g.async) cp_async_wait();
            __syncthreads();
        }
        RES_MARK(3);
    }
}

template <int NPTS>
static void kernel_f32(const void** out, int halo) {
    *out = halo ? (const void*)stencil_resident_kernel<NPTS, true, float>
                : (const void*)stencil_resident_kernel<NPTS, false, float>;
}

template <int NPTS>
static void kernel_bf16(const void** out, int halo) {
    *out = halo ? (const void*)stencil_resident_kernel<NPTS, true, __nv_bfloat16>
                : (const void*)stencil_resident_kernel<NPTS, false, __nv_bfloat16>;
}

// The kernel instance of a point count, element type and mode (halo rows
// in shared memory or not: a template parameter, so the halo instances
// carry no path that reads device memory in the step loop).
static const void* resident_kernel(int npts, int dtype, int halo) {
    const void* f = nullptr;
    if (dtype == STENCIL_BF16) {
        STENCIL_DISPATCH_NPTS(npts, kernel_bf16, &f, halo)
    } else {
        STENCIL_DISPATCH_NPTS(npts, kernel_f32, &f, halo)
    }
    return f;
}

#ifdef RES_PROFILE
extern "C" int stencil_resident_profile(unsigned long long* out) {
    cudaError_t e = cudaMemcpyFromSymbol(out, res_cycles, sizeof(res_cycles));
    if (e != cudaSuccess) return (int)e;
    const unsigned long long zero[4] = {0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(res_cycles, zero, sizeof(zero));
}
#endif

// The kernel's thread count and the new values a thread holds (checked by
// the wrapper against stencil2d.RES_THREADS and RES_CELLS).
extern "C" int stencil_resident_shape(int* threads, int* cells) {
    *threads = RES_THREADS;
    *cells = RES_CELLS;
    return 0;
}

// The card's opt-in shared memory per block and the kernel's static shared
// memory (checked by the wrapper against stencil2d.PERKS_STATIC_SMEM).
extern "C" int stencil_resident_smem(int npts, int dtype, int* optin,
                                     int* static_bytes) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, resident_kernel(npts, dtype, 0));
    if (e != cudaSuccess) return (int)e;
    *static_bytes = (int)attr.sharedSizeBytes;
    return 0;
}

// Co-resident CTAs for `smem_bytes` of dynamic shared memory.
extern "C" int stencil_resident_max_ctas(int npts, int dtype, int smem_bytes,
                                         int* out) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const void* f = resident_kernel(npts, dtype, 0);
    e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, RES_THREADS,
                                                      smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    *out = per_sm * sms;
    return 0;
}

// Launches `grid` CTAs for each of `lanes` stacked domains on `stream` for
// elements of type `dtype`; returns the cudaError_t of the launch (0 =
// success) and sets *async to whether the halo rows are copied by cp.async
// (halo rows in shared memory, 16-byte aligned rows).
extern "C" int stencil_resident_launch(const void* x, void* buf0, void* buf1,
                                       StencilArgs a, ResArgs g, int dtype,
                                       int grid, int lanes, int smem_bytes,
                                       cudaStream_t stream, int* async) {
    const void* f = resident_kernel(a.npts, dtype, g.halo);
    const int eb = dtype == STENCIL_BF16 ? 2 : 4;
    g.safe = 0;
    for (int k = 0; k < a.npts; ++k) {
        const int lin = a.d0[k] * a.P + a.dc[k];
        g.lin[k] = lin * eb;
        g.safe = lin > g.safe ? lin : (-lin > g.safe ? -lin : g.safe);
    }
    g.cells = smem_bytes / eb;
    if (g.halo && 2 * g.safe + 1 > g.cells) return (int)cudaErrorInvalidValue;
    g.async = g.halo && ((long long)a.P * eb) % 16 == 0
              && (uintptr_t)buf0 % 16 == 0 && (uintptr_t)buf1 % 16 == 0;
    *async = g.async;
    cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {(void*)&x, (void*)&buf0, (void*)&buf1, (void*)&a, (void*)&g};
    e = cudaLaunchCooperativeKernel(f, dim3(grid, lanes), dim3(RES_THREADS),
                                    args, (size_t)smem_bytes, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
