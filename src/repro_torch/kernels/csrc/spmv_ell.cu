// ELL sparse matrix-vector product, y = A x.
//
// Replaces: src/repro/kernels/spmv_ell.py:spmv_ell (`_spmv_kernel`). It is
// the SpMV of the port's CG loop tiers (host_loop, and device_loop as one
// CUDA graph) for a problem given as ELL planes.
//
// Layout: data (n, K) float32 and cols (n, K) int32, row-major, every row
// padded to K slots with data 0 and column 0 (a padding slot adds
// 0 * x[0] = 0, as in the reference). x has n_cols entries.
//
// Bound on the H100: device memory. The product must read data and cols
// once (8 B per stored slot), x once and write y once; the arithmetic (two
// float32 operations per slot) is far below the float32 rate. x is
// gathered K times per row: it is read through L2 (4 MB at n = 2^20 next to
// a 50 MB L2), so its gathers cost L2 bandwidth, not device memory.
//
// Design: coalesced row runs. A run is R consecutive rows (R = 256, fewer
// where K is large so that two runs fit the shared memory, see
// kernels/spmv_ell.py:run_rows); its data and cols are two contiguous
// blocks of R K 4 bytes. A grid of a few CTAs a SM (as many as the card
// holds at once) walks the runs; each CTA copies its next run into shared
// memory with 16-byte cp.async by all its threads, one run ahead of the one
// it sums (double-buffered), so the planes stream at full line width. A
// block whose base is not 16-byte aligned (a view into a larger buffer)
// takes a 4-byte cp.async loop in the same kernel. Each thread owns one row
// of the run: it reads its K slots from shared memory, starts all K gathers
// of x before the first add (K is a template parameter at K = 5, the width
// of the main path's poisson2d and convdiff2d planes; other widths take
// the same loop in batches of eight at run time), and sums in slot order with
// every product rounded before the add (__fmul_rn / __fadd_rn, and the
// build passes -fmad=false), which is the plain version's order
// (ref.spmv_ell), so the two agree bit for bit. cg_fused has its own SpMV.
// Known cost, for later work: a thread reads its slots from shared memory
// at a stride of K words, so an even K meets bank conflicts.
//
// Batched (kLanes): B right-hand sides on the one A, Y = A X, in ONE launch
// that reads A once. The lanes are stored instance-major, x as [B, n_cols]
// and y as [B, n] (the batched tier's public layout, so no transpose on
// either side). A run's slots are staged once as above; a thread loads its
// row's K columns and values from shared memory once, then for each lane
// gathers that lane's x at those columns and sums in slot order, the
// single-instance order, so each lane is bit-equal to its own launch.
// Bound: A's bytes once, plus B times (x gathered once, y written once).
#include <cuda_runtime.h>
#include <stdint.h>

#define SPMV_MAX_RUN 256

__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
                 : "memory");
}

// `words` 32-bit words from src to dst (shared memory, 16-byte aligned) by
// the CTA's threads: 16-byte copies where src is 16-byte aligned, else (and
// for the tail) 4-byte copies.
__device__ __forceinline__ void copy_block(uint32_t* dst, const uint32_t* src,
                                           int words) {
    const int t = threadIdx.x, nt = blockDim.x;
    int done = 0;
    if (((uintptr_t)src & 15) == 0) {
        const int vec = words >> 2;
        for (int i = t; i < vec; i += nt) cp_async16(dst + 4 * i, src + 4 * i);
        done = vec << 2;
    }
    for (int i = done + t; i < words; i += nt) cp_async4(dst + i, src + i);
}

// One row: K slots from shared memory, every gather started before the sum.
// K > 0 is the width at compile time; K == 0 takes k at run time.
template <int K>
__device__ __forceinline__ float row_sum(const float* ds, const int* cs,
                                         const float* __restrict__ x, int k) {
    float acc = 0.f;
    if constexpr (K > 0) {
        float xv[K];
#pragma unroll
        for (int j = 0; j < K; ++j) xv[j] = __ldg(x + cs[j]);
#pragma unroll
        for (int j = 0; j < K; ++j)
            acc = __fadd_rn(acc, __fmul_rn(ds[j], xv[j]));
    } else {
        for (int j0 = 0; j0 < k; j0 += 8) {
            float xv[8];
#pragma unroll
            for (int e = 0; e < 8; ++e)
                xv[e] = j0 + e < k ? __ldg(x + cs[j0 + e]) : 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e)
                if (j0 + e < k)
                    acc = __fadd_rn(acc, __fmul_rn(ds[j0 + e], xv[e]));
        }
    }
    return acc;
}

// One row for every lane: the K columns and values read from shared
// memory once, then each lane's gathers and its sum in slot order (the
// order of row_sum, so each lane's y is bit-equal to a single launch's).
template <int K>
__device__ __forceinline__ void row_lanes(const float* ds, const int* cs,
                                          const float* __restrict__ x,
                                          float* __restrict__ y, int i, int n,
                                          int ncols, int lanes, int k) {
    if constexpr (K > 0) {
        int col[K];
        float av[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
            col[j] = cs[j];
            av[j] = ds[j];
        }
        for (int b = 0; b < lanes; ++b) {
            const float* xb = x + (size_t)b * ncols;
            float xv[K];
#pragma unroll
            for (int j = 0; j < K; ++j) xv[j] = __ldg(xb + col[j]);
            float acc = 0.f;
#pragma unroll
            for (int j = 0; j < K; ++j)
                acc = __fadd_rn(acc, __fmul_rn(av[j], xv[j]));
            y[(size_t)b * n + i] = acc;
        }
    } else {
        for (int b = 0; b < lanes; ++b)
            y[(size_t)b * n + i] = row_sum<0>(ds, cs, x + (size_t)b * ncols, k);
    }
}

// Words of one plane of one run in shared memory (a 16-byte multiple).
__host__ __device__ __forceinline__ int run_words(int R, int k) {
    return (R * k + 3) & ~3;
}

// blockDim.x = R rows a run. Shared memory: two buffers of [data | cols].
// kLanes: `lanes` right-hand sides, x [lanes, ncols] and y [lanes, n].
template <int K, bool kLanes>
__global__ void __launch_bounds__(SPMV_MAX_RUN)
spmv_ell_kernel(const float* __restrict__ data, const int* __restrict__ cols,
                const float* __restrict__ x, float* __restrict__ y, int n,
                int k_rt, int runs, int lanes, int ncols) {
    const int k = K > 0 ? K : k_rt;
    const int R = blockDim.x, t = threadIdx.x;
    const int W = run_words(R, k);
    extern __shared__ __align__(16) uint32_t sm[];
    auto fetch = [&](int run, int buf) {
        const int r0 = run * R;
        const int words = min(R, n - r0) * k;
        const size_t off = (size_t)r0 * k;
        copy_block(sm + buf * 2 * W,
                   reinterpret_cast<const uint32_t*>(data + off), words);
        copy_block(sm + buf * 2 * W + W,
                   reinterpret_cast<const uint32_t*>(cols + off), words);
    };
    int run = blockIdx.x, buf = 0;
    if (run < runs) fetch(run, 0);
    asm volatile("cp.async.commit_group;" ::: "memory");
    for (; run < runs; run += gridDim.x) {
        const int next = run + gridDim.x;
        if (next < runs) fetch(next, buf ^ 1);
        asm volatile("cp.async.commit_group;" ::: "memory");
        asm volatile("cp.async.wait_group 1;" ::: "memory");   // this run's
        __syncthreads();
        const int i = run * R + t;
        if (i < n) {
            const uint32_t* b = sm + buf * 2 * W;
            const float* ds = reinterpret_cast<const float*>(b) + t * k;
            const int* cs = reinterpret_cast<const int*>(b + W) + t * k;
            if constexpr (kLanes)
                row_lanes<K>(ds, cs, x, y, i, n, ncols, lanes, k);
            else
                y[i] = row_sum<K>(ds, cs, x, k);
        }
        __syncthreads();    // the buffer is refilled by the next iteration
        buf ^= 1;
    }
}

template <int K, bool kLanes>
static int launch(const float* data, const int* cols, const float* x,
                  float* y, int n, int k, int R, int lanes, int ncols,
                  cudaStream_t stream) {
    const size_t smem = (size_t)2 * 2 * run_words(R, k) * sizeof(uint32_t);
    // the grid: as many CTAs as the card holds at once, asked once per
    // (device, rows, shared memory) of this instance
    static int c_dev = -1, c_R = 0, c_blocks = 0;
    static size_t c_smem = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev != c_dev || R != c_R || smem != c_smem) {
        e = cudaFuncSetAttribute(spmv_ell_kernel<K, kLanes>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
        if (e != cudaSuccess) return (int)e;
        int sms = 0, per_sm = 0;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return (int)e;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, spmv_ell_kernel<K, kLanes>, R, smem);
        if (e != cudaSuccess) return (int)e;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        c_dev = dev; c_R = R; c_smem = smem; c_blocks = per_sm * sms;
    }
    const int runs = (n + R - 1) / R;
    spmv_ell_kernel<K, kLanes><<<min(runs, c_blocks), R, smem, stream>>>(
        data, cols, x, y, n, k, runs, lanes, ncols);
    return (int)cudaGetLastError();
}

// Launches on `stream` with runs of R rows (1 <= R <= 256) for `lanes`
// right-hand sides (x [lanes, ncols], y [lanes, n]; lanes = 1 is the
// single-instance kernel); returns the cudaError_t of the launch
// (0 = success).
extern "C" int spmv_ell_launch(const float* data, const int* cols,
                               const float* x, float* y, int n, int k, int R,
                               int lanes, int ncols, cudaStream_t stream) {
    if (n <= 0 || lanes == 0) return 0;
    if (k < 0 || R < 1 || R > SPMV_MAX_RUN || lanes < 0)
        return (int)cudaErrorInvalidValue;
    if (lanes == 1) {
        if (k == 5) return launch<5, false>(data, cols, x, y, n, k, R, 1, ncols, stream);
        return launch<0, false>(data, cols, x, y, n, k, R, 1, ncols, stream);
    }
    if (k == 5) return launch<5, true>(data, cols, x, y, n, k, R, lanes, ncols, stream);
    return launch<0, true>(data, cols, x, y, n, k, R, lanes, ncols, stream);
}
