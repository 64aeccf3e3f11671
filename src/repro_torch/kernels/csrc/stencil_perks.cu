// The PERKS persistent stencil kernel: `steps` Jacobi steps in one
// cooperative launch, with the leading `R` rows of the domain kept in
// shared memory for the kernel's whole life.
//
// Replaces: src/repro/kernels/stencil2d.py:stencil_perks (`_perks_kernel`,
// fuse_steps=1) with R < H. With every row cached (stencil_perks at R = H
// and stencil2d.py:stencil_resident) the wrapper runs
// csrc/stencil_resident.cu instead.
//
// The TPU kernel runs its grid in order on one core and updates the domain
// in place, carrying overwritten rows in VMEM. Here 132 SMs run at once, so
// an in-place update would race with a neighbour's halo read. Instead:
//   * the cached rows [0, R) are cut into `nb` contiguous bands, one per
//     CTA, each at least r rows; a band lives in shared memory from the
//     prologue (one load) to the epilogue (one store);
//   * each step a CTA updates its band in place, a block of rows at a
//     time: the new rows are held in registers until the whole block has
//     been read, and the old values of the r rows above the next block are
//     kept in an r-row ring in shared memory, so a band costs (rows + r)
//     rows of shared memory and two __syncthreads per block of rows;
//   * after the band update the CTA writes only the r-row top and bottom
//     borders of its band to device memory, where the neighbouring bands
//     and the streamed rows read them in the next step;
//   * the uncached rows [R, H) stream every step between two device-memory
//     ping-pong buffers (step 0 reads the caller's x, so x is never
//     written), cells spread over all CTAs;
//   * grid.sync() is the barrier between steps (the paper's Fig. 3, right).
//
// Cells are float or __nv_bfloat16 (one instance each, chosen at launch).
//
// Bound on the H100: device memory for the streamed rows, 2 * (H - R) * P
// * sizeof(T) bytes per step, plus 4r rows per band per step for the borders; the
// cached rows cost one load and one store in total (Eq. 5 of the paper).
// Each spec's point count is a compile-time
// constant (STENCIL_DISPATCH_NPTS), so the point loops unroll.
#include <cooperative_groups.h>

#include "stencil_common.cuh"

namespace cg = cooperative_groups;

// Streamed rows a thread takes at a time (step_rows): with one 1024-thread
// CTA per SM the streamed loop is bound by memory latency, and four rows'
// loads in flight measured 30.3 ms against 34.8 ms for one on 8192^2 x 100
// steps on an H100 (eight: 41.9 ms; PERF.md, scripts/kernel_variants.py).
#ifndef PERKS_STREAM_ROWS
#define PERKS_STREAM_ROWS 4
#endif

template <int NPTS, typename T>
__global__ void __launch_bounds__(PERKS_THREADS, 1)
stencil_perks_kernel(const T* __restrict__ x, T* buf0, T* buf1, StencilArgs a,
                     int steps, int R, int nb) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ SpecShared s;
    __shared__ const T* rows[PERKS_MAX_BLOCK_ROWS + 2 * STENCIL_MAX_RADIUS];
    load_spec(a, s);
    cg::grid_group grid = cg::this_grid();

    const int P = a.P, r = a.r;
    const int tid = threadIdx.x;
    const int b = blockIdx.x;
    int b0 = 0, b1 = 0;
    if (b < nb) {
        b0 = (int)((long long)b * R / nb);
        b1 = (int)((long long)(b + 1) * R / nb);
    }
    const int nrows = b1 - b0;
    T* band = reinterpret_cast<T*>(smem_raw);  // rows [b0, b1)
    T* ring = band + (size_t)nrows * P;         // old values of r rows
    // rows updated per block: as many as the registers hold
    int kb = (PERKS_CELLS_PER_THREAD * PERKS_THREADS) / P;
    kb = max(1, min(kb, PERKS_MAX_BLOCK_ROWS));

    // Prologue: the band's one load from device memory.
    for (int e = tid; e < nrows * P; e += blockDim.x)
        band[e] = x[(size_t)b0 * P + e];
    __syncthreads();

    for (int k = 0; k < steps; ++k) {
        const T* src = (k == 0) ? x : ((k & 1) ? buf0 : buf1);
        T* dst = (k & 1) ? buf1 : buf0;

        // Band update in place, a block of rows [i, i1) at a time: read the
        // old rows i-r .. i1-1+r (above the block from the ring, the block
        // and below it from the band, outside the band from src), compute
        // into registers, then save the old rows the next block still
        // needs into the ring and write the new rows over the old. (The
        // same update as stencil_band.cuh's inplace_step, written out here:
        // calling that function made the streamed loop of this kernel 10-21%
        // slower on 8192^2 on an H100, PERF.md.)
        for (int i = b0; i < b1; i += kb) {
            const int i1 = min(i + kb, b1);
            const int nr = i1 - i;
            for (int t = tid; t < nr + 2 * r; t += blockDim.x) {
                const int j = i - r + t;
                const T* p = nullptr;
                if (j >= b0 && j < i)
                    p = ring + (size_t)(j % r) * P;
                else if (j >= i && j < b1)
                    p = band + (size_t)(j - b0) * P;
                else if (j >= 0 && j < a.H)
                    p = src + (size_t)j * P;
                rows[t] = p;
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
                        T* own = band + (size_t)(row - b0) * P;
                        if (row >= i1 - r)
                            ring[(size_t)(row % r) * P + c] = own[c];
                        own[c] = v[q];
                    }
                    c += PERKS_THREADS;
                    while (c >= P) { c -= P; ++ii; }
                }
            }
        }
        if (nrows > 0) {
            __syncthreads();
            // Publish the band's r-row borders for the neighbours' next step.
            const int top_end = min(b0 + r, b1);
            for (int e = tid; e < (top_end - b0) * P; e += blockDim.x)
                dst[(size_t)b0 * P + e] = band[e];
            const int bot = max(b1 - r, top_end);
            for (int e = tid; e < (b1 - bot) * P; e += blockDim.x)
                dst[(size_t)bot * P + e] = band[(size_t)(bot - b0) * P + e];
        }

        // Streamed rows [R, H): device memory in, device memory out, one
        // row per CTA at a time.
        step_rows<NPTS, PERKS_STREAM_ROWS>(src, dst, a, s, R + b, gridDim.x, tid,
                                           blockDim.x);
        grid.sync();
    }

    // Epilogue: the band's one store, into the buffer the last step wrote.
    if (nrows > 0 && steps > 0) {
        T* fin = ((steps - 1) & 1) ? buf1 : buf0;
        for (int e = tid; e < nrows * P; e += blockDim.x)
            fin[(size_t)b0 * P + e] = band[e];
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

// Largest cached row (cells) the kernel's registers can hold.
extern "C" int stencil_perks_max_row_cells(void) {
    return PERKS_CELLS_PER_THREAD * PERKS_THREADS;
}

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
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f,
                                                      PERKS_THREADS, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    *out = per_sm * sms;
    return 0;
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// Elements of type `dtype` (STENCIL_F32 or STENCIL_BF16).
extern "C" int stencil_perks_launch(const void* x, void* buf0, void* buf1,
                                    StencilArgs a, int dtype, int steps, int R,
                                    int nb, int grid, int smem_bytes,
                                    cudaStream_t stream) {
    const void* f = perks_kernel(a.npts, dtype);
    cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {(void*)&x, (void*)&buf0, (void*)&buf1, (void*)&a,
                    (void*)&steps, (void*)&R, (void*)&nb};
    e = cudaLaunchCooperativeKernel(f, dim3(grid),
                                    dim3(PERKS_THREADS), args, (size_t)smem_bytes, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
