// Helpers shared by the cooperative Krylov kernels (cg_fused.cu,
// bicgstab_fused.cu, gmres_cycle_fused.cu): the zero-guarded division, the
// ELL row product, the grid-wide reductions in one fixed order, and the
// capacity queries and launch of a cooperative kernel.
//
// A reduction round sums up to KRY_WARPS values over the whole grid:
// every thread adds its rows' terms for each value, each warp sums its
// threads (a butterfly), warp v sums value v over the block's warps and
// writes the block's partial to partials[v * g + block]; after grid.sync()
// warp v of every CTA sums the g partials of value v in the same order.
// So every CTA holds the same sums, and a run repeats bit for bit: no
// float atomics anywhere.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define KRY_THREADS 1024
#define KRY_WARPS (KRY_THREADS / 32)

// a / b, or 0 when b is 0 or NaN (the plain version's _safe_div).
__device__ __forceinline__ float safe_div(float a, float b) {
    return fabsf(b) > 0.f ? __fdiv_rn(a, b) : 0.f;
}

// Sum over a warp by a butterfly: every lane ends with the same value.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// One thread's term of value `slot`: summed over the warp, kept per warp in
// warp_part[slot * KRY_WARPS + warp]. Every thread of the block calls it.
__device__ __forceinline__ void warp_partial(float v, int slot,
                                             float* warp_part) {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) warp_part[slot * KRY_WARPS + (threadIdx.x >> 5)] = v;
}

// The block's partials of values [0, nv) to partials[v * g + blockIdx.x].
// Every thread of the block calls it after its warp_partial calls.
__device__ __forceinline__ void block_partials(int nv, const float* warp_part,
                                               float* partials, int g) {
    __syncthreads();
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (w < nv) {
        const float t = warp_sum(warp_part[w * KRY_WARPS + lane]);
        if (lane == 0) partials[w * g + blockIdx.x] = t;
    }
}

// After grid.sync(): the grid's sums of values [0, nv) into sums[0, nv),
// the same in every CTA and visible to the whole block. L1 is bypassed:
// other SMs wrote the partials.
__device__ __forceinline__ void grid_sums(int nv, const float* partials, int g,
                                          float* sums) {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (w < nv) {
        float t = 0.f;
        for (int i = lane; i < g; i += 32)
            t = __fadd_rn(t, __ldcg(partials + w * g + i));
        t = warp_sum(t);
        if (lane == 0) sums[w] = t;
    }
    __syncthreads();
}

// Row li of the CTA's range of A times q (slots in slot order, each product
// rounded before its add: the plain version's order). Rows below `ca` come
// from the slot-major copy in shared memory (ad, ac with row stride
// ca_max), the rest from device memory; q is gathered through L2.
__device__ __forceinline__ float ell_row(int li, int row, int ca, int ca_max,
                                         int k, const float* ad, const int* ac,
                                         const float* __restrict__ data,
                                         const int* __restrict__ cols,
                                         const float* q) {
    float acc = 0.f;
    if (li < ca) {
        for (int j = 0; j < k; ++j)
            acc = __fadd_rn(acc, __fmul_rn(ad[(size_t)j * ca_max + li],
                                           __ldcg(q + ac[(size_t)j * ca_max + li])));
    } else {
        const size_t base = (size_t)row * k;
        for (int j = 0; j < k; ++j)
            acc = __fadd_rn(acc, __fmul_rn(__ldg(data + base + j),
                                           __ldcg(q + __ldg(cols + base + j))));
    }
    return acc;
}

// The leading `ca` rows of the CTA's range [r0, ...) of A into shared memory,
// slot-major (neighbouring threads read neighbouring banks).
__device__ __forceinline__ void cache_rows(int r0, int ca, int ca_max, int k,
                                           const float* __restrict__ data,
                                           const int* __restrict__ cols,
                                           float* ad, int* ac) {
    for (int e = threadIdx.x; e < ca * k; e += KRY_THREADS) {
        const int li = e / k, j = e - li * k;
        ad[(size_t)j * ca_max + li] = __ldg(data + (size_t)(r0 + li) * k + j);
        ac[(size_t)j * ca_max + li] = __ldg(cols + (size_t)(r0 + li) * k + j);
    }
}

// The card's opt-in shared memory per block and a kernel's static shared
// memory; the wrapper gives the rest to the kernel's dynamic layout.
static int kry_smem(const void* f, int* optin, int* static_bytes) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, f);
    if (e != cudaSuccess) return (int)e;
    *static_bytes = (int)attr.sharedSizeBytes;
    return 0;
}

// Co-resident CTAs of kernel f with `smem_bytes` of dynamic shared memory:
// the largest grid a cooperative launch accepts.
static int kry_max_ctas(const void* f, int smem_bytes, int* out) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, KRY_THREADS, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    *out = per_sm * sms;
    return 0;
}

// A cooperative launch of f on `stream`; returns its cudaError_t.
static int kry_launch(const void* f, int grid, int smem_bytes, void** args,
                      cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaLaunchCooperativeKernel(f, dim3(grid), dim3(KRY_THREADS), args,
                                    (size_t)smem_bytes, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
