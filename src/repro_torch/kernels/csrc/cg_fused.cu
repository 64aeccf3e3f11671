// PERKS conjugate gradient: `iters` textbook CG iterations from x0 = 0 in
// one cooperative persistent launch, the iteration vectors kept in shared
// memory for the kernel's whole life.
//
// Replaces: src/repro/kernels/cg_fused.py:cg_fused, both its resident-matrix
// kernel (`_cg_kernel_resident`, the paper's MIX/MAT policies) and its
// streamed-matrix kernel (`_cg_kernel_streamed`, VEC). It is the port's
// resident tier for CG (exec/adapters.py CGProblem.run_resident).
//
// The TPU kernel runs on one core with the whole of x, r, p and Ap in VMEM
// and takes its dot products over whole vectors. Here 132 SMs run at once
// and one CTA holds at most 227 KB, so:
//   * each CTA owns a contiguous range of rows, [r0, r1), about n / grid,
//     and keeps x, r, p and Ap of those rows in shared memory from the
//     prologue (b read once) to the epilogue (x written once);
//   * the SpMV of its rows gathers p from a device-memory copy `p_glob`
//     that every CTA publishes its rows of p to once per iteration (p is
//     the one vector other rows read); the gathers hit L2;
//   * the matrix: the leading `ca` rows of the CTA's range stay in shared
//     memory (slot-major, so neighbouring threads read neighbouring banks),
//     the rest is streamed from device memory every iteration. ca = 0 is
//     the paper's VEC policy, ca = all rows its MIX with the whole matrix
//     on chip, anything between is partial MIX: on the H100 a large A does
//     not fit beside the vectors, so part of it stays on chip;
//   * the two dot products of an iteration are grid-wide: each CTA writes
//     its partial sum (a fixed tree over its threads) to device memory,
//     grid.sync(), and every CTA sums the partials in the same fixed order,
//     so all CTAs hold the same alpha and beta and a run repeats bit for
//     bit. No float atomics.
// Order within an iteration follows ref.cg_iteration_matvec: Ap = A p;
// alpha = rr / (p.Ap); x += alpha p; r -= alpha Ap; rr' = r.r;
// beta = rr' / rr; p = r + beta p. Divisions are _safe_div
// (|b| > 0 ? a / b : 0) and every product is rounded before its add
// (-fmad=false), as torch computes the plain version; only the order of
// the dot products' sums differs from torch.dot.
// Three grid.sync() per iteration: after the SpMV partials, after the r.r
// partials, and after p is published.
//
// Bound on the H100: device memory for the streamed rows of A, 8 B per
// stored slot per iteration, plus the p gathers through L2; with A wholly
// on chip, the grid barriers and the latency of the gathers.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define CG_THREADS 1024
#define CG_WARPS (CG_THREADS / 32)

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

// Sum of v over the block in a fixed order; the result is valid in warp 0.
// Every thread of the block must call it.
__device__ float block_sum(float v, float* warp_part) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    v = warp_sum(v);
    if (lane == 0) warp_part[w] = v;
    __syncthreads();
    float t = 0.f;
    if (w == 0) t = warp_sum(lane < CG_WARPS ? warp_part[lane] : 0.f);
    __syncthreads();
    return t;
}

// Sum of the grid's `g` partials in one fixed order (the same in every
// CTA), broadcast to the whole block. L1 is bypassed: other SMs wrote them.
__device__ float grid_sum(const float* part, int g, float* bcast) {
    if (threadIdx.x < 32) {
        float t = 0.f;
        for (int i = threadIdx.x; i < g; i += 32) t = __fadd_rn(t, __ldcg(part + i));
        t = warp_sum(t);
        if (threadIdx.x == 0) *bcast = t;
    }
    __syncthreads();
    const float v = *bcast;
    __syncthreads();
    return v;
}

__global__ void __launch_bounds__(CG_THREADS, 1)
cg_fused_kernel(const float* __restrict__ data, const int* __restrict__ cols,
                const float* __restrict__ b, float* __restrict__ x_out,
                float* __restrict__ rr_out, float* p_glob, float* partials,
                int n, int k, int iters, int rows_stride, int ca_max) {
    extern __shared__ float smem[];
    __shared__ float warp_part[CG_WARPS];
    __shared__ float bcast;
    cg::grid_group grid = cg::this_grid();

    const int g = gridDim.x, bid = blockIdx.x, tid = threadIdx.x;
    const int r0 = (int)((long long)bid * n / g);
    const int r1 = (int)((long long)(bid + 1) * n / g);
    const int nr = r1 - r0;
    const int ca = min(ca_max, nr);                // cached rows of A
    float* xs = smem;
    float* rs = xs + rows_stride;
    float* ps = rs + rows_stride;
    float* aps = ps + rows_stride;
    float* ad = aps + rows_stride;                 // (K, ca_max) slot-major
    int* ac = (int*)(ad + (size_t)ca_max * k);
    float* part_pap = partials;                    // slot A: p.Ap partials
    float* part_rr = partials + g;                 // slot B: r.r partials

    // Prologue: the cached rows of A, and b, each read once.
    for (int e = tid; e < ca * k; e += CG_THREADS) {
        const int li = e / k, j = e - li * k;
        ad[(size_t)j * ca_max + li] = __ldg(data + (size_t)(r0 + li) * k + j);
        ac[(size_t)j * ca_max + li] = __ldg(cols + (size_t)(r0 + li) * k + j);
    }
    float part = 0.f;
    for (int li = tid; li < nr; li += CG_THREADS) {
        const float bv = __ldg(b + r0 + li);
        xs[li] = 0.f;
        rs[li] = bv;
        ps[li] = bv;
        p_glob[r0 + li] = bv;
        part = __fadd_rn(part, __fmul_rn(bv, bv));
    }
    part = block_sum(part, warp_part);             // also orders the A copy
    if (tid == 0) part_rr[bid] = part;
    grid.sync();
    float rr = grid_sum(part_rr, g, &bcast);

    for (int it = 0; it < iters; ++it) {
        // Ap = A p over the CTA's rows, and the partial of p.Ap.
        part = 0.f;
        for (int li = tid; li < nr; li += CG_THREADS) {
            float acc = 0.f;
            if (li < ca) {
                for (int j = 0; j < k; ++j)
                    acc = __fadd_rn(acc, __fmul_rn(
                        ad[(size_t)j * ca_max + li],
                        __ldcg(p_glob + ac[(size_t)j * ca_max + li])));
            } else {
                const size_t base = (size_t)(r0 + li) * k;
                for (int j = 0; j < k; ++j)
                    acc = __fadd_rn(acc, __fmul_rn(
                        __ldg(data + base + j),
                        __ldcg(p_glob + __ldg(cols + base + j))));
            }
            aps[li] = acc;
            part = __fadd_rn(part, __fmul_rn(ps[li], acc));
        }
        part = block_sum(part, warp_part);
        if (tid == 0) part_pap[bid] = part;
        grid.sync();
        const float alpha = safe_div(rr, grid_sum(part_pap, g, &bcast));

        // x += alpha p; r -= alpha Ap; the partial of r.r.
        part = 0.f;
        for (int li = tid; li < nr; li += CG_THREADS) {
            xs[li] = __fadd_rn(xs[li], __fmul_rn(alpha, ps[li]));
            const float r = __fsub_rn(rs[li], __fmul_rn(alpha, aps[li]));
            rs[li] = r;
            part = __fadd_rn(part, __fmul_rn(r, r));
        }
        part = block_sum(part, warp_part);
        if (tid == 0) part_rr[bid] = part;
        grid.sync();
        const float rr_new = grid_sum(part_rr, g, &bcast);
        const float beta = safe_div(rr_new, rr);
        rr = rr_new;

        // p = r + beta p, published for the next iteration's gathers.
        for (int li = tid; li < nr; li += CG_THREADS) {
            const float pn = __fadd_rn(rs[li], __fmul_rn(beta, ps[li]));
            ps[li] = pn;
            p_glob[r0 + li] = pn;
        }
        grid.sync();
    }

    // Epilogue: x written once.
    for (int li = tid; li < nr; li += CG_THREADS) x_out[r0 + li] = xs[li];
    if (bid == 0 && tid == 0) rr_out[0] = rr;
}

// The card's opt-in shared memory per block and the kernel's static shared
// memory; the wrapper gives the vectors and the cached rows the difference.
extern "C" int cg_fused_smem(int* optin, int* static_bytes) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, (const void*)cg_fused_kernel);
    if (e != cudaSuccess) return (int)e;
    *static_bytes = (int)attr.sharedSizeBytes;
    return 0;
}

// Co-resident CTAs for `smem_bytes` of dynamic shared memory: the largest
// grid a cooperative launch accepts.
extern "C" int cg_fused_max_ctas(int smem_bytes, int* out) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const void* f = (const void*)cg_fused_kernel;
    e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, CG_THREADS,
                                                      smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    *out = per_sm * sms;
    return 0;
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `partials` holds 2 * grid floats, `p_glob` n floats.
extern "C" int cg_fused_launch(const float* data, const int* cols,
                               const float* b, float* x_out, float* rr_out,
                               float* p_glob, float* partials, int n, int k,
                               int iters, int rows_stride, int ca_max, int grid,
                               int smem_bytes, cudaStream_t stream) {
    const void* f = (const void*)cg_fused_kernel;
    cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {(void*)&data, (void*)&cols, (void*)&b, (void*)&x_out,
                    (void*)&rr_out, (void*)&p_glob, (void*)&partials,
                    (void*)&n, (void*)&k, (void*)&iters, (void*)&rows_stride,
                    (void*)&ca_max};
    e = cudaLaunchCooperativeKernel(f, dim3(grid), dim3(CG_THREADS), args,
                                    (size_t)smem_bytes, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
