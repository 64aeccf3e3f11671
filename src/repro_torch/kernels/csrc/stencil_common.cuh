// Shared pieces of the hand-written Hopper stencil kernels.
//
// A domain of shape (H, D1, D2) (3D) or (H, D2) (2D, D1 = 1) is seen as H
// leading-axis "rows" of P = D1 * D2 contiguous cells. A stencil point has
// a leading-axis offset d0, in-plane offsets d1 (3D only, else 0) and d2,
// and an in-row offset dc = d1 * D2 + d2. The outermost r cells on every
// axis are Dirichlet (copied through).
//
// Cells are stored as T, float or __nv_bfloat16. Every update sums its
// terms in the spec's offset order, each product rounded to T before the
// add and each partial sum rounded to T (float32 arithmetic under
// __fmul_rn / __fadd_rn, then __float2bfloat16_rn for bf16; the build
// passes -fmad=false). That is the order and rounding of the plain torch
// version, whose bf16 `x * w` is one float32 product rounded to bf16: the
// two agree bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define STENCIL_MAX_POINTS 32
#define STENCIL_MAX_RADIUS 8

// Threads of the deep schedule's persistent CTA (one CTA per SM,
// csrc/stencil_tb.cu), and the registers that hold new values while a
// cached band's rows are updated in place (csrc/stencil_band.cuh): one
// block of rows is computed into them, then written back. A row updated in
// place has at most PERKS_CELLS_PER_THREAD * PERKS_THREADS cells, which
// must stay PERKS_MAX_ROW_CELLS of stencil2d.py (the wrappers check it).
constexpr int PERKS_THREADS = 1024;
constexpr int PERKS_CELLS_PER_THREAD = 20;
#define PERKS_MAX_BLOCK_ROWS 32

// Passed by value from the host (ctypes mirrors this layout).
struct StencilArgs {
    int H, D1, D2, P, ndim, r, npts;
    int d0[STENCIL_MAX_POINTS];
    int dc[STENCIL_MAX_POINTS];
    int d1[STENCIL_MAX_POINTS];
    int d2[STENCIL_MAX_POINTS];
    float w[STENCIL_MAX_POINTS];
};

// A batched launch of a persistent kernel stacks B domains of H * P cells
// and puts lane b on the CTAs (x, b): blockIdx.x and gridDim.x keep their
// meaning inside a lane, and one grid.sync() serves every lane. A CTA
// moves its domain pointers to its lane's domain first (64-bit: B domains
// may hold more than 2^31 cells).
template <typename T>
__device__ __forceinline__ T* lane_domain(T* p, const StencilArgs& a) {
    return p + (size_t)blockIdx.y * (size_t)a.H * (size_t)a.P;
}

// The spec copied into shared memory once per block.
struct SpecShared {
    int d0[STENCIL_MAX_POINTS];
    int dc[STENCIL_MAX_POINTS];
    int d1[STENCIL_MAX_POINTS];
    int d2[STENCIL_MAX_POINTS];
    int lin[STENCIL_MAX_POINTS];  // d0 * P + dc: offset in the flat domain
    float w[STENCIL_MAX_POINTS];
};

__device__ __forceinline__ void load_spec(const StencilArgs& a, SpecShared& s) {
    for (int k = threadIdx.x; k < a.npts; k += blockDim.x) {
        s.d0[k] = a.d0[k];
        s.dc[k] = a.dc[k];
        s.d1[k] = a.d1[k];
        s.d2[k] = a.d2[k];
        s.lin[k] = a.d0[k] * a.P + a.dc[k];
        s.w[k] = a.w[k];
    }
    __syncthreads();
}

// -- arithmetic in the storage type ----------------------------------------

__device__ __forceinline__ float term(float x, float w) { return __fmul_rn(x, w); }
__device__ __forceinline__ float plus(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ __nv_bfloat16 term(__nv_bfloat16 x, float w) {
    return __float2bfloat16_rn(__fmul_rn(__bfloat162float(x), w));
}
__device__ __forceinline__ __nv_bfloat16 plus(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

// A load that bypasses L1 (cached in L2 only): another CTA wrote the value
// earlier in the same launch, before a grid barrier.
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 ldcg(const __nv_bfloat16* p) {
    return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// 16 bytes from device memory (through L2 only) into shared memory without
// passing through registers; cp_async_wait waits for this thread's copies.
// Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"((unsigned)__cvta_generic_to_shared(smem)), "l"(gmem)
                 : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_all;" ::: "memory");
}

// n / q and n % q by one multiply-high (q fixed for many divisions): exact
// for 0 <= n and n * q < 2^32.
struct FastDiv {
    int q;
    unsigned m;
    __device__ explicit FastDiv(int q_)
        : q(q_), m(q_ == 1 ? 0u : 0xFFFFFFFFu / (unsigned)q_ + 1) {}
    __device__ int div(int n) const {
        return q == 1 ? n : (int)__umulhi((unsigned)n, m);
    }
    __device__ int mod(int n) const { return n - div(n) * q; }
};

// Update of the cell at index idx of a buffer whose neighbours lie at the
// offsets lin[] (the buffer's own strides).
template <int NPTS, typename T>
__device__ __forceinline__ T sum_at(const T* src, int idx, const int* lin,
                                    const SpecShared& s, int npts) {
    const int n = NPTS > 0 ? NPTS : npts;
    T acc = term(src[idx + lin[0]], s.w[0]);
#pragma unroll
    for (int k = 1; k < (NPTS > 0 ? NPTS : STENCIL_MAX_POINTS); ++k) {
        if (NPTS == 0 && k >= n) break;
        acc = plus(acc, term(src[idx + lin[k]], s.w[k]));
    }
    return acc;
}

// Update of in-row cell c of a row whose neighbour rows i-r .. i+r are given
// as pointers rows[0 .. 2r] (shared or global memory: generic addressing);
// point k lies at in-row offset off[k] (s.dc for whole rows).
template <int NPTS, typename T>
__device__ __forceinline__ T sum_rows(const T* const* rows, int r, int c,
                                      const int* off, const SpecShared& s,
                                      int npts) {
    const int n = NPTS > 0 ? NPTS : npts;
    T acc = term(rows[s.d0[0] + r][c + off[0]], s.w[0]);
#pragma unroll
    for (int k = 1; k < (NPTS > 0 ? NPTS : STENCIL_MAX_POINTS); ++k) {
        if (NPTS == 0 && k >= n) break;
        acc = plus(acc, term(rows[s.d0[k] + r][c + off[k]], s.w[k]));
    }
    return acc;
}

// Calls F<N>() with N the compile-time point count of the Table-III specs
// (5, 7, 9, 13, 17, 19, 21, 25, 27 points), or F<0>() for any other count.
#define STENCIL_DISPATCH_NPTS(npts, F, ...)                    \
    switch (npts) {                                           \
        case 5: F<5>(__VA_ARGS__); break;                      \
        case 7: F<7>(__VA_ARGS__); break;                      \
        case 9: F<9>(__VA_ARGS__); break;                      \
        case 13: F<13>(__VA_ARGS__); break;                    \
        case 17: F<17>(__VA_ARGS__); break;                    \
        case 19: F<19>(__VA_ARGS__); break;                    \
        case 21: F<21>(__VA_ARGS__); break;                    \
        case 25: F<25>(__VA_ARGS__); break;                    \
        case 27: F<27>(__VA_ARGS__); break;                    \
        default: F<0>(__VA_ARGS__); break;                     \
    }

// Whether in-row cell c lies inside the frozen border of the non-leading
// axes (2D: its column; 3D: its y and x).
__device__ __forceinline__ bool col_interior(int c, const StencilArgs& a) {
    if (a.ndim == 3) {
        const int y = c / a.D2;
        const int x = c - y * a.D2;
        return x >= a.r && x < a.D2 - a.r && y >= a.r && y < a.D1 - a.r;
    }
    return c >= a.r && c < a.D2 - a.r;
}

// Whether leading-axis row i lies inside the frozen border.
__device__ __forceinline__ bool row_interior(int i, const StencilArgs& a) {
    return i >= a.r && i < a.H - a.r;
}

// Whether cell (i, y, x) lies inside the frozen border (2D: y = 0).
__device__ __forceinline__ bool cell_interior(int i, int y, int x, const StencilArgs& a) {
    return row_interior(i, a) && x >= a.r && x < a.D2 - a.r &&
           (a.ndim != 3 || (y >= a.r && y < a.D1 - a.r));
}

// The element type of a launch: 0 float32, 1 bfloat16 (the wrappers' code).
#define STENCIL_F32 0
#define STENCIL_BF16 1
