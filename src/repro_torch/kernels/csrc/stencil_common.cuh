// Shared pieces of the hand-written Hopper stencil kernels.
//
// A domain of shape (H, D1, D2) (3D) or (H, D2) (2D, D1 = 1) is seen as H
// leading-axis "rows" of P = D1 * D2 contiguous float32 cells. A stencil
// point has a leading-axis offset d0 and an in-row offset dc = d1 * D2 + d2.
// The outermost r cells on every axis are Dirichlet (copied through).
//
// Every update sums its terms in the spec's offset order, each product
// rounded before the add (__fmul_rn / __fadd_rn, and the build passes
// -fmad=false), which is exactly the order and rounding of the plain torch
// version: the two agree bit for bit.
#pragma once

#include <cuda_runtime.h>

#define STENCIL_MAX_POINTS 32
#define STENCIL_MAX_RADIUS 8

// Passed by value from the host (ctypes mirrors this layout).
struct StencilArgs {
    int H, D1, D2, P, ndim, r, npts;
    int d0[STENCIL_MAX_POINTS];
    int dc[STENCIL_MAX_POINTS];
    float w[STENCIL_MAX_POINTS];
};

// The spec copied into shared memory once per block.
struct SpecShared {
    int d0[STENCIL_MAX_POINTS];
    int dc[STENCIL_MAX_POINTS];
    int lin[STENCIL_MAX_POINTS];  // d0 * P + dc: offset in the flat domain
    float w[STENCIL_MAX_POINTS];
};

__device__ __forceinline__ void load_spec(const StencilArgs& a, SpecShared& s) {
    for (int k = threadIdx.x; k < a.npts; k += blockDim.x) {
        s.d0[k] = a.d0[k];
        s.dc[k] = a.dc[k];
        s.lin[k] = a.d0[k] * a.P + a.dc[k];
        s.w[k] = a.w[k];
    }
    __syncthreads();
}

// Update of the cell at flat index idx, all neighbours read from src.
// NPTS > 0 is the point count known at compile time (the loop unrolls and
// the loads issue together); NPTS == 0 reads it from npts. With in = false
// every term reads the cell itself, so a frozen border cell's loads stay in
// bounds and the caller can issue them unconditionally (the sum is then
// unused).
template <int NPTS>
__device__ __forceinline__ float sum_flat(const float* __restrict__ src, int idx,
                                          const SpecShared& s, int npts, bool in) {
    const int n = NPTS > 0 ? NPTS : npts;
    const int m = in ? -1 : 0;
    float acc = __fmul_rn(src[idx + (s.lin[0] & m)], s.w[0]);
#pragma unroll
    for (int k = 1; k < (NPTS > 0 ? NPTS : STENCIL_MAX_POINTS); ++k) {
        if (NPTS == 0 && k >= n) break;
        acc = __fadd_rn(acc, __fmul_rn(src[idx + (s.lin[k] & m)], s.w[k]));
    }
    return acc;
}

// Update of cell c of a row whose neighbour rows i-r .. i+r are given as
// pointers rows[0 .. 2r] (shared or global memory: generic addressing).
template <int NPTS>
__device__ __forceinline__ float sum_rows(const float* const* rows, int r, int c,
                                          const SpecShared& s, int npts) {
    const int n = NPTS > 0 ? NPTS : npts;
    float acc = __fmul_rn(rows[s.d0[0] + r][c + s.dc[0]], s.w[0]);
#pragma unroll
    for (int k = 1; k < (NPTS > 0 ? NPTS : STENCIL_MAX_POINTS); ++k) {
        if (NPTS == 0 && k >= n) break;
        acc = __fadd_rn(acc, __fmul_rn(rows[s.d0[k] + r][c + s.dc[k]], s.w[k]));
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

// One step of rows i = first, first + stride, ... < H, cells of each row
// spread over threads (c0, c0 + cstride, ...): src -> dst, frozen cells
// copied through. Neighbouring threads take neighbouring cells, so loads
// and stores coalesce. A thread takes U rows at a time and issues all their
// loads before it stores any result, so it keeps U rows' device-memory
// reads in flight; a row past H reads row H - 1 (frozen, in bounds) and is
// not stored.
template <int NPTS, int U>
__device__ __forceinline__ void step_rows(const float* __restrict__ src,
                                          float* __restrict__ dst,
                                          const StencilArgs& a, const SpecShared& s,
                                          int first, int stride, int c0, int cstride) {
    for (int i0 = first; i0 < a.H; i0 += U * stride) {
        for (int c = c0; c < a.P; c += cstride) {
            const bool col_in = col_interior(c, a);
            float v[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int i = min(i0 + u * stride, a.H - 1);
                const int idx = i * a.P + c;
                const bool in = col_in && row_interior(i, a);
                const float acc = sum_flat<NPTS>(src, idx, s, a.npts, in);
                v[u] = in ? acc : src[idx];
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int i = i0 + u * stride;
                if (i < a.H) dst[i * a.P + c] = v[u];
            }
        }
    }
}
