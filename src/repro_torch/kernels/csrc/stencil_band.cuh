// The cached bands of the temporal-blocking kernels (csrc/stencil_tb.cu,
// the deep schedule; csrc/stencil_shallow.cu, the shallow tiles): the rows
// [0, R) cut into one band a CTA, kept in shared memory from the prologue to
// the epilogue and advanced ct steps a pass in place. NT is the kernel's
// thread count and CELLS the new values a thread holds while a block of rows
// is updated: NT * CELLS is the widest cached row, stencil2d.PERKS_MAX_ROW_CELLS.
#pragma once

#include "stencil_common.cuh"

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
template <int NPTS, int NT, int CELLS, typename T>
__device__ __forceinline__ void inplace_step(T* win, int w0, int w1, int lo, int hi,
                                             T* ring, const T* src,
                                             const StencilArgs& a, const SpecShared& s,
                                             const T** rows) {
    const int P = a.P, r = a.r, H = a.H, tid = threadIdx.x;
    int kb = (CELLS * NT) / P;
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
        T v[CELLS];
        {
            int ii = ii0, c = c0;
#pragma unroll
            for (int q = 0; q < CELLS; ++q) {
                if (ii < nr)
                    v[q] = (row_interior(i + ii, a) && col_interior(c, a))
                               ? sum_rows<NPTS>(rows + ii, r, c, s.dc, s, a.npts)
                               : rows[ii + r][c];
                c += NT;
                while (c >= P) { c -= P; ++ii; }
            }
        }
        __syncthreads();
        {
            int ii = ii0, c = c0;
#pragma unroll
            for (int q = 0; q < CELLS; ++q) {
                if (ii < nr) {
                    const int row = i + ii;
                    T* own = win + (size_t)(row - w0) * P;
                    if (row >= i1 - r)
                        ring[(size_t)(row % r) * P + c] = own[c];
                    own[c] = v[q];
                }
                c += NT;
                while (c >= P) { c -= P; ++ii; }
            }
        }
    }
}

// One pass of a cached band [b0, b1): level k -> k + ct in place.
template <int NPTS, int NT, int CELLS, typename T>
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
        inplace_step<NPTS, NT, CELLS>(win, w0, w1, shrink_lo(w0, k, r), shrink_hi(w1, k, r, H),
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

