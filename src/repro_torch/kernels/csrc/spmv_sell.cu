// SELL-C-sigma sparse matrix-vector product, y_perm = A_perm x.
//
// Replaces: src/repro/kernels/spmv_sell.py:spmv_sell (`_sell_kernel`). It
// is the SpMV of the port's CG loop tiers for a problem built with
// `CGProblem.from_matvec(SellOperator.matvec, ...)` (solvers/cg.py), which
// restores the original row order with a torch gather after it.
//
// Layout (repro_torch.sparse.SellMatrix): rows sorted by nnz within
// sigma-windows and cut into slices of C rows; slice s holds slice_k[s]
// slots per row, stored slot-major from slice_offsets[s]: the element of
// slot j of permuted row p lives at slice_offsets[p / C] + j * C + p % C.
// Output: (n_slices * C,) in the permuted, padded row order, as the
// reference returns it.
//
// Bound on the H100: device memory. The product must read the stored
// slots (8 B each, data and cols), the two slice tables, x once and write
// y once; the gathers of x hit L2 (x is 4 MB at n = 2^20).
//
// Design, simple first: one thread per permuted row, the slots summed in
// slot order with every product rounded before the add (__fmul_rn /
// __fadd_rn, -fmad=false), the order of the plain version (ref.spmv_sell).
// Neighbouring threads are neighbouring lanes of a slice, so for each slot
// they read neighbouring addresses: the loads coalesce. Each row stops at
// its own slice's width; the TPU kernel's fixed C * K_max window and its
// mask were a static-shape workaround and are gone. C is a runtime
// argument (the registry's default is 8, solvers.cg.load_sell uses 32).
#include <cuda_runtime.h>

#define SELL_THREADS 256

__global__ void __launch_bounds__(SELL_THREADS)
spmv_sell_kernel(const float* __restrict__ data, const int* __restrict__ cols,
                 const int* __restrict__ slice_offsets,
                 const int* __restrict__ slice_k, const float* __restrict__ x,
                 float* __restrict__ y, int rows, int c) {
    for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < rows;
         p += gridDim.x * blockDim.x) {
        const int s = p / c;
        const int lane = p - s * c;
        const int k = __ldg(slice_k + s);
        const size_t off = (size_t)__ldg(slice_offsets + s) + lane;
        float acc = 0.f;
        for (int j = 0; j < k; ++j) {
            const size_t e = off + (size_t)j * c;
            acc = __fadd_rn(acc, __fmul_rn(__ldg(data + e),
                                           __ldg(x + __ldg(cols + e))));
        }
        y[p] = acc;
    }
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int spmv_sell_launch(const float* data, const int* cols,
                                const int* slice_offsets, const int* slice_k,
                                const float* x, float* y, int n_slices, int c,
                                cudaStream_t stream) {
    const int rows = n_slices * c;
    if (rows <= 0) return 0;
    const int blocks = (rows + SELL_THREADS - 1) / SELL_THREADS;
    spmv_sell_kernel<<<blocks, SELL_THREADS, 0, stream>>>(
        data, cols, slice_offsets, slice_k, x, y, rows, c);
    return (int)cudaGetLastError();
}
