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
// Design, simple first: one thread per row, the K slots summed in slot
// order with every product rounded before the add (__fmul_rn / __fadd_rn,
// and the build passes -fmad=false), which is the plain version's order
// (ref.spmv_ell), so the two agree bit for bit. The TPU kernel pads the
// rows to a block multiple; here a grid-stride loop takes any n.
// Known cost, for later work: (n, K) row-major means a thread reads with a
// stride of K * 4 B, so a warp's loads of one slot touch K times the lines
// they use (L1 catches the rest of each line for the next slots). A
// slot-major layout, a warp per few rows, or vector loads would coalesce.
#include <cuda_runtime.h>

#define SPMV_THREADS 256

__global__ void __launch_bounds__(SPMV_THREADS)
spmv_ell_kernel(const float* __restrict__ data, const int* __restrict__ cols,
                const float* __restrict__ x, float* __restrict__ y, int n,
                int k) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
        const size_t base = (size_t)i * k;
        float acc = 0.f;
        for (int j = 0; j < k; ++j)
            acc = __fadd_rn(acc, __fmul_rn(__ldg(data + base + j),
                                           __ldg(x + __ldg(cols + base + j))));
        y[i] = acc;
    }
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int spmv_ell_launch(const float* data, const int* cols,
                               const float* x, float* y, int n, int k,
                               cudaStream_t stream) {
    if (n <= 0) return 0;
    const int blocks = (n + SPMV_THREADS - 1) / SPMV_THREADS;
    spmv_ell_kernel<<<blocks, SPMV_THREADS, 0, stream>>>(data, cols, x, y, n, k);
    return (int)cudaGetLastError();
}
