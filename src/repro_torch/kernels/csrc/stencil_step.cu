// One Jacobi step of a stencil, out of place: src -> dst.
//
// Replaces: src/repro/kernels/stencil2d.py:stencil_baseline_step (the TPU
// `_perks_kernel` with steps=1, cached_rows=0). It is the step of the
// port's host_loop tier (one launch per step) and, captured N times into a
// CUDA graph, of its device_loop tier.
//
// Bound on the H100: device memory. One step must read the domain once and
// write it once, 2 * H * P * sizeof(T) bytes at 3.35 TB/s (T is float or
// __nv_bfloat16, chosen at launch); the arithmetic
// (2 * npoints flops per cell) is 20-50x below the float32 rate. Design:
// about 4096 blocks walk the rows (grid y) and the cells of a row (grid
// x); neighbouring threads take neighbouring cells so loads and stores
// coalesce, and no thread divides to find its row; the 2r neighbour rows
// a block touches are re-read through L1/L2, not device memory, so the
// traffic stays near the bound.
// The point count is a compile-time constant per spec, so the point loop
// unrolls and a thread's loads issue together.
// Nothing survives the launch, which is the point of the host-loop
// baseline (the paper's Fig. 3, left).
//
// Batched: B domains of the same shape, stored one after another
// ([B, H, ...], the batched tier's stacked state), step in ONE launch. The
// instance is the grid's z index: a block works inside one instance, so it
// never mixes two instances' halos, and each cell's update is the same
// function of the same neighbours as in a single-instance launch, so every
// instance's result is bit-equal to its own launch (B = 1 is the
// single-instance launch itself). The x/y grid shrinks with B to keep
// about STEP_BLOCKS blocks. Bound: 2 * B * H * P * sizeof(T) bytes.
#include "stencil_common.cuh"

#define STEP_THREADS 256
#define STEP_BLOCKS 4096
// Rows a thread takes at a time (step_rows). The many resident blocks keep
// enough loads in flight with one: four measured 0.39-0.40 ms against
// 0.30 ms at 8192^2 on an H100 (PERF.md, scripts/kernel_variants.py).
#ifndef STEP_STREAM_ROWS
#define STEP_STREAM_ROWS 1
#endif

template <int NPTS, typename T>
__global__ void __launch_bounds__(STEP_THREADS)
stencil_step_kernel(const T* __restrict__ src, T* __restrict__ dst,
                    StencilArgs a) {
    __shared__ SpecShared s;
    load_spec(a, s);
    const size_t inst = (size_t)blockIdx.z * a.H * a.P;   // this instance
    src += inst;
    dst += inst;
    step_rows<NPTS, STEP_STREAM_ROWS>(src, dst, a, s, blockIdx.y, gridDim.y,
                    blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
}

template <int NPTS>
static void launch_f32(const void* src, void* dst, const StencilArgs& a,
                       dim3 grid, cudaStream_t stream) {
    stencil_step_kernel<NPTS><<<grid, STEP_THREADS, 0, stream>>>(
        (const float*)src, (float*)dst, a);
}

template <int NPTS>
static void launch_bf16(const void* src, void* dst, const StencilArgs& a,
                        dim3 grid, cudaStream_t stream) {
    stencil_step_kernel<NPTS><<<grid, STEP_THREADS, 0, stream>>>(
        (const __nv_bfloat16*)src, (__nv_bfloat16*)dst, a);
}

// Launches on `stream` one step of `batch` domains stored one after
// another (batch = 1: one domain) for elements of type `dtype`
// (STENCIL_F32 or STENCIL_BF16); returns the cudaError_t of the launch
// (0 = success).
extern "C" int stencil_step_launch(const void* src, void* dst, StencilArgs a,
                                   int dtype, int batch, cudaStream_t stream) {
    if (batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
    // About STEP_BLOCKS blocks: x across a row, y over rows (grid-stride),
    // z over the instances.
    const int gx = min((a.P + STEP_THREADS - 1) / STEP_THREADS, 64);
    const int gy = max(1, min(min(a.H, 65535), STEP_BLOCKS / (gx * batch)));
    const dim3 grid(gx, gy, batch);
    if (dtype == STENCIL_BF16) {
        STENCIL_DISPATCH_NPTS(a.npts, launch_bf16, src, dst, a, grid, stream)
    } else {
        STENCIL_DISPATCH_NPTS(a.npts, launch_f32, src, dst, a, grid, stream)
    }
    return (int)cudaGetLastError();
}
