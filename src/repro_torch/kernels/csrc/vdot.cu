// Dot products of B pairs of vectors in ONE launch: out[l] = a[l] . b[l].
//
// Replaces: the reductions of the Krylov loop tiers' step functions
// (`jnp.vdot` in src/repro/kernels/ref.py:cg_iteration_matvec, BiCGStab's
// and GMRES's steps), which XLA fuses on the TPU. It is the loop tiers'
// dot (exec/precision.py dot_for) for one vector pair (B = 1) and for the
// batched tier's B lanes, stored instance-major ([B, n]).
//
// Why a kernel of its own: the batched tier must give each lane exactly
// the bits of that instance solved alone, and a library reduction picks
// its split of the vector by the number of outputs, so a [B, n] sum and an
// [n] dot add in different orders. Here the order depends on n only:
// G = ceil(n / (THREADS * 8)) blocks a lane (at most VDOT_MAX_BLOCKS), block
// g's thread t adds elements g * THREADS + t + j * G * THREADS for j = 0,
// 1, ... in turn (four loads of each vector in flight), each product
// rounded before its add (__fmul_rn / __fadd_rn, and -fmad=false); a
// butterfly sums each warp, warp 0 the warps, and the block writes its
// partial. The last block of a lane to finish (a ticket counter, after a
// fence: the threadfence reduction) sums the G partials in index order
// with the same butterflies and writes out[l], then resets the lane's
// counter for the next launch on the same counters. Two launches in
// flight at once must not share counters: the wrapper keeps a set a
// stream, and gives a launch captured into a CUDA graph a set of its own.
// Which block is last does not change the order. The lanes are the grid's
// y index and never meet. With `b_lanes` < B one operand is shared: lane l
// reads b's row l % b_lanes (GMRES's projections of one vector a lane on
// the rows of its basis), which changes which row a lane reads and
// nothing of the order of its sum.
//
// Bound on the H100: device memory, 2 * B * n * sizeof(T) bytes read once.
#include <cuda_runtime.h>

#define VDOT_THREADS 256
#define VDOT_PER_THREAD 8          // elements a thread at the sizing of G
#define VDOT_MAX_BLOCKS 264        // two a SM
#define VDOT_MAX_LANES 1024        // lanes of the counters the wrapper keeps

__device__ __forceinline__ float vmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float vadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double vmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double vadd(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ T warp_butterfly(T v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = vadd(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// The block's sum of one value a thread, in a fixed order; valid in
// thread 0.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* warp_part) {
    v = warp_butterfly(v);
    if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = v;
    __syncthreads();
    T s = 0;
    if (threadIdx.x < 32) {
        s = threadIdx.x < VDOT_THREADS / 32 ? warp_part[threadIdx.x] : T(0);
        s = warp_butterfly(s);
    }
    return s;
}

template <typename T>
__global__ void __launch_bounds__(VDOT_THREADS)
vdot_kernel(const T* __restrict__ a, const T* __restrict__ b,
            T* __restrict__ out, T* partial, unsigned* count, int n,
            int b_lanes) {
    __shared__ T warp_part[VDOT_THREADS / 32];
    __shared__ bool last;
    const int G = gridDim.x, g = blockIdx.x, lane = blockIdx.y;
    a += (size_t)lane * n;
    b += (size_t)(lane % b_lanes) * n;
    const int stride = G * VDOT_THREADS;
    int i = g * VDOT_THREADS + threadIdx.x;
    T acc = 0;
    for (; i + 3 * stride < n; i += 4 * stride) {
        T av[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            av[u] = __ldg(a + i + u * stride);
            bv[u] = __ldg(b + i + u * stride);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) acc = vadd(acc, vmul(av[u], bv[u]));
    }
    for (; i < n; i += stride) acc = vadd(acc, vmul(__ldg(a + i), __ldg(b + i)));
    const T s = block_sum(acc, warp_part);
    if (threadIdx.x == 0) {
        partial[(size_t)lane * G + g] = s;
        __threadfence();
        last = atomicAdd(count + lane, 1u) == (unsigned)G - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    // The lane's G partials in index order (thread t takes t, t + 256, ...).
    T p = 0;
    for (int j = threadIdx.x; j < G; j += VDOT_THREADS)
        p = vadd(p, __ldcg(partial + (size_t)lane * G + j));
    __syncthreads();   // warp_part is reused
    const T total = block_sum(p, warp_part);
    if (threadIdx.x == 0) {
        out[lane] = total;
        count[lane] = 0;
    }
}

// Blocks a lane for vectors of n elements (the order of the sums depends
// on it, so it depends on n only).
static int vdot_blocks(int n) {
    const int per_block = VDOT_THREADS * VDOT_PER_THREAD;
    const int g = (n + per_block - 1) / per_block;
    return g < 1 ? 1 : (g > VDOT_MAX_BLOCKS ? VDOT_MAX_BLOCKS : g);
}

extern "C" int vdot_blocks_for(int n) { return vdot_blocks(n); }

// Launches on `stream` the dots of `lanes` pairs of n-element vectors of
// type `dtype` (0 float32, 1 float64), a [lanes, n] and b [b_lanes, n]
// contiguous (lane l pairs a's row l with b's row l % b_lanes; b_lanes
// divides lanes), into out[lanes]; `partial` holds lanes *
// vdot_blocks_for(n) elements and `count` lanes zeroed words (the kernel
// leaves them zero). Returns the cudaError_t of the launch (0 = success).
extern "C" int vdot_launch(const void* a, const void* b, void* out,
                           void* partial, unsigned* count, int n, int lanes,
                           int b_lanes, int dtype, cudaStream_t stream) {
    if (lanes < 1 || lanes > VDOT_MAX_LANES || n < 0 || lanes > 65535 ||
        b_lanes < 1 || lanes % b_lanes != 0)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(vdot_blocks(n), lanes);
    if (dtype == 1)
        vdot_kernel<double><<<grid, VDOT_THREADS, 0, stream>>>(
            (const double*)a, (const double*)b, (double*)out,
            (double*)partial, count, n, b_lanes);
    else
        vdot_kernel<float><<<grid, VDOT_THREADS, 0, stream>>>(
            (const float*)a, (const float*)b, (float*)out, (float*)partial,
            count, n, b_lanes);
    return (int)cudaGetLastError();
}
