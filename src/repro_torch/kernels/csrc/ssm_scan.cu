// Mamba2 SSD chunk scan with the recurrent state h kept on chip: a PERKS
// kernel for a recurrence along the sequence.
//
// Replaces: src/repro/kernels/ssm_scan.py:ssm_scan (`_ssd_kernel`), and the
// vmap over a batch in src/repro/kernels/ops.py:ssd_scan. The TPU kernel
// walks the chunks of one sequence as a sequential grid with h (H, N, P)
// float32 in VMEM scratch. Here each head is independent, so CTA
// (column slice, head, sequence) walks every chunk of its sequence in order
// with its slice of h (N x Ps float32) in shared memory for the whole scan:
// h never goes to device memory and no grid barrier is needed.
//
// Math per head (chunk of length L, cum[i] = sum_{k<=i} dt_k a_h):
//   intra:  y[i] += sum_{j<=i} e^{cum[i]-cum[j]} (c_i . b_j) dt_j x_j
//   cross:  y[i] += e^{cum[i]} c_i . h
//   skip:   y[i] += d_h x_i
//   state:  h = e^{cum[L-1]} h + sum_j e^{cum[L-1]-cum[j]} dt_j b_j (x) x_j
// The upper triangle is masked before exp (its exponent is positive and
// overflows for long chunks).
//
// Layout: x (B, T, H, P), dt (B, T, H), b and c (B, T, N), y (B, T, H, P),
// one type, float32 or bf16 (read as float32, y rounded once); a and d (H,)
// float32. The chunk C is any length from 1 to SSM_MAX_CHUNK and T need not
// be a multiple of it: the last chunk is shorter.
//
// Work: a first kernel writes the chunks' score matrices c_i . b_j (shared
// by all heads) to a float32 workspace, (B, chunks, C, C); the scan kernel
// reads them. Bound on the H100: float32 operations, about
// 2 T H P (C + 2 N) for the scan (C/2 intra, N cross, N state terms per
// output), against one pass over the streams.
//
// Design, simple first: a chunk stages the decay matrix
// M[i][j] = e^{cum[i]-cum[j]} S[i][j] dt_j, the slice of x and the chunk of
// c (then of b) in shared memory, its loops unrolled by 8 so that each
// thread has eight loads in flight (the rows come from L2 or memory). Each
// thread keeps a tile of outputs (4 rows x 4 columns) and of state entries
// (8 state rows x 4 columns) in registers, so a pair of shared-memory loads
// feeds several fmaf. Products use fmaf (the build passes -fmad=false,
// which leaves explicit fmaf fused). Limits: Ps <= 32 columns a CTA,
// N <= 256. Known costs, for later work: the intra, cross and state
// products are small matrix products run on the CUDA cores (wgmma would
// take them), the cumulative sum is serial, the tiles take 166 KB of shared
// memory (one CTA of 8 warps a SM), and every CTA of a head recomputes M
// and restages c and b.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define SSM_THREADS 256
#define SSM_MAX_CHUNK 128
#define SSM_TC 8                         // threads along a slice's columns
#define SSM_TR (SSM_THREADS / SSM_TC)    // threads along rows (32)
#define SSM_RP 4                         // columns a thread owns: Ps <= 32
#define SSM_RI (SSM_MAX_CHUNK / SSM_TR)  // chunk rows a thread owns (4)
#define SSM_RN 8                         // state rows a thread owns: N <= 256
#define SSM_MAX_SLICE (SSM_TC * SSM_RP)
#define SSM_MAX_STATE (SSM_TR * SSM_RN)
#define XS SSM_MAX_SLICE
#define SSM_ST (SSM_MAX_CHUNK / 16)      // score rows/columns a thread owns

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// S[bt][k][i][j] = c_i . b_j for j <= i < L (the chunk's length), else 0.
// The chunk's c and b go to shared memory; thread (ti, tj) sums a tile of
// rows ti + 16 r and columns tj + 16 q (8 x 8) in registers.
template <typename T>
__global__ void __launch_bounds__(SSM_THREADS)
ssd_scores_kernel(const T* __restrict__ b, const T* __restrict__ c,
                  float* __restrict__ S, int T_, int N, int C, int chunks) {
    const int k = blockIdx.x, bt = blockIdx.y;
    const int c0 = k * C, L = min(C, T_ - c0);
    const int tid = threadIdx.x, ti = tid / 16, tj = tid - (tid / 16) * 16;
    const int NS = N + 1;
    extern __shared__ float sm[];
    float* cs = sm;                         // L x NS
    float* bs = sm + (size_t)C * NS;        // L x NS
    const T* bb = b + ((size_t)bt * T_ + c0) * N;
    const T* cc = c + ((size_t)bt * T_ + c0) * N;
#pragma unroll 8
    for (int idx = tid; idx < L * N; idx += SSM_THREADS) {
        const int i = idx / N, n = idx - (idx / N) * N;
        cs[i * NS + n] = to_f(cc[idx]);
        bs[i * NS + n] = to_f(bb[idx]);
    }
    __syncthreads();
    float acc[SSM_ST][SSM_ST];
#pragma unroll
    for (int r = 0; r < SSM_ST; ++r)
#pragma unroll
        for (int q = 0; q < SSM_ST; ++q) acc[r][q] = 0.f;
#pragma unroll 2
    for (int n = 0; n < N; ++n) {
        float cv[SSM_ST], bv[SSM_ST];
#pragma unroll
        for (int r = 0; r < SSM_ST; ++r) {
            const int i = ti + 16 * r, j = tj + 16 * r;
            cv[r] = i < L ? cs[i * NS + n] : 0.f;
            bv[r] = j < L ? bs[j * NS + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < SSM_ST; ++r)
#pragma unroll
            for (int q = 0; q < SSM_ST; ++q)
                acc[r][q] = fmaf(cv[r], bv[q], acc[r][q]);
    }
    float* Sk = S + ((size_t)bt * chunks + k) * C * C;
#pragma unroll
    for (int r = 0; r < SSM_ST; ++r) {
        const int i = ti + 16 * r;
        if (i >= C) continue;
#pragma unroll
        for (int q = 0; q < SSM_ST; ++q) {
            const int j = tj + 16 * q;
            if (j < C) Sk[i * C + j] = (j <= i && i < L) ? acc[r][q] : 0.f;
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(SSM_THREADS)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ b,
                const T* __restrict__ c, const float* __restrict__ d,
                const float* __restrict__ S, T* __restrict__ y, int T_,
                int H, int P, int N, int C, int Ps, int chunks) {
    const int p0 = blockIdx.x * Ps, head = blockIdx.y, bt = blockIdx.z;
    const int ps = min(Ps, P - p0);         // columns of this CTA
    const int tid = threadIdx.x;
    const int tr = tid / SSM_TC, tc = tid - (tid / SSM_TC) * SSM_TC;
    const int MS = C + 1, NS = N + 1;       // padded row strides
    extern __shared__ float sm[];
    float* M = sm;                          // C x MS decay-weighted scores
    float* BC = M + (size_t)C * MS;         // C x NS: the chunk of c, then b
    // the slice of x and of the state, SSM_MAX_SLICE columns a row (those
    // past the slice's ps are 0, so a tile needs no column test)
    float* X = BC + (size_t)C * NS;         // C x XS
    float* Hs = X + (size_t)C * XS;         // N x XS
    float* cum = Hs + (size_t)N * XS;       // C
    float* dts = cum + C;                   // C
    float* w = dts + C;                     // C: e^{cum[L-1]-cum[j]} dt_j
    const float ah = a[head], dh = d[head];

    for (int i = tid; i < N * XS; i += SSM_THREADS) Hs[i] = 0.f;

    for (int k = 0; k < chunks; ++k) {
        const int c0 = k * C, L = min(C, T_ - c0);
        const size_t r0 = (size_t)bt * T_ + c0;     // first row of the chunk
        for (int j = tid; j < L; j += SSM_THREADS)
            dts[j] = to_f(dt[(r0 + j) * H + head]);
        __syncthreads();
        if (tid == 0) {
            float s = 0.f;
            for (int j = 0; j < L; ++j) {
                s = __fadd_rn(s, __fmul_rn(dts[j], ah));
                cum[j] = s;
            }
        }
#pragma unroll 8
        for (int idx = tid; idx < L * XS; idx += SSM_THREADS) {
            const int j = idx / XS, p = idx - (idx / XS) * XS;
            X[j * XS + p] = p < ps
                ? to_f(x[((r0 + j) * H + head) * P + p0 + p]) : 0.f;
        }
#pragma unroll 8
        for (int idx = tid; idx < L * N; idx += SSM_THREADS) {
            const int j = idx / N, n = idx - (idx / N) * N;
            BC[j * NS + n] = to_f(c[r0 * N + idx]);
        }
        __syncthreads();
        const float* Sk = S + ((size_t)bt * chunks + k) * C * C;
        // M by rows: warp w takes rows w, w + 8, ..., its lanes the
        // columns; the upper triangle is 0 (masked before exp)
        for (int i = tid / 32; i < L; i += SSM_THREADS / 32) {
            const float ci = cum[i];
#pragma unroll 4
            for (int j = tid & 31; j < L; j += 32)
                M[i * MS + j] = j <= i
                    ? __fmul_rn(__fmul_rn(expf(ci - cum[j]), Sk[i * C + j]),
                                dts[j])
                    : 0.f;
        }
        const float cl = cum[L - 1];
        for (int j = tid; j < L; j += SSM_THREADS)
            w[j] = __fmul_rn(expf(cl - cum[j]), dts[j]);
        __syncthreads();

        // outputs of the chunk: intra, cross, skip. Thread (tr, tc) owns
        // rows tr + 32 r and columns tc + 8 q of the slice (a 4 x 4 tile in
        // registers: four M and four X values feed sixteen fmaf). M is 0
        // above the diagonal, so the tile runs j to its last row.
        {
            float acc[SSM_RI][SSM_RP], cr[SSM_RI][SSM_RP];
#pragma unroll
            for (int r = 0; r < SSM_RI; ++r)
#pragma unroll
                for (int q = 0; q < SSM_RP; ++q) acc[r][q] = cr[r][q] = 0.f;
            const int jmax = min(L - 1, tr + SSM_TR * (SSM_RI - 1));
#pragma unroll 4
            for (int j = 0; j <= jmax; ++j) {
                float mv[SSM_RI], xv[SSM_RP];
#pragma unroll
                for (int r = 0; r < SSM_RI; ++r) {
                    const int i = tr + SSM_TR * r;
                    mv[r] = i < L ? M[i * MS + j] : 0.f;
                }
#pragma unroll
                for (int q = 0; q < SSM_RP; ++q) xv[q] = X[j * XS + tc + SSM_TC * q];
#pragma unroll
                for (int r = 0; r < SSM_RI; ++r)
#pragma unroll
                    for (int q = 0; q < SSM_RP; ++q)
                        acc[r][q] = fmaf(mv[r], xv[q], acc[r][q]);
            }
#pragma unroll 4
            for (int n = 0; n < N; ++n) {
                float cv[SSM_RI], hv[SSM_RP];
#pragma unroll
                for (int r = 0; r < SSM_RI; ++r) {
                    const int i = tr + SSM_TR * r;
                    cv[r] = i < L ? BC[i * NS + n] : 0.f;
                }
#pragma unroll
                for (int q = 0; q < SSM_RP; ++q) hv[q] = Hs[n * XS + tc + SSM_TC * q];
#pragma unroll
                for (int r = 0; r < SSM_RI; ++r)
#pragma unroll
                    for (int q = 0; q < SSM_RP; ++q)
                        cr[r][q] = fmaf(cv[r], hv[q], cr[r][q]);
            }
#pragma unroll
            for (int r = 0; r < SSM_RI; ++r) {
                const int i = tr + SSM_TR * r;
                if (i >= L) continue;
                const float ec = expf(cum[i]);
#pragma unroll
                for (int q = 0; q < SSM_RP; ++q) {
                    const int p = tc + SSM_TC * q;
                    if (p >= ps) continue;
                    float o = __fadd_rn(acc[r][q], __fmul_rn(ec, cr[r][q]));
                    o = __fadd_rn(o, __fmul_rn(dh, X[i * XS + p]));
                    y[((r0 + i) * H + head) * P + p0 + p] = from_f<T>(o);
                }
            }
        }
        __syncthreads();

        // the state update, from the chunk of b
#pragma unroll 8
        for (int idx = tid; idx < L * N; idx += SSM_THREADS) {
            const int j = idx / N, n = idx - (idx / N) * N;
            BC[j * NS + n] = to_f(b[r0 * N + idx]);
        }
        __syncthreads();
        const float ecl = expf(cl);
        // thread (tr, tc) owns state rows tr + 32 r and columns tc + 8 q
        {
            float acc[SSM_RN][SSM_RP];
#pragma unroll
            for (int r = 0; r < SSM_RN; ++r)
#pragma unroll
                for (int q = 0; q < SSM_RP; ++q) acc[r][q] = 0.f;
#pragma unroll 4
            for (int j = 0; j < L; ++j) {
                const float wj = w[j];
                float bv[SSM_RN], xv[SSM_RP];
#pragma unroll
                for (int r = 0; r < SSM_RN; ++r) {
                    const int n = tr + SSM_TR * r;
                    bv[r] = n < N ? __fmul_rn(wj, BC[j * NS + n]) : 0.f;
                }
#pragma unroll
                for (int q = 0; q < SSM_RP; ++q) xv[q] = X[j * XS + tc + SSM_TC * q];
#pragma unroll
                for (int r = 0; r < SSM_RN; ++r)
#pragma unroll
                    for (int q = 0; q < SSM_RP; ++q)
                        acc[r][q] = fmaf(bv[r], xv[q], acc[r][q]);
            }
#pragma unroll
            for (int r = 0; r < SSM_RN; ++r) {
                const int n = tr + SSM_TR * r;
                if (n >= N) continue;
#pragma unroll
                for (int q = 0; q < SSM_RP; ++q) {
                    const int p = tc + SSM_TC * q;
                    if (p >= ps) continue;
                    Hs[n * XS + p] = __fadd_rn(__fmul_rn(ecl, Hs[n * XS + p]),
                                               acc[r][q]);
                }
            }
        }
        __syncthreads();
    }
}

// Dynamic shared memory of the scan kernel at chunk C and state N, or of
// the scores kernel (2 C (N + 1) floats) when that is more.
extern "C" int ssm_scan_smem_bytes(int C, int N) {
    const size_t scan = (size_t)C * (C + 1) + (size_t)C * (N + 1)
        + (size_t)C * XS + (size_t)N * XS + 3 * (size_t)C;
    const size_t scores = 2 * (size_t)C * (N + 1);
    return (int)(sizeof(float) * (scan > scores ? scan : scores));
}

// The card's opt-in shared memory per block and the scan kernel's static
// shared memory (the `_build.smem_limit` convention).
extern "C" int ssm_scan_smem(int* optin, int* static_bytes) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, ssd_scan_kernel<float>);
    if (e != cudaSuccess) return (int)e;
    *static_bytes = (int)fa.sharedSizeBytes;
    return 0;
}

template <typename T>
static int launch(const void* x, const void* dt, const float* a,
                  const void* b, const void* c, const float* d, void* y,
                  float* S, int B, int T_, int H, int P, int N, int C, int Ps,
                  cudaStream_t stream) {
    const int chunks = (T_ + C - 1) / C;
    const int smem = ssm_scan_smem_bytes(C, N);     // enough for both
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const int ssmem = (int)(sizeof(float) * 2 * (size_t)C * (N + 1));
    e = cudaFuncSetAttribute(ssd_scores_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ssmem);
    if (e != cudaSuccess) return (int)e;
    ssd_scores_kernel<T><<<dim3(chunks, B), SSM_THREADS, ssmem, stream>>>(
        (const T*)b, (const T*)c, S, T_, N, C, chunks);
    ssd_scan_kernel<T><<<dim3((P + Ps - 1) / Ps, H, B), SSM_THREADS, smem,
                         stream>>>(
        (const T*)x, (const T*)dt, a, (const T*)b, (const T*)c, d, S, (T*)y,
        T_, H, P, N, C, Ps, chunks);
    return (int)cudaGetLastError();
}

// Launches on `stream` (bf16 != 0: bf16 streams, else float32); S holds
// B * ceil(T / C) * C * C floats. Returns the cudaError_t (0 = success).
extern "C" int ssm_scan_launch(const void* x, const void* dt, const float* a,
                               const void* b, const void* c, const float* d,
                               void* y, float* S, int B, int T_, int H, int P,
                               int N, int C, int Ps, int bf16,
                               cudaStream_t stream) {
    if (B <= 0 || T_ <= 0 || H <= 0 || P <= 0) return 0;
    if (C < 1 || C > SSM_MAX_CHUNK || N < 1 || N > SSM_MAX_STATE || Ps < 1
        || Ps > SSM_MAX_SLICE)
        return (int)cudaErrorInvalidValue;
    return bf16 ? launch<__nv_bfloat16>(x, dt, a, b, c, d, y, S, B, T_, H, P,
                                        N, C, Ps, stream)
                : launch<float>(x, dt, a, b, c, d, y, S, B, T_, H, P, N, C,
                                Ps, stream);
}
