// GQA single-token flash-decode: one query token per sequence against its
// KV cache, out = softmax(q k^T / sqrt(D)) v, with an optional valid length.
//
// Replaces: src/repro/kernels/decode_attn.py:decode_attention
// (`_decode_kernel`). The TPU kernel walks the KV blocks of one sequence in
// order with the online-softmax carry (running max m, normaliser l,
// accumulator acc, all float32) in VMEM scratch. Here the sequence is split
// over CTAs as well, so a long cache fills the card (flash-decode): CTA
// (split, kv head, batch) walks its slice of the positions with its own
// float32 m/l/acc in registers and shared memory for the G = Hq/Hkv query
// heads of its kv head; a second small kernel merges the splits. With one
// split the first kernel writes the output itself. It computes the function
// of ref.decode_attention(q, k, v, length=) (the TPU kernel is the
// length=None case): masked positions s >= length[b] get the logit -1e30,
// as the models' attention fills them (nn/attention.py).
//
// Layout: q (B, Hq, D), k and v (B, S, Hkv, D), out (B, Hq, D), all row-major
// and of one type, float32 or bf16 (read as float32, the output rounded
// once). length is (B,) int32 in device memory or null: the decode step can
// be captured into a CUDA graph and replayed with the length it writes on
// the card. Query head h*G + g reads kv head h.
//
// Bound on the H100: device memory. K and V are read once (2 S Hkv D
// elements per sequence); the arithmetic is 4 G D operations a position.
//
// Design, simple first. A chunk of DA_THREADS positions at a time: thread t
// takes position t and forms its G logits from the key row (16-byte vector
// loads where D allows, q in shared memory read as float4s); the chunk's
// max and sum per head are block reductions; the probabilities go to
// shared memory. The value rows come through shared memory in stages of
// DA_VBYTES (16-byte loads by every thread, all in flight at once), and
// the value product is split as D columns x (DA_THREADS / D) groups of
// positions, each thread keeping its G accumulators in registers, the
// groups summed at the end.
// The register arrays are as long as the group bound MG (8 or 16), so the
// common groups of 8 or fewer heads run three CTAs a SM. Known costs, for
// later work: the block reductions cost four __syncthreads a chunk, the
// key rows are read a row a thread (staging them through shared memory
// gained nothing), no chunk's loads overlap the previous chunk's
// arithmetic, and the tensor cores are not used.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define DA_THREADS 256
#define DA_WARPS (DA_THREADS / 32)
#define DA_MAX_G 16
#define DA_MAX_D 256
#define DA_NEG (-1e30f)
#define DA_VBYTES 16384     // shared memory for one stage of value rows

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

// 16 bytes of a row as float32.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
    static constexpr int N = 4;
    __device__ static void load(const float* p, float* o) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p));
        o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
    }
};
template <> struct Vec16<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ static void load(const __nv_bfloat16* p, float* o) {
        const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            o[2 * i] = f.x;
            o[2 * i + 1] = f.y;
        }
    }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// The G dot products of one key row with the query rows qs (G x D, float32).
template <typename T, bool VEC, int MG>
__device__ __forceinline__ void row_dots(const T* __restrict__ krow,
                                         const float* qs, int D, int G,
                                         float (&lg)[MG]) {
#pragma unroll
    for (int g = 0; g < MG; ++g) lg[g] = 0.f;
    if (VEC) {
        // q in float4s (D % 4 == 0 here): one shared-memory load, the same
        // address for the whole warp, feeds four fmaf
        constexpr int V = Vec16<T>::N;
#pragma unroll 2
        for (int d0 = 0; d0 < D; d0 += V) {
            float kf[V];
            Vec16<T>::load(krow + d0, kf);
#pragma unroll
            for (int g = 0; g < MG; ++g) {
                if (g < G) {
#pragma unroll
                    for (int e = 0; e < V; e += 4) {
                        const float4 q4 = *reinterpret_cast<const float4*>(
                            qs + g * D + d0 + e);
                        lg[g] = fmaf(q4.x, kf[e], lg[g]);
                        lg[g] = fmaf(q4.y, kf[e + 1], lg[g]);
                        lg[g] = fmaf(q4.z, kf[e + 2], lg[g]);
                        lg[g] = fmaf(q4.w, kf[e + 3], lg[g]);
                    }
                }
            }
        }
    } else {
        for (int d0 = 0; d0 < D; ++d0) {
            const float kf = to_f(krow[d0]);
#pragma unroll
            for (int g = 0; g < MG; ++g)
                if (g < G) lg[g] = fmaf(qs[g * D + d0], kf, lg[g]);
        }
    }
}

// part: per (b, query head, split) the row [m, l, acc[0..D-1]] when there is
// more than one split. MG bounds G (8 or DA_MAX_G): the register arrays are
// MG long, so groups of 8 or fewer run three CTAs a SM.
template <typename T, bool VEC, int MG>
__global__ void __launch_bounds__(DA_THREADS, MG <= 8 ? 3 : 2)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ length,
                   T* __restrict__ out, float* __restrict__ part, int S,
                   int Hq, int Hkv, int D, int split_len) {
    const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int splits = gridDim.x;
    const int G = Hq / Hkv;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int s_begin = split * split_len;
    const int s_end = min(S, s_begin + split_len);
    const int len = length ? length[b] : S;

    extern __shared__ float smem[];
    float* qs = smem;                       // G x D
    const int GP = (G + 3) & ~3;            // G rounded up to float4s
    float* P = qs + G * D;                  // DA_THREADS x GP probabilities
    float* red = P + GP * DA_THREADS;       // DA_WARPS x G partials
    float* stat = red + DA_WARPS * G;       // G chunk maxima, G chunk sums
    // a stage of value rows, 16-byte aligned after the float arrays
    T* Vs = reinterpret_cast<T*>(
        smem + ((G * D + GP * DA_THREADS + DA_WARPS * G + 2 * G + 3) & ~3));
    const int VS = max(1, min(DA_THREADS, DA_VBYTES / (D * (int)sizeof(T))));

    const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
    for (int i = tid; i < G * D; i += DA_THREADS) qs[i] = to_f(qb[i]);
    __syncthreads();

    const size_t row = (size_t)Hkv * D;     // elements between positions
    const T* kb = k + (size_t)b * S * row + (size_t)h * D;
    const T* vb = v + (size_t)b * S * row + (size_t)h * D;
    const float sd = sqrtf((float)D);
    const int NG = DA_THREADS / D;          // groups of positions (values)
    const int grp = tid / D, dd = tid - (tid / D) * D;
    const bool vact = grp < NG;

    float acc[MG], m_run[MG], l_run[MG];
#pragma unroll
    for (int g = 0; g < MG; ++g) {
        acc[g] = 0.f;
        m_run[g] = -INFINITY;
        l_run[g] = 0.f;
    }

    for (int c0 = s_begin; c0 < s_end; c0 += DA_THREADS) {
        const int s = c0 + tid;
        const bool valid = s < s_end;
        float lg[MG];
        if (valid) {
            row_dots<T, VEC, MG>(kb + (size_t)s * row, qs, D, G, lg);
            const bool keep = s < len;
#pragma unroll
            for (int g = 0; g < MG; ++g)
                lg[g] = keep ? lg[g] / sd : DA_NEG;
        }
        // the chunk's max per head
#pragma unroll
        for (int g = 0; g < MG; ++g) {
            if (g < G) {
                const float mv = warp_max(valid ? lg[g] : -INFINITY);
                if (lane == 0) red[warp * G + g] = mv;
            }
        }
        __syncthreads();
        if (tid < G) {
            float mv = -INFINITY;
            for (int w = 0; w < DA_WARPS; ++w) mv = fmaxf(mv, red[w * G + tid]);
            stat[tid] = mv;
        }
        __syncthreads();
        // probabilities against the new running max, and their sum per head
#pragma unroll
        for (int g = 0; g < MG; ++g) {
            if (g < G) {
                const float m_new = fmaxf(m_run[g], stat[g]);
                const float p = valid ? expf(lg[g] - m_new) : 0.f;
                P[tid * GP + g] = p;
                const float ps = warp_sum(p);
                if (lane == 0) red[warp * G + g] = ps;
            } else if (g < GP) {
                P[tid * GP + g] = 0.f;      // the float4 reads' padding
            }
        }
        __syncthreads();
        if (tid < G) {
            float sum = 0.f;
            for (int w = 0; w < DA_WARPS; ++w) sum += red[w * G + tid];
            stat[G + tid] = sum;
        }
        __syncthreads();
#pragma unroll
        for (int g = 0; g < MG; ++g) {
            if (g < G) {
                const float m_new = fmaxf(m_run[g], stat[g]);
                const float alpha = expf(m_run[g] - m_new);
                l_run[g] = l_run[g] * alpha + stat[G + g];
                m_run[g] = m_new;
                acc[g] *= alpha;
            }
        }
        // the value rows of the chunk, a stage of VS rows at a time through
        // shared memory (16-byte loads, all issued before they are used)
        const int nv = min(DA_THREADS, s_end - c0);
        for (int t0 = 0; t0 < nv; t0 += VS) {
            const int ns = min(VS, nv - t0);
            if (VEC) {
                constexpr int E = Vec16<T>::N;
                const int per = D / E;
                for (int idx = tid; idx < ns * per; idx += DA_THREADS) {
                    const int t = idx / per, e = idx - (idx / per) * per;
                    reinterpret_cast<uint4*>(Vs)[idx] = __ldg(
                        reinterpret_cast<const uint4*>(
                            vb + (size_t)(c0 + t0 + t) * row) + e);
                }
            } else {
                for (int idx = tid; idx < ns * D; idx += DA_THREADS) {
                    const int t = idx / D, e = idx - (idx / D) * D;
                    Vs[idx] = vb[(size_t)(c0 + t0 + t) * row + e];
                }
            }
            __syncthreads();
            if (vact) {
#pragma unroll 4
                for (int t = grp; t < ns; t += NG) {
                    const float vv = to_f(Vs[t * D + dd]);
                    const float* pt = P + (t0 + t) * GP;
#pragma unroll
                    for (int g4 = 0; g4 < MG; g4 += 4) {
                        if (g4 < G) {
                            const float4 p4 =
                                *reinterpret_cast<const float4*>(pt + g4);
                            acc[g4] = fmaf(p4.x, vv, acc[g4]);
                            acc[g4 + 1] = fmaf(p4.y, vv, acc[g4 + 1]);
                            acc[g4 + 2] = fmaf(p4.z, vv, acc[g4 + 2]);
                            acc[g4 + 3] = fmaf(p4.w, vv, acc[g4 + 3]);
                        }
                    }
                }
            }
            __syncthreads();    // Vs is rewritten by the next stage
        }
        __syncthreads();    // P, red and stat are rewritten by the next chunk
    }

    // sum the groups' accumulators (P is free now: NG * D <= DA_THREADS)
    if (vact) {
#pragma unroll
        for (int g = 0; g < MG; ++g)
            if (g < G) P[(grp * G + g) * D + dd] = acc[g];
    }
    __syncthreads();
    if (tid < D) {
        for (int g = 0; g < G; ++g) {
            float a = 0.f;
            for (int j = 0; j < NG; ++j) a += P[(j * G + g) * D + tid];
            const size_t qrow = (size_t)b * Hq + (size_t)h * G + g;
            float lv = 0.f, mv = 0.f;
#pragma unroll
            for (int gg = 0; gg < MG; ++gg)
                if (gg == g) { lv = l_run[gg]; mv = m_run[gg]; }
            if (splits == 1) {
                out[qrow * D + tid] = from_f<T>(a / lv);
            } else {
                float* pr = part + (qrow * splits + split) * (D + 2);
                if (tid == 0) { pr[0] = mv; pr[1] = lv; }
                pr[2 + tid] = a;
            }
        }
    }
}

// Merge the splits of one (b, query head): out = sum_s e^{m_s - M} acc_s /
// sum_s e^{m_s - M} l_s. One thread per output column.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part,
                                      T* __restrict__ out, int Hq, int D,
                                      int splits) {
    const size_t qrow = (size_t)blockIdx.y * Hq + blockIdx.x;
    const float* pr = part + qrow * splits * (D + 2);
    const int d = threadIdx.x;
    float M = -INFINITY;
    for (int s = 0; s < splits; ++s) M = fmaxf(M, pr[s * (D + 2)]);
    float L = 0.f, o = 0.f;
    for (int s = 0; s < splits; ++s) {
        const float e = expf(pr[s * (D + 2)] - M);
        L += e * pr[s * (D + 2) + 1];
        o += e * pr[s * (D + 2) + 2 + d];
    }
    out[qrow * D + d] = from_f<T>(o / L);
}

static size_t smem_bytes(int G, int D) {
    const size_t GP = (size_t)((G + 3) & ~3);
    const size_t floats = (size_t)G * D + GP * DA_THREADS
        + (size_t)DA_WARPS * G + 2 * (size_t)G;
    return sizeof(float) * ((floats + 3) & ~(size_t)3) + DA_VBYTES;
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const int* length, void* out, float* part, int B, int S,
                  int Hq, int Hkv, int D, int splits, int split_len,
                  cudaStream_t stream) {
    const int G = Hq / Hkv;
    const dim3 grid(splits, Hkv, B);
    const size_t smem = smem_bytes(G, D);
    const bool vec = D % Vec16<T>::N == 0
        && ((uintptr_t)k % 16 == 0) && ((uintptr_t)v % 16 == 0);
#define DA_LAUNCH(V, MG)                                                 \
    decode_attn_kernel<T, V, MG><<<grid, DA_THREADS, smem, stream>>>(    \
        (const T*)q, (const T*)k, (const T*)v, length, (T*)out, part, S,  \
        Hq, Hkv, D, split_len)
    if (G <= 8) {
        if (vec) DA_LAUNCH(true, 8); else DA_LAUNCH(false, 8);
    } else {
        if (vec) DA_LAUNCH(true, DA_MAX_G); else DA_LAUNCH(false, DA_MAX_G);
    }
#undef DA_LAUNCH
    if (splits > 1)
        decode_combine_kernel<T><<<dim3(Hq, B), D, 0, stream>>>(
            part, (T*)out, Hq, D, splits);
    return (int)cudaGetLastError();
}

// Launches on `stream` (bf16 != 0: bf16 tensors, else float32); `part` holds
// B * Hq * splits * (D + 2) floats when splits > 1. Needs Hq % Hkv == 0,
// Hq / Hkv <= DA_MAX_G, D <= DA_MAX_D and every split non-empty. Returns the
// cudaError_t of the launches (0 = success).
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const int* length, void* out, float* part,
                                  int B, int S, int Hq, int Hkv, int D,
                                  int splits, int split_len, int bf16,
                                  cudaStream_t stream) {
    if (B <= 0 || Hq <= 0) return 0;
    if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > DA_MAX_G || D <= 0 || D > DA_MAX_D
        || S <= 0 || splits <= 0 || (size_t)(splits - 1) * split_len >= (size_t)S)
        return (int)cudaErrorInvalidValue;
    return bf16 ? launch<__nv_bfloat16>(q, k, v, length, out, part, B, S, Hq,
                                        Hkv, D, splits, split_len, stream)
                : launch<float>(q, k, v, length, out, part, B, S, Hq, Hkv, D,
                                splits, split_len, stream);
}
