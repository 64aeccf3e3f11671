// GQA single-token flash-decode: one query token per sequence against its
// KV cache, out = softmax(q k^T / sqrt(D)) v, with an optional valid length.
//
// Replaces: src/repro/kernels/decode_attn.py:decode_attention
// (`_decode_kernel`). The TPU kernel walks the KV blocks of one sequence in
// order with the online-softmax carry (running max m, normaliser l,
// accumulator acc, all float32) in VMEM scratch. Here the sequence is split
// over CTAs as well, so a long cache fills the card (flash-decode): CTA
// (split, kv head, batch) walks its slice of the positions with its own
// float32 m/l/acc for the G = Hq/Hkv query heads of its kv head; a second
// small kernel merges the splits. With one split the first kernel writes
// the output itself. It computes the function of
// ref.decode_attention(q, k, v, length=) (the TPU kernel is the length=None
// case).
//
// Layout: q (B, Hq, D), k and v (B, S, Hkv, D), out (B, Hq, D), all row-major
// and of one type, float32 or bf16. length is (B,) int32 in device memory
// or null: the decode step can be captured into a CUDA graph and replayed
// with the length it writes on the card. Query head h*G + g reads kv head h.
//
// Bound on the H100: device memory. K and V are read once (2 S Hkv D
// elements per sequence); the arithmetic is 4 G D operations a position,
// about 7 a byte at G = 7 in bf16, far under the tensor cores' ~295.
//
// Two kernels; the wrapper (kernels/decode_attn.py:kernel_for) picks one
// from dtype and shape before the launch.
//
// decode_attn_mma_kernel (bf16, D % 16 == 0, D <= 256, G <= 16, k and v
// 16-byte aligned): the tensor cores, fed by an asynchronous ring of K/V tiles.
// A CTA is one producer warp and four consumer warps. The producer copies
// tiles of DT_TILE positions (K and V) into a ring of 3, 4 or 8 stages in
// shared memory (consumer warp w reads stages w, w + 4; with 3 stages one
// warp idles) by TMA: 2D tensor maps over k and v viewed as (B S, Hkv D),
// encoded on the host per call (cuTensorMapEncodeTiled, looked up with
// cudaGetDriverEntryPoint) and passed as __grid_constant__
// parameters, boxes of 64 rows x W columns (W = 64, 32 or 16, the widest
// that divides D) swizzled over 2W bytes, so that every ldmatrix below is
// free of bank conflicts. A tile is 2 D / W box loads completing on the
// stage's full mbarrier (expect_tx); the consumers release a stage on its
// empty mbarrier. The loop has no block barrier. TMA boxes and not one
// cp.async.bulk per row: a bulk copy per 128-byte row (D = 64) ran no
// faster than the CUDA-core kernel on an H100 SXM (about 0.9 TB/s, one
// copy instruction per 128 bytes). Tiles wholly at or past
// length[b] are not loaded; a partial tile's positions past length are
// loaded and masked (rows past the end of k and v read as zeros).
// Each consumer warp takes whole tiles in turn with its own online-softmax
// state in registers (FlashAttention-2's layout for one query token): the
// G query rows, zero-padded to 16, are the A operand of
// mma.sync.m16n8k16 (bf16 in, float32 sums), the K tile the B operand
// through ldmatrix; the logits are scaled (in log2 units) and masked
// (s >= length -> -inf) in float32; the row max and sum are two
// xor-shuffles over a quad; P is rounded to bf16 and used directly as the
// A operand of the value product, V through ldmatrix.trans. At the end the
// four warps' (m, l, acc) merge through shared memory (the ring, reused
// after a block barrier) and the CTA writes the output or its split's
// [m, l, acc] row; a split wholly past length writes m = -inf, l = 0, which
// the combine skips. Not wgmma: it takes 64 rows and G <= 16 would waste
// three quarters of them; the kernel is bound by bytes, not by the
// mma.sync rate. Rounding: the plain version rounds the logits to bf16 and
// the normalised weights to bf16 before the value product; this kernel
// keeps the logits in float32 and rounds the unnormalised P to bf16 (l sums
// the rounded values). The difference is bounded by the bf16 check's rule
// (rtol 5e-2, atol 5e-2 x the output's rms).
//
// decode_attn_kernel (float32, and bf16 the mma kernel does not take): the
// CUDA cores. A chunk of DA_THREADS positions at a time: thread t takes
// position t and forms its G logits from the key row (16-byte vector
// loads where D allows, q in shared memory read as float4s); the chunk's
// max and sum per head are block reductions; the probabilities go to
// shared memory. The value rows come through shared memory in stages of
// DA_VBYTES (16-byte loads by every thread, all in flight at once), and
// the value product is split as D columns x (DA_THREADS / D) groups of
// positions, each thread keeping its G accumulators in registers, the
// groups summed at the end. Masked positions get the logit -1e30, as the
// models' attention fills them (nn/attention.py). The register arrays are
// as long as the group bound MG (8 or 16), so the common groups of 8 or
// fewer heads run three CTAs a SM. Its costs: four __syncthreads a chunk
// for the block reductions, no chunk's loads overlap the previous chunk's
// arithmetic, and the float32 products stay on the CUDA cores (TF32 would
// miss the float32 tolerance).
#include <cuda.h>
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
// sum_s e^{m_s - M} l_s. One thread per output column. A split with
// m = -inf (wholly past length, from the mma kernel) adds nothing.
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
        if (pr[s * (D + 2)] == -INFINITY) continue;
        const float e = expf(pr[s * (D + 2)] - M);
        L += e * pr[s * (D + 2) + 1];
        o += e * pr[s * (D + 2) + 2 + d];
    }
    out[qrow * D + d] = from_f<T>(o / L);
}

// ---- the tensor-core kernel (bf16) ------------------------------------------

#define DT_TILE 64                       // positions a tile
#define DT_CONSUMERS 4                   // consumer warps
#define DT_THREADS (32 * (DT_CONSUMERS + 1))
#define DT_MIN_STAGES 2
#define DT_MAX_STAGES 8
#define DT_HEAD 128                      // bytes for the 2 x stages mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(bar) : "memory");
}

// Spin until the phase of parity `parity` of the mbarrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

// One box of the 2D tensor map `map` at (column c0, row c1) into shared
// memory at dst, completing on the mbarrier `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier"
                 "::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
                    "r"(c1), "r"(bar)
                 : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr) : "memory");
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
    return *reinterpret_cast<uint32_t*>(&h);
}

// Shared memory: DT_HEAD bytes of mbarriers (full[stages], empty[stages]),
// the 16 query rows at a stride of 2D + 16 bytes, then, from a 1024-byte
// boundary (the 128-byte swizzle's period), `stages` stages of a K tile and
// a V tile, each D / W boxes of DT_TILE rows x W columns as TMA swizzles
// them (kernels/decode_attn.py:mma_layout computes the same).
static size_t mma_smem_bytes(int D, int stages) {
    return DT_HEAD + 16 * (2 * (size_t)D + 16) + 1024
        + (size_t)stages * 2 * DT_TILE * 2 * D;
}

// The box width W of a head dim D: the widest of 64, 32 and 16 columns that
// divides D. A box row is 2W bytes, the span of the swizzle (128, 64 or 32
// bytes), under which the eight rows of an ldmatrix matrix fall in eight
// different bank groups.
static int box_cols(int D) {
    return D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);
}

// DM bounds D (64, 128 or 256): the accumulator is DM / 8 fragments of
// four floats, unrolled, with the columns past D skipped. part as for
// decode_attn_kernel.
template <int DM>
__global__ void __launch_bounds__(DT_THREADS, DM <= 128 ? 2 : 1)
decode_attn_mma_kernel(const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __nv_bfloat16* __restrict__ q,
                  const int* __restrict__ length,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                  int S, int Hq, int Hkv, int D, int W, int split_len,
                  int stages) {
    const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int splits = gridDim.x;
    const int G = Hq / Hkv;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int RS = 2 * D + 16;                  // a query row
    const int box_bytes = DT_TILE * 2 * W;      // one box: 64 rows x W
    const int tile_bytes = DT_TILE * 2 * D;     // a K or V tile: D / W boxes
    const int s_begin = split * split_len;
    const int s_end = min(S, s_begin + split_len);
    const int len = length ? min(length[b], S) : S;
    const int lim = min(s_end, len);        // positions < lim count
    const int ntiles = lim > s_begin ? (lim - s_begin + DT_TILE - 1) / DT_TILE
                                     : 0;

    extern __shared__ __align__(128) unsigned char dsm[];
    uint64_t* bars = reinterpret_cast<uint64_t*>(dsm);
    unsigned char* qs = dsm + DT_HEAD;
    const uint32_t base = smem_u32(dsm);
    const uint32_t ring_u32 = (base + DT_HEAD + 16 * RS + 1023) & ~1023u;
    unsigned char* ring = dsm + (ring_u32 - base);
    if (tid == 0) {
        for (int i = 0; i < 2 * stages; ++i) mbar_init(smem_u32(bars + i), 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    const __nv_bfloat16* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
    for (int i = tid; i < 16 * D; i += DT_THREADS) {
        const int r = i / D, c = i - r * D;
        reinterpret_cast<__nv_bfloat16*>(qs + r * RS)[c] =
            r < G ? qb[r * D + c] : __float2bfloat16_rn(0.f);
    }
    __syncthreads();

    const int g = lane >> 2, t4 = lane & 3;
    float o[DM / 8][4];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < DM / 8; ++j)
        o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

    if (warp == DT_CONSUMERS) {
        // producer: tile i into stage i % stages once its last reader let
        // go; lane j < D / W loads box j of K, lane D / W + j box j of V
        const int nbox = D / W;
        for (int i = 0; i < ntiles; ++i) {
            const int st = i % stages, r = i / stages;
            if (r > 0) mbar_wait(smem_u32(bars + stages + st), (r - 1) & 1);
            const uint32_t full = smem_u32(bars + st);
            if (lane == 0) mbar_expect_tx(full, 2 * tile_bytes);
            __syncwarp();
            if (lane < 2 * nbox) {
                const bool is_k = lane < nbox;
                const int j = is_k ? lane : lane - nbox;
                tma_load_2d(ring_u32 + st * 2 * tile_bytes
                                + (is_k ? 0 : tile_bytes) + j * box_bytes,
                            is_k ? &kmap : &vmap, h * D + j * W,
                            b * S + s_begin + i * DT_TILE, full);
            }
        }
    } else {
        // consumer: the tiles of stages warp, warp + 4, ..., in order. One
        // warp reads each stage, so it waits on the stage's full barrier
        // only after it released the stage's previous round: a parity wait
        // can then not be satisfied by an earlier phase of the same parity.
        const float sl2 = 1.4426950408889634f / sqrtf((float)D);
        const int mi = lane >> 3;
        // ldmatrix row addresses: q (a0..a3 = rows 0-7 / 8-15, columns
        // 0-7 / 8-15 of a k-step), K (b0, b1 of two n-tiles of positions),
        // V (b0, b1 of two n-tiles of columns, transposed)
        const uint32_t q_addr = smem_u32(qs)
            + ((lane & 7) + (mi & 1) * 8) * RS + (mi >> 1) * 16;
        const uint32_t k_row = ((mi >> 1) * 8 + (lane & 7)) * 2 * W;
        const uint32_t v_row = ((mi & 1) * 8 + (lane & 7)) * 2 * W;
        // 16-byte chunk qc of a row (columns 8qc..8qc+7) in the swizzled
        // boxes: box qc / C, chunk qc % C xor'd with the row's key, for
        // C = W / 8 chunks a box row; the key depends on the row mod 8 only
        const int lg = W == 64 ? 3 : (W == 32 ? 2 : 1);     // log2 C
        const int key = ((lane & 7) >> (3 - lg)) & ((1 << lg) - 1);
        auto chunk = [&](int qc) -> uint32_t {
            return (uint32_t)((qc >> lg) * box_bytes
                              + (((qc & ((1 << lg) - 1)) ^ key) << 4));
        };
        for (int i = 0; i < ntiles; ++i) {
            const int st = i % stages, r = i / stages;
            if (st % DT_CONSUMERS != warp) continue;
            mbar_wait(smem_u32(bars + st), r & 1);
            const uint32_t kt = ring_u32 + st * 2 * tile_bytes;
            const uint32_t vt = kt + tile_bytes;
            // logits: 16 query rows x 64 positions, eight n-tiles
            float sc[8][4];
#pragma unroll
            for (int j = 0; j < 8; ++j)
                sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
            for (int ks = 0; ks < DM / 16; ++ks) {
                if (ks < D / 16) {
                    uint32_t a[4];
                    ldsm_x4(q_addr + ks * 32, a);
#pragma unroll
                    for (int jp = 0; jp < 4; ++jp) {
                        uint32_t bb[4];
                        ldsm_x4(kt + jp * 32 * W + k_row
                                    + chunk(2 * ks + (mi & 1)), bb);
                        mma_bf16(sc[2 * jp], a, bb[0], bb[1]);
                        mma_bf16(sc[2 * jp + 1], a, bb[2], bb[3]);
                    }
                }
            }
            // scale to log2 units, mask, and the row maxima over the quad
            const int s0 = s_begin + i * DT_TILE;
            float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const bool ok = s0 + 8 * j + 2 * t4 + e < lim;
                    sc[j][e] = ok ? sc[j][e] * sl2 : -INFINITY;
                    sc[j][2 + e] = ok ? sc[j][2 + e] * sl2 : -INFINITY;
                    mx0 = fmaxf(mx0, sc[j][e]);
                    mx1 = fmaxf(mx1, sc[j][2 + e]);
                }
            }
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
            // the tile holds a valid position, so the new maxima are finite
            const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
            const float al0 = exp2f(m0 - n0), al1 = exp2f(m1 - n1);
            m0 = n0;
            m1 = n1;
            // P in bf16 as the A operand of the value product: k-step kk
            // (positions 16kk..16kk+15) is n-tiles 2kk and 2kk+1
            uint32_t pa[4][4];
            float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const __nv_bfloat162 lo = __floats2bfloat162_rn(
                    exp2f(sc[j][0] - n0), exp2f(sc[j][1] - n0));
                const __nv_bfloat162 hi = __floats2bfloat162_rn(
                    exp2f(sc[j][2] - n1), exp2f(sc[j][3] - n1));
                pa[j >> 1][(j & 1) * 2] = bf16x2_bits(lo);
                pa[j >> 1][(j & 1) * 2 + 1] = bf16x2_bits(hi);
                const float2 fl = __bfloat1622float2(lo);
                const float2 fh = __bfloat1622float2(hi);
                ps0 += fl.x + fl.y;
                ps1 += fh.x + fh.y;
            }
            l0 = l0 * al0 + ps0;
            l1 = l1 * al1 + ps1;
#pragma unroll
            for (int j = 0; j < DM / 8; ++j) {
                o[j][0] *= al0;
                o[j][1] *= al0;
                o[j][2] *= al1;
                o[j][3] *= al1;
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
                for (int dp = 0; dp < DM / 16; ++dp) {
                    if (dp < D / 16) {
                        uint32_t bb[4];
                        ldsm_x4_t(vt + kk * 32 * W + v_row
                                      + chunk(2 * dp + (mi >> 1)), bb);
                        mma_bf16(o[2 * dp], pa[kk], bb[0], bb[1]);
                        mma_bf16(o[2 * dp + 1], pa[kk], bb[2], bb[3]);
                    }
                }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(smem_u32(bars + stages + st));
        }
    }

    // merge the four warps' states through shared memory (the ring, free
    // once every tile is consumed): per warp 16 rows of [m, l, acc[D]]
    __syncthreads();
    float* mrg = reinterpret_cast<float*>(ring);
    const int MW = D + 2;          // a merge row: m, l, acc[D]
    if (warp < DT_CONSUMERS) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        float* r0 = mrg + (warp * 16 + g) * MW;
        float* r1 = r0 + 8 * MW;
        if (t4 == 0) {
            r0[0] = m0; r0[1] = l0;
            r1[0] = m1; r1[1] = l1;
        }
#pragma unroll
        for (int j = 0; j < DM / 8; ++j) {
            if (j < D / 8) {
                const int c = 2 + 8 * j + 2 * t4;
                r0[c] = o[j][0]; r0[c + 1] = o[j][1];
                r1[c] = o[j][2]; r1[c + 1] = o[j][3];
            }
        }
    }
    __syncthreads();
    for (int idx = tid; idx < G * D; idx += DT_THREADS) {
        const int gg = idx / D, d = idx - gg * D;
        float M = -INFINITY;
#pragma unroll
        for (int w = 0; w < DT_CONSUMERS; ++w)
            M = fmaxf(M, mrg[(w * 16 + gg) * MW]);
        float L = 0.f, A = 0.f;
#pragma unroll
        for (int w = 0; w < DT_CONSUMERS; ++w) {
            const float* rw = mrg + (w * 16 + gg) * MW;
            if (rw[0] == -INFINITY) continue;   // the warp took no tile
            const float e = exp2f(rw[0] - M);
            L += e * rw[1];
            A += e * rw[2 + d];
        }
        const size_t qrow = (size_t)b * Hq + (size_t)h * G + gg;
        if (splits == 1) {
            out[qrow * D + d] = __float2bfloat16_rn(A / L);
        } else {
            float* pr = part + (qrow * splits + split) * (D + 2);
            if (d == 0) {
                // the combine's m is in natural-log units
                pr[0] = M == -INFINITY ? -INFINITY : M * 0.6931471805599453f;
                pr[1] = L;
            }
            pr[2 + d] = A;
        }
    }
}

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so that the
// library links nothing beyond it.
static EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult res;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                    cudaEnableDefault, &res) == cudaSuccess
            && res == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// The 2D map of k or v viewed as (B S rows, Hkv D columns): boxes of
// DT_TILE rows x W columns, swizzled over 2W bytes; rows past B S read as 0.
static int kv_map(CUtensorMap* m, const void* base, long long rows, int cols,
                  int W) {
    const EncodeTiledFn enc = encode_tiled();
    if (!enc) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
    const cuuint32_t box[2] = {(cuuint32_t)W, DT_TILE};
    const cuuint32_t step[2] = {1, 1};
    const CUtensorMapSwizzle sw = W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
        : (W == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
    return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
               dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
        ? 0 : (int)cudaErrorInvalidValue;
}

template <int DM>
static int launch_mma(const void* q, const void* k, const void* v,
                      const int* length, void* out, float* part, int B, int S,
                      int Hq, int Hkv, int D, int splits, int split_len,
                      int stages, cudaStream_t stream) {
    const int W = box_cols(D);
    CUtensorMap km, vm;
    int err = kv_map(&km, k, (long long)B * S, Hkv * D, W);
    if (err) return err;
    err = kv_map(&vm, v, (long long)B * S, Hkv * D, W);
    if (err) return err;
    // the kernel's shared-memory limit, raised once per device as far as
    // a launch needs
    const size_t smem = mma_smem_bytes(D, stages);
    static size_t smem_set[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (smem > smem_set[dev]) {
        e = cudaFuncSetAttribute(decode_attn_mma_kernel<DM>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_set[dev] = smem;
    }
    decode_attn_mma_kernel<DM>
        <<<dim3(splits, Hkv, B), DT_THREADS, smem, stream>>>(
        km, vm, (const __nv_bfloat16*)q, length, (__nv_bfloat16*)out, part, S,
        Hq, Hkv, D, W, split_len, stages);
    if (splits > 1)
        decode_combine_kernel<__nv_bfloat16><<<dim3(Hq, B), D, 0, stream>>>(
            part, (__nv_bfloat16*)out, Hq, D, splits);
    return (int)cudaGetLastError();
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

// The tensor-core kernel on `stream`: bf16 q, k, v with D % 16 == 0,
// D <= 256, Hq / Hkv <= 16, k and v 16-byte aligned, `stages` stages of the
// K/V ring (kernels/decode_attn.py:mma_layout); `part` as for
// decode_attn_launch. Returns the cudaError_t of the launches (0 = success).
extern "C" int decode_attn_mma_launch(const void* q, const void* k,
                                      const void* v, const int* length,
                                      void* out, float* part, int B, int S,
                                      int Hq, int Hkv, int D, int splits,
                                      int split_len, int stages,
                                      cudaStream_t stream) {
    if (B <= 0 || Hq <= 0) return 0;
    if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > 16 || D <= 0 || D % 16
        || D > DA_MAX_D || S <= 0 || splits <= 0
        || (size_t)(splits - 1) * split_len >= (size_t)S
        || stages < DT_MIN_STAGES || stages > DT_MAX_STAGES)
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)k % 16 || (uintptr_t)v % 16)
        return (int)cudaErrorMisalignedAddress;
    if ((long long)B * S >= (1LL << 31))     // TMA's row coordinate
        return (int)cudaErrorInvalidValue;
    if (D <= 64)
        return launch_mma<64>(q, k, v, length, out, part, B, S, Hq, Hkv, D,
                              splits, split_len, stages, stream);
    if (D <= 128)
        return launch_mma<128>(q, k, v, length, out, part, B, S, Hq, Hkv, D,
                               splits, split_len, stages, stream);
    return launch_mma<256>(q, k, v, length, out, part, B, S, Hq, Hkv, D,
                           splits, split_len, stages, stream);
}
