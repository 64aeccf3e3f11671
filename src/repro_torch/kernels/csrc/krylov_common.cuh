// Helpers shared by the cooperative Krylov kernels (cg_fused.cu,
// bicgstab_fused.cu, gmres_cycle_fused.cu): the zero-guarded division, the
// ELL row products, the grid-wide reduction rounds in one fixed order, and
// the capacity queries and launch of a cooperative kernel.
//
// A reduction round sums up to KRY_WARPS values over the whole grid:
// every thread adds its rows' terms for each value, each warp sums its
// threads (a butterfly), warp v sums value v over the block's warps and
// publishes the block's partial; warp v of every CTA then sums the g
// partials of value v in the same order (lane-strided, then a butterfly).
// So every CTA holds the same sums, and a run repeats bit for bit: no
// float atomics anywhere. The round is tagged_round, one trip through L2.
// A launch's words hold kValues values a round (KRY_TAG_VALUES = 2 in
// bicgstab_fused.cu, KRY_WARPS = 32 for the projections of
// gmres_cycle_fused.cu and for cg_fused.cu, one value a right-hand side). Warp v writes the partial as one 64-bit word
// {value, round} with a release at gpu scope (after a block barrier, so it
// also releases the block's earlier writes to device memory), and polls
// the g words of value v with acquire loads, every lane's words in flight
// at once, until every tag is the round (relaxed loads and one acquire
// fence after them were slower on an H100). Rounds are numbered 1, 2, ...
// within a launch, and round k uses the words of parity k & 1: a CTA
// writes round k + 2 only after it has read every partial of round k + 1,
// which no CTA writes before it has read all of round k, so no word is
// overwritten while a CTA may still read it. A word of a value that the
// round before did not sum holds an older round's tag, which is never
// taken. The launch zeroes the words first (kry_zero_tags,
// stream-ordered, so a captured graph replays it too): a tag left by an
// earlier launch is never taken either.
#pragma once
#include <cuda_runtime.h>

#define KRY_THREADS 1024
#define KRY_WARPS (KRY_THREADS / 32)

// a / b, or 0 when b is 0 or NaN (the plain version's _safe_div).
__device__ __forceinline__ float safe_div(float a, float b) {
    return fabsf(b) > 0.f ? __fdiv_rn(a, b) : 0.f;
}

// Sum over a warp by a butterfly: every lane ends with the same value.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// Sums over a warp of LB values a thread (v, LB a power of two <= 32), by
// recursive halving: at xor partner o = 16, 8, ... a thread keeps the half
// of its values that bit o of its lane selects and adds its partner's copy
// of that half; once one value is left, butterfly steps finish it. Every
// value's sum is warp_sum's bit for bit: each step adds the same two
// partial sums as the butterfly does (in the other order, and a + b is
// b + a). Returns the sum of value lane / (32 / LB), which lanes
// (32 / LB) l ... (32 / LB)(l + 1) - 1 all hold. v is left clobbered.
template <int M>
__device__ __forceinline__ void halve_values(float* v, int o) {
    const bool upper = (threadIdx.x & o) != 0;
#pragma unroll
    for (int j = 0; j < M / 2; ++j) {
        const float keep = upper ? v[M / 2 + j] : v[j];
        const float give = upper ? v[j] : v[M / 2 + j];
        v[j] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, give, o));
    }
}

template <int LB>
__device__ __forceinline__ float warp_sums(float (&v)[LB]) {
    static_assert(LB >= 1 && LB <= 32 && (LB & (LB - 1)) == 0,
                  "LB: a power of two up to 32");
    if constexpr (LB >= 2) halve_values<LB>(v, 16);
    if constexpr (LB >= 4) halve_values<LB / 2>(v, 8);
    if constexpr (LB >= 8) halve_values<LB / 4>(v, 4);
    if constexpr (LB >= 16) halve_values<LB / 8>(v, 2);
    if constexpr (LB >= 32) halve_values<LB / 16>(v, 1);
    float s = v[0];
#pragma unroll
    for (int o = 16 / LB; o > 0; o >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    return s;
}

// One thread's term of value `slot`: summed over the warp, kept per warp in
// warp_part[slot * KRY_WARPS + warp]. Every thread of the block calls it.
__device__ __forceinline__ void warp_partial(float v, int slot,
                                             float* warp_part) {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) warp_part[slot * KRY_WARPS + (threadIdx.x >> 5)] = v;
}

// -- the tagged all-reduce ----------------------------------------------------

// Built with -DKRY_PROFILE, thread 0 of every CTA sums the clock cycles of
// the fused Krylov kernels by phase: 0 the work between rounds outside the
// SpMVs and projections (forming p, s or v and its block barrier, the
// updates), in each tagged round 1 its first block barrier and the block's
// partial, 2 the release of the tagged word, 3 polling until every tag has
// come, 4 the sum and the last block barrier; 5 the SpMVs (thread 0's
// rows); 6 GMRES's projections (one pass over the rows and the warps'
// sums); <kernel>_profile reads and clears the sums.
#ifdef KRY_PROFILE
#define KRY_PHASES 7
__device__ unsigned long long kry_cycles[KRY_PHASES];
__device__ __forceinline__ long long* kry_prof() {
    __shared__ long long p[KRY_PHASES + 1];   // the sums, then the last mark
    return p;
}
#define KRY_MARK(kind)                                               \
    do {                                                             \
        if (threadIdx.x == 0) {                                      \
            long long* p_ = kry_prof();                              \
            const long long t_ = clock64();                          \
            if ((kind) >= 0)                                         \
                p_[(kind)] += t_ - p_[KRY_PHASES];                   \
            else                                                     \
                for (int i_ = 0; i_ < KRY_PHASES; ++i_) p_[i_] = 0;  \
            p_[KRY_PHASES] = t_;                                     \
        }                                                            \
    } while (0)
#define KRY_PROF_END()                                                   \
    do {                                                                 \
        if (threadIdx.x == 0)                                            \
            for (int i_ = 0; i_ < KRY_PHASES; ++i_)                      \
                atomicAdd(&kry_cycles[i_],                               \
                          (unsigned long long)kry_prof()[i_]);           \
    } while (0)
// The sums since the last call into out[0, KRY_PHASES), then cleared.
static int kry_profile(unsigned long long* out) {
    cudaError_t e = cudaMemcpyFromSymbol(out, kry_cycles, sizeof(kry_cycles));
    if (e != cudaSuccess) return (int)e;
    const unsigned long long zero[KRY_PHASES] = {};
    return (int)cudaMemcpyToSymbol(kry_cycles, zero, sizeof(zero));
}
#else
#define KRY_MARK(kind) do {} while (0)
#define KRY_PROF_END() do {} while (0)
#endif

#define KRY_TAG_VALUES 2                  // BiCGStab's values a round
#define KRY_MAX_GRID 160                  // CTAs a tagged round polls at most
#define KRY_POLL (KRY_MAX_GRID / 32)      // words a lane polls at most
#define KRY_WAIT_CYCLES (1LL << 34)       // a round waited for this long traps

// Bytes of the tag words of a launch on g CTAs whose rounds sum up to
// `values` values: two parities of values x g words.
static size_t kry_tag_bytes(int g, int values = KRY_TAG_VALUES) {
    return sizeof(unsigned long long) * 2 * (size_t)values * (size_t)g;
}

__device__ __forceinline__ void st_release_gpu(unsigned long long* p,
                                               unsigned long long v) {
    asm volatile("st.release.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
}

__device__ __forceinline__ void st_relaxed_gpu(unsigned long long* p,
                                               unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire_gpu(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.gpu.global.b64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

// Round `rnd` (>= 1) of values [0, nv) over the grid, nv <= kValues (the
// values of the launch's tag words): the block's partials (from the warps'
// in warp_part) published as tagged words, then the grid's sums into
// sums[0, nv), the same in every CTA and visible to the whole block. Every
// thread of the block calls it after its warp_partial calls and its writes
// to device memory that the round publishes. A round with kRelease false
// stores its words relaxed, with no fence: it carries its sums and orders
// nothing else, so it publishes no write to device memory (its polls still
// acquire, which orders the reuse of the words two rounds on).
template <int kValues = KRY_TAG_VALUES, bool kRelease = true>
__device__ __forceinline__ void tagged_round(int nv, const float* warp_part,
                                             unsigned long long* tags, int g,
                                             unsigned rnd, float* sums) {
    KRY_MARK(0);
    __syncthreads();
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (w < nv) {
        unsigned long long* words =
            tags + ((size_t)(rnd & 1) * kValues + w) * g;
        const float part = warp_sum(warp_part[w * KRY_WARPS + lane]);
        const unsigned long long tag = (unsigned long long)rnd << 32;
        KRY_MARK(1);
        if (lane == 0) {
            if constexpr (kRelease)
                st_release_gpu(words + blockIdx.x, tag | __float_as_uint(part));
            else
                st_relaxed_gpu(words + blockIdx.x, tag | __float_as_uint(part));
        }
        KRY_MARK(2);
        unsigned long long got[KRY_POLL];
#pragma unroll
        for (int j = 0; j < KRY_POLL; ++j)
            got[j] = lane + 32 * j < g ? ld_acquire_gpu(words + lane + 32 * j)
                                       : tag;
        for (long long start = 0;;) {
            bool ready = true;
#pragma unroll
            for (int j = 0; j < KRY_POLL; ++j)
                ready = ready && (got[j] >> 32) == rnd;
            if (__all_sync(0xffffffffu, ready)) break;
            if (start == 0)
                start = clock64();
            else if (clock64() - start > KRY_WAIT_CYCLES)
                __trap();   // a CTA never came: fail, do not hang the card
#pragma unroll
            for (int j = 0; j < KRY_POLL; ++j)
                if ((got[j] >> 32) != rnd)
                    got[j] = ld_acquire_gpu(words + lane + 32 * j);
        }
        KRY_MARK(3);
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < KRY_POLL; ++j)
            if (lane + 32 * j < g)
                t = __fadd_rn(t, __uint_as_float((unsigned)got[j]));
        t = warp_sum(t);
        if (lane == 0) sums[w] = t;
    }
    __syncthreads();
    KRY_MARK(4);
}

// Zeroes the tag words of a launch on `stream` before it; returns the
// cudaError_t (also for a grid wider than a round polls).
static int kry_zero_tags(unsigned long long* tags, int grid,
                         cudaStream_t stream, int values = KRY_TAG_VALUES) {
    if (grid > KRY_MAX_GRID) return (int)cudaErrorInvalidConfiguration;
    return (int)cudaMemsetAsync(tags, 0, kry_tag_bytes(grid, values), stream);
}

// -- SpMV rows with the operand formed at the gather -------------------------
//
// An operand Q gives the value of the vector at column c: Q::mine(c) for
// the CTA's own rows (read from shared memory by Q::value), otherwise
// Q::load issues the loads of device memory it is formed from (into a
// Q::Raw) and Q::value forms it, in the plain version's rounding.

// The K slots at a, c (slot j at j * stride) times q: every column (and,
// from device memory, every value) loaded first, then every gather issued,
// then the sum in slot order, each product rounded before its add.
// kGlobal: a, c in device memory (read-only path), else in shared memory,
// whose values are read at the sum: fewer registers live at once, where a
// 1024-thread CTA has 64 a thread (loaded early, BiCGStab's spilled).
template <int K, bool kGlobal, class Q>
__device__ __forceinline__ float slots_times(const float* a, const int* c,
                                             size_t stride, const Q& q) {
    int col[K];
    float av[K];
    typename Q::Raw raw[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
        if constexpr (kGlobal) col[j] = __ldg(c + j * stride);
        else col[j] = c[j * stride];
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
        if constexpr (kGlobal) av[j] = __ldg(a + j * stride);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) q.load(col[j], raw[j]);
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
        if constexpr (!kGlobal) av[j] = a[j * stride];
        acc = __fadd_rn(acc, __fmul_rn(av[j], q.value(col[j], raw[j])));
    }
    return acc;
}

// Row li of the CTA's range of A times operand q, as ell_row below: rows
// below `ca` from the slot-major copy in shared memory, the rest streamed.
// K = 5 (the 2D five-point matrices of the main cells) has every slot's
// loads in flight at once; any other K walks its slots in turn.
template <class Q>
__device__ __forceinline__ float ell_row_q(int li, int row, int ca,
                                           int ca_max, int k, const float* ad,
                                           const int* ac,
                                           const float* __restrict__ data,
                                           const int* __restrict__ cols,
                                           const Q& q) {
    if (k == 5) {
        if (li < ca) return slots_times<5, false>(ad + li, ac + li, ca_max, q);
        return slots_times<5, true>(data + (size_t)row * 5,
                                    cols + (size_t)row * 5, 1, q);
    }
    float acc = 0.f;
    typename Q::Raw raw;
    if (li < ca) {
        for (int j = 0; j < k; ++j) {
            const int c = ac[(size_t)j * ca_max + li];
            q.load(c, raw);
            acc = __fadd_rn(acc, __fmul_rn(ad[(size_t)j * ca_max + li],
                                           q.value(c, raw)));
        }
    } else {
        const size_t base = (size_t)row * k;
        for (int j = 0; j < k; ++j) {
            const int c = __ldg(cols + base + j);
            q.load(c, raw);
            acc = __fadd_rn(acc, __fmul_rn(__ldg(data + base + j),
                                           q.value(c, raw)));
        }
    }
    return acc;
}

// Row li of the CTA's range of A times q (slots in slot order, each product
// rounded before its add: the plain version's order). Rows below `ca` come
// from the slot-major copy in shared memory (ad, ac with row stride
// ca_max), the rest from device memory; q is gathered through L2.
__device__ __forceinline__ float ell_row(int li, int row, int ca, int ca_max,
                                         int k, const float* ad, const int* ac,
                                         const float* __restrict__ data,
                                         const int* __restrict__ cols,
                                         const float* q) {
    float acc = 0.f;
    if (li < ca) {
        for (int j = 0; j < k; ++j)
            acc = __fadd_rn(acc, __fmul_rn(ad[(size_t)j * ca_max + li],
                                           __ldcg(q + ac[(size_t)j * ca_max + li])));
    } else {
        const size_t base = (size_t)row * k;
        for (int j = 0; j < k; ++j)
            acc = __fadd_rn(acc, __fmul_rn(__ldg(data + base + j),
                                           __ldcg(q + __ldg(cols + base + j))));
    }
    return acc;
}

// The leading `ca` rows of the CTA's range [r0, ...) of A into shared memory,
// slot-major (neighbouring threads read neighbouring banks).
__device__ __forceinline__ void cache_rows(int r0, int ca, int ca_max, int k,
                                           const float* __restrict__ data,
                                           const int* __restrict__ cols,
                                           float* ad, int* ac) {
    for (int e = threadIdx.x; e < ca * k; e += KRY_THREADS) {
        const int li = e / k, j = e - li * k;
        ad[(size_t)j * ca_max + li] = __ldg(data + (size_t)(r0 + li) * k + j);
        ac[(size_t)j * ca_max + li] = __ldg(cols + (size_t)(r0 + li) * k + j);
    }
}

// The card's opt-in shared memory per block and a kernel's static shared
// memory; the wrapper gives the rest to the kernel's dynamic layout.
static int kry_smem(const void* f, int* optin, int* static_bytes) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, f);
    if (e != cudaSuccess) return (int)e;
    *static_bytes = (int)attr.sharedSizeBytes;
    return 0;
}

// Co-resident CTAs of kernel f with `smem_bytes` of dynamic shared memory:
// the largest grid a cooperative launch accepts.
static int kry_max_ctas(const void* f, int smem_bytes, int* out) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, KRY_THREADS, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    *out = per_sm * sms;
    return 0;
}

// A cooperative launch of f on `stream`; returns its cudaError_t.
static int kry_launch(const void* f, int grid, int smem_bytes, void** args,
                      cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaLaunchCooperativeKernel(f, dim3(grid), dim3(KRY_THREADS), args,
                                    (size_t)smem_bytes, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
