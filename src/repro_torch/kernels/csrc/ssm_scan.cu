// Mamba2 SSD chunk scan with the recurrent state h kept on chip: a PERKS
// kernel for a recurrence along the sequence, with its chunk products on
// the tensor cores at float32 accuracy.
//
// Replaces: src/repro/kernels/ssm_scan.py:ssm_scan (`_ssd_kernel`), and the
// vmap over a batch in src/repro/kernels/ops.py:ssd_scan. The TPU kernel
// walks the chunks of one sequence as a sequential grid with h (H, N, P)
// float32 in VMEM scratch. Here each head is independent, so CTA
// (16-column slice, head, sequence) walks every chunk of its sequence in
// order with its slice of h (N x 16 float32) in registers for the whole
// scan: h never goes to device memory and no grid barrier is needed.
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
// float32; on request the final state h_out (B, H, N, P) float32, which the
// state warps store from their registers after the last chunk (a model's
// prefill hands it to the decode). The chunk C is any length from 1 to SSM_MAX_CHUNK, N at most
// SSM_MAX_STATE, any P and B, and T need not be a multiple of C: the last
// chunk is shorter. A chunk is cut into 16-row tiles; rows past its end
// are zeros in shared memory and are never read from or written to device
// memory.
//
// Bounds on the H100 SXM at mamba2-780m's widths (B = 1, T = 8192, H = 48,
// P = 64, N = 128, C = 128): the products take 16.3 GFLOP, 0.243 ms at the
// CUDA cores' 67 TFLOP/s (the float32 bound); the scan must move 211 MB,
// 0.063 ms at 3.35 TB/s; run as 3xTF32 on the tensor cores the products
// are 3 x 16.3 GFLOP at 495 TFLOP/s, 0.099 ms (mma.sync, which this
// kernel uses, runs below that wgmma rate).
//
// Two kernels. `ssd_prep_kernel`, one CTA a chunk of a sequence, computes
// the chunk's scores S = c b^T once for every head (tensor cores, 3xTF32)
// into a float32 workspace, its lower 16x16 tiles only, each in the
// tensor-core fragment order the scan reads; and rewrites the chunk's c and
// b as NS slots, slot s holding Nk state columns of c (for the cross term)
// and Rb rows of b (for the state update), one contiguous block each (16 KB
// at C = 128). `ssd_scan_kernel` walks the chunks with 4 row warps (intra,
// cross and y of two row tiles each, r and RT - 1 - r, so that each takes
// RT + 1 of S's tiles), 4 state warps (the state update of two 16-row
// groups of h each, in registers; the next chunk's cum, and its S made
// into M = e^{cum_i - cum_j} S dt_j in place) and one copy warp. What it
// does about the parent kernel's five holds:
//  1. Too few CTAs: 16 columns a CTA (SSM_SLICE), 192 CTAs at the main
//     shape, in at most 113 KB of shared memory, so two fit on an SM.
//  2. No copy in flight: the copy warp feeds S and the slots by bulk
//     copies on mbarriers, one S buffer and a ring of 3 slots ahead of the
//     warps; S of chunk k+1 is copied while chunk k's slots are computed.
//     x and dt of chunk k+1 are read while chunk k is computed, into the
//     other of two buffers. (A whole chunk of c and b is 128 KB in float32,
//     and two of them do not fit in an SM: they come in slots.) A cluster
//     of 8 heads receiving each S and slot by one multicast copy ran no
//     faster than a copy a CTA (L2 serves a 16 KB slot quickly, and the
//     heads advance in lockstep), so there is no cluster.
//  3. Six times the bytes through L2: S is computed once a chunk, not once
//     a head, and no CTA recomputes M's exponent for another's columns.
//  4. A serial cumulative sum: cum is a warp scan (__shfl_up_sync), four
//     rows a lane, in float32.
//  5. CUDA-core products fed from shared memory: intra (M X), cross (C h),
//     the state update ((w o B)^T X) and S run on mma.sync m16n8k8 TF32
//     with split operands: v = hi + lo, hi on TF32's bits, and d += a_lo
//     b_hi + a_hi b_lo into one sum, a_hi b_hi into another, added once in
//     float32 (3xTF32: about float32 accuracy; one TF32 pass keeps three
//     digits). Fragments load as one 16- or 8-byte word a lane, free of
//     bank conflicts.
// The hi part comes from Veltkamp's split, not cvt.rna.tf32.f32: a
// conversion runs at a quarter of the FP32 rate, and a build splitting by
// cvt.rna was 12-15% slower. One named barrier a chunk, and one for h;
// none in the slot walk. No atomics: a call repeats bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stencil_async.cuh"

#define SSM_MAX_CHUNK 128
#define SSM_MAX_STATE 256
#define SSM_SLICE 16                     // columns of a head a CTA owns
#define SSM_ROWW 4                       // row warps: intra, cross, y
#define SSM_WARPS (2 * SSM_ROWW)         // and as many state warps
#define SSM_THREADS (32 * (SSM_WARPS + 1))   // and one copy warp
#define SSM_PREP_THREADS 256
#define SSM_RING 3                       // c/b slots in flight
#define SSM_HEAD 128                     // bytes of mbarriers
#define SSM_SM_BYTES 233472              // shared memory of an SM
#define SSM_WAIT_CYCLES (1LL << 34)

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

// The tiling of one call, the same on the host and in both kernels. A slot
// carries Nk state columns of c (all the chunk's rows: the cross term) and
// Rb rows of b (all the state columns: the state update), so that every
// warp has the same work in every slot.
struct SsmGeom {
    int C, Cpad, RT;      // chunk, its rows padded to 16, its 16-row tiles
    int N, NG;            // state rows, their 16-row groups
    int gps, Nk, NS;      // groups a slot, state columns a slot, slots a chunk
    int Rb, NGp;          // b rows a slot, groups the slots cover
    int chunks, R;        // chunks a sequence, slots in the ring
    int s_floats;         // S of a chunk: RT (RT + 1) / 2 tiles of 256
    int slot_floats;      // a slot: c part (Cpad x Nk), b part (Rb x 16 NGp)
    int smem;             // the scan kernel's dynamic shared memory
};

static SsmGeom ssm_geom(int T_, int N, int C) {
    SsmGeom g;
    g.C = C;
    g.Cpad = (C + 15) / 16 * 16;
    g.RT = g.Cpad / 16;
    g.N = N;
    g.NG = (N + 15) / 16;
    // about 4096 floats a slot: short chunks take more state columns
    g.gps = 8 / g.RT < 1 ? 1 : (8 / g.RT < g.NG ? 8 / g.RT : g.NG);
    g.Nk = 16 * g.gps;
    g.NS = (g.NG + g.gps - 1) / g.gps;
    g.NGp = g.NS * g.gps;
    g.Rb = (g.Cpad + 8 * g.NS - 1) / (8 * g.NS) * 8;
    g.chunks = (T_ + C - 1) / C;
    g.s_floats = g.RT * (g.RT + 1) / 2 * 256;
    g.slot_floats = g.Cpad * g.Nk + 16 * g.NGp * g.Rb;
    const int fixed = SSM_HEAD + 4 * (g.s_floats + 2 * g.Cpad * SSM_SLICE
                                      + g.NG * 256 + 8 * g.Cpad);
    g.R = SSM_RING;
    while (g.R > 2 && 2 * (fixed + 4 * g.R * g.slot_floats + 1024)
                          > SSM_SM_BYTES)
        --g.R;
    g.smem = fixed + 4 * g.R * g.slot_floats;
    return g;
}

// ---- tensor cores: mma.sync m16n8k8 TF32, 3xTF32 ------------------------
//
// Fragments (g = lane / 4, t = lane % 4): A (16 x 8, row) a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8, col) b0 (t, g),
// b1 (t + 4, g); C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3
// (g + 8, 2t + 1).

// v = hi + lo with hi on TF32's 11 significant bits, rounded to nearest,
// by Veltkamp's split (t = v (2^13 + 1), hi = t - (t - v); FMUL and FADD
// at full rate, where a cvt runs at a quarter); lo = v - hi is exact and
// the tensor core reads its top 19 bits.
template <int K>
__device__ __forceinline__ void split_tf32(const float (&v)[K],
                                           uint32_t (&hi)[K],
                                           uint32_t (&lo)[K]) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
        const float t = __fmul_rn(v[i], 8193.f);
        const float h = __fsub_rn(t, __fsub_rn(t, v[i]));
        hi[i] = __float_as_uint(h);
        lo[i] = __float_as_uint(__fsub_rn(v[i], h));
    }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                   "r"(b[1]));
}

// a b at about float32 accuracy: big += a_hi b_hi, small += a_lo b_hi +
// a_hi b_lo (two chains; the small terms are not rounded into the big sum
// until the end).
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
    mma_tf32(small, al, bh);
    mma_tf32(small, ah, bl);
    mma_tf32(big, ah, bh);
}

// ---- the scores and slots of a chunk -------------------------------------
//
// Workspace, per (sequence, chunk): S, RT (RT + 1) / 2 tiles (r, s <= r) at
// r (r + 1) / 2 + s, each two 8-column halves kk of 32 lanes x 4 floats, the
// A fragment of rows 16r.., columns 16s + 8kk..; then NS slots, each the c
// part (A fragments of rows 16r.. x state columns sNk + 8kn.., tile r, step
// kn) and the b part (A fragments of b^T, state rows 16G.. x chunk rows
// sRb + 8kj.., group G, step kj). Rows past the chunk and columns past N are
// zeros.
template <typename T>
__global__ void __launch_bounds__(SSM_PREP_THREADS)
ssd_prep_kernel(const T* __restrict__ b, const T* __restrict__ c,
                float* __restrict__ ws_s, float* __restrict__ ws_cb, int T_,
                SsmGeom g) {
    const int k = blockIdx.x, bt = blockIdx.y;
    const int c0 = k * g.C, L = min(g.C, T_ - c0);
    const size_t r0 = (size_t)bt * T_ + c0;
    const size_t seq = (size_t)bt * g.chunks + k;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int ST = g.Nk + 4;                // row stride: conflict-free
    const int nkc = g.Nk / 8, kb = g.Rb / 8;
    extern __shared__ float sm[];
    float* cs = sm;                         // Cpad x ST
    float* bs = sm + (size_t)g.Cpad * ST;   // Cpad x ST
    float acc[8][2][4], acs[8][2][4];      // big and small terms
#pragma unroll
    for (int s2 = 0; s2 < 8; ++s2)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[s2][q][e] = acs[s2][q][e] = 0.f;
    float* cb = ws_cb + seq * g.NS * (size_t)g.slot_floats;
    for (int s = 0; s < g.NS; ++s) {
        const int n0 = s * g.Nk;
        for (int idx = tid; idx < g.Cpad * g.Nk; idx += SSM_PREP_THREADS) {
            const int i = idx / g.Nk, n = idx - i * g.Nk;
            const bool in = i < L && n0 + n < g.N;
            const size_t at = (r0 + i) * g.N + n0 + n;
            cs[i * ST + n] = in ? to_f(c[at]) : 0.f;
            bs[i * ST + n] = in ? to_f(b[at]) : 0.f;
        }
        __syncthreads();
        float* slot = cb + (size_t)s * g.slot_floats;
        for (int idx = tid; idx < g.Cpad * g.Nk; idx += SSM_PREP_THREADS) {
            const int e = idx & 3, ln = (idx >> 2) & 31, rest = idx >> 7;
            const int r = rest / nkc, kn = rest - r * nkc;
            slot[idx] = cs[(16 * r + (ln >> 2) + 8 * (e & 1)) * ST + 8 * kn
                           + (ln & 3) + 4 * (e >> 1)];
        }
        // the b part: rows sRb.. of every state column, from device memory
        float* bpart = slot + g.Cpad * g.Nk;
        for (int idx = tid; idx < 16 * g.NGp * g.Rb;
             idx += SSM_PREP_THREADS) {
            const int e = idx & 3, ln = (idx >> 2) & 31, rest = idx >> 7;
            const int G = rest / kb, kj = rest - G * kb;
            const int j = s * g.Rb + 8 * kj + (ln & 3) + 4 * (e >> 1);
            const int n = 16 * G + (ln >> 2) + 8 * (e & 1);
            bpart[idx] = j < L && n < g.N ? to_f(b[(r0 + j) * g.N + n]) : 0.f;
        }
        // S += c b^T over this slot's state columns: warp w, rows 16w..
        if (w < g.RT) {
            for (int kn = 0; kn < nkc; ++kn) {
                const int i0 = 16 * w + gq, nc = 8 * kn + tq;
                const float av[4] = {cs[i0 * ST + nc], cs[(i0 + 8) * ST + nc],
                                     cs[i0 * ST + nc + 4],
                                     cs[(i0 + 8) * ST + nc + 4]};
                uint32_t ah[4], al[4];
                split_tf32(av, ah, al);
#pragma unroll
                for (int s2 = 0; s2 < 8; ++s2) {
                    if (s2 > w) break;
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        const int jr = 16 * s2 + 8 * q + gq;
                        const float bv[2] = {bs[jr * ST + nc],
                                             bs[jr * ST + nc + 4]};
                        uint32_t bh[2], bl[2];
                        split_tf32(bv, bh, bl);
                        mma_3xtf32(acc[s2][q], acs[s2][q], ah, al, bh,
                                   bl);
                    }
                }
            }
        }
        __syncthreads();
    }
    if (w < g.RT) {
        float* Sk = ws_s + seq * g.s_floats + w * (w + 1) / 2 * 256;
#pragma unroll
        for (int s2 = 0; s2 < 8; ++s2) {
            if (s2 > w) break;
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int c8 = 2 * tq + (e & 1);
                    Sk[((s2 * 2 + q) * 32 + gq * 4 + (c8 & 3)) * 4
                       + (e >> 1) + 2 * (c8 >> 2)] =
                        __fadd_rn(acc[s2][q][e], acs[s2][q][e]);
                }
        }
    }
}

// ---- the scan --------------------------------------------------------------

// -DSSM_PROFILE: clock cycles by phase, summed over the CTAs into
// ssm_prof: row warp 0 (6 phases: the chunk's barrier, the wait for M,
// intra, the waits for slots, the slots' products, y and the next X), state
// warp 0 (publishing h and the next cum, the wait for the next S, making
// it M, the waits for slots, the slots' products, h), then the copy warp's
// lane 0 (waits for the buffers' readers, the rest).
#define SSM_PROF_SLOTS 14
#ifdef SSM_PROFILE
__device__ unsigned long long ssm_prof[SSM_PROF_SLOTS];
#define PROF(i) do { const long long now_ = clock64(); \
    prof[i] += now_ - tick; tick = now_; } while (0)
#else
#define PROF(i) do {} while (0)
#endif

// Index of X[j][p] (or h[n][p]) in B-fragment order: 8-row step j / 8,
// 8-column tile p / 8, 32 lanes x 2.
__device__ __forceinline__ int bfrag(int j, int p) {
    return (((j >> 3) * 2 + (p >> 3)) * 32 + (p & 7) * 4 + (j & 3)) * 2
        + ((j >> 2) & 1);
}

// A B fragment (8-row step kj, 8-column tile q) of X or h, split.
__device__ __forceinline__ void b_frag(const float* B, int kj, int q,
                                       int lane, uint32_t (&bh)[2],
                                       uint32_t (&bl)[2]) {
    const float2 v = *reinterpret_cast<const float2*>(
        B + ((kj * 2 + q) * 32 + lane) * 2);
    const float va[2] = {v.x, v.y};
    split_tf32(va, bh, bl);
}

// S of a chunk into M = e^{cum_i - cum_j} S dt_j (j <= i < L, else 0: the
// upper triangle masked before exp), in place, by the state warps (st =
// a thread's index among them; it takes one lane's float4 of one 8-column
// half of every other tile); v holds the chunk's cum, e^cum, w, dt. The
// exponent is at most 0, where __expf is within a few ulp of expf (the
// same errors against the plain version at chunks 128, 15 and 1).
__device__ __forceinline__ void decay_scores(float* Sb, const float* v,
                                             int L, int RT, int Cpad,
                                             int st) {
    const float* cum = v;
    const float* dts = v + 3 * Cpad;
    float4* S4 = reinterpret_cast<float4*>(Sb);
    const int kk = (st >> 5) & 1, ln = st & 31, first = st >> 6;
    const int gi = ln >> 2, tj = 8 * kk + (ln & 3);
    const int tiles = RT * (RT + 1) / 2, step = 32 * SSM_ROWW / 64;
    // three tiles at a time: every load before any store
    for (int t0 = first; t0 < tiles; t0 += 3 * step) {
        float4 sv[3];
        float ci[3][2], cj[3][2], dj[3][2];
        int i0[3], j0[3], u[3];
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            const int tile = min(t0 + step * b, tiles - 1);
            // tile = r (r + 1) / 2 + sj, 0 <= sj <= r (sqrtf exact here)
            const int r = (int)((sqrtf((float)(8 * tile + 1)) - 1.f) * 0.5f);
            const int sj = tile - r * (r + 1) / 2;
            i0[b] = 16 * r + gi;
            j0[b] = 16 * sj + tj;
            u[b] = tile * 64 + kk * 32 + ln;
            sv[b] = S4[u[b]];
            ci[b][0] = cum[i0[b]];
            ci[b][1] = cum[i0[b] + 8];
            cj[b][0] = cum[j0[b]];
            cj[b][1] = cum[j0[b] + 4];
            dj[b][0] = dts[j0[b]];
            dj[b][1] = dts[j0[b] + 4];
        }
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            if (t0 + step * b >= tiles) break;
            const int a0 = i0[b], a1 = a0 + 8, c0 = j0[b], c1 = c0 + 4;
            S4[u[b]] = make_float4(
                c0 <= a0 && a0 < L ? __fmul_rn(__fmul_rn(
                    __expf(ci[b][0] - cj[b][0]), sv[b].x), dj[b][0]) : 0.f,
                c0 <= a1 && a1 < L ? __fmul_rn(__fmul_rn(
                    __expf(ci[b][1] - cj[b][0]), sv[b].y), dj[b][0]) : 0.f,
                c1 <= a0 && a0 < L ? __fmul_rn(__fmul_rn(
                    __expf(ci[b][0] - cj[b][1]), sv[b].z), dj[b][1]) : 0.f,
                c1 <= a1 && a1 < L ? __fmul_rn(__fmul_rn(
                    __expf(ci[b][1] - cj[b][1]), sv[b].w), dj[b][1]) : 0.f);
        }
    }
    // these generic writes precede the next bulk copy into the buffer
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Step st of the intra term of rows 16r..: M's 8-column step st times X,
// into yb (a_hi b_hi) and ys (the small terms).
__device__ __forceinline__ void intra_step(const float* Mb, const float* Xs,
                                           int r, int st, int lane,
                                           float (&yb)[2][4],
                                           float (&ys)[2][4]) {
    const float4 mv4 = *reinterpret_cast<const float4*>(
        Mb + (r * (r + 1) + st) * 128 + lane * 4);
    const float mv[4] = {mv4.x, mv4.y, mv4.z, mv4.w};
    uint32_t mh[4], ml[4];
    split_tf32(mv, mh, ml);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        uint32_t xh[2], xl[2];
        b_frag(Xs, st, q, lane, xh, xl);
        mma_3xtf32(yb[q], ys[q], mh, ml, xh, xl);
    }
}

// A row warp thread's share (tid) of chunk k's x slice, zero past the
// chunk and the slice, into X (B-fragment order).
#define SSM_XLOAD (SSM_MAX_CHUNK * SSM_SLICE / (32 * SSM_ROWW))
template <typename T>
__device__ __forceinline__ void load_x(const T* __restrict__ x, float* Xs,
                                       int k, const SsmGeom& g, int T_, int H,
                                       int P, int bt, int head, int p0,
                                       int ps, int st) {
    const int c0 = k * g.C, L = min(g.C, T_ - c0);
    const size_t r0 = (size_t)bt * T_ + c0;
    float v[SSM_XLOAD];
#pragma unroll
    for (int m = 0; m < SSM_XLOAD; ++m) {
        const int e = st + 32 * SSM_ROWW * m, j = e >> 4, p = e & 15;
        v[m] = j < L && p < ps
            ? to_f(x[((r0 + j) * H + head) * P + p0 + p]) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < SSM_XLOAD; ++m) {
        const int e = st + 32 * SSM_ROWW * m, j = e >> 4, p = e & 15;
        if (j < g.Cpad) Xs[(((j >> 3) * 2 + (p >> 3)) * 32 + (p & 7) * 4
                            + (j & 3)) * 2 + ((j >> 2) & 1)] = v[m];
    }
}

// Lane l's rows 4l..4l+3 of chunk k's dt, zero past the chunk.
template <typename T>
__device__ __forceinline__ void load_dt(
    const T* __restrict__ dt, float (&dtv)[4], int k, const SsmGeom& g,
    int T_, int H, int bt, int head, int lane) {
    const int c0 = k * g.C, L = min(g.C, T_ - c0);
    const size_t r0 = (size_t)bt * T_ + c0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        dtv[e] = j < L ? to_f(dt[(r0 + j) * H + head]) : 0.f;
    }
}

// cum of a chunk of length L by a warp scan (lane l sums rows 4l..4l+3 in
// order, the lanes' totals scan by __shfl_up_sync, and each row adds the
// totals of the lanes before its own), and from it the chunk's e^cum,
// w = e^{cum[L-1] - cum} dt and dt, into v (cum, e^cum, w, dt; Cpad each).
__device__ __forceinline__ void scan_chunk(const float (&dtv)[4], float ah,
                                           int L, int Cpad, int lane,
                                           float* v) {
    float s[4], run = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const float gv = __fmul_rn(dtv[e], ah);
        run = e == 0 ? gv : __fadd_rn(run, gv);
        s[e] = run;
    }
    float tot = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot = __fadd_rn(u, tot);
    }
    float ex = __shfl_up_sync(0xffffffffu, tot, 1);
    if (lane == 0) ex = 0.f;
    float cv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) cv[e] = __fadd_rn(ex, s[e]);
    const int jl = L - 1;
    const float mine = (jl & 3) == 0 ? cv[0] : (jl & 3) == 1 ? cv[1]
                     : (jl & 3) == 2 ? cv[2] : cv[3];
    const float cl = __shfl_sync(0xffffffffu, mine, jl >> 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        if (j >= Cpad) continue;
        v[j] = cv[e];
        v[Cpad + j] = j < L ? expf(cv[e]) : 0.f;
        v[2 * Cpad + j] = j < L ? __fmul_rn(expf(cl - cv[e]), dtv[e]) : 0.f;
        v[3 * Cpad + j] = dtv[e];
    }
}

__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, %0;" :: "n"(32 * SSM_WARPS) : "memory");
}

// The state warps publish h; the row warps wait for it before the cross
// term.
__device__ __forceinline__ void h_published() {
    asm volatile("bar.arrive 2, %0;" :: "n"(32 * SSM_WARPS) : "memory");
}

// The state warps alone.
__device__ __forceinline__ void state_sync() {
    asm volatile("bar.sync 3, %0;" :: "n"(32 * SSM_ROWW) : "memory");
}

__device__ __forceinline__ void h_wait() {
    asm volatile("bar.sync 2, %0;" :: "n"(32 * SSM_WARPS) : "memory");
}

// Shared memory: SSM_HEAD bytes of mbarriers (full and empty, for buffer
// 0 = S and buffers 1..R = the slots), S, the
// R slots, X (2 x Cpad x 16, B fragments), h (NG x 256, B fragments), and
// cum, e^cum, w, dt (2 x 4 x Cpad). NGW: state groups a warp owns (N <= 128: 2,
// else 4).
template <typename T, int NGW>
__global__ void __launch_bounds__(SSM_THREADS, 2)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ d,
                const float* __restrict__ ws_s,
                const float* __restrict__ ws_cb, T* __restrict__ y,
                float* __restrict__ h_out, int T_, int H, int P, SsmGeom g) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int p0 = blockIdx.x * SSM_SLICE, head = blockIdx.y, bt = blockIdx.z;
    const int ps = min(SSM_SLICE, P - p0);
    const int R = g.R;
    const uint32_t bar0 = smem_u32(smem);
    float* Sb = reinterpret_cast<float*>(smem + SSM_HEAD);
    float* slots = Sb + g.s_floats;
    // X and the chunk's cum, e^cum, w, dt in two buffers: chunk k in k % 2
    float* Xbuf = slots + (size_t)R * g.slot_floats;   // 2 x Cpad x 16
    float* hs = Xbuf + 2 * g.Cpad * SSM_SLICE;          // NG x 256
    float* vbuf = hs + g.NG * 256;                      // 2 x 4 x Cpad
#define FULL(i) (bar0 + 8 * (i))
#define EMPTY(i) (bar0 + 32 + 8 * (i))
    if (tid == 0) {
        for (int i = 0; i <= R; ++i) {
            mbar_init(FULL(i), 1);
            mbar_init(EMPTY(i), i == 0 ? SSM_ROWW : SSM_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    const size_t seq = (size_t)bt * g.chunks;

    if (warp == SSM_WARPS) {
        // the copy warp: S of chunk 0, then per chunk k its first R slots,
        // S of chunk k + 1 (its buffer frees once chunk k's intra is done),
        // its other slots; each fill waits for the buffer's last readers
        if (lane == 0) {
#ifdef SSM_PROFILE
            long long prof[2] = {0, 0}, tick = clock64();
#endif
            int fills[SSM_RING + 1] = {0, 0, 0, 0};
            auto fill = [&](int buf, const float* src, int floats) {
                const int n = fills[buf]++;
                PROF(1);
                if (n > 0)
                    mbar_wait_or_trap(EMPTY(buf), (n - 1) & 1,
                                      SSM_WAIT_CYCLES);
                PROF(0);
                const uint32_t bytes = 4u * floats;
                mbar_expect_tx(FULL(buf), bytes);
                const uint32_t dst = buf == 0
                    ? smem_u32(Sb)
                    : smem_u32(slots + (size_t)(buf - 1) * g.slot_floats);
                bulk_copy(dst, src, bytes, FULL(buf));
            };
            auto slice = [&](int k, int s) {
                fill(1 + (k * g.NS + s) % R,
                     ws_cb + ((seq + k) * g.NS + s) * (size_t)g.slot_floats,
                     g.slot_floats);
            };
            fill(0, ws_s + seq * g.s_floats, g.s_floats);
            const int early = min(R, g.NS);
            for (int k = 0; k < g.chunks; ++k) {
                for (int s = 0; s < early; ++s) slice(k, s);
                if (k + 1 < g.chunks)
                    fill(0, ws_s + (seq + k + 1) * g.s_floats, g.s_floats);
                for (int s = early; s < g.NS; ++s) slice(k, s);
            }
#ifdef SSM_PROFILE
            PROF(1);
            for (int i = 0; i < 2; ++i)
                atomicAdd(&ssm_prof[12 + i], (unsigned long long)prof[i]);
#endif
        }
        __syncwarp();
    } else {
        // X of chunk 0 by the row warps, its cum and M by the state warps
        const bool row = warp < SSM_ROWW;
        const int sw = warp - SSM_ROWW, st = tid - 32 * SSM_ROWW;
        const float ah = a[head], dh = d[head];
        if (row) load_x(x, Xbuf, 0, g, T_, H, P, bt, head, p0, ps, tid);
        if (sw == 0) {
            float dtv[4];
            load_dt(dt, dtv, 0, g, T_, H, bt, head, lane);
            scan_chunk(dtv, ah, min(g.C, T_), g.Cpad, lane, vbuf);
        }
        if (!row) {
            state_sync();
            mbar_wait_or_trap(FULL(0), 0, SSM_WAIT_CYCLES);
            decay_scores(Sb, vbuf, min(g.C, T_), g.RT, g.Cpad, st);
        }
        consumer_sync();
#ifdef SSM_PROFILE
        long long prof[6] = {0, 0, 0, 0, 0, 0}, tick = clock64();
#endif
        if (row) {
            // row tiles ta = warp and tb = RT - 1 - warp: the pair takes
            // RT + 1 16-column tiles of S whichever the warp
            const int nkc = g.Nk / 8;
            const int tr[2] = {warp, g.RT - 1 - warp};
            const bool has[2] = {2 * warp <= g.RT - 1, 2 * warp < g.RT - 1};
            for (int k = 0; k < g.chunks; ++k) {
                const int c0 = k * g.C, L = min(g.C, T_ - c0);
                const size_t r0 = (size_t)bt * T_ + c0;
                const float* Xs = Xbuf + (k & 1) * g.Cpad * SSM_SLICE;
                const float* ecum = vbuf + (k & 1) * 4 * g.Cpad + g.Cpad;
                bool rows[2];
#pragma unroll
                for (int t = 0; t < 2; ++t)
                    rows[t] = has[t] && 16 * tr[t] < L;
                float yb[2][2][4], ys[2][2][4];
#pragma unroll
                for (int t = 0; t < 2; ++t)
#pragma unroll
                    for (int q = 0; q < 2; ++q)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            yb[t][q][e] = ys[t][q][e] = 0.f;

                // intra: the two tiles' 8-column steps of M interleaved (M
                // of this chunk is in the S buffer, made by the state warps)
                PROF(0);
                mbar_wait_or_trap(FULL(0), k & 1, SSM_WAIT_CYCLES);
                PROF(1);
                {
                    const int lk = (L + 7) / 8;     // 8-column steps in range
                    const int na = rows[0] ? min(2 * (tr[0] + 1), lk) : 0;
                    const int nb = rows[1] ? min(2 * (tr[1] + 1), lk) : 0;
#pragma unroll 2
                    for (int j = 0; j < max(na, nb); ++j) {
                        if (j < na)
                            intra_step(Sb, Xs, tr[0], j, lane, yb[0], ys[0]);
                        if (j < nb)
                            intra_step(Sb, Xs, tr[1], j, lane, yb[1], ys[1]);
                    }
                }
                __syncwarp();
                if (lane == 0) mbar_arrive(EMPTY(0));
                float yi[2][2][4];                  // intra, summed
#pragma unroll
                for (int t = 0; t < 2; ++t)
#pragma unroll
                    for (int q = 0; q < 2; ++q)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            yi[t][q][e] = __fadd_rn(yb[t][q][e], ys[t][q][e]);
                            yb[t][q][e] = ys[t][q][e] = 0.f;   // now C h's
                        }
                PROF(2);
                h_wait();

                // the slots: cross (C h) on the two tiles over the slot's
                // state columns
                for (int s = 0; s < g.NS; ++s) {
                    const int f = k * g.NS + s, slot = f % R;
                    PROF(4);
                    mbar_wait_or_trap(FULL(1 + slot), (f / R) & 1,
                                      SSM_WAIT_CYCLES);
                    PROF(3);
                    const float* cp = slots + (size_t)slot * g.slot_floats;
#pragma unroll 2
                    for (int kn = 0; kn < nkc; ++kn) {
                        const int n8 = s * g.Nk + 8 * kn;
                        if (n8 >= g.N) break;
                        uint32_t hh[2][2], hl[2][2];
#pragma unroll
                        for (int q = 0; q < 2; ++q)
                            b_frag(hs, n8 >> 3, q, lane, hh[q], hl[q]);
#pragma unroll
                        for (int t = 0; t < 2; ++t) {
                            if (!rows[t]) continue;
                            const float4 cv4 =
                                *reinterpret_cast<const float4*>(
                                    cp + ((tr[t] * nkc + kn) * 32 + lane) * 4);
                            const float cv[4] = {cv4.x, cv4.y, cv4.z, cv4.w};
                            uint32_t chh[4], cll[4];
                            split_tf32(cv, chh, cll);
#pragma unroll
                            for (int q = 0; q < 2; ++q)
                                mma_3xtf32(yb[t][q], ys[t][q], chh, cll,
                                           hh[q], hl[q]);
                        }
                    }
                    __syncwarp();
                    if (lane == 0) mbar_arrive(EMPTY(1 + slot));
                }
                PROF(4);

                // y = intra + e^cum (C h) + d x on the rows and columns in
                // range
#pragma unroll
                for (int t = 0; t < 2; ++t) {
                    if (!rows[t]) continue;
#pragma unroll
                    for (int q = 0; q < 2; ++q)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int i = 16 * tr[t] + gq + 8 * (e >> 1);
                            const int p = 8 * q + 2 * tq + (e & 1);
                            if (i >= L || p >= ps) continue;
                            float o = __fadd_rn(yi[t][q][e], __fmul_rn(
                                ecum[i],
                                __fadd_rn(yb[t][q][e], ys[t][q][e])));
                            o = __fadd_rn(o, __fmul_rn(dh, Xs[bfrag(i, p)]));
                            y[((r0 + i) * H + head) * P + p0 + p] =
                                from_f<T>(o);
                        }
                }
                // chunk k + 1's X into the other buffer (free since chunk
                // k - 1 ended)
                if (k + 1 < g.chunks)
                    load_x(x, Xbuf + ((k + 1) & 1) * g.Cpad * SSM_SLICE,
                           k + 1, g, T_, H, P, bt, head, p0, ps, tid);
                PROF(5);
                consumer_sync();
            }
        } else {
            // state groups sw + SSM_ROWW o (o < NGW), 16 rows x 16 columns
            // each, in accumulator layout; db, ds: the chunk's update, big
            // and small terms
            const int kb = g.Rb / 8;
            float h[NGW][2][4], db[NGW][2][4], ds[NGW][2][4];
#pragma unroll
            for (int o = 0; o < NGW; ++o)
#pragma unroll
                for (int q = 0; q < 2; ++q)
#pragma unroll
                    for (int e = 0; e < 4; ++e) h[o][q][e] = 0.f;
            for (int k = 0; k < g.chunks; ++k) {
                const int c0 = k * g.C, L = min(g.C, T_ - c0);
                const float* Xs = Xbuf + (k & 1) * g.Cpad * SSM_SLICE;
                const float* v = vbuf + (k & 1) * 4 * g.Cpad;
                const float* wv = v + 2 * g.Cpad;
                const float ecl = expf(v[L - 1]);
                // h of chunk k - 1, for the cross term
#pragma unroll
                for (int o = 0; o < NGW; ++o) {
                    const int G = sw + SSM_ROWW * o;
                    if (G >= g.NG) continue;
#pragma unroll
                    for (int q = 0; q < 2; ++q)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            hs[bfrag(16 * G + gq + 8 * (e >> 1),
                                     8 * q + 2 * tq + (e & 1))] = h[o][q][e];
                }
                // chunk k + 1's cum into the other buffer (free since chunk
                // k - 1 ended), published with h
                if (k + 1 < g.chunks && sw == 0) {
                    float dtv[4];
                    load_dt(dt, dtv, k + 1, g, T_, H, bt, head, lane);
                    scan_chunk(dtv, ah, min(g.C, T_ - c0 - g.C), g.Cpad,
                               lane, vbuf + ((k + 1) & 1) * 4 * g.Cpad);
                }
                h_published();
#pragma unroll
                for (int o = 0; o < NGW; ++o)
#pragma unroll
                    for (int q = 0; q < 2; ++q)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            db[o][q][e] = ds[o][q][e] = 0.f;
                PROF(0);

                // the slots: the state update over the slot's rows of b
                for (int s = 0; s < g.NS; ++s) {
                    const int f = k * g.NS + s, slot = f % R;
                    PROF(4);
                    mbar_wait_or_trap(FULL(1 + slot), (f / R) & 1,
                                      SSM_WAIT_CYCLES);
                    PROF(3);
                    const float* bp = slots + (size_t)slot * g.slot_floats
                        + g.Cpad * g.Nk;
#pragma unroll 2
                    for (int kl = 0; kl < kb; ++kl) {
                        const int j0 = s * g.Rb + 8 * kl;
                        if (j0 >= L) break;
                        const float w0 = wv[j0 + tq], w1 = wv[j0 + tq + 4];
                        uint32_t xh[2][2], xl[2][2];
#pragma unroll
                        for (int q = 0; q < 2; ++q)
                            b_frag(Xs, j0 >> 3, q, lane, xh[q], xl[q]);
#pragma unroll
                        for (int o = 0; o < NGW; ++o) {
                            const int G = sw + SSM_ROWW * o;
                            if (G >= g.NG) break;
                            const float4 bv =
                                *reinterpret_cast<const float4*>(
                                    bp + ((G * kb + kl) * 32 + lane) * 4);
                            const float av[4] = {__fmul_rn(bv.x, w0),
                                                 __fmul_rn(bv.y, w0),
                                                 __fmul_rn(bv.z, w1),
                                                 __fmul_rn(bv.w, w1)};
                            uint32_t bh[4], bl[4];
                            split_tf32(av, bh, bl);
#pragma unroll
                            for (int q = 0; q < 2; ++q)
                                mma_3xtf32(db[o][q], ds[o][q], bh, bl, xh[q],
                                           xl[q]);
                        }
                    }
                    __syncwarp();
                    if (lane == 0) mbar_arrive(EMPTY(1 + slot));
                }
                PROF(4);
#pragma unroll
                for (int o = 0; o < NGW; ++o)
#pragma unroll
                    for (int q = 0; q < 2; ++q)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            h[o][q][e] = __fadd_rn(
                                __fmul_rn(ecl, h[o][q][e]),
                                __fadd_rn(db[o][q][e], ds[o][q][e]));
                PROF(5);
                // chunk k + 1's S, once copied, into its M
                if (k + 1 < g.chunks) {
                    state_sync();
                    mbar_wait_or_trap(FULL(0), (k + 1) & 1, SSM_WAIT_CYCLES);
                    PROF(1);
                    decay_scores(Sb, vbuf + ((k + 1) & 1) * 4 * g.Cpad,
                                 min(g.C, T_ - c0 - g.C), g.RT, g.Cpad, st);
                    PROF(2);
                }
                consumer_sync();
            }
            // the final state, where the caller asks for it: h_out (B, H,
            // N, P) float32, after the last chunk
            if (h_out != nullptr) {
                float* ho = h_out + ((size_t)bt * H + head) * g.N * P + p0;
#pragma unroll
                for (int o = 0; o < NGW; ++o) {
                    const int G = sw + SSM_ROWW * o;
                    if (G >= g.NG) continue;
#pragma unroll
                    for (int q = 0; q < 2; ++q)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int n = 16 * G + gq + 8 * (e >> 1);
                            const int p = 8 * q + 2 * tq + (e & 1);
                            if (n < g.N && p < ps)
                                ho[(size_t)n * P + p] = h[o][q][e];
                        }
                }
            }
        }
#ifdef SSM_PROFILE
        if (lane == 0 && (warp == 0 || warp == SSM_ROWW))
            for (int i = 0; i < 6; ++i)
                atomicAdd(&ssm_prof[(warp ? 6 : 0) + i],
                          (unsigned long long)prof[i]);
#endif
    }
#undef FULL
#undef EMPTY
}

#ifdef SSM_PROFILE
// Copies the summed cycles into out (SSM_PROF_SLOTS values) and zeroes
// them.
extern "C" int ssm_scan_profile(unsigned long long* out) {
    cudaError_t e = cudaDeviceSynchronize();
    if (e != cudaSuccess) return (int)e;
    e = cudaMemcpyFromSymbol(out, ssm_prof, sizeof(ssm_prof));
    if (e != cudaSuccess) return (int)e;
    unsigned long long zero[SSM_PROF_SLOTS] = {};
    return (int)cudaMemcpyToSymbol(ssm_prof, zero, sizeof(zero));
}
#endif

// Floats of the workspace a call takes: S and the c/b slots of every chunk.
extern "C" long long ssm_scan_workspace_floats(int B, int T_, int N, int C) {
    if (B <= 0 || T_ <= 0 || C < 1 || N < 1) return 0;
    const SsmGeom g = ssm_geom(T_, N, C);
    return (long long)B * g.chunks
        * ((long long)g.s_floats + (long long)g.NS * g.slot_floats);
}

template <typename T, int NGW>
static int prepare(const SsmGeom& g) {
    return (int)cudaFuncSetAttribute(
        ssd_scan_kernel<T, NGW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        g.smem);
}

template <typename T, int NGW>
static int launch_scan(const SsmGeom& g, const void* x, const void* dt,
                       const float* a, const float* d, const float* ws_s,
                       const float* ws_cb, void* y, float* h_out, int B,
                       int T_, int H, int P, cudaStream_t stream) {
    const int err = prepare<T, NGW>(g);
    if (err) return err;
    ssd_scan_kernel<T, NGW><<<dim3((P + SSM_SLICE - 1) / SSM_SLICE, H, B),
                              SSM_THREADS, g.smem, stream>>>(
        (const T*)x, (const T*)dt, a, d, ws_s, ws_cb, (T*)y, h_out, T_, H, P,
        g);
    return (int)cudaGetLastError();
}

static int valid(int B, int T_, int H, int P, int N, int C) {
    return B > 0 && T_ > 0 && H > 0 && P > 0 && C >= 1
        && C <= SSM_MAX_CHUNK && N >= 1 && N <= SSM_MAX_STATE;
}

// What a launch at these shapes runs: out = {grid x, y, z, the scan
// kernel's dynamic shared memory, slots in the ring, threads a CTA, the
// prep kernel's dynamic shared memory}. Returns a cudaError_t.
extern "C" int ssm_scan_config(int B, int T_, int H, int P, int N, int C,
                               int bf16, int* out) {
    if (!valid(B, T_, H, P, N, C)) return (int)cudaErrorInvalidValue;
    const SsmGeom g = ssm_geom(T_, N, C);
    const bool four = g.NG > 2 * SSM_ROWW;
    const int e = bf16 ? (four ? prepare<__nv_bfloat16, 4>(g)
                               : prepare<__nv_bfloat16, 2>(g))
                       : (four ? prepare<float, 4>(g) : prepare<float, 2>(g));
    if (e) return e;
    const int v[7] = {(P + SSM_SLICE - 1) / SSM_SLICE, H, B, g.smem, g.R,
                      SSM_THREADS, 8 * g.Cpad * (g.Nk + 4)};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
    return 0;
}

template <typename T>
static int launch(const void* x, const void* dt, const float* a,
                  const void* b, const void* c, const float* d, void* y,
                  float* h_out, float* ws, int B, int T_, int H, int P, int N,
                  int C, cudaStream_t stream) {
    const SsmGeom g = ssm_geom(T_, N, C);
    float* ws_s = ws;
    float* ws_cb = ws + (size_t)B * g.chunks * g.s_floats;
    ssd_prep_kernel<T><<<dim3(g.chunks, B), SSM_PREP_THREADS,
                         8 * g.Cpad * (g.Nk + 4), stream>>>(
        (const T*)b, (const T*)c, ws_s, ws_cb, T_, g);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return g.NG > 2 * SSM_ROWW
        ? launch_scan<T, 4>(g, x, dt, a, d, ws_s, ws_cb, y, h_out, B, T_, H,
                            P, stream)
        : launch_scan<T, 2>(g, x, dt, a, d, ws_s, ws_cb, y, h_out, B, T_, H,
                            P, stream);
}

// Launches on `stream` (bf16 != 0: bf16 streams, else float32); ws holds
// ssm_scan_workspace_floats(B, T, N, C) floats. h_out, if not null,
// receives the state after the last chunk, (B, H, N, P) float32; y is the
// same with or without it. Returns the cudaError_t (0 = success).
extern "C" int ssm_scan_launch(const void* x, const void* dt, const float* a,
                               const void* b, const void* c, const float* d,
                               void* y, float* h_out, float* ws, int B,
                               int T_, int H, int P, int N, int C, int bf16,
                               cudaStream_t stream) {
    if (B <= 0 || T_ <= 0 || H <= 0 || P <= 0) return 0;
    if (!valid(B, T_, H, P, N, C)) return (int)cudaErrorInvalidValue;
    return bf16 ? launch<__nv_bfloat16>(x, dt, a, b, c, d, y, h_out, ws, B,
                                        T_, H, P, N, C, stream)
                : launch<float>(x, dt, a, b, c, d, y, h_out, ws, B, T_, H, P,
                                N, C, stream);
}
