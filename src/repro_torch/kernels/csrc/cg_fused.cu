// PERKS conjugate gradient: `iters` textbook CG iterations from x0 = 0 in
// one cooperative persistent launch, the iteration vectors kept in shared
// memory for the kernel's whole life.
//
// Replaces: src/repro/kernels/cg_fused.py:cg_fused, both its resident-matrix
// kernel (`_cg_kernel_resident`, the paper's MIX/MAT policies) and its
// streamed-matrix kernel (`_cg_kernel_streamed`, VEC). It is the port's
// resident tier for CG (exec/adapters.py CGProblem.run_resident).
//
// The TPU kernel runs on one core with the whole of x, r, p and Ap in VMEM
// and takes its dot products over whole vectors. Here 132 SMs run at once
// and one CTA holds at most 227 KB, so:
//   * each CTA owns a contiguous range of rows, [r0, r1), about n / grid,
//     and keeps x, r, p and Ap of those rows in shared memory from the
//     prologue (b read once) to the epilogue (x written once);
//   * the SpMV forms p where it is gathered: the CTA's own columns from
//     shared memory, where it formed p = r + beta p itself behind a block
//     barrier; every other column c from device-memory copies of r and of
//     the last p as __fadd_rn(r[c], __fmul_rn(beta, p[c])), the rounding
//     of the owner's own p (so no barrier waits for p to be published);
//   * the matrix: the leading `ca` rows of the CTA's range stay in shared
//     memory (slot-major, so neighbouring threads read neighbouring banks),
//     the rest is streamed from device memory every iteration, a row's
//     five slots loaded at once. ca = 0 is the paper's VEC policy, ca = all
//     rows its MIX with the whole matrix on chip, anything between is
//     partial MIX: on the H100 a large A does not fit beside the vectors,
//     so part of it stays on chip;
//   * the two dot products of an iteration are tagged rounds
//     (krylov_common.cuh tagged_round): every CTA sums the CTAs' partials
//     in the same fixed order, so all CTAs hold the same alpha and beta and
//     a run repeats bit for bit. No float atomics, no grid.sync().
//
// The schedule (tests/test_torch_krylov_schedule.py models it and runs it
// under adversarial interleavings). Device memory: vg, r and p of every
// row (one float each a lane), written for the rows another CTA gathers
// (marked in the prologue, read after round 1).
//   prologue      writes p of vg = b (p_0)                  -> round 1: b.b
//   iteration i:
//     spmv        gathers r = r_i, p = p_{i-1} of vg
//                 (i = 0: p = p_0 as it is)                 -> round: p.Ap
//     update      writes r = r_{i+1}, p = p_i of vg         -> round: r.r
// Every value a phase gathers was written before the round that ends the
// phase before it, and is overwritten only after the round that ends the
// gathering phase: the spmv of iteration i reads r_i and p_{i-1}, which the
// update of iteration i - 1 wrote before its r.r round and the update of
// iteration i overwrites after the p.Ap round. Two rounds an iteration,
// and no barrier that only publishes.
//
// Order within an iteration follows ref.cg_iteration_matvec: Ap = A p;
// alpha = rr / (p.Ap); x += alpha p; r -= alpha Ap; rr' = r.r;
// beta = rr' / rr; p = r + beta p. Divisions are _safe_div
// (|b| > 0 ? a / b : 0) and every product is rounded before its add
// (-fmad=false), as torch computes the plain version; only the order of
// the dot products' sums differs from torch.dot.
//
// Lanes: `lanes` (B <= 32) systems on the one A in ONE launch, B = 1 the
// single-instance launch. The kernel is built for LB = B rounded up to a
// power of two (1, 2, 4, ..., 32); a padded lane holds zeros and is never
// summed into a round or written out. Every CTA owns the same rows for
// every lane as a single launch on the same grid, and keeps A's cached
// share once for all lanes. A thread takes its rows in the single launch's
// order and does every lane in one pass over them: a row's slots and
// columns are read once, the gathers of up to CG_GATHER_LANES lanes are in
// flight at once (r and p of a remote column's four lanes are two 16-byte
// loads, where instance-major copies took eight; the vectors are
// lane-minor, [row][LB] in shared memory and vg_r in device memory), and
// each lane's product sum runs in slot order. The dot products' partials stay per lane in the single
// launch's row order (in registers for LB <= 4; above, from shared memory
// after the pass), and one multi-value warp reduction (warp_sums) takes
// the B values of a warp to its partials with each lane's bits those of
// the single launch's butterfly. Each of the two rounds carries the B
// lanes' values at once, so an iteration takes two rounds whatever B is,
// and x and rr of each lane are bit-equal to its own launch.
//
// Bound on the H100: device memory for the streamed rows of A, 8 B per
// stored slot per iteration, plus the gathers of other CTAs' columns
// through L2 (8 B a lane each) and the publishing of the rows they gather;
// with A wholly on chip, the two rounds an iteration (one trip through L2
// each: a floor of 2 x iters rounds whatever B is), the latency of one
// row's gathers, and for the lanes shared-memory throughput: x, r, p and
// Ap are read or written about 16 times an iteration, 16 B a row a lane
// (the planner offers a batched resident plan only where LB lanes fit).
#include "krylov_common.cuh"

// Lanes a thread gathers and sums at once inside a row (G); up to this
// many lanes it also keeps the dot products' partials and alpha in
// registers through the row passes.
#define CG_GATHER_LANES 4
// Lanes a thread sums its dot-product partials for at once where they do
// not stay in registers through the row passes (LB > CG_GATHER_LANES).
#define CG_PARTIAL_LANES 8

// W consecutive floats at p (aligned to 4 W bytes, 16 for W >= 4) in the
// widest accesses that cover them; the _cg form loads through L2 only.
template <int W>
__device__ __forceinline__ void ld_lanes(const float* p, float* v) {
    if constexpr (W % 4 == 0) {
#pragma unroll
        for (int i = 0; i < W / 4; ++i) {
            const float4 t = reinterpret_cast<const float4*>(p)[i];
            v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z,
                  v[4 * i + 3] = t.w;
        }
    } else if constexpr (W == 2) {
        const float2 t = *reinterpret_cast<const float2*>(p);
        v[0] = t.x, v[1] = t.y;
    } else {
        v[0] = *p;
    }
}

template <int W>
__device__ __forceinline__ void ld_lanes_cg(const float* p, float* v) {
    if constexpr (W % 4 == 0) {
#pragma unroll
        for (int i = 0; i < W / 4; ++i) {
            const float4 t = __ldcg(reinterpret_cast<const float4*>(p) + i);
            v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z,
                  v[4 * i + 3] = t.w;
        }
    } else if constexpr (W == 2) {
        const float2 t = __ldcg(reinterpret_cast<const float2*>(p));
        v[0] = t.x, v[1] = t.y;
    } else {
        v[0] = __ldcg(p);
    }
}

template <int W>
__device__ __forceinline__ void st_lanes(float* p, const float* v) {
    if constexpr (W % 4 == 0) {
#pragma unroll
        for (int i = 0; i < W / 4; ++i)
            reinterpret_cast<float4*>(p)[i] =
                make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    } else if constexpr (W == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
        *p = v[0];
    }
}

// Where a group's r and p of column c lie in vg (2 LB floats a column):
// for G <= 2 side by side, [column][group][r, p][G], so one access moves
// both; for G = 4 in tiles of CG_TILE_ROWS columns,
// [tile][group][r | p][CG_TILE_ROWS][G], so a warp's stores of r (or p)
// for consecutive rows fill whole 32-byte sectors (side by side, each of
// a row's two 16-byte stores would fill half of one). vg_r: the offset of
// r; p lies vg_p floats after it.
#define CG_TILE_ROWS 8
template <int LB, int G>
__device__ __forceinline__ size_t vg_r(int c, int l0) {
    if constexpr (G <= 2)
        return (size_t)c * (2 * LB) + 2 * l0;
    else
        return (size_t)(c / CG_TILE_ROWS) * (CG_TILE_ROWS * 2 * LB) +
               (size_t)(l0 / G) * (CG_TILE_ROWS * 2 * G) +
               (size_t)(c % CG_TILE_ROWS) * G;
}
template <int G>
constexpr int vg_p = G <= 2 ? G : CG_TILE_ROWS * G;

// A group's r and p of one column (at q, p vg_p<G> floats after r):
// loaded, or stored, as one access where they fit in 16 bytes.
template <int G>
__device__ __forceinline__ void ld_pair_cg(const float* q, float* r,
                                           float* p) {
    if constexpr (G <= 2) {
        float v[2 * G];
        ld_lanes_cg<2 * G>(q, v);
#pragma unroll
        for (int l = 0; l < G; ++l) r[l] = v[l], p[l] = v[G + l];
    } else {
        ld_lanes_cg<G>(q, r);
        ld_lanes_cg<G>(q + vg_p<G>, p);
    }
}

template <int G>
__device__ __forceinline__ void st_pair(float* q, const float* r,
                                        const float* p) {
    if constexpr (G <= 2) {
        float v[2 * G];
#pragma unroll
        for (int l = 0; l < G; ++l) v[l] = r[l], v[G + l] = p[l];
        st_lanes<2 * G>(q, v);
    } else {
        st_lanes<G>(q, r);
        st_lanes<G>(q + vg_p<G>, p);
    }
}

// p of a group of G lanes at column c: the CTA's own from shared memory
// (own, [row][LB]), any other formed from the owner's published r and p
// (vg, at vg_r; p itself in the first iteration) as
// __fadd_rn(r, __fmul_rn(beta, p)), the owner's own rounding.
template <int LB, int G>
struct LaneP {
    const float* own;
    const float* vg;
    int r0, nr;
    bool first;
    __device__ bool mine(int c) const {
        return (unsigned)(c - r0) < (unsigned)nr;
    }
    // the loads of another CTA's column for lanes [l0, l0 + G)
    __device__ void load(int c, int l0, float* r, float* p) const {
        const float* q = vg + vg_r<LB, G>(c, l0);
        if (first) ld_lanes_cg<G>(q + vg_p<G>, p);
        else ld_pair_cg<G>(q, r, p);
    }
    __device__ void own_value(int c, int l0, float* v) const {
        ld_lanes<G>(own + (size_t)(c - r0) * LB + l0, v);
    }
    __device__ void form(const float* r, const float* p, const float* beta,
                         float* v) const {
#pragma unroll
        for (int l = 0; l < G; ++l)
            v[l] = first ? p[l] : __fadd_rn(r[l], __fmul_rn(beta[l], p[l]));
    }
};

// acc = one row of A times p for lanes [l0, l0 + G): K slots whose
// columns are col and whose values are av (kGlobal: in registers) or at a
// (slot j at j * stride in shared memory, read at the sum); the gathers
// issued first, then the sum in slot order, each product rounded before
// its add (the single launch's order, lane by lane). Up to two lanes, every
// slot's gather has registers of its own (2 K G); above, the first two
// remote slots' do (4 G: a 2D five-point row has at most two columns
// outside its CTA's range unless the range is narrower than the grid's
// side), and a further one is loaded at its turn in the sum.
template <int LB, int G, int K, bool kGlobal>
__device__ __forceinline__ void slots_lanes(const float* a, size_t stride,
                                            const int* col, const float* av,
                                            const LaneP<LB, G>& q, int l0,
                                            const float* beta, float* acc) {
#pragma unroll
    for (int l = 0; l < G; ++l) acc[l] = 0.f;
    if constexpr (G <= 2) {
        float r[K][G], p[K][G];
#pragma unroll
        for (int j = 0; j < K; ++j)
            if (!q.mine(col[j])) q.load(col[j], l0, r[j], p[j]);
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const float aj = kGlobal ? av[j] : a[j * stride];
            float v[G];
            if (q.mine(col[j])) q.own_value(col[j], l0, v);
            else q.form(r[j], p[j], beta, v);
#pragma unroll
            for (int l = 0; l < G; ++l)
                acc[l] = __fadd_rn(acc[l], __fmul_rn(aj, v[l]));
        }
    } else {
        float ra[G], pa[G], rb[G], pb[G];
        int sa = K, sb = K;
#pragma unroll
        for (int j = 0; j < K; ++j) {
            if (!q.mine(col[j])) {
                if (sa == K) {
                    sa = j;
                    q.load(col[j], l0, ra, pa);
                } else if (sb == K) {
                    sb = j;
                    q.load(col[j], l0, rb, pb);
                }
            }
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const float aj = kGlobal ? av[j] : a[j * stride];
            float v[G];
            if (q.mine(col[j])) {
                q.own_value(col[j], l0, v);
            } else if (j == sa) {
                q.form(ra, pa, beta, v);
            } else if (j == sb) {
                q.form(rb, pb, beta, v);
            } else {
                float r[G], p[G];
                q.load(col[j], l0, r, p);
                q.form(r, p, beta, v);
            }
#pragma unroll
            for (int l = 0; l < G; ++l)
                acc[l] = __fadd_rn(acc[l], __fmul_rn(aj, v[l]));
        }
    }
}

// One row of A times p for every lane, into ap_row (shared, [LB]): K = 5
// slots at a, c (slot j at j * stride; device memory when kGlobal, else
// shared memory), every column (and streamed value) read once for all the
// row's groups of lanes. kRegs: part[l] += p[l] Ap[l], p from p_row.
template <int LB, int G, bool kGlobal, bool kRegs>
__device__ __forceinline__ void row5_lanes(const float* a, const int* c,
                                           size_t stride,
                                           const LaneP<LB, G>& q,
                                           const float* lane_beta,
                                           float* ap_row, const float* p_row,
                                           float* part) {
    int col[5];
    float av[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) {
        if constexpr (kGlobal) col[j] = __ldg(c + j * stride);
        else col[j] = c[j * stride];
    }
#pragma unroll
    for (int j = 0; j < 5; ++j) {
        if constexpr (kGlobal) av[j] = __ldg(a + j * stride);
    }
#pragma unroll
    for (int l0 = 0; l0 < LB; l0 += G) {
        float beta[G], acc[G];
#pragma unroll
        for (int l = 0; l < G; ++l) beta[l] = lane_beta[l0 + l];
        slots_lanes<LB, G, 5, kGlobal>(a, stride, col, av, q, l0, beta, acc);
        st_lanes<G>(ap_row + l0, acc);
        if constexpr (kRegs) {
            float pv[G];
            ld_lanes<G>(p_row + l0, pv);
#pragma unroll
            for (int l = 0; l < G; ++l)
                part[l0 + l] = __fadd_rn(part[l0 + l], __fmul_rn(pv[l], acc[l]));
        }
    }
}

// The same for any K: a group's slots walked in turn, each gather waited
// for before the next (rows below `ca` from the slot-major copy in shared
// memory, the rest streamed).
template <int LB, int G, bool kRegs>
__device__ __forceinline__ void rowk_lanes(int li, int row, int ca,
                                           int ca_max, int k, const float* ad,
                                           const int* ac,
                                           const float* __restrict__ data,
                                           const int* __restrict__ cols,
                                           const LaneP<LB, G>& q,
                                           const float* lane_beta,
                                           float* ap_row, const float* p_row,
                                           float* part) {
    const size_t base = (size_t)row * k;
#pragma unroll
    for (int l0 = 0; l0 < LB; l0 += G) {
        float beta[G], acc[G];
#pragma unroll
        for (int l = 0; l < G; ++l) {
            beta[l] = lane_beta[l0 + l];
            acc[l] = 0.f;
        }
        for (int j = 0; j < k; ++j) {
            const int c = li < ca ? ac[(size_t)j * ca_max + li]
                                  : __ldg(cols + base + j);
            const float a = li < ca ? ad[(size_t)j * ca_max + li]
                                    : __ldg(data + base + j);
            float v[G];
            if (q.mine(c)) {
                q.own_value(c, l0, v);
            } else {
                float r[G], p[G];
                q.load(c, l0, r, p);
                q.form(r, p, beta, v);
            }
#pragma unroll
            for (int l = 0; l < G; ++l)
                acc[l] = __fadd_rn(acc[l], __fmul_rn(a, v[l]));
        }
        st_lanes<G>(ap_row + l0, acc);
        if constexpr (kRegs) {
            float pv[G];
            ld_lanes<G>(p_row + l0, pv);
#pragma unroll
            for (int l = 0; l < G; ++l)
                part[l0 + l] = __fadd_rn(part[l0 + l], __fmul_rn(pv[l], acc[l]));
        }
    }
}

// The warp sums of a thread's W partials of lanes [l0, l0 + W) into
// warp_part (value l of warp w at l * KRY_WARPS + w), for lanes below
// `lanes`. Every thread of the block calls it.
template <int W>
__device__ __forceinline__ void lane_partials(float (&part)[W], int l0,
                                              int lanes, float* warp_part) {
    const float s = warp_sums<W>(part);
    const int lane = threadIdx.x & 31, l = l0 + lane / (32 / W);
    if (lane % (32 / W) == 0 && l < lanes)
        warp_part[l * KRY_WARPS + (threadIdx.x >> 5)] = s;
}

// The partials of u . v ([row][LB] in shared memory) over a thread's rows,
// in the row passes' order, up to CG_PARTIAL_LANES lanes at a time, each
// summed over the warp into warp_part.
template <int LB>
__device__ __forceinline__ void dot_partials(const float* u, const float* v,
                                             int nr, int lanes,
                                             float* warp_part) {
    constexpr int W = LB < CG_PARTIAL_LANES ? LB : CG_PARTIAL_LANES;
#pragma unroll
    for (int l0 = 0; l0 < LB; l0 += W) {
        float part[W];
#pragma unroll
        for (int l = 0; l < W; ++l) part[l] = 0.f;
        for (int li = threadIdx.x; li < nr; li += KRY_THREADS) {
            float a[W], c[W];
            ld_lanes<W>(u + (size_t)li * LB + l0, a);
            ld_lanes<W>(v + (size_t)li * LB + l0, c);
#pragma unroll
            for (int l = 0; l < W; ++l)
                part[l] = __fadd_rn(part[l], __fmul_rn(a[l], c[l]));
        }
        lane_partials<W>(part, l0, lanes, warp_part);
    }
}

template <int LB>
__global__ void __launch_bounds__(KRY_THREADS, 1)
cg_fused_kernel(const float* __restrict__ data, const int* __restrict__ cols,
                const float* __restrict__ b, float* __restrict__ x_out,
                float* __restrict__ rr_out, float* vg,
                unsigned char* gathered, unsigned long long* tags, int n,
                int k, int iters, int rows_stride, int ca_max, int lanes) {
    extern __shared__ float4 smem4[];
    __shared__ float sums[KRY_WARPS];
    __shared__ float lane_rr[KRY_WARPS], lane_beta[KRY_WARPS];
    __shared__ float lane_alpha[KRY_WARPS];
    constexpr int G = LB < CG_GATHER_LANES ? LB : CG_GATHER_LANES;
    // the dot products' partials and alpha in registers through the row
    // passes (above, the partials summed from shared memory after them and
    // alpha once a lane in shared memory)
    constexpr bool kRegs = LB <= CG_GATHER_LANES;

    const int g = gridDim.x, bid = blockIdx.x, tid = threadIdx.x;
    const int r0 = (int)((long long)bid * n / g);
    const int r1 = (int)((long long)(bid + 1) * n / g);
    const int nr = r1 - r0;
    const int ca = min(ca_max, nr);                // cached rows of A
    float* warp_part = reinterpret_cast<float*>(smem4);  // (LB, KRY_WARPS)
    float* xs = warp_part + LB * KRY_WARPS;        // x, r, p, Ap: [row][LB]
    float* rs = xs + (size_t)LB * rows_stride;
    float* ps = rs + (size_t)LB * rows_stride;
    float* aps = ps + (size_t)LB * rows_stride;
    float* ad = aps + (size_t)LB * rows_stride;    // (K, ca_max)
    int* ac = (int*)(ad + (size_t)ca_max * k);
    unsigned rnd = 0;
    float part[kRegs ? LB : 1];

    // a padded lane's sums stay 0 (rounds sum the first `lanes` values)
    if (tid < KRY_WARPS) sums[tid] = 0.f;

    // Prologue: the cached rows of A, and every lane's b, each read once;
    // p_0 = b published by the first round, and so are the marks of the
    // rows another CTA gathers (gathered[c] = 1, zeroed by the launch).
    cache_rows(r0, ca, ca_max, k, data, cols, ad, ac);
    for (int e = tid; e < nr * k; e += KRY_THREADS) {
        const int c = __ldg(cols + (size_t)r0 * k + e);
        if ((unsigned)(c - r0) >= (unsigned)nr) gathered[c] = 1;
    }
#pragma unroll
    for (int l = 0; l < (kRegs ? LB : 1); ++l) part[l] = 0.f;
    for (int li = tid; li < nr; li += KRY_THREADS) {
        const int row = r0 + li;
#pragma unroll
        for (int l0 = 0; l0 < LB; l0 += G) {
            float bv[G], zero[G];
#pragma unroll
            for (int l = 0; l < G; ++l) {
                bv[l] = l0 + l < lanes ? __ldg(b + (size_t)(l0 + l) * n + row)
                                       : 0.f;
                zero[l] = 0.f;
            }
            const size_t at = (size_t)li * LB + l0;
            st_lanes<G>(xs + at, zero);
            st_lanes<G>(rs + at, bv);
            st_lanes<G>(ps + at, bv);
            st_pair<G>(vg + vg_r<LB, G>(row, l0), zero, bv);
            if constexpr (kRegs) {
#pragma unroll
                for (int l = 0; l < G; ++l)
                    part[l0 + l] = __fadd_rn(part[l0 + l],
                                             __fmul_rn(bv[l], bv[l]));
            }
        }
    }
    if constexpr (kRegs) lane_partials<LB>(part, 0, lanes, warp_part);
    else dot_partials<LB>(rs, rs, nr, lanes, warp_part);
    tagged_round<KRY_WARPS>(lanes, warp_part, tags, g, ++rnd, sums);  // orders the A copy
    if (tid < LB) {
        lane_rr[tid] = sums[tid];
        lane_beta[tid] = 0.f;
    }
    // bit m: the thread's m-th row is gathered by another CTA, so the
    // updates publish it (a thread has at most 15 rows: 16 B a row a lane
    // in 227 KB)
    unsigned publish = 0;
    for (int li = tid, m = 0; li < nr; li += KRY_THREADS, ++m)
        if (__ldcg(gathered + r0 + li)) publish |= 1u << m;
    __syncthreads();
    KRY_MARK(-1);

    for (int it = 0; it < iters; ++it) {
        // p = r + beta p over the CTA's rows (p_0 = b is there already).
        if (it > 0) {
            for (int li = tid; li < nr; li += KRY_THREADS) {
#pragma unroll
                for (int l0 = 0; l0 < LB; l0 += G) {
                    const size_t at = (size_t)li * LB + l0;
                    float r[G], p[G];
                    ld_lanes<G>(rs + at, r);
                    ld_lanes<G>(ps + at, p);
#pragma unroll
                    for (int l = 0; l < G; ++l)
                        p[l] = __fadd_rn(r[l], __fmul_rn(lane_beta[l0 + l], p[l]));
                    st_lanes<G>(ps + at, p);
                }
            }
            __syncthreads();
        }

        // Ap = A p over the CTA's rows for every lane, and the partials of
        // p.Ap.
        KRY_MARK(0);
        const LaneP<LB, G> q{ps, vg, r0, nr, it == 0};
#pragma unroll
        for (int l = 0; l < (kRegs ? LB : 1); ++l) part[l] = 0.f;
        for (int li = tid; li < nr; li += KRY_THREADS) {
            const int row = r0 + li;
            float* ap_row = aps + (size_t)li * LB;
            const float* p_row = ps + (size_t)li * LB;
            if (k == 5) {
                if (li < ca)
                    row5_lanes<LB, G, false, kRegs>(ad + li, ac + li, ca_max,
                                                    q, lane_beta, ap_row,
                                                    p_row, part);
                else
                    row5_lanes<LB, G, true, kRegs>(
                        data + (size_t)row * 5, cols + (size_t)row * 5, 1, q,
                        lane_beta, ap_row, p_row, part);
            } else {
                rowk_lanes<LB, G, kRegs>(li, row, ca, ca_max, k, ad, ac, data,
                                         cols, q, lane_beta, ap_row, p_row,
                                         part);
            }
        }
        if constexpr (kRegs) lane_partials<LB>(part, 0, lanes, warp_part);
        else dot_partials<LB>(ps, aps, nr, lanes, warp_part);
        KRY_MARK(5);
        tagged_round<KRY_WARPS>(lanes, warp_part, tags, g, ++rnd, sums);

        // x += alpha p; r -= alpha Ap; r and p published for the next
        // iteration's gathers; the partials of r.r.
        float alpha[kRegs ? LB : 1];
        if constexpr (kRegs) {
#pragma unroll
            for (int l = 0; l < LB; ++l)
                alpha[l] = safe_div(lane_rr[l], sums[l]);
        } else {
            if (tid < LB) lane_alpha[tid] = safe_div(lane_rr[tid], sums[tid]);
            __syncthreads();
        }
#pragma unroll
        for (int l = 0; l < (kRegs ? LB : 1); ++l) part[l] = 0.f;
        for (int li = tid, m = 0; li < nr; li += KRY_THREADS, ++m) {
            const int row = r0 + li;
            const bool pub = (publish >> m) & 1u;
#pragma unroll
            for (int l0 = 0; l0 < LB; l0 += G) {
                const size_t at = (size_t)li * LB + l0;
                float x[G], r[G], p[G], ap[G];
                ld_lanes<G>(xs + at, x);
                ld_lanes<G>(rs + at, r);
                ld_lanes<G>(ps + at, p);
                ld_lanes<G>(aps + at, ap);
#pragma unroll
                for (int l = 0; l < G; ++l) {
                    float al;
                    if constexpr (kRegs) al = alpha[l0 + l];
                    else al = lane_alpha[l0 + l];
                    x[l] = __fadd_rn(x[l], __fmul_rn(al, p[l]));
                    r[l] = __fsub_rn(r[l], __fmul_rn(al, ap[l]));
                    if constexpr (kRegs)
                        part[l0 + l] = __fadd_rn(part[l0 + l],
                                                 __fmul_rn(r[l], r[l]));
                }
                st_lanes<G>(xs + at, x);
                st_lanes<G>(rs + at, r);
                if (pub) st_pair<G>(vg + vg_r<LB, G>(row, l0), r, p);
            }
        }
        if constexpr (kRegs) lane_partials<LB>(part, 0, lanes, warp_part);
        else dot_partials<LB>(rs, rs, nr, lanes, warp_part);
        tagged_round<KRY_WARPS>(lanes, warp_part, tags, g, ++rnd, sums);
        if (tid < LB) {
            lane_beta[tid] = safe_div(sums[tid], lane_rr[tid]);
            lane_rr[tid] = sums[tid];
        }
        __syncthreads();
    }

    KRY_MARK(0);
    KRY_PROF_END();

    // Epilogue: x written once.
    for (int li = tid; li < nr; li += KRY_THREADS)
        for (int l = 0; l < lanes; ++l)
            x_out[(size_t)l * n + r0 + li] = xs[(size_t)li * LB + l];
    if (bid == 0 && tid < lanes) rr_out[tid] = lane_rr[tid];
}

// The kernel at each lane width LB = 1, 2, 4, ..., KRY_WARPS.
static const void* const kCgKernels[] = {
    (const void*)cg_fused_kernel<1>,  (const void*)cg_fused_kernel<2>,
    (const void*)cg_fused_kernel<4>,  (const void*)cg_fused_kernel<8>,
    (const void*)cg_fused_kernel<16>, (const void*)cg_fused_kernel<32>,
};
static const int kCgWidths = sizeof(kCgKernels) / sizeof(kCgKernels[0]);

// The largest static shared memory of the widths (all declare the same).
extern "C" int cg_fused_smem(int* optin, int* static_bytes) {
    *static_bytes = 0;
    for (int i = 0; i < kCgWidths; ++i) {
        int s = 0;
        const int e = kry_smem(kCgKernels[i], optin, &s);
        if (e != 0) return e;
        if (s > *static_bytes) *static_bytes = s;
    }
    return 0;
}

#ifdef KRY_PROFILE
extern "C" int cg_fused_profile(unsigned long long* out) {
    return kry_profile(out);
}
#endif

// The co-resident CTAs of the width that holds fewest.
extern "C" int cg_fused_max_ctas(int smem_bytes, int* out) {
    *out = 1 << 30;
    for (int i = 0; i < kCgWidths; ++i) {
        int c = 0;
        const int e = kry_max_ctas(kCgKernels[i], smem_bytes, &c);
        if (e != 0) return e;
        if (c < *out) *out = c;
    }
    return 0;
}

// Launches on `stream` `lanes` systems on the one A (1 <= lanes <=
// KRY_WARPS: b, x_out [lanes, n], rr_out [lanes]) on the kernel of width
// LB, `lanes` rounded up to a power of two; returns the cudaError_t of the
// launch (0 = success). `vecs` holds vg, 2 LB floats a row with the rows
// rounded up to whole tiles of CG_TILE_ROWS, then a byte a row (gathered),
// zeroed here before the launch, as are the `tags`, kry_tag_bytes(grid,
// KRY_WARPS) bytes; the dynamic shared
// memory holds LB * KRY_WARPS floats of warp partials, then x, r, p and
// Ap of rows_stride rows of LB lanes, then the cached rows of A.
extern "C" int cg_fused_launch(const float* data, const int* cols,
                               const float* b, float* x_out, float* rr_out,
                               float* vecs, unsigned long long* tags, int n,
                               int k, int iters, int rows_stride, int ca_max,
                               int grid, int smem_bytes, int lanes,
                               cudaStream_t stream) {
    if (lanes < 1 || lanes > KRY_WARPS) return (int)cudaErrorInvalidValue;
    int e = kry_zero_tags(tags, grid, stream, KRY_WARPS);
    if (e != 0) return e;
    int w = 0;
    while ((1 << w) < lanes) ++w;
    const size_t tiled = (size_t)(n + CG_TILE_ROWS - 1) / CG_TILE_ROWS *
                         CG_TILE_ROWS;
    unsigned char* gathered = (unsigned char*)(vecs + 2 * tiled * (1 << w));
    e = (int)cudaMemsetAsync(gathered, 0, (size_t)n, stream);
    if (e != 0) return e;
    void* args[] = {(void*)&data, (void*)&cols, (void*)&b, (void*)&x_out,
                    (void*)&rr_out, (void*)&vecs, (void*)&gathered,
                    (void*)&tags, (void*)&n, (void*)&k, (void*)&iters,
                    (void*)&rows_stride, (void*)&ca_max, (void*)&lanes};
    return kry_launch(kCgKernels[w], grid, smem_bytes, args, stream);
}
