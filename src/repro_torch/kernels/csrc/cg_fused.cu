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
//     five slots loaded at once (krylov_common.cuh ell_row_q). ca = 0 is
//     the paper's VEC policy, ca = all rows its MIX with the whole matrix
//     on chip, anything between is partial MIX: on the H100 a large A does
//     not fit beside the vectors, so part of it stays on chip;
//   * the two dot products of an iteration are tagged rounds
//     (krylov_common.cuh tagged_round): every CTA sums the CTAs' partials
//     in the same fixed order, so all CTAs hold the same alpha and beta and
//     a run repeats bit for bit. No float atomics, no grid.sync().
//
// The schedule (tests/test_torch_krylov_schedule.py models it and runs it
// under adversarial interleavings). Device memory: r_glob and p_glob, one
// float a row each.
//   prologue      writes p_glob = b (p_0)                  -> round 1: b.b
//   iteration i:
//     spmv        gathers r_glob = r_i, p_glob = p_{i-1}
//                 (i = 0: p_glob = p_0 as it is)           -> round: p.Ap
//     update      writes r_glob = r_{i+1}, p_glob = p_i    -> round: r.r
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
// Bound on the H100: device memory for the streamed rows of A, 8 B per
// stored slot per iteration, plus the gathers of other CTAs' columns
// through L2; with A wholly on chip, the two rounds an iteration (one trip
// through L2 each) and the latency of those gathers.
//
// Batched: `lanes` (B <= 32) systems on the one A in ONE launch. Every CTA
// owns the same rows for every lane as in a single-instance launch on the
// same grid, and keeps A's cached share once for all lanes (A does not
// scale with the batch); x, r, p and Ap of its rows are kept for each lane
// (16 B a row a lane, beside the share of A: the planner offers a batched
// resident plan only where they fit). Each phase runs lane after lane over
// the CTA's rows, in the single-instance order within a lane, and each of
// the two rounds of an iteration carries the B lanes' values at once (a
// tagged round sums up to 32), so an iteration still takes two rounds
// whatever B is. Every lane's sums run in the same CTA order as a single
// launch's at the same grid, so x and rr of each lane are bit-equal to its
// own launch (lanes = 1 is the single-instance launch).
#include "krylov_common.cuh"

// p at a column: the CTA's own from shared memory, any other formed from
// r_glob and p_glob (p_glob itself in the first iteration).
struct CgP {
    const float* own;
    int r0, nr;
    const float* r;
    const float* p;
    float beta;
    bool first;
    struct Raw {
        float r, p;
    };
    __device__ bool mine(int c) const {
        return (unsigned)(c - r0) < (unsigned)nr;
    }
    __device__ void load(int c, Raw& w) const {
        if (!mine(c)) {
            w.p = __ldcg(p + c);
            if (!first) w.r = __ldcg(r + c);
        }
    }
    __device__ float value(int c, const Raw& w) const {
        if (mine(c)) return own[c - r0];
        return first ? w.p : __fadd_rn(w.r, __fmul_rn(beta, w.p));
    }
};

__global__ void __launch_bounds__(KRY_THREADS, 1)
cg_fused_kernel(const float* __restrict__ data, const int* __restrict__ cols,
                const float* __restrict__ b, float* __restrict__ x_out,
                float* __restrict__ rr_out, float* r_glob, float* p_glob,
                unsigned long long* tags, int n, int k, int iters,
                int rows_stride, int ca_max, int lanes) {
    extern __shared__ float smem[];
    __shared__ float sums[KRY_WARPS];
    __shared__ float lane_rr[KRY_WARPS], lane_beta[KRY_WARPS];

    const int g = gridDim.x, bid = blockIdx.x, tid = threadIdx.x;
    const int r0 = (int)((long long)bid * n / g);
    const int r1 = (int)((long long)(bid + 1) * n / g);
    const int nr = r1 - r0;
    const int ca = min(ca_max, nr);                // cached rows of A
    float* warp_part = smem;                       // (lanes, KRY_WARPS)
    float* vec = warp_part + lanes * KRY_WARPS;    // lane l: x, r, p, Ap
    float* ad = vec + (size_t)4 * lanes * rows_stride;  // (K, ca_max)
    int* ac = (int*)(ad + (size_t)ca_max * k);
    auto xs = [&](int l) { return vec + (size_t)(4 * l) * rows_stride; };
    auto rs = [&](int l) { return xs(l) + rows_stride; };
    auto ps = [&](int l) { return xs(l) + 2 * rows_stride; };
    auto aps = [&](int l) { return xs(l) + 3 * rows_stride; };
    unsigned rnd = 0;

    // Prologue: the cached rows of A, and each lane's b, each read once;
    // p_0 = b published by the first round.
    cache_rows(r0, ca, ca_max, k, data, cols, ad, ac);
    for (int l = 0; l < lanes; ++l) {
        const float* bl = b + (size_t)l * n;
        float* x = xs(l);
        float* r = rs(l);
        float* p = ps(l);
        float part = 0.f;
        for (int li = tid; li < nr; li += KRY_THREADS) {
            const float bv = __ldg(bl + r0 + li);
            x[li] = 0.f;
            r[li] = bv;
            p[li] = bv;
            p_glob[(size_t)l * n + r0 + li] = bv;
            part = __fadd_rn(part, __fmul_rn(bv, bv));
        }
        warp_partial(part, l, warp_part);
    }
    tagged_round<KRY_WARPS>(lanes, warp_part, tags, g, ++rnd, sums);  // orders the A copy
    if (tid < lanes) {
        lane_rr[tid] = sums[tid];
        lane_beta[tid] = 0.f;
    }
    __syncthreads();
    KRY_MARK(-1);

    for (int it = 0; it < iters; ++it) {
        // p = r + beta p over the CTA's rows (p_0 = b is there already).
        if (it > 0) {
            for (int l = 0; l < lanes; ++l) {
                const float beta = lane_beta[l];
                const float* r = rs(l);
                float* p = ps(l);
                for (int li = tid; li < nr; li += KRY_THREADS)
                    p[li] = __fadd_rn(r[li], __fmul_rn(beta, p[li]));
            }
            __syncthreads();
        }

        // Ap = A p over the CTA's rows, and the partial of p.Ap, a lane at
        // a time (A's cached rows read from shared memory by every lane).
        KRY_MARK(0);
        for (int l = 0; l < lanes; ++l) {
            const float* p = ps(l);
            float* ap = aps(l);
            const CgP q{p, r0, nr, r_glob + (size_t)l * n,
                        p_glob + (size_t)l * n, lane_beta[l], it == 0};
            float part = 0.f;
            for (int li = tid; li < nr; li += KRY_THREADS) {
                const float acc = ell_row_q(li, r0 + li, ca, ca_max, k, ad,
                                            ac, data, cols, q);
                ap[li] = acc;
                part = __fadd_rn(part, __fmul_rn(p[li], acc));
            }
            warp_partial(part, l, warp_part);
        }
        KRY_MARK(5);
        tagged_round<KRY_WARPS>(lanes, warp_part, tags, g, ++rnd, sums);

        // x += alpha p; r -= alpha Ap; r and p published for the next
        // iteration's gathers; the partial of r.r.
        for (int l = 0; l < lanes; ++l) {
            const float alpha = safe_div(lane_rr[l], sums[l]);
            float* x = xs(l);
            float* r = rs(l);
            const float* p = ps(l);
            const float* ap = aps(l);
            float* rg = r_glob + (size_t)l * n + r0;
            float* pg = p_glob + (size_t)l * n + r0;
            float part = 0.f;
            for (int li = tid; li < nr; li += KRY_THREADS) {
                const float pv = p[li];
                x[li] = __fadd_rn(x[li], __fmul_rn(alpha, pv));
                const float rv = __fsub_rn(r[li], __fmul_rn(alpha, ap[li]));
                r[li] = rv;
                rg[li] = rv;
                pg[li] = pv;
                part = __fadd_rn(part, __fmul_rn(rv, rv));
            }
            warp_partial(part, l, warp_part);
        }
        tagged_round<KRY_WARPS>(lanes, warp_part, tags, g, ++rnd, sums);
        if (tid < lanes) {
            lane_beta[tid] = safe_div(sums[tid], lane_rr[tid]);
            lane_rr[tid] = sums[tid];
        }
        __syncthreads();
    }

    KRY_MARK(0);
    KRY_PROF_END();

    // Epilogue: x written once.
    for (int l = 0; l < lanes; ++l) {
        const float* x = xs(l);
        for (int li = tid; li < nr; li += KRY_THREADS)
            x_out[(size_t)l * n + r0 + li] = x[li];
    }
    if (bid == 0 && tid < lanes) rr_out[tid] = lane_rr[tid];
}

extern "C" int cg_fused_smem(int* optin, int* static_bytes) {
    return kry_smem((const void*)cg_fused_kernel, optin, static_bytes);
}

#ifdef KRY_PROFILE
extern "C" int cg_fused_profile(unsigned long long* out) {
    return kry_profile(out);
}
#endif

extern "C" int cg_fused_max_ctas(int smem_bytes, int* out) {
    return kry_max_ctas((const void*)cg_fused_kernel, smem_bytes, out);
}

// Launches on `stream` `lanes` systems on the one A (1 <= lanes <=
// KRY_WARPS: b, x_out [lanes, n], rr_out [lanes]); returns the cudaError_t
// of the launch (0 = success). `vecs` holds 2 * lanes * n floats (r_glob,
// p_glob), `tags` kry_tag_bytes(grid, KRY_WARPS) bytes, zeroed here before
// the launch; the dynamic shared memory holds lanes * KRY_WARPS floats of
// warp partials before the vectors.
extern "C" int cg_fused_launch(const float* data, const int* cols,
                               const float* b, float* x_out, float* rr_out,
                               float* vecs, unsigned long long* tags, int n,
                               int k, int iters, int rows_stride, int ca_max,
                               int grid, int smem_bytes, int lanes,
                               cudaStream_t stream) {
    if (lanes < 1 || lanes > KRY_WARPS) return (int)cudaErrorInvalidValue;
    int e = kry_zero_tags(tags, grid, stream, KRY_WARPS);
    if (e != 0) return e;
    float* r_glob = vecs;
    float* p_glob = vecs + (size_t)lanes * n;
    void* args[] = {(void*)&data, (void*)&cols, (void*)&b, (void*)&x_out,
                    (void*)&rr_out, (void*)&r_glob, (void*)&p_glob,
                    (void*)&tags, (void*)&n, (void*)&k, (void*)&iters,
                    (void*)&rows_stride, (void*)&ca_max, (void*)&lanes};
    return kry_launch((const void*)cg_fused_kernel, grid, smem_bytes, args,
                      stream);
}
