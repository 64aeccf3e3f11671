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
                int rows_stride, int ca_max) {
    extern __shared__ float smem[];
    __shared__ float warp_part[KRY_WARPS];
    __shared__ float sums[1];

    const int g = gridDim.x, bid = blockIdx.x, tid = threadIdx.x;
    const int r0 = (int)((long long)bid * n / g);
    const int r1 = (int)((long long)(bid + 1) * n / g);
    const int nr = r1 - r0;
    const int ca = min(ca_max, nr);                // cached rows of A
    float* xs = smem;
    float* rs = xs + rows_stride;
    float* ps = rs + rows_stride;
    float* aps = ps + rows_stride;
    float* ad = aps + rows_stride;                 // (K, ca_max) slot-major
    int* ac = (int*)(ad + (size_t)ca_max * k);
    unsigned rnd = 0;

    // Prologue: the cached rows of A, and b, each read once; p_0 = b
    // published by the first round.
    cache_rows(r0, ca, ca_max, k, data, cols, ad, ac);
    float part = 0.f;
    for (int li = tid; li < nr; li += KRY_THREADS) {
        const float bv = __ldg(b + r0 + li);
        xs[li] = 0.f;
        rs[li] = bv;
        ps[li] = bv;
        p_glob[r0 + li] = bv;
        part = __fadd_rn(part, __fmul_rn(bv, bv));
    }
    warp_partial(part, 0, warp_part);
    tagged_round(1, warp_part, tags, g, ++rnd, sums);  // orders the A copy
    float rr = sums[0], beta = 0.f;
    KRY_MARK(-1);

    for (int it = 0; it < iters; ++it) {
        // p = r + beta p over the CTA's rows (p_0 = b is there already).
        if (it > 0) {
            for (int li = tid; li < nr; li += KRY_THREADS)
                ps[li] = __fadd_rn(rs[li], __fmul_rn(beta, ps[li]));
            __syncthreads();
        }

        // Ap = A p over the CTA's rows, and the partial of p.Ap.
        KRY_MARK(0);
        const CgP q{ps, r0, nr, r_glob, p_glob, beta, it == 0};
        part = 0.f;
        for (int li = tid; li < nr; li += KRY_THREADS) {
            const float acc = ell_row_q(li, r0 + li, ca, ca_max, k, ad, ac,
                                        data, cols, q);
            aps[li] = acc;
            part = __fadd_rn(part, __fmul_rn(ps[li], acc));
        }
        KRY_MARK(5);
        warp_partial(part, 0, warp_part);
        tagged_round(1, warp_part, tags, g, ++rnd, sums);
        const float alpha = safe_div(rr, sums[0]);

        // x += alpha p; r -= alpha Ap; r and p published for the next
        // iteration's gathers; the partial of r.r.
        part = 0.f;
        for (int li = tid; li < nr; li += KRY_THREADS) {
            const float p = ps[li];
            xs[li] = __fadd_rn(xs[li], __fmul_rn(alpha, p));
            const float r = __fsub_rn(rs[li], __fmul_rn(alpha, aps[li]));
            rs[li] = r;
            r_glob[r0 + li] = r;
            p_glob[r0 + li] = p;
            part = __fadd_rn(part, __fmul_rn(r, r));
        }
        warp_partial(part, 0, warp_part);
        tagged_round(1, warp_part, tags, g, ++rnd, sums);
        const float rr_new = sums[0];
        beta = safe_div(rr_new, rr);
        rr = rr_new;
    }

    KRY_MARK(0);
    KRY_PROF_END();

    // Epilogue: x written once.
    for (int li = tid; li < nr; li += KRY_THREADS) x_out[r0 + li] = xs[li];
    if (bid == 0 && tid == 0) rr_out[0] = rr;
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

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `vecs` holds 2 * n floats (r_glob, p_glob), `tags` kry_tag_bytes(grid)
// bytes, zeroed here before the launch.
extern "C" int cg_fused_launch(const float* data, const int* cols,
                               const float* b, float* x_out, float* rr_out,
                               float* vecs, unsigned long long* tags, int n,
                               int k, int iters, int rows_stride, int ca_max,
                               int grid, int smem_bytes, cudaStream_t stream) {
    int e = kry_zero_tags(tags, grid, stream);
    if (e != 0) return e;
    float* r_glob = vecs;
    float* p_glob = vecs + n;
    void* args[] = {(void*)&data, (void*)&cols, (void*)&b, (void*)&x_out,
                    (void*)&rr_out, (void*)&r_glob, (void*)&p_glob,
                    (void*)&tags, (void*)&n, (void*)&k, (void*)&iters,
                    (void*)&rows_stride, (void*)&ca_max};
    return kry_launch((const void*)cg_fused_kernel, grid, smem_bytes, args,
                      stream);
}
