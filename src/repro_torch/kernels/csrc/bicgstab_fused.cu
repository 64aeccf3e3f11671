// PERKS BiCGStab: `iters` BiCGStab iterations from x0 = 0 in one
// cooperative persistent launch, the iteration vectors kept in shared
// memory for the kernel's whole life.
//
// Replaces: src/repro/kernels/krylov_fused.py:bicgstab_fused, both its
// resident-matrix kernel (`_bicgstab_kernel_resident`, MIX) and its
// streamed-matrix kernel (`_bicgstab_kernel_streamed`, VEC). It is the
// port's resident tier for BiCGStab (exec/krylov.py
// BiCGStabProblem.run_resident).
//
// The TPU kernel runs on one core with the seven vectors in VMEM and takes
// its dots over whole vectors. Here 132 SMs run at once and one CTA holds
// at most 227 KB, so, as in cg_fused.cu:
//   * each CTA owns a contiguous range of rows and keeps x, r, rhat, p, v
//     and t of those rows in shared memory (s takes r's slot: r is dead once
//     s = r - alpha v is formed), from the prologue (b read once) to the
//     epilogue (x written once);
//   * the two SpMVs of an iteration (v = A p, t = A s) form their operand
//     where it is gathered: the CTA's own columns from shared memory, where
//     it formed p (or s) itself behind a block barrier; every other column
//     c from device-memory copies as p[c] = r[c] + beta d[c] and
//     s[c] = r[c] - alpha v[c], the rounding of the owner's own, so no
//     barrier waits for p or s to be published. d = p_old - omega v_old is
//     what the owner's p = r + beta (p_old - omega v_old) adds to r, which
//     the owner computes and publishes once omega is known: the p gather
//     loads two values, not three, and one v buffer serves (gathering
//     p_old and v_old, v by the parity of the iteration, spilled registers
//     and ran slower on bicgstab-large);
//   * the matrix: the leading `ca` rows of the CTA's range in shared memory
//     (slot-major), the rest streamed from device memory, twice per
//     iteration, a row's five slots loaded at once (krylov_common.cuh
//     ell_row_q). ca = 0 is VEC, ca = all rows MIX with the whole of A on
//     chip, anything between partial MIX (the planner's matrix_fraction);
//   * the five dots are three tagged rounds (krylov_common.cuh
//     tagged_round): <rhat,v>; <t,s> with <t,t>; <r,r> with the next
//     iteration's rho = <rhat,r>. No grid.sync().
//
// The schedule (tests/test_torch_krylov_schedule.py models it and runs it
// under adversarial interleavings). Device memory: r_glob, d_glob and
// v_glob, one float a row each.
//   prologue   writes r_glob = r_0 = b, d_glob = d_0 = 0  -> round 1: rho/rr
//   iteration i:
//     p-spmv   gathers r_glob = r_i, d_glob = d_i;
//              writes v_glob = v_i                    -> round: <rhat,v>
//     s-spmv   gathers r_glob = r_i, v_glob = v_i      -> round: <t,s>, <t,t>
//     update   writes r_glob = r_{i+1},
//              d_glob = d_{i+1} = p_i - omega_i v_i     -> round: rho/rr
// Every value a phase gathers was written before a round that ends an
// earlier phase, and is overwritten only after the round that ends the
// last phase gathering it: r_i is read by both SpMVs of iteration i and
// d_i by the p-spmv, and both are overwritten by the update after the
// <t,s> round; v_i is read by the s-spmv and overwritten by the p-spmv of
// iteration i + 1, after the rho/rr round. Three rounds an iteration, and
// no barrier that only publishes.
//
// Order within an iteration follows ref.bicgstab_iteration_matvec, with
// every product rounded before its add (-fmad=false); only the order of
// the dots' sums differs from torch.dot.
//
// Bound on the H100: device memory for the streamed rows of A, 8 B per
// stored slot twice per iteration; with A on chip, the three rounds an
// iteration (one trip through L2 each) and the latency of the gathers of
// other CTAs' columns.
#include "krylov_common.cuh"

// p at a column: the CTA's own from shared memory, any other formed from
// r_glob and d_glob (d = p_old - omega v_old, published by its owner).
struct BicgP {
    const float* own;
    int r0, nr;
    const float* r;
    const float* d;
    float beta;
    struct Raw {
        float r, d;
    };
    __device__ bool mine(int c) const {
        return (unsigned)(c - r0) < (unsigned)nr;
    }
    __device__ void load(int c, Raw& w) const {
        if (!mine(c)) {
            w.r = __ldcg(r + c);
            w.d = __ldcg(d + c);
        }
    }
    __device__ float value(int c, const Raw& w) const {
        if (mine(c)) return own[c - r0];
        return __fadd_rn(w.r, __fmul_rn(beta, w.d));
    }
};

// s at a column: the CTA's own from shared memory, any other formed from
// r_glob and this iteration's v.
struct BicgS {
    const float* own;
    int r0, nr;
    const float* r;
    const float* v;
    float alpha;
    struct Raw {
        float r, v;
    };
    __device__ bool mine(int c) const {
        return (unsigned)(c - r0) < (unsigned)nr;
    }
    __device__ void load(int c, Raw& w) const {
        if (!mine(c)) {
            w.r = __ldcg(r + c);
            w.v = __ldcg(v + c);
        }
    }
    __device__ float value(int c, const Raw& w) const {
        if (mine(c)) return own[c - r0];
        return __fsub_rn(w.r, __fmul_rn(alpha, w.v));
    }
};

__global__ void __launch_bounds__(KRY_THREADS, 1)
bicgstab_fused_kernel(const float* __restrict__ data,
                      const int* __restrict__ cols,
                      const float* __restrict__ b, float* __restrict__ x_out,
                      float* __restrict__ rr_out, float* r_glob,
                      float* d_glob, float* v_glob, unsigned long long* tags,
                      int n, int k, int iters, int rows_stride, int ca_max) {
    extern __shared__ float smem[];
    __shared__ float warp_part[2 * KRY_WARPS];
    __shared__ float sums[2];

    const int g = gridDim.x, bid = blockIdx.x, tid = threadIdx.x;
    const int r0 = (int)((long long)bid * n / g);
    const int r1 = (int)((long long)(bid + 1) * n / g);
    const int nr = r1 - r0;
    const int ca = min(ca_max, nr);                // cached rows of A
    float* xs = smem;
    float* rs = xs + rows_stride;                  // r, and s within an iteration
    float* hs = rs + rows_stride;                  // rhat
    float* ps = hs + rows_stride;
    float* vs = ps + rows_stride;
    float* ts = vs + rows_stride;
    float* ad = ts + rows_stride;                  // (K, ca_max) slot-major
    int* ac = (int*)(ad + (size_t)ca_max * k);
    unsigned rnd = 0;

    // Prologue: the cached rows of A, and b, each read once; r_0 = b and
    // p_{-1} = v_{-1} = 0 published by the first round. rr0 = <b,b> is
    // also the first rho = <rhat,r>.
    cache_rows(r0, ca, ca_max, k, data, cols, ad, ac);
    float part = 0.f;
    for (int li = tid; li < nr; li += KRY_THREADS) {
        const float bv = __ldg(b + r0 + li);
        xs[li] = 0.f;
        rs[li] = bv;
        hs[li] = bv;
        ps[li] = 0.f;
        vs[li] = 0.f;
        r_glob[r0 + li] = bv;
        d_glob[r0 + li] = 0.f;
        part = __fadd_rn(part, __fmul_rn(bv, bv));
    }
    warp_partial(part, 0, warp_part);
    tagged_round(1, warp_part, tags, g, ++rnd, sums);  // orders the A copy
    float rho_new = sums[0], rr = sums[0];
    float rho = 1.f, alpha = 1.f, omega = 1.f;
    KRY_MARK(-1);

    for (int it = 0; it < iters; ++it) {
        // p = r + beta (p - omega v) over the CTA's rows.
        const float beta = __fmul_rn(safe_div(rho_new, rho), safe_div(alpha, omega));
        for (int li = tid; li < nr; li += KRY_THREADS) {
            const float d = __fmul_rn(beta, __fsub_rn(ps[li], __fmul_rn(omega, vs[li])));
            ps[li] = __fadd_rn(rs[li], d);
        }
        __syncthreads();

        // v = A p, published, and the partial of <rhat,v>.
        KRY_MARK(0);
        const BicgP qp{ps, r0, nr, r_glob, d_glob, beta};
        part = 0.f;
        for (int li = tid; li < nr; li += KRY_THREADS) {
            const float v = ell_row_q(li, r0 + li, ca, ca_max, k, ad, ac,
                                      data, cols, qp);
            vs[li] = v;
            v_glob[r0 + li] = v;
            part = __fadd_rn(part, __fmul_rn(hs[li], v));
        }
        KRY_MARK(5);
        warp_partial(part, 0, warp_part);
        tagged_round(1, warp_part, tags, g, ++rnd, sums);
        const float alpha_n = safe_div(rho_new, sums[0]);

        // s = r - alpha v (in r's slot).
        for (int li = tid; li < nr; li += KRY_THREADS)
            rs[li] = __fsub_rn(rs[li], __fmul_rn(alpha_n, vs[li]));
        __syncthreads();

        // t = A s and the partials of <t,s> and <t,t>.
        KRY_MARK(0);
        const BicgS qs{rs, r0, nr, r_glob, v_glob, alpha_n};
        float pts = 0.f, ptt = 0.f;
        for (int li = tid; li < nr; li += KRY_THREADS) {
            const float t = ell_row_q(li, r0 + li, ca, ca_max, k, ad, ac,
                                      data, cols, qs);
            ts[li] = t;
            pts = __fadd_rn(pts, __fmul_rn(t, rs[li]));
            ptt = __fadd_rn(ptt, __fmul_rn(t, t));
        }
        KRY_MARK(5);
        warp_partial(pts, 0, warp_part);
        warp_partial(ptt, 1, warp_part);
        tagged_round(2, warp_part, tags, g, ++rnd, sums);
        const float omega_n = safe_div(sums[0], sums[1]);

        // x += alpha p + omega s; r = s - omega t and d = p - omega v,
        // published for the next iteration's gathers; the partials of the
        // next rho = <rhat,r> and of rr = <r,r>.
        float prho = 0.f, prr = 0.f;
        for (int li = tid; li < nr; li += KRY_THREADS) {
            const float s = rs[li], p = ps[li];
            xs[li] = __fadd_rn(__fadd_rn(xs[li], __fmul_rn(alpha_n, p)),
                               __fmul_rn(omega_n, s));
            const float r = __fsub_rn(s, __fmul_rn(omega_n, ts[li]));
            rs[li] = r;
            r_glob[r0 + li] = r;
            d_glob[r0 + li] = __fsub_rn(p, __fmul_rn(omega_n, vs[li]));
            prho = __fadd_rn(prho, __fmul_rn(hs[li], r));
            prr = __fadd_rn(prr, __fmul_rn(r, r));
        }
        warp_partial(prho, 0, warp_part);
        warp_partial(prr, 1, warp_part);
        tagged_round(2, warp_part, tags, g, ++rnd, sums);
        rho = rho_new;
        rho_new = sums[0];
        rr = sums[1];
        alpha = alpha_n;
        omega = omega_n;
    }

    KRY_MARK(0);
    KRY_PROF_END();

    // Epilogue: x written once.
    for (int li = tid; li < nr; li += KRY_THREADS) x_out[r0 + li] = xs[li];
    if (bid == 0 && tid == 0) rr_out[0] = rr;
}

extern "C" int bicgstab_fused_smem(int* optin, int* static_bytes) {
    return kry_smem((const void*)bicgstab_fused_kernel, optin, static_bytes);
}

#ifdef KRY_PROFILE
extern "C" int bicgstab_fused_profile(unsigned long long* out) {
    return kry_profile(out);
}
#endif

extern "C" int bicgstab_fused_max_ctas(int smem_bytes, int* out) {
    return kry_max_ctas((const void*)bicgstab_fused_kernel, smem_bytes, out);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `vecs` holds 3 * n floats (r_glob, d_glob, v_glob), `tags`
// kry_tag_bytes(grid) bytes, zeroed here before the launch.
extern "C" int bicgstab_fused_launch(const float* data, const int* cols,
                                     const float* b, float* x_out,
                                     float* rr_out, float* vecs,
                                     unsigned long long* tags, int n, int k,
                                     int iters, int rows_stride, int ca_max,
                                     int grid, int smem_bytes,
                                     cudaStream_t stream) {
    int e = kry_zero_tags(tags, grid, stream);
    if (e != 0) return e;
    float* r_glob = vecs;
    float* d_glob = vecs + n;
    float* v_glob = vecs + 2 * (size_t)n;
    void* args[] = {(void*)&data, (void*)&cols, (void*)&b, (void*)&x_out,
                    (void*)&rr_out, (void*)&r_glob, (void*)&d_glob,
                    (void*)&v_glob, (void*)&tags, (void*)&n, (void*)&k,
                    (void*)&iters, (void*)&rows_stride, (void*)&ca_max};
    return kry_launch((const void*)bicgstab_fused_kernel, grid, smem_bytes,
                      args, stream);
}
