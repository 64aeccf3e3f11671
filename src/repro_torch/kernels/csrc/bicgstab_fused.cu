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
//   * the two SpMVs of an iteration (v = A p, t = A s) gather p, then s,
//     from one device-memory vector `q_glob` that every CTA publishes its
//     rows to; the gathers hit L2. p and s never need the buffer at the
//     same time, so one serves both;
//   * the matrix: the leading `ca` rows of the CTA's range in shared memory
//     (slot-major), the rest streamed from device memory, twice per
//     iteration. ca = 0 is VEC, ca = all rows MIX with the whole of A on
//     chip, anything between partial MIX (the planner's matrix_fraction);
//   * the five dots are grid-wide reductions (krylov_common.cuh): <t,s>
//     and <t,t> share one round, and <r,r> shares one with the next
//     iteration's rho = <rhat,r>. Five grid.sync() per iteration: rho/rr,
//     p published, <rhat,v>, s published, <t,s>/<t,t>.
// Order within an iteration follows ref.bicgstab_iteration_matvec, with
// every product rounded before its add (-fmad=false); only the order of
// the dots' sums differs from torch.dot.
//
// Bound on the H100: device memory for the streamed rows of A, 8 B per
// stored slot twice per iteration; with A on chip, the five grid barriers
// and the latency of the gathers.
#include "krylov_common.cuh"

// Partial slots, each g floats: rho = <rhat,r>, rr = <r,r>, <rhat,v>,
// <t,s>, <t,t>.
#define SLOT_RHO 0
#define SLOT_RV 2
#define SLOT_TS 3

__global__ void __launch_bounds__(KRY_THREADS, 1)
bicgstab_fused_kernel(const float* __restrict__ data,
                      const int* __restrict__ cols,
                      const float* __restrict__ b, float* __restrict__ x_out,
                      float* __restrict__ rr_out, float* q_glob,
                      float* partials, int n, int k, int iters,
                      int rows_stride, int ca_max) {
    extern __shared__ float smem[];
    __shared__ float warp_part[2 * KRY_WARPS];
    __shared__ float sums[2];
    cg::grid_group grid = cg::this_grid();

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
    float* part_rho = partials + SLOT_RHO * g;     // then rr at + g
    float* part_rv = partials + SLOT_RV * g;
    float* part_ts = partials + SLOT_TS * g;       // then <t,t> at + g

    // Prologue: the cached rows of A, and b, each read once. rr0 = <b,b> is
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
        part = __fadd_rn(part, __fmul_rn(bv, bv));
    }
    warp_partial(part, 0, warp_part);
    block_partials(1, warp_part, part_rho, g);     // also orders the A copy
    grid.sync();
    grid_sums(1, part_rho, g, sums);
    float rho_new = sums[0], rr = sums[0];
    float rho = 1.f, alpha = 1.f, omega = 1.f;

    for (int it = 0; it < iters; ++it) {
        // p = r + beta (p - omega v), published for v = A p.
        const float beta = __fmul_rn(safe_div(rho_new, rho), safe_div(alpha, omega));
        for (int li = tid; li < nr; li += KRY_THREADS) {
            const float d = __fmul_rn(beta, __fsub_rn(ps[li], __fmul_rn(omega, vs[li])));
            const float p = __fadd_rn(rs[li], d);
            ps[li] = p;
            q_glob[r0 + li] = p;
        }
        grid.sync();

        // v = A p and the partial of <rhat,v>.
        part = 0.f;
        for (int li = tid; li < nr; li += KRY_THREADS) {
            const float v = ell_row(li, r0 + li, ca, ca_max, k, ad, ac, data,
                                    cols, q_glob);
            vs[li] = v;
            part = __fadd_rn(part, __fmul_rn(hs[li], v));
        }
        warp_partial(part, 0, warp_part);
        block_partials(1, warp_part, part_rv, g);
        grid.sync();
        grid_sums(1, part_rv, g, sums);
        const float alpha_n = safe_div(rho_new, sums[0]);

        // s = r - alpha v (in r's slot), published for t = A s.
        for (int li = tid; li < nr; li += KRY_THREADS) {
            const float s = __fsub_rn(rs[li], __fmul_rn(alpha_n, vs[li]));
            rs[li] = s;
            q_glob[r0 + li] = s;
        }
        grid.sync();

        // t = A s and the partials of <t,s> and <t,t>.
        float pts = 0.f, ptt = 0.f;
        for (int li = tid; li < nr; li += KRY_THREADS) {
            const float t = ell_row(li, r0 + li, ca, ca_max, k, ad, ac, data,
                                    cols, q_glob);
            ts[li] = t;
            pts = __fadd_rn(pts, __fmul_rn(t, rs[li]));
            ptt = __fadd_rn(ptt, __fmul_rn(t, t));
        }
        warp_partial(pts, 0, warp_part);
        warp_partial(ptt, 1, warp_part);
        block_partials(2, warp_part, part_ts, g);
        grid.sync();
        grid_sums(2, part_ts, g, sums);
        const float omega_n = safe_div(sums[0], sums[1]);

        // x += alpha p + omega s; r = s - omega t; the partials of the next
        // rho = <rhat,r> and of rr = <r,r>.
        float prho = 0.f, prr = 0.f;
        for (int li = tid; li < nr; li += KRY_THREADS) {
            const float s = rs[li];
            xs[li] = __fadd_rn(__fadd_rn(xs[li], __fmul_rn(alpha_n, ps[li])),
                               __fmul_rn(omega_n, s));
            const float r = __fsub_rn(s, __fmul_rn(omega_n, ts[li]));
            rs[li] = r;
            prho = __fadd_rn(prho, __fmul_rn(hs[li], r));
            prr = __fadd_rn(prr, __fmul_rn(r, r));
        }
        warp_partial(prho, 0, warp_part);
        warp_partial(prr, 1, warp_part);
        block_partials(2, warp_part, part_rho, g);
        grid.sync();
        grid_sums(2, part_rho, g, sums);
        rho = rho_new;
        rho_new = sums[0];
        rr = sums[1];
        alpha = alpha_n;
        omega = omega_n;
    }

    // Epilogue: x written once.
    for (int li = tid; li < nr; li += KRY_THREADS) x_out[r0 + li] = xs[li];
    if (bid == 0 && tid == 0) rr_out[0] = rr;
}

extern "C" int bicgstab_fused_smem(int* optin, int* static_bytes) {
    return kry_smem((const void*)bicgstab_fused_kernel, optin, static_bytes);
}

extern "C" int bicgstab_fused_max_ctas(int smem_bytes, int* out) {
    return kry_max_ctas((const void*)bicgstab_fused_kernel, smem_bytes, out);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `partials` holds 5 * grid floats, `q_glob` n floats.
extern "C" int bicgstab_fused_launch(const float* data, const int* cols,
                                     const float* b, float* x_out,
                                     float* rr_out, float* q_glob,
                                     float* partials, int n, int k, int iters,
                                     int rows_stride, int ca_max, int grid,
                                     int smem_bytes, cudaStream_t stream) {
    void* args[] = {(void*)&data, (void*)&cols, (void*)&b, (void*)&x_out,
                    (void*)&rr_out, (void*)&q_glob, (void*)&partials,
                    (void*)&n, (void*)&k, (void*)&iters, (void*)&rows_stride,
                    (void*)&ca_max};
    return kry_launch((const void*)bicgstab_fused_kernel, grid, smem_bytes,
                      args, stream);
}
