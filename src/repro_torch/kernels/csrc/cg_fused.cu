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
//   * the SpMV of its rows gathers p from a device-memory copy `p_glob`
//     that every CTA publishes its rows of p to once per iteration (p is
//     the one vector other rows read); the gathers hit L2;
//   * the matrix: the leading `ca` rows of the CTA's range stay in shared
//     memory (slot-major, so neighbouring threads read neighbouring banks),
//     the rest is streamed from device memory every iteration. ca = 0 is
//     the paper's VEC policy, ca = all rows its MIX with the whole matrix
//     on chip, anything between is partial MIX: on the H100 a large A does
//     not fit beside the vectors, so part of it stays on chip;
//   * the two dot products of an iteration are grid-wide: each CTA writes
//     its partial sum (a fixed tree over its threads) to device memory,
//     grid.sync(), and every CTA sums the partials in the same fixed order,
//     so all CTAs hold the same alpha and beta and a run repeats bit for
//     bit. No float atomics.
// Order within an iteration follows ref.cg_iteration_matvec: Ap = A p;
// alpha = rr / (p.Ap); x += alpha p; r -= alpha Ap; rr' = r.r;
// beta = rr' / rr; p = r + beta p. Divisions are _safe_div
// (|b| > 0 ? a / b : 0) and every product is rounded before its add
// (-fmad=false), as torch computes the plain version; only the order of
// the dot products' sums differs from torch.dot.
// Three grid.sync() per iteration: after the SpMV partials, after the r.r
// partials, and after p is published.
//
// Bound on the H100: device memory for the streamed rows of A, 8 B per
// stored slot per iteration, plus the p gathers through L2; with A wholly
// on chip, the grid barriers and the latency of the gathers.
#include "krylov_common.cuh"

__global__ void __launch_bounds__(KRY_THREADS, 1)
cg_fused_kernel(const float* __restrict__ data, const int* __restrict__ cols,
                const float* __restrict__ b, float* __restrict__ x_out,
                float* __restrict__ rr_out, float* p_glob, float* partials,
                int n, int k, int iters, int rows_stride, int ca_max) {
    extern __shared__ float smem[];
    __shared__ float warp_part[KRY_WARPS];
    __shared__ float sums[1];
    cg::grid_group grid = cg::this_grid();

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
    float* part_pap = partials;                    // slot A: p.Ap partials
    float* part_rr = partials + g;                 // slot B: r.r partials

    // Prologue: the cached rows of A, and b, each read once.
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
    block_partials(1, warp_part, part_rr, g);      // also orders the A copy
    grid.sync();
    grid_sums(1, part_rr, g, sums);
    float rr = sums[0];

    for (int it = 0; it < iters; ++it) {
        // Ap = A p over the CTA's rows, and the partial of p.Ap.
        part = 0.f;
        for (int li = tid; li < nr; li += KRY_THREADS) {
            const float acc = ell_row(li, r0 + li, ca, ca_max, k, ad, ac,
                                      data, cols, p_glob);
            aps[li] = acc;
            part = __fadd_rn(part, __fmul_rn(ps[li], acc));
        }
        warp_partial(part, 0, warp_part);
        block_partials(1, warp_part, part_pap, g);
        grid.sync();
        grid_sums(1, part_pap, g, sums);
        const float alpha = safe_div(rr, sums[0]);

        // x += alpha p; r -= alpha Ap; the partial of r.r.
        part = 0.f;
        for (int li = tid; li < nr; li += KRY_THREADS) {
            xs[li] = __fadd_rn(xs[li], __fmul_rn(alpha, ps[li]));
            const float r = __fsub_rn(rs[li], __fmul_rn(alpha, aps[li]));
            rs[li] = r;
            part = __fadd_rn(part, __fmul_rn(r, r));
        }
        warp_partial(part, 0, warp_part);
        block_partials(1, warp_part, part_rr, g);
        grid.sync();
        grid_sums(1, part_rr, g, sums);
        const float rr_new = sums[0];
        const float beta = safe_div(rr_new, rr);
        rr = rr_new;

        // p = r + beta p, published for the next iteration's gathers.
        for (int li = tid; li < nr; li += KRY_THREADS) {
            const float pn = __fadd_rn(rs[li], __fmul_rn(beta, ps[li]));
            ps[li] = pn;
            p_glob[r0 + li] = pn;
        }
        grid.sync();
    }

    // Epilogue: x written once.
    for (int li = tid; li < nr; li += KRY_THREADS) x_out[r0 + li] = xs[li];
    if (bid == 0 && tid == 0) rr_out[0] = rr;
}

extern "C" int cg_fused_smem(int* optin, int* static_bytes) {
    return kry_smem((const void*)cg_fused_kernel, optin, static_bytes);
}

extern "C" int cg_fused_max_ctas(int smem_bytes, int* out) {
    return kry_max_ctas((const void*)cg_fused_kernel, smem_bytes, out);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `partials` holds 2 * grid floats, `p_glob` n floats.
extern "C" int cg_fused_launch(const float* data, const int* cols,
                               const float* b, float* x_out, float* rr_out,
                               float* p_glob, float* partials, int n, int k,
                               int iters, int rows_stride, int ca_max, int grid,
                               int smem_bytes, cudaStream_t stream) {
    void* args[] = {(void*)&data, (void*)&cols, (void*)&b, (void*)&x_out,
                    (void*)&rr_out, (void*)&p_glob, (void*)&partials,
                    (void*)&n, (void*)&k, (void*)&iters, (void*)&rows_stride,
                    (void*)&ca_max};
    return kry_launch((const void*)cg_fused_kernel, grid, smem_bytes, args,
                      stream);
}
