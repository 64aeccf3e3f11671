// PERKS GMRES(m): one restart cycle (the Arnoldi process with two
// classical Gram-Schmidt passes, CGS2, then the small least-squares solve
// and the update of x) in one cooperative persistent launch, the basis V and
// the whole of A kept in shared memory for the cycle's life.
//
// Replaces: src/repro/kernels/krylov_fused.py:gmres_cycle_fused
// (`_gmres_cycle_kernel`), and the least-squares solve and x += y V[:m] that
// the reference's resident tier runs on the accelerator after it
// (src/repro/exec/krylov.py, GMRESProblem.run_resident). It is the cycle of
// the port's resident tier for GMRES (exec/krylov.py
// GMRESProblem.run_resident).
//
// The TPU kernel keeps V (m+1, n) in VMEM as its output buffer and projects
// on the whole basis with matrix products on one core. Here:
//   * each CTA owns a contiguous range of rows and keeps its columns of V
//     ((m+1) x rows), w and its rows of A (slot-major) in shared memory for
//     the whole cycle; the planner's GMRES gate offers this tier only when
//     all of A fits beside the basis, so no row of A is streamed;
//   * v_j is the vector every row reads in the SpMV w = A v_j: each CTA
//     writes its rows of v_j to row j of the output V once, when v_j is
//     formed, and the SpMV gathers from there through L2; the output V is
//     written exactly once and never read back from device memory by its
//     own CTA;
//   * a CGS2 projection h = V w is a round of j+1 grid-wide reductions at
//     once (krylov_common.cuh: warp v sums value v, so j+1 <= 32 and
//     m <= 31); w -= V^T h is then local to each row. Per inner step four
//     grid.sync(): the two projections, ||w||, and v_{j+1} published;
//   * H and beta are the same in every CTA (the sums are taken in one
//     fixed order), so every CTA keeps [H | beta e1] in shared memory and
//     solves min ||H y - beta e1|| itself (Givens rotations by one warp,
//     lane c rotating column c, then back substitution on lane 0, as
//     ref.hessenberg_lstsq) and writes x + y V[:m] for its own rows: no
//     further grid.sync() and no trip to the host. CTA 0 writes column j of
//     H once, after step j, and beta once.
// Order follows ref.gmres_cycle_update: r = b - A x; beta = sqrt(<r,r>);
// v_0 = r * (1/beta); per step w = A v_j; h1 = V w; w -= h1 V; h2 = V w;
// w -= h2 V; hn = ||w||; v_{j+1} = w * (1/hn), the divisions zero-guarded
// and every product rounded before its add (-fmad=false). The sums of the
// projections and norms are in another order than torch's.
//
// Bound on the H100: the work is on chip after the prologue (A, b and x read
// once, V and x written once), so the 4m+2 grid barriers and the gathers of
// v_j through L2 bound it, not device memory.
#include "krylov_common.cuh"

#define GMRES_MAX_V KRY_WARPS       // m + 1 <= 32 values per reduction round
#define GMRES_RS (GMRES_MAX_V + 1)  // row stride of [H | beta e1] in shared

__global__ void __launch_bounds__(KRY_THREADS, 1)
gmres_cycle_kernel(const float* __restrict__ data,
                   const int* __restrict__ cols,
                   const float* __restrict__ x_in,
                   const float* __restrict__ b, float* V_out,
                   float* __restrict__ H_out, float* __restrict__ beta_out,
                   float* __restrict__ x_out, float* partials, int n, int k,
                   int m, int rows_stride) {
    extern __shared__ float smem[];
    __shared__ float warp_part[GMRES_MAX_V * KRY_WARPS];
    __shared__ float h1[GMRES_MAX_V], h2[GMRES_MAX_V], sums[1];
    __shared__ float R[GMRES_MAX_V * GMRES_RS], y[GMRES_MAX_V];  // [H | beta e1]
    cg::grid_group grid = cg::this_grid();

    const int g = gridDim.x, bid = blockIdx.x, tid = threadIdx.x;
    const int r0 = (int)((long long)bid * n / g);
    const int r1 = (int)((long long)(bid + 1) * n / g);
    const int nr = r1 - r0;
    const int stride = rows_stride;
    float* Vs = smem;                                  // (m+1, stride)
    float* ws = Vs + (size_t)(m + 1) * stride;
    float* ad = ws + stride;                           // (K, stride) slot-major
    int* ac = (int*)(ad + (size_t)stride * k);
    float* part_h1 = partials;                         // (m+1) * g
    float* part_h2 = partials + (size_t)(m + 1) * g;   // (m+1) * g
    float* part_n = partials + (size_t)2 * (m + 1) * g; // g

    // Prologue: the CTA's rows of A (all of them), then r = b - A x with x
    // gathered from device memory; r waits in w's slot.
    cache_rows(r0, nr, stride, k, data, cols, ad, ac);
    __syncthreads();
    float part = 0.f;
    for (int li = tid; li < nr; li += KRY_THREADS) {
        const float r = __fsub_rn(__ldg(b + r0 + li),
                                  ell_row(li, r0 + li, nr, stride, k, ad, ac,
                                          data, cols, x_in));
        ws[li] = r;
        part = __fadd_rn(part, __fmul_rn(r, r));
    }
    warp_partial(part, 0, warp_part);
    block_partials(1, warp_part, part_n, g);
    grid.sync();
    grid_sums(1, part_n, g, sums);
    const float beta = __fsqrt_rn(sums[0]);
    if (tid <= m) R[tid * GMRES_RS + m] = tid == 0 ? beta : 0.f;
    float inv = safe_div(1.f, beta);
    for (int li = tid; li < nr; li += KRY_THREADS) {
        const float v = __fmul_rn(ws[li], inv);
        Vs[li] = v;
        V_out[r0 + li] = v;
    }
    grid.sync();

    for (int j = 0; j < m; ++j) {
        const int nv = j + 1;
        const float* vj = V_out + (size_t)j * n;
        // w = A v_j, and the partials of h1 = V w.
        for (int li = tid; li < nr; li += KRY_THREADS)
            ws[li] = ell_row(li, r0 + li, nr, stride, k, ad, ac, data, cols, vj);
        for (int v = 0; v < nv; ++v) {
            part = 0.f;
            for (int li = tid; li < nr; li += KRY_THREADS)
                part = __fadd_rn(part, __fmul_rn(Vs[(size_t)v * stride + li], ws[li]));
            warp_partial(part, v, warp_part);
        }
        block_partials(nv, warp_part, part_h1, g);
        grid.sync();
        grid_sums(nv, part_h1, g, h1);

        // w -= h1 V, and the partials of h2 = V w.
        for (int li = tid; li < nr; li += KRY_THREADS) {
            float acc = 0.f;
            for (int v = 0; v < nv; ++v)
                acc = __fadd_rn(acc, __fmul_rn(h1[v], Vs[(size_t)v * stride + li]));
            ws[li] = __fsub_rn(ws[li], acc);
        }
        for (int v = 0; v < nv; ++v) {
            part = 0.f;
            for (int li = tid; li < nr; li += KRY_THREADS)
                part = __fadd_rn(part, __fmul_rn(Vs[(size_t)v * stride + li], ws[li]));
            warp_partial(part, v, warp_part);
        }
        block_partials(nv, warp_part, part_h2, g);
        grid.sync();
        grid_sums(nv, part_h2, g, h2);

        // w -= h2 V, and the partial of ||w||^2.
        part = 0.f;
        for (int li = tid; li < nr; li += KRY_THREADS) {
            float acc = 0.f;
            for (int v = 0; v < nv; ++v)
                acc = __fadd_rn(acc, __fmul_rn(h2[v], Vs[(size_t)v * stride + li]));
            const float w = __fsub_rn(ws[li], acc);
            ws[li] = w;
            part = __fadd_rn(part, __fmul_rn(w, w));
        }
        warp_partial(part, 0, warp_part);
        block_partials(1, warp_part, part_n, g);
        grid.sync();
        grid_sums(1, part_n, g, sums);
        const float hn = __fsqrt_rn(sums[0]);

        // Column j of H (every CTA's copy; CTA 0's to H_out), and
        // v_{j+1} = w / hn published.
        if (tid <= m) {
            const float h = tid < nv ? __fadd_rn(h1[tid], h2[tid])
                                     : (tid == nv ? hn : 0.f);
            R[tid * GMRES_RS + j] = h;
            if (bid == 0) H_out[(size_t)tid * m + j] = h;
        }
        inv = safe_div(1.f, hn);
        float* vn = V_out + (size_t)(j + 1) * n;
        for (int li = tid; li < nr; li += KRY_THREADS) {
            const float v = __fmul_rn(ws[li], inv);
            Vs[(size_t)(j + 1) * stride + li] = v;
            vn[r0 + li] = v;
        }
        grid.sync();
    }
    if (bid == 0 && tid == 0) beta_out[0] = beta;

    // y = argmin ||H y - beta e1|| (ref.hessenberg_lstsq): rotation j turns
    // rows j, j+1 of R by (cos, sin) = (a, c) / hypot(a, c), the identity
    // for a zero pair; then back substitution, zero-guarded, so the columns
    // after an Arnoldi breakdown get y = 0. The loop's last grid.sync() made
    // R whole in every CTA.
    if (tid < 32) {
        for (int j = 0; j < m; ++j) {
            const float a = R[j * GMRES_RS + j], c = R[(j + 1) * GMRES_RS + j];
            const float rad = hypotf(a, c);
            const float cs = rad > 0.f ? __fdiv_rn(a, rad) : 1.f;
            const float sn = rad > 0.f ? __fdiv_rn(c, rad) : 0.f;
            __syncwarp();
            if (tid >= j && tid <= m) {
                const float top = R[j * GMRES_RS + tid];
                const float bot = R[(j + 1) * GMRES_RS + tid];
                R[j * GMRES_RS + tid] = __fadd_rn(__fmul_rn(cs, top),
                                                  __fmul_rn(sn, bot));
                R[(j + 1) * GMRES_RS + tid] = __fsub_rn(__fmul_rn(cs, bot),
                                                        __fmul_rn(sn, top));
            }
            __syncwarp();
        }
        if (tid == 0) {
            for (int i = m - 1; i >= 0; --i) {
                float acc = 0.f;
                for (int l = i + 1; l < m; ++l)
                    acc = __fadd_rn(acc, __fmul_rn(R[i * GMRES_RS + l], y[l]));
                y[i] = safe_div(__fsub_rn(R[i * GMRES_RS + m], acc),
                                R[i * GMRES_RS + i]);
            }
        }
    }
    __syncthreads();

    // x_new = x + y V[:m] for the CTA's rows.
    for (int li = tid; li < nr; li += KRY_THREADS) {
        float acc = 0.f;
        for (int v = 0; v < m; ++v)
            acc = __fadd_rn(acc, __fmul_rn(y[v], Vs[(size_t)v * stride + li]));
        x_out[r0 + li] = __fadd_rn(__ldg(x_in + r0 + li), acc);
    }
}

extern "C" int gmres_cycle_fused_smem(int* optin, int* static_bytes) {
    return kry_smem((const void*)gmres_cycle_kernel, optin, static_bytes);
}

extern "C" int gmres_cycle_fused_max_ctas(int smem_bytes, int* out) {
    return kry_max_ctas((const void*)gmres_cycle_kernel, smem_bytes, out);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `partials` holds (2 (m+1) + 1) * grid floats; V_out is (m+1, n), H_out
// (m+1, m) and x_out (n,), all written in full; x_out must not alias x_in.
extern "C" int gmres_cycle_fused_launch(const float* data, const int* cols,
                                        const float* x_in, const float* b,
                                        float* V_out, float* H_out,
                                        float* beta_out, float* x_out,
                                        float* partials,
                                        int n, int k, int m, int rows_stride,
                                        int grid, int smem_bytes,
                                        cudaStream_t stream) {
    void* args[] = {(void*)&data, (void*)&cols, (void*)&x_in, (void*)&b,
                    (void*)&V_out, (void*)&H_out, (void*)&beta_out,
                    (void*)&x_out, (void*)&partials, (void*)&n, (void*)&k, (void*)&m,
                    (void*)&rows_stride};
    return kry_launch((const void*)gmres_cycle_kernel, grid, smem_bytes, args,
                      stream);
}
