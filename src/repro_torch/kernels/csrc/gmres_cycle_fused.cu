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
//   * the SpMV w = A v_j forms v_j where it is gathered: the CTA's own
//     columns from its rows of V in shared memory, every other column c
//     from the published w of the step before (r before the first step) as
//     __fmul_rn(w[c], inv), inv = safe_div(1, hn) (1 / beta), the rounding
//     in which the owner formed its own v_j. So only the halo goes through
//     L2, and no barrier waits for v_j to be published. Row j of the output
//     V is written once, when v_j is formed, and never read by the kernel;
//   * a CGS2 projection h = V w is one walk over the CTA's rows: the warps
//     own values, KRY_WARPS / P of them a value (P the power of two >= j+1,
//     at most 16: a second walk for values 16 and up), each summing V[v] . w
//     over the rows lane-strided, so a warp sums one value by one butterfly.
//     w -= V^T h is local to each row (a pass and a block barrier before
//     the second projection). The sums are in another order than the PR 15
//     kernel's; its layout (all j+1 partials of a thread's rows in
//     registers) was slower on the H100 (PERF.md);
//   * every grid-wide sum is a tagged round (krylov_common.cuh
//     tagged_round) of up to KRY_WARPS = 32 values, warp v summing value v:
//     beta, then per step h1, h2 and ||w||. 1 + 3m rounds a cycle (49 at
//     m = 16) and no grid.sync(). h1 and h2 carry only their sums: their
//     words are stored relaxed, with no fence (a release waits for the
//     CTA's writes of V to reach L2); beta and ||w|| release the published
//     w;
//   * H and beta are the same in every CTA (the sums are taken in one
//     fixed order), so every CTA keeps [H | beta e1] in shared memory and
//     solves min ||H y - beta e1|| itself (Givens rotations by one warp,
//     lane c rotating column c, then back substitution on lane 0, as
//     ref.hessenberg_lstsq) and writes x + y V[:m] for its own rows: no
//     round after the last step and no trip to the host. CTA 0 writes
//     column j of H once, after step j, and beta once.
//
// The schedule (tests/test_torch_krylov_schedule.py models it and runs it
// under adversarial interleavings). Device memory: u[2], one float a row
// each; u_j, the vector v_j is formed from (u_0 = r, u_{j+1} = the w of
// step j), lives in u[j & 1].
//   prologue   writes u[0] = r                            -> round 1: <r,r>
//   step j:
//     spmv     gathers u[j & 1] = u_j, times the last
//              ordered round's 1/hn (1/beta)               -> h1 (relaxed)
//     update   (w -= h1 V, then the partials of h2)       -> h2 (relaxed)
//     norm     writes u[(j + 1) & 1] = w_j                -> round: ||w||
// Only the ordered rounds order device memory. With every round ordered,
// one buffer would do: a CTA overwrites it only after this step's h1
// round, which no CTA passes before every CTA has ended the SpMV that
// gathers it. With h1 and h2 relaxed, u_{j+1} goes to the other buffer,
// last gathered in step j - 1, before the ||w|| round of that step.
//
// Order follows ref.gmres_cycle_update: r = b - A x; beta = sqrt(<r,r>);
// v_0 = r * (1/beta); per step w = A v_j; h1 = V w; w -= h1 V; h2 = V w;
// w -= h2 V; hn = ||w||; v_{j+1} = w * (1/hn), the divisions zero-guarded
// and every product rounded before its add (-fmad=false). The sums of the
// projections and norms are in another order than torch's.
//
// Bound on the H100: the work is on chip after the prologue (A, b and x read
// once, V and x written once), so the 1 + 3m rounds and the gathers of the
// halo through L2 bound it, not device memory.
#include "krylov_common.cuh"

#define GMRES_MAX_V KRY_WARPS       // values a round's words hold; m + 1 <= 32
#define GMRES_RS (GMRES_MAX_V + 1)  // row stride of [H | beta e1] in shared

// v_j at a column: the CTA's own from its row of V in shared memory, any
// other formed from the published w as w[c] * inv.
struct GmresV {
    const float* own;
    int r0, nr;
    const float* w;
    float inv;
    struct Raw {
        float w;
    };
    __device__ bool mine(int c) const {
        return (unsigned)(c - r0) < (unsigned)nr;
    }
    __device__ void load(int c, Raw& x) const {
        if (!mine(c)) x.w = __ldcg(w + c);
    }
    __device__ float value(int c, const Raw& x) const {
        if (mine(c)) return own[c - r0];
        return __fmul_rn(x.w, inv);
    }
};

// The block's terms of V[v] . w for v < nv <= P, each warp's sum to
// warp_part[v * KRY_WARPS + warp] (tagged_round sums the warps'). row(li)
// gives w at the CTA's row li, and may form and write it. Every thread of
// the block calls it.
template <int P, class Row>
__device__ __forceinline__ void project_pass(int nv, int nr, const float* Vs,
                                             int stride, const float* ws,
                                             const Row& row,
                                             float* warp_part) {
    const int tid = threadIdx.x, lane = tid & 31;
    // Warps own values: the KRY_WARPS / P warps of value v sum V[v] . w
    // over the rows lane-strided, one term of the block's partial each.
    for (int li = tid; li < nr; li += KRY_THREADS) row(li);
    __syncthreads();
    constexpr int S = KRY_WARPS / P;
    const int v = (tid >> 5) / S, q = (tid >> 5) % S;
    if (v < nv) {
        float a = 0.f;
        for (int li = q * 32 + lane; li < nr; li += 32 * S)
            a = __fadd_rn(a, __fmul_rn(Vs[(size_t)v * stride + li], ws[li]));
        a = warp_sum(a);
        if (lane == 0) warp_part[v * KRY_WARPS + q] = a;
        if (q == 0 && lane >= S) warp_part[v * KRY_WARPS + lane] = 0.f;
    }
}

// project_pass at the smallest bucket P >= nv, at most 16 values a pass
// (two warps a value): values 16 and up in a second pass over the rows,
// which reads w as the first left it.
template <class Row>
__device__ __forceinline__ void project(int nv, int nr, const float* Vs,
                                        int stride, const float* ws,
                                        const Row& row, float* warp_part) {
    if (nv <= 1) project_pass<1>(nv, nr, Vs, stride, ws, row, warp_part);
    else if (nv <= 2) project_pass<2>(nv, nr, Vs, stride, ws, row, warp_part);
    else if (nv <= 4) project_pass<4>(nv, nr, Vs, stride, ws, row, warp_part);
    else if (nv <= 8) project_pass<8>(nv, nr, Vs, stride, ws, row, warp_part);
    else project_pass<16>(min(nv, 16), nr, Vs, stride, ws, row, warp_part);
    if (nv > 16)
        project_pass<16>(nv - 16, nr, Vs + (size_t)16 * stride, stride, ws,
                         [&](int li) { return ws[li]; },
                         warp_part + 16 * KRY_WARPS);
}

__global__ void __launch_bounds__(KRY_THREADS, 1)
gmres_cycle_kernel(const float* __restrict__ data,
                   const int* __restrict__ cols,
                   const float* __restrict__ x_in,
                   const float* __restrict__ b, float* __restrict__ V_out,
                   float* __restrict__ H_out, float* __restrict__ beta_out,
                   float* __restrict__ x_out, float* u,
                   unsigned long long* tags, int n, int k, int m,
                   int rows_stride) {
    extern __shared__ float smem[];
    __shared__ float warp_part[GMRES_MAX_V * KRY_WARPS];
    __shared__ float h1[GMRES_MAX_V], h2[GMRES_MAX_V], sums[1];
    __shared__ float R[GMRES_MAX_V * GMRES_RS], y[GMRES_MAX_V];  // [H | beta e1]

    const int g = gridDim.x, bid = blockIdx.x, tid = threadIdx.x;
    const int r0 = (int)((long long)bid * n / g);
    const int r1 = (int)((long long)(bid + 1) * n / g);
    const int nr = r1 - r0;
    const int stride = rows_stride;
    float* Vs = smem;                                  // (m+1, stride)
    float* ws = Vs + (size_t)(m + 1) * stride;
    float* ad = ws + stride;                           // (K, stride) slot-major
    int* ac = (int*)(ad + (size_t)stride * k);
    unsigned rnd = 0;

    // Prologue: the CTA's rows of A (all of them), then r = b - A x with x
    // gathered from device memory; r waits in w's slot and is published in
    // u[0] for the first SpMV's gathers by the beta round.
    cache_rows(r0, nr, stride, k, data, cols, ad, ac);
    __syncthreads();
    float part = 0.f;
    for (int li = tid; li < nr; li += KRY_THREADS) {
        const float r = __fsub_rn(__ldg(b + r0 + li),
                                  ell_row(li, r0 + li, nr, stride, k, ad, ac,
                                          data, cols, x_in));
        ws[li] = r;
        u[r0 + li] = r;
        part = __fadd_rn(part, __fmul_rn(r, r));
    }
    warp_partial(part, 0, warp_part);
    tagged_round<GMRES_MAX_V>(1, warp_part, tags, g, ++rnd, sums);
    const float beta = __fsqrt_rn(sums[0]);
    if (tid <= m) R[tid * GMRES_RS + m] = tid == 0 ? beta : 0.f;
    float inv = safe_div(1.f, beta);
    KRY_MARK(-1);

    for (int j = 0;; ++j) {
        // v_j = w * inv over the CTA's rows, to shared memory and once to V.
        float* vj = Vs + (size_t)j * stride;
        float* vo = V_out + (size_t)j * n + r0;
        for (int li = tid; li < nr; li += KRY_THREADS) {
            const float v = __fmul_rn(ws[li], inv);
            vj[li] = v;
            vo[li] = v;
        }
        __syncthreads();
        if (j == m) break;
        const int nv = j + 1;

        // w = A v_j, v_j formed at the gather; the partials of h1 = V w.
        KRY_MARK(0);
        const GmresV q{vj, r0, nr, u + (size_t)(j & 1) * n, inv};
        for (int li = tid; li < nr; li += KRY_THREADS)
            ws[li] = ell_row_q(li, r0 + li, nr, stride, k, ad, ac, data,
                               cols, q);
        KRY_MARK(5);
        project(nv, nr, Vs, stride, ws, [&](int li) { return ws[li]; },
                warp_part);
        KRY_MARK(6);
        tagged_round<GMRES_MAX_V, false>(nv, warp_part, tags, g, ++rnd, h1);

        // w -= h1 V, then the partials of h2 = V w.
        project(nv, nr, Vs, stride, ws, [&](int li) {
            float acc = 0.f;
            for (int v = 0; v < nv; ++v)
                acc = __fadd_rn(acc, __fmul_rn(h1[v], Vs[(size_t)v * stride + li]));
            const float w = __fsub_rn(ws[li], acc);
            ws[li] = w;
            return w;
        }, warp_part);
        KRY_MARK(6);
        tagged_round<GMRES_MAX_V, false>(nv, warp_part, tags, g, ++rnd, h2);

        // w -= h2 V, published in the other buffer for the next SpMV's
        // gathers (its last gathers, in step j - 1, ended before that
        // step's ||w|| round); the partial of ||w||^2.
        float* un = u + (size_t)((j + 1) & 1) * n;
        part = 0.f;
        for (int li = tid; li < nr; li += KRY_THREADS) {
            float acc = 0.f;
            for (int v = 0; v < nv; ++v)
                acc = __fadd_rn(acc, __fmul_rn(h2[v], Vs[(size_t)v * stride + li]));
            const float w = __fsub_rn(ws[li], acc);
            ws[li] = w;
            un[r0 + li] = w;
            part = __fadd_rn(part, __fmul_rn(w, w));
        }
        warp_partial(part, 0, warp_part);
        KRY_MARK(6);
        tagged_round<GMRES_MAX_V>(1, warp_part, tags, g, ++rnd, sums);
        const float hn = __fsqrt_rn(sums[0]);

        // Column j of H (every CTA's copy; CTA 0's to H_out).
        if (tid <= m) {
            const float h = tid < nv ? __fadd_rn(h1[tid], h2[tid])
                                     : (tid == nv ? hn : 0.f);
            R[tid * GMRES_RS + j] = h;
            if (bid == 0) H_out[(size_t)tid * m + j] = h;
        }
        inv = safe_div(1.f, hn);
    }
    if (bid == 0 && tid == 0) beta_out[0] = beta;

    // y = argmin ||H y - beta e1|| (ref.hessenberg_lstsq): rotation j turns
    // rows j, j+1 of R by (cos, sin) = (a, c) / hypot(a, c), the identity
    // for a zero pair; then back substitution, zero-guarded, so the columns
    // after an Arnoldi breakdown get y = 0. The block barrier after v_m made
    // R whole.
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
    KRY_MARK(0);
    KRY_PROF_END();
}

extern "C" int gmres_cycle_fused_smem(int* optin, int* static_bytes) {
    return kry_smem((const void*)gmres_cycle_kernel, optin, static_bytes);
}

#ifdef KRY_PROFILE
extern "C" int gmres_cycle_fused_profile(unsigned long long* out) {
    return kry_profile(out);
}
#endif

extern "C" int gmres_cycle_fused_max_ctas(int smem_bytes, int* out) {
    return kry_max_ctas((const void*)gmres_cycle_kernel, smem_bytes, out);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `u` holds 2 n floats, `tags` kry_tag_bytes(grid, GMRES_MAX_V) bytes,
// zeroed here before the launch. V_out is (m+1, n), H_out (m+1, m) and
// x_out (n,), all written in full; x_out must not alias x_in.
extern "C" int gmres_cycle_fused_launch(const float* data, const int* cols,
                                        const float* x_in, const float* b,
                                        float* V_out, float* H_out,
                                        float* beta_out, float* x_out,
                                        float* u,
                                        unsigned long long* tags,
                                        int n, int k, int m, int rows_stride,
                                        int grid, int smem_bytes,
                                        cudaStream_t stream) {
    int e = kry_zero_tags(tags, grid, stream, GMRES_MAX_V);
    if (e != 0) return e;
    void* args[] = {(void*)&data, (void*)&cols, (void*)&x_in, (void*)&b,
                    (void*)&V_out, (void*)&H_out, (void*)&beta_out,
                    (void*)&x_out, (void*)&u, (void*)&tags, (void*)&n,
                    (void*)&k, (void*)&m, (void*)&rows_stride};
    return kry_launch((const void*)gmres_cycle_kernel, grid, smem_bytes, args,
                      stream);
}
