// One Jacobi step of a stencil, out of place: src -> dst.
//
// Replaces: src/repro/kernels/stencil2d.py:stencil_baseline_step (the TPU
// `_perks_kernel` with steps=1, cached_rows=0). It is the step of the
// port's host_loop tier (one launch per step) and, captured N times into a
// CUDA graph, of its device_loop tier; on `[B, ...]` it steps B domains in
// one launch (the batched loop tiers).
//
// Bound on the H100: device memory. One step must read the domain once and
// write it once, 2 * B * H * P * sizeof(T) bytes at 3.35 TB/s (T is float
// or __nv_bfloat16, chosen at launch). The arithmetic (2 * npoints flops a
// cell) is below that on every Table-III spec, but not by much on the wide
// ones (2ds25pt: 0.050 ms against 0.160 at 8192^2 f32), so the design also
// keeps the instructions a term few.
//
// Design: each input value crosses from device memory to an SM once, and
// from shared memory to a thread's registers about once.
//  - A CTA owns a tile of the in-row cells (2D: a strip of columns; 3D: a
//    (y, x) tile of the plane) with its r-wide halo, and walks a segment of
//    the leading axis (rows in 2D, planes in 3D), reading r rows past each
//    end of it.
//  - It keeps a ring of 2r + 1 + STEP_PREFETCH rows of its tile in shared
//    memory. Every thread copies its 16-byte chunks of the row STEP_PREFETCH
//    rows ahead with cp.async; one __syncthreads a row publishes them.
//  - A thread computes V = 16 / sizeof(T) adjacent cells of a row (4 f32, 8
//    bf16) and reads its neighbours' windows with 16-byte shared-memory
//    loads. Where every point off the centre row lies on the leading axis
//    (the star specs, 3d17pt), those neighbours stay in a register queue of
//    2r + 1 chunks that moves down one row a step: one 16-byte load a row
//    per thread.
//  - The Table-III specs are compiled shapes: their offsets are constants,
//    so every window and queue entry is a register and every weight an
//    immediate operand from the kernel's parameters. The launch matches a
//    spec against them offset by offset; any other spec takes a runtime
//    path (one shared-memory load a term, the same ring).
//  - The launch geometry (tile, ring, shared memory, and segments of the
//    leading axis such that one wave of CTAs, as many as the card holds,
//    covers the domain) comes from kernels/stencil2d.py:step_layout.
//
// Measured on an H100 (PERF.md §6, row 2 by spec): every Table-III spec
// in f32 at 52-76% of its byte bound (8192^2 in 2D, 256^3 in 3D), where
// the previous one-cell-a-thread kernel, whose blocks re-read every
// neighbour row through L2, reached 6-54%.
//
// Every cell is the same function of the same neighbours as before and as
// the plain torch version: the terms in the spec's order, each product and
// partial sum rounded as stencil_common.cuh says. bf16 sums add pairs of
// cells with add.bf16x2: for two bf16 operands a float32 sum rounded to
// bf16 equals the sum rounded to bf16 once (float32 has at least 2 * 8 + 2
// bits; double rounding is innocuous), so it is plus() bit for bit.
//
// Rows whose width is not a multiple of 16 bytes (or tensors that do not
// start on a 16-byte boundary) are copied and stored cell by cell inside
// the same kernel (StepArgs::aligned = 0; the wrapper counts them).
//
// Batched: B domains of the same shape, stored one after another, step in
// ONE launch; the instance is the grid's z index and a tile never crosses
// instances, so every instance's result is bit-equal to its own launch.
#include <stdint.h>

#include "stencil_common.cuh"

// Threads a CTA at most, rows (planes) in flight ahead of the 2r + 1 in
// use, and 16-byte chunks of a ring slot a thread copies at most. Mirrored
// in kernels/stencil2d.py (STEP_THREADS, STEP_PREFETCH, STEP_FILL).
constexpr int STEP_THREADS = 256;
constexpr int STEP_PREFETCH = 3;
constexpr int STEP_FILL = 4;

// The launch geometry (kernels/stencil2d.py:step_layout; ctypes mirrors
// this layout). A tile is `rows` plane rows (1 in 2D) of `lanes * V` cells;
// a ring slot is its rows and r-row halo (3D), each `span` cells wide.
struct StepArgs {
    int lanes;    // threads across a tile row
    int rows;     // plane rows of a tile (3D; 1 in 2D)
    int ra;       // halo cells each side of a ring row: r rounded up to V
    int span;     // cells of a ring row: lanes * V + 2 * ra
    int slot;     // cells of a ring slot: (rows + 2r) * span (3D), span (2D)
    int slots;    // ring slots: 2r + 1 + STEP_PREFETCH
    int seg;      // leading-axis rows (planes) of a CTA
    int tiles_x;  // tiles across a plane row
    int aligned;  // 1: 16-byte rows and tensors; 0: copied cell by cell
};

// -- the compiled shapes -----------------------------------------------------

struct Off {
    int d0, d1, d2;
};

enum { STEP_STAR = 0, STEP_BOX = 1, STEP_3D17 = 2, STEP_POISSON = 3 };

__host__ __device__ constexpr int ipow(int b, int e) { return e == 0 ? 1 : b * ipow(b, e - 1); }
__host__ __device__ constexpr int floordiv(int a, int b) {
    return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// The offsets of kernels/common.py's generators, point k in the spec's
// order (d1 = 0 in 2D): _star (the centre, then each axis's -d, +d for d =
// 1..r), _box (lexicographic, last axis fastest), _3d17pt and _poisson3d.
template <int F, int ND, int R>
struct Shape {
    static constexpr int nd = ND, r = R;
    static constexpr int n = F == STEP_STAR ? 1 + 2 * ND * R
                           : F == STEP_BOX  ? ipow(2 * R + 1, ND)
                           : F == STEP_3D17 ? 17
                                            : 19;
    // every point off the centre row (plane) lies on the leading axis
    static constexpr bool queue = F == STEP_STAR || F == STEP_3D17;

    __host__ __device__ static constexpr Off axis(int ax, int s) {
        return ND == 2 ? Off{ax == 0 ? s : 0, 0, ax == 1 ? s : 0}
                       : Off{ax == 0 ? s : 0, ax == 1 ? s : 0, ax == 2 ? s : 0};
    }
    __host__ __device__ static constexpr Off at(int k) {
        if (F == STEP_STAR) {
            if (k == 0) return Off{0, 0, 0};
            const int m = k - 1, rem = m % (2 * R), d = rem / 2 + 1;
            return axis(m / (2 * R), rem % 2 ? d : -d);
        }
        if (F == STEP_BOX) {
            const int b = 2 * R + 1;
            return ND == 2 ? Off{k / b - R, 0, k % b - R}
                           : Off{k / (b * b) - R, (k / b) % b - R, k % b - R};
        }
        if (F == STEP_3D17) {
            constexpr int t[17][3] = {
                {0, 0, 0}, {-1, 0, 0}, {1, 0, 0}, {0, -1, 0}, {0, 1, 0},
                {0, 0, -1}, {0, 0, 1}, {0, 1, 1}, {0, 1, -1}, {0, -1, 1},
                {0, -1, -1}, {2, 0, 0}, {-2, 0, 0}, {0, 2, 0}, {0, -2, 0},
                {0, 0, 2}, {0, 0, -2}};
            return Off{t[k][0], t[k][1], t[k][2]};
        }
        // _poisson3d: the 3x3x3 box less its 8 corners, in box order
        int seen = 0;
        for (int j = 0; j < 27; ++j) {
            const Off o{j / 9 - 1, (j / 3) % 3 - 1, j % 3 - 1};
            const int l1 = (o.d0 < 0 ? -o.d0 : o.d0) + (o.d1 < 0 ? -o.d1 : o.d1) +
                           (o.d2 < 0 ? -o.d2 : o.d2);
            if (l1 <= 2 && seen++ == k) return o;
        }
        return Off{0, 0, 0};
    }
    // the in-row offsets point group (d0, d1) reaches: [lo, hi]; lo > hi
    // when the spec has no point there
    __host__ __device__ static constexpr int lo(int d0, int d1) {
        int v = R + 1;
        for (int k = 0; k < n; ++k) {
            const Off o = at(k);
            if (o.d0 == d0 && o.d1 == d1 && o.d2 < v) v = o.d2;
        }
        return v;
    }
    __host__ __device__ static constexpr int hi(int d0, int d1) {
        int v = -R - 1;
        for (int k = 0; k < n; ++k) {
            const Off o = at(k);
            if (o.d0 == d0 && o.d1 == d1 && o.d2 > v) v = o.d2;
        }
        return v;
    }
};

// Any other spec: offsets and weights read at run time.
struct RuntimeShape {
    static constexpr int n = 0, r = 0, nd = 0;
};

// The Table-III specs (kernels/common.py BENCHMARKS), in its order.
#define STEP_SHAPES(X)                                                        \
    X(STEP_STAR, 2, 1) X(STEP_STAR, 2, 2) X(STEP_STAR, 2, 3)                  \
    X(STEP_STAR, 2, 4) X(STEP_STAR, 2, 5) X(STEP_STAR, 2, 6)                  \
    X(STEP_BOX, 2, 1) X(STEP_BOX, 2, 2) X(STEP_STAR, 3, 1)                    \
    X(STEP_STAR, 3, 2) X(STEP_3D17, 3, 2) X(STEP_BOX, 3, 1)                   \
    X(STEP_POISSON, 3, 1)

template <class S>
static bool matches(const StencilArgs& a) {
    if (a.npts != S::n || a.r != S::r || a.ndim != S::nd) return false;
    for (int k = 0; k < S::n; ++k) {
        const Off o = S::at(k);
        if (a.d0[k] != o.d0 || a.d1[k] != o.d1 || a.d2[k] != o.d2) return false;
    }
    return true;
}

// -- cells of a 16-byte chunk ------------------------------------------------

// A chunk is four 32-bit words: 4 float cells or 8 bf16 cells (cell 2p in
// the low half of word p). get() is cell e of consecutive chunks, as float.
template <typename T> struct Cells;
template <> struct Cells<float> {
    static constexpr int V = 4;
    __device__ static float get(const uint32_t* w, int e) { return __uint_as_float(w[e]); }
};
template <> struct Cells<__nv_bfloat16> {
    static constexpr int V = 8;
    __device__ static float get(const uint32_t* w, int e) {
        return __uint_as_float(e & 1 ? w[e >> 1] & 0xFFFF0000u : w[e >> 1] << 16);
    }
};

template <int I> struct IC { static constexpr int value = I; };

// f(IC<I>{}), f(IC<I + 1>{}), ..., f(IC<N - 1>{}): a loop whose index is a
// constant in its body.
template <int I, int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
    if constexpr (I < N) {
        f(IC<I>{});
        static_for<I + 1, N>(f);
    }
}

__device__ __forceinline__ void load_chunk(uint32_t* w, const void* smem) {
    const uint4 v = *reinterpret_cast<const uint4*>(smem);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Cell e of a chunk's words as T's bits (cell-by-cell stores).
template <typename T>
__device__ __forceinline__ void store_cell(T* p, const uint32_t* w, int e) {
    if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<uint32_t*>(p) = w[e];
    } else {
        *reinterpret_cast<unsigned short*>(p) =
            (unsigned short)(e & 1 ? w[e >> 1] >> 16 : w[e >> 1] & 0xFFFFu);
    }
}

// -- the kernel --------------------------------------------------------------

template <class S, typename T>
__global__ void __launch_bounds__(STEP_THREADS)
stencil_step_kernel(const T* __restrict__ src, T* __restrict__ dst,
                    const __grid_constant__ StencilArgs a, const StepArgs g) {
    constexpr int V = Cells<T>::V;
    extern __shared__ __align__(16) unsigned char step_smem[];
    T* ring = reinterpret_cast<T*>(step_smem);

    const int H = a.H, D1 = a.D1, W = a.D2, P = a.P;
    const int r = S::n ? S::r : a.r;
    const int ry = (S::n ? S::nd : a.ndim) == 3 ? r : 0;
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int tyi = blockIdx.x / g.tiles_x, txi = blockIdx.x - tyi * g.tiles_x;
    const int x0 = txi * g.lanes * V, y0 = tyi * g.rows;
    const int s0 = blockIdx.y * g.seg, s1 = min(H, s0 + g.seg);
    const size_t inst = (size_t)blockIdx.z * H * P;
    src += inst;
    dst += inst;
    const int ly = tid / g.lanes, lx = tid - ly * g.lanes;
    const int oy = y0 + ly, ox = x0 + lx * V;         // this thread's first cell
    const int own = (ly + ry) * g.span + g.ra + lx * V;  // its chunk in a slot
    const bool store = oy < D1 && ox < W;
    const bool y_in = ry == 0 || (oy >= r && oy < D1 - r);

    // This thread's chunks of a ring slot (aligned rows): offset in the
    // slot and in the plane, -1 where the chunk lies outside the domain.
    const int cpr = g.span / V;
    const int chunks = (g.slot / g.span) * cpr;
    int soff[STEP_FILL], goff[STEP_FILL];
#pragma unroll
    for (int q = 0; q < STEP_FILL; ++q) {
        const int idx = tid + q * nthreads;
        const int row = idx / cpr, ch = idx - row * cpr;
        const int gy = y0 - ry + row, gx = x0 - g.ra + ch * V;
        soff[q] = row * g.span + ch * V;
        goff[q] = idx < chunks && gy >= 0 && gy < D1 && gx >= 0 && gx < W
                      ? gy * W + gx : -1;
    }
    // Copy local row L (plane s0 - r + L) into slot `sl`, if it is one the
    // segment reads; always one commit group.
    auto fill = [&](int L, int sl) {
        const int plane = s0 - r + L;
        if (plane >= 0 && plane < H && plane < s1 + r) {
            T* sp = ring + sl * g.slot;
            const T* gp = src + plane * P;
            if (g.aligned) {
#pragma unroll
                for (int q = 0; q < STEP_FILL; ++q)
                    if (goff[q] >= 0) cp_async16(sp + soff[q], gp + goff[q]);
            } else {
                for (int e = tid; e < g.slot; e += nthreads) {
                    const int row = e / g.span, c = e - row * g.span;
                    const int gy = y0 - ry + row, gx = x0 - g.ra + c;
                    if (gy >= 0 && gy < D1 && gx >= 0 && gx < W) sp[e] = gp[gy * W + gx];
                }
            }
        }
        cp_async_commit();
    };
    auto next = [&](int sl) { return sl + 1 == g.slots ? 0 : sl + 1; };
    // Write this thread's V cells of row i (words as a chunk).
    auto put = [&](int i, const uint32_t* w) {
        if (!store) return;
        T* p = dst + i * P + oy * W + ox;
        if (g.aligned) {
            *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
        } else {
#pragma unroll
            for (int v = 0; v < V; ++v)
                if (ox + v < W) store_cell(p + v, w, v);
        }
    };
    // The slot of the row d0 from the centre, the centre row's i - r in `cs`.
    auto slot_of = [&](int cs, int m) {  // m = d0 + r in [0, 2r]
        const int sl = cs + m;
        return sl >= g.slots ? sl - g.slots : sl;
    };

    int fs = 0;
    for (int L = 0; L < 2 * r + STEP_PREFETCH; ++L) {
        fill(L, fs);
        fs = next(fs);
    }

    if constexpr (S::n > 0) {
        constexpr int R = S::r, R1 = S::nd == 3 ? S::r : 0;
        constexpr int CB = floordiv(-R, V), CE = floordiv(V - 1 + R, V);
        constexpr int NW = 4 * (CE - CB + 1);   // words of a group's window
        constexpr int QN = S::queue ? 2 * R + 1 : 1;
        uint32_t q[QN][4];                       // own chunk, rows i-r..i+r
        int cs = 0;
        for (int j = 0; s0 + j < s1; ++j) {
            const int i = s0 + j;
            cp_async_wait_group<STEP_PREFETCH - 1>();
            __syncthreads();
            fill(j + 2 * r + STEP_PREFETCH, fs);
            fs = next(fs);
            const T* base = ring + own;
            if constexpr (S::queue) {
                if (j == 0) {
#pragma unroll
                    for (int m = 0; m < QN; ++m)
                        load_chunk(q[m], base + slot_of(cs, m) * g.slot);
                } else {
#pragma unroll
                    for (int m = 0; m + 1 < QN; ++m)
#pragma unroll
                        for (int c = 0; c < 4; ++c) q[m][c] = q[m + 1][c];
                    load_chunk(q[QN - 1], base + slot_of(cs, QN - 1) * g.slot);
                }
            }
            uint32_t ctr[4];  // own chunk of row i
            if constexpr (S::queue) {
#pragma unroll
                for (int c = 0; c < 4; ++c) ctr[c] = q[R][c];
            } else {
                load_chunk(ctr, base + slot_of(cs, R) * g.slot);
            }
            uint32_t out[4];
            if (i < r || i >= H - r) {
#pragma unroll
                for (int c = 0; c < 4; ++c) out[c] = ctr[c];
                put(i, out);
                cs = next(cs);
                continue;
            }
            // the windows of every group this thread reads from shared memory
            uint32_t win[2 * R + 1][2 * R1 + 1][NW];
            static_for<0, 2 * R + 1>([&](auto a0) {
                constexpr int d0 = decltype(a0)::value - R;
                if constexpr (!S::queue || d0 == 0) {
                    const T* rp = base + slot_of(cs, d0 + R) * g.slot;
                    static_for<0, 2 * R1 + 1>([&](auto a1) {
                        constexpr int d1 = decltype(a1)::value - R1;
                        constexpr int lo = S::lo(d0, d1), hi = S::hi(d0, d1);
                        if constexpr (lo <= hi) {
                            constexpr int c0 = floordiv(lo, V), c1 = floordiv(V - 1 + hi, V);
                            static_for<c0, c1 + 1>([&](auto ac) {
                                constexpr int c = decltype(ac)::value;
                                load_chunk(&win[d0 + R][d1 + R1][4 * (c - CB)],
                                           rp + d1 * g.span + c * V);
                            });
                        }
                    });
                }
            });
            // the cell of point k for cell v of this thread's chunk, as float
            auto value = [&](auto kc, int v) -> float {
                constexpr Off o = S::at(decltype(kc)::value);
                if constexpr (S::queue && o.d0 != 0)
                    return Cells<T>::get(q[o.d0 + R], v);
                else
                    return Cells<T>::get(win[o.d0 + R][o.d1 + R1], v + o.d2 - CB * V);
            };
            bool in[V];
#pragma unroll
            for (int v = 0; v < V; ++v)
                in[v] = y_in && ox + v >= r && ox + v < W - r;
            if constexpr (sizeof(T) == 4) {
                float acc[V];
                static_for<0, S::n>([&](auto kc) {
                    const float w = a.w[decltype(kc)::value];
#pragma unroll
                    for (int v = 0; v < V; ++v) {
                        const float t = __fmul_rn(value(kc, v), w);
                        acc[v] = decltype(kc)::value == 0 ? t : __fadd_rn(acc[v], t);
                    }
                });
#pragma unroll
                for (int v = 0; v < V; ++v)
                    out[v] = in[v] ? __float_as_uint(acc[v]) : ctr[v];
            } else {
                __nv_bfloat162 acc[V / 2];
                static_for<0, S::n>([&](auto kc) {
                    const float w = a.w[decltype(kc)::value];
#pragma unroll
                    for (int p = 0; p < V / 2; ++p) {
                        const __nv_bfloat162 t = __floats2bfloat162_rn(
                            __fmul_rn(value(kc, 2 * p), w),
                            __fmul_rn(value(kc, 2 * p + 1), w));
                        acc[p] = decltype(kc)::value == 0 ? t : __hadd2(acc[p], t);
                    }
                });
#pragma unroll
                for (int p = 0; p < V / 2; ++p) {
                    const uint32_t m = (in[2 * p] ? 0xFFFFu : 0u) |
                                       (in[2 * p + 1] ? 0xFFFF0000u : 0u);
                    const uint32_t s = (uint32_t)__bfloat16_as_ushort(acc[p].x) |
                                       (uint32_t)__bfloat16_as_ushort(acc[p].y) << 16;
                    out[p] = (s & m) | (ctr[p] & ~m);
                }
            }
            put(i, out);
            cs = next(cs);
        }
    } else {
        // Any other spec: every term one shared-memory load at run-time
        // offsets, summed by term()/plus().
        int cs = 0;
        for (int j = 0; s0 + j < s1; ++j) {
            const int i = s0 + j;
            cp_async_wait_group<STEP_PREFETCH - 1>();
            __syncthreads();
            fill(j + 2 * r + STEP_PREFETCH, fs);
            fs = next(fs);
            uint32_t ctr[4], out[4];
            load_chunk(ctr, ring + slot_of(cs, r) * g.slot + own);
            if (i < r || i >= H - r) {
                put(i, ctr);
                cs = next(cs);
                continue;
            }
            T acc[V];
#pragma unroll
            for (int v = 0; v < V; ++v) {
                for (int k = 0; k < a.npts; ++k) {
                    const T x = ring[slot_of(cs, a.d0[k] + r) * g.slot + own +
                                     a.d1[k] * g.span + v + a.d2[k]];
                    acc[v] = k == 0 ? term(x, a.w[k]) : plus(acc[v], term(x, a.w[k]));
                }
            }
            T* o = reinterpret_cast<T*>(out);
            const T* c = reinterpret_cast<const T*>(ctr);
#pragma unroll
            for (int v = 0; v < V; ++v)
                o[v] = y_in && ox + v >= r && ox + v < W - r ? acc[v] : c[v];
            put(i, out);
            cs = next(cs);
        }
    }
    cp_async_wait_group<0>();
}

template <class S, typename T>
static int launch(const void* src, void* dst, const StencilArgs& a,
                  const StepArgs& g, dim3 grid, int threads, int smem,
                  cudaStream_t stream) {
    auto kernel = stencil_step_kernel<S, T>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, threads, smem, stream>>>((const T*)src, (T*)dst, a, g);
    return (int)cudaGetLastError();
}

template <class S, typename T>
static int occupancy(int threads, int smem, int* per_sm) {
    auto kernel = stencil_step_kernel<S, T>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                             threads, smem);
}

// f(S{}) for the compiled shape `a` matches (*shape: its index in
// STEP_SHAPES), or for RuntimeShape (*shape = -1).
template <class F>
static int with_shape(const StencilArgs& a, int* shape, F&& f) {
    int k = 0;
#define STEP_TRY(FAM, ND, R)                                                  \
    if (matches<Shape<FAM, ND, R>>(a)) {                                      \
        *shape = k;                                                           \
        return f(Shape<FAM, ND, R>{});                                        \
    }                                                                         \
    ++k;
    STEP_SHAPES(STEP_TRY)
#undef STEP_TRY
    *shape = -1;
    return f(RuntimeShape{});
}

// Launches on `stream` one step of `batch` domains stored one after
// another (batch = 1: one domain) of elements `dtype` (STENCIL_F32 or
// STENCIL_BF16) with the geometry `g` on a grid of `grid_x` tiles by
// `grid_y` segments; sets *shape to the compiled shape the spec matched
// (its index in STEP_SHAPES) or -1 (the runtime path), and returns the
// cudaError_t of the launch (0 = success).
extern "C" int stencil_step_launch(const void* src, void* dst, StencilArgs a,
                                   StepArgs g, int dtype, int batch,
                                   int grid_x, int grid_y, int smem,
                                   cudaStream_t stream, int* shape) {
    const int threads = g.lanes * g.rows;
    const int V = dtype == STENCIL_BF16 ? 8 : 4;
    if (batch < 1 || batch > 65535 || grid_y < 1 || grid_y > 65535 ||
        grid_x < 1 || threads < 1 || threads > STEP_THREADS || g.span % V ||
        g.ra % V || g.slots < 2 * a.r + 1 + STEP_PREFETCH ||
        (g.slot / g.span) * (g.span / V) > STEP_FILL * threads)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(grid_x, grid_y, batch);
    return with_shape(a, shape, [&](auto s) {
        using S = decltype(s);
        return dtype == STENCIL_BF16
                   ? launch<S, __nv_bfloat16>(src, dst, a, g, grid, threads, smem, stream)
                   : launch<S, float>(src, dst, a, g, grid, threads, smem, stream);
    });
}

// CTAs of the kernel for spec `a` and `dtype` one SM holds at once with
// `threads` threads and `smem` bytes of dynamic shared memory each.
extern "C" int stencil_step_per_sm(StencilArgs a, int dtype, int threads,
                                   int smem, int* per_sm) {
    int shape;
    return with_shape(a, &shape, [&](auto s) {
        using S = decltype(s);
        return dtype == STENCIL_BF16
                   ? occupancy<S, __nv_bfloat16>(threads, smem, per_sm)
                   : occupancy<S, float>(threads, smem, per_sm);
    });
}
