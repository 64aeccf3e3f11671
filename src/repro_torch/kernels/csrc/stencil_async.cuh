// Hopper's asynchronous copies shared by the stencil kernels: mbarriers in
// shared memory and 1D bulk copies (TMA without a tensor map) completing on
// one (csrc/stencil_tb.cu, the deep schedule's level-0 ring;
// csrc/stencil_perks.cu, the one-step kernel's window).
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_inval(uint32_t bar) {
    asm volatile("mbarrier.inval.shared::cta.b64 [%0];" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(bar) : "memory");
}

// Spin until the phase of parity `parity` of the mbarrier has completed,
// or trap once it has waited `cycles` clock cycles: a wait that can never
// end then fails the launch with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar,
                                                  uint32_t parity,
                                                  long long cycles) {
    uint32_t done = 0;
    long long start = 0;
    while (true) {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (start == 0)
            start = clock64();
        else if (clock64() - start > cycles)
            __trap();
    }
}

// `bytes` (a multiple of 16) from device memory at `src` into shared memory
// at `dst` (both 16-byte aligned), completing on mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];"
                 :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Ask L2 to fetch `bytes` (a multiple of 16) of device memory from `src`
// (16-byte aligned) ahead of a later copy.
__device__ __forceinline__ void bulk_prefetch_l2(const void* src, uint32_t bytes) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                 :: "l"(src), "r"(bytes) : "memory");
}
