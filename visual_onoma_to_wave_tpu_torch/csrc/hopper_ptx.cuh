// Hopper PTX helpers shared by the port's kernels (mrf.cu, convnext.cu,
// flash_mha.cu, conv1d_tc.cu): mbarrier init / arrive / expect_tx / wait,
// the bulk copy that completes on an mbarrier, the generic-to-async proxy
// fence, the wgmma fence / commit / wait, the register fence that keeps
// accumulators in place across a wait, the shared-memory matrix descriptor
// of an unswizzled K-major operand, and the wgmma m64nNk8 tf32 and m64nNk16
// bf16 wrappers with both operands in shared memory at N 8 to 128.
//
// Each source is compiled on its own (ops/cuda_build.py, whose hash covers
// this header too) and includes this file once, after <stdint.h>; everything
// here has internal linkage, so a source may add Wgmma<N> at another N in
// its own anonymous namespace (conv1d_tc.cu: N 80).
#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// whether the barrier's phase of parity `parity` has completed, without waiting
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// one contiguous copy from device memory to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// the stagers' plain stores become visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N of this warpgroup's wgmma groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across a wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand without swizzle: 8-row
// x 16-byte core matrices of 128 contiguous bytes, `lbo` bytes apart along K
// and 128 bytes apart along M / N. The start address needs 16-byte alignment.
__device__ __forceinline__ uint64_t desc_of(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// wgmma m64nNk8 (tf32) and m64nNk16 (bf16), A and B from shared memory (both
// K-major), fp32 accumulators d[N / 2]: d = A B^T + (scale_d ? d : 0).
template <int N>
struct Wgmma;
template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void tf32(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3"
                 "}, %4, %5, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3"
                 "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void tf32(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7"
                 "}, %8, %9, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7])
                 : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7"
                 "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7])
                 : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void tf32(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15"
                 "}, %16, %17, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
                 : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15"
                 "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
                 : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void tf32(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31"
                 "}, %32, %33, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
                   "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31])
                 : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31"
                 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
                   "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31])
                 : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void tf32(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
                 "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
                 "%60, %61, %62, %63"
                 "}, %64, %65, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
                   "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
                   "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
                   "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
                   "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
                   "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
                   "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
                 : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
                 "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
                 "%60, %61, %62, %63"
                 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
                   "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
                   "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
                   "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
                   "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
                   "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
                   "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
                 : "l"(da), "l"(db), "r"(scale_d));
  }
};

}  // namespace
