// One HiFi-GAN multi-receptive-field (MRF) stage on Hopper's tensor cores.
//
// Replaces the TPU kernel visual_onoma_to_wave_tpu/ops/pallas_mrf.py::
// mrf_stage_fused (body _mrf_kernel, packing pack_mrf_weights). On x (B, C, T),
// per branch b (kernel k_b, dilations d_0..d_2):
//
//     y = x;  for each d:  h = conv_{k,d}(lrelu(y)) + bias
//                          y = y + conv_{k,1}(lrelu(h)) + bias
//     out = ((y_0 + y_1) + y_2) / 3
//
// every conv zero-padded at the edges of [0, T) (the TPU kernel masks each
// conv output to [0, T), pallas_mrf.py:115). Operands are fp32 or bf16: x, the
// weights and every conv input (after the leaky ReLU) are rounded to the
// operand type, products accumulate in fp32, the residual streams stay fp32
// and the output is rounded once (pallas_mrf.py:90-127).
//
// Three designs, chosen by ops/mrf.py::mrf_route from the width, the type
// and the stage's size (in bf16 a tile design takes a stage only with
// enough of its work items per SM, ops/mrf.py::MIN_ITEMS_PER_SM):
//   * bf16 at C 8, 16 and 32: one pass per frame tile, one launch a stage,
//     every conv of the tile on chip (below, "one pass per frame tile";
//     entry mrf_stage_onepass_fwd). It is built for C 64 too, where the conv
//     chain runs faster. At C >= 128 the tile's windows and residual stream
//     no longer fit in shared memory beside a weight ring (C 128 with 64
//     output frames: 224 KB before any weight);
//   * bf16 at C 64: one launch per residual unit, h in shared memory (below,
//     "one launch per residual unit"; entry mrf_stage_unit_fwd), 4 launches
//     a stage. It is built for C 128 and 256 too, where the conv chain runs
//     faster;
//   * fp32 at every width and bf16 at C 128 and above (and every stage too
//     small for a tile design): the conv chain (entry mrf_stage_fwd), 8
//     launches a stage through fp32 scratch, as follows.
//
// What bounds it. A stage does 6 * (3 + 7 + 11) * C^2 = 126 C^2 multiply-adds
// per position. fp32 runs as 3xTF32 (three TF32 products a multiply-add), so
// at 495 TFLOP/s the tensor-core bound is 6.4 ms at C 512 x T 1000 and C 32 x
// T 256000, 12.8 at C 256 x 8000 and C 64 x 128000, 25.6 at C 128 x 64000 (B
// 16); bf16 runs one product at 989 TFLOP/s (1.1 / 2.1 / 4.3 ms). The bytes
// are set by the structure below: 53 fp32 planes of (B, T, C) a stage.
//
// Layout: frames on wgmma's M, output channels on N. A conv is
//     out^T[t, co] = sum_j sum_ci in^T[t + (j - (k-1)/2) d, ci] A_j^T[ci, co],
// K = ci. wgmma's M is fixed at 64 while N takes any multiple of 8, so every
// width (C 8 to 512) fills every product; co on M would waste half of each
// product at C 32 and could not serve C 16 or 8.
//   * The input window of a tile is staged once per chunk of input channels,
//     channels-last, in the no-swizzle K-major layout: each 16-byte group of
//     channels (4 fp32, 8 bf16) is its own column of W = M + 2 pad frames,
//     one 16-byte row per frame, so 8 frames make one 128-byte core matrix
//     and the next group lies W * 16 bytes on (the descriptor's `lbo`). A
//     tap's shift by s frames is then the A descriptor's start address plus
//     16 s bytes: each of the k taps is one more descriptor into the same
//     window, with no copy per tap (core matrices need 16-byte alignment
//     only without swizzle).
//   * The leaky ReLU, the rounding to the operand type and, for fp32, the
//     split into hi = tf32(v) and lo = v - hi happen once, as the window is
//     staged; each tap then issues hi*lo, lo*hi and hi*hi (3xTF32; lo*lo,
//     ~2^-22 relative, is dropped) or one bf16 product.
//   * The weights of tap j are the B operand, K-major (co rows, ci
//     contiguous), packed once by ops/mrf.py::pack_mrf_kernel_weights in
//     core-matrix order, hi and lo TF32 planes for fp32. One stage of the
//     stream is one (ci chunk, tap) plane for the tile's NT output channels,
//     fetched by one cp.async.bulk completing on an mbarrier.
//   * The tensor cores' own fp32 accumulation truncates, and K is up to
//     11 * 512 deep: for fp32 each (16-channel chunk, tap) is one fresh
//     tensor-core sum (K 16), which the consumers add to their fp32
//     accumulators on the CUDA cores (tests/test_torch_mrf_tc.py repeats the
//     arithmetic: 3xTF32 lands within 1e-5 of the fp32 chain; one TF32
//     product does not). bf16 products are exact and its bound loose, so
//     there up to GROUP_MAX = 4 taps of a chunk make one sum (K 128): one
//     wait for the tensor cores per group, not per tap, keeps them fed
//     longer. (Four fp32 taps a sum, K 64, took the demo iSTFTNet-mel's
//     waveform from 6.3e-6 to 9.95e-6 of its 1e-5 bound against the JAX
//     golden, chip_smoke phase 9.)
//   * A CTA has 384 threads: two consumer warpgroups, each 64 * MB frames of
//     the tile's M = 128 * MB, and a producer warpgroup whose first warp
//     streams the weights (one thread) and whose other three stage the
//     windows into a ring of two, 8 loads in flight a thread (setmaxnreg:
//     200 registers a consumer thread, 104 a producer thread, 504 a lane in
//     all). The weight ring holds up to 128 KB of stages (8 of 16 KB at C >=
//     128 fp32, 16 of 4 KB at C 32), as many as the two windows leave room
//     for and never fewer than two groups, so the next group streams while
//     one is multiplied. Tile per width: NT = min(C, 128) output channels,
//     MB = 1 (C >= 128), 2 (C 64), 4 (C <= 32), so that each consumer holds
//     64 accumulators and 64 of the fresh sum. One CTA per SM walks the
//     (branch, item, frame tile, channel tile) items of a conv in a strided
//     loop, the k = 11 branch first. The epilogue issues all its loads (bias,
//     conv2's residual) before its first store.
//   * bf16 at C 8 has 8 channels, half of wgmma's k16: the window's second
//     group is staged as zeros and the packed weights carry zero columns.
//
// Structure of the conv chain. A stage is 8 launches on the caller's stream: x to a
// channels-last fp32 copy, then the 6 convs of the branches' chains (the
// three branches' convs of one dilation side by side in one launch), then the
// average back to (B, C, T). conv1 writes h_b = conv + bias; conv2 reads h_b
// as its input and y_b (x at the first dilation) as its residual, and writes
// y_b in place, each element by the thread that read it. The wrapper
// allocates 7 fp32 planes of scratch: x^T, y_0..y_2, h_0..h_2.
// Bytes a stage (chip_smoke.py::mrf_design_bytes), in planes of B*T*C*4: 1
// (x^T) + per conv its input with the tile's halo, its output and conv2's
// residual + 3 (the average's reads) = 51-53 planes, plus x and the output in
// the operand type. At the served shapes (B 16): 1.73 GB at C 512 x T 1000
// (0.5 ms at 3.35 TB/s, below the 3xTF32 bound), 6.9 GB at C 256 x 8000 (2.1
// ms), 27.0-27.6 GB at C 128 x 64000, 64 x 128000 and 32 x 256000 (8.1-8.3
// ms: above the 3xTF32 bound of 6.4 ms at C 32, 63% of the 12.8 at C 64).
// The weight stream from L2, every tile reading its conv's taps once:
// 33.8 GB fp32 at C 512 x T 1000, 8.3 GB at C 32 x 256000. At bf16 C <= 32
// the one-pass design and at C 64 the unit design below replace this
// structure.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CONSUMERS = 256;              // two warpgroups
constexpr int THREADS = CONSUMERS + 128;    // + the producer warpgroup
constexpr int STAGERS = 96;                 // producer warps 1-3 stage windows
constexpr int STAGES_MAX = 16;              // weight ring slots, at most
constexpr int RING_BYTES = 131072;          // weight bytes in flight, at most
constexpr int GROUP_MAX = 4;                // taps a fresh tensor-core sum, at most
constexpr int KMAX = 11;                    // largest kernel size
constexpr int NBR = 3;                      // branches
constexpr int NDIL = 3;                     // dilations per branch
constexpr int SMEM_MAX = 232448;
constexpr float SLOPE = 0.1f;

template <typename T>
struct Op;
template <>
struct Op<float> {            // 3xTF32: hi and lo planes, wgmma k 8, 4 channels a group
  static constexpr int SPLIT = 2, CPG = 4, KSTEP = 8, KCMAX = 16, GROUP = 1;
};
template <>
struct Op<__nv_bfloat16> {    // one bf16 plane, wgmma k 16, 8 channels a group
  static constexpr int SPLIT = 1, CPG = 8, KSTEP = 16, KCMAX = 32, GROUP = GROUP_MAX;
};

// Tile geometry: NT output channels (= C below 128), M = 128 * MB frames, KC
// input channels a stage (KCP with bf16 C 8's zero padding), G 16-byte
// groups a stage, KS wgmma k-steps a stage.
template <typename T, int NT, int MB>
struct Geom {
  static constexpr int M = 128 * MB;
  static constexpr int KC = NT < Op<T>::KCMAX ? NT : Op<T>::KCMAX;
  static constexpr int KCP = KC < Op<T>::KSTEP ? Op<T>::KSTEP : KC;
  static constexpr int G = KCP / Op<T>::CPG;
  static constexpr int KS = KCP / Op<T>::KSTEP;
  static constexpr int PLANE = NT * KCP * (int)sizeof(T);
  static constexpr int WSTAGE = PLANE * Op<T>::SPLIT;
  static constexpr int ACC = NT / 2;          // accumulators a thread per 64-frame block
  static_assert(MB * ACC <= 64, "registers");
};

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : SLOPE * v; }
__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// ---- shared-memory barriers, bulk copies, wgmma ---------------------------

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
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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
// One k-step of a fresh sum: 3xTF32 (each operand's lo plane lies `a_lo` /
// `b_lo` bytes past its hi plane) or one bf16 product.
template <typename T, int N>
__device__ __forceinline__ void mma(float* d, uint32_t a, uint32_t a_lbo, uint32_t a_lo,
                                    uint32_t b, uint32_t b_lbo, uint32_t b_lo, int scale_d) {
  if constexpr (sizeof(T) == 4) {
    Wgmma<N>::tf32(d, desc_of(a, a_lbo), desc_of(b + b_lo, b_lbo), scale_d);  // hi * lo
    Wgmma<N>::tf32(d, desc_of(a + a_lo, a_lbo), desc_of(b, b_lbo), 1);        // lo * hi
    Wgmma<N>::tf32(d, desc_of(a, a_lbo), desc_of(b, b_lbo), 1);               // hi * hi
  } else {
    Wgmma<N>::bf16(d, desc_of(a, a_lbo), desc_of(b, b_lbo), scale_d);
  }
}

// ---- rings ----------------------------------------------------------------

struct Ring {
  uint32_t full, empty;  // shared addresses of full[0], empty[0]
  int slots, slot;
  uint32_t phase;
  __device__ __forceinline__ void advance() {
    if (++slot == slots) {
      slot = 0;
      phase ^= 1;
    }
  }
  // consumers: wait for the current slot to fill
  __device__ __forceinline__ void acquire() {
    mbar_wait(full + 8 * slot, phase);
    __syncwarp();  // converged again before the warpgroup's .aligned wgmma
  }
  // consumers: every warp hands the slot back once its wgmma groups are done
  __device__ __forceinline__ void release() {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * slot);
    advance();
  }
  // producers: wait until the current slot is free
  __device__ __forceinline__ void wait_empty() { mbar_wait(empty + 8 * slot, phase ^ 1); }
};

// ---- one conv of the three branches ----------------------------------------

// Slot s of a launch is one branch's conv; slots are ordered by falling k.
// `in` is read with its halo (leaky ReLU at staging), `res` is null (conv1:
// out = conv + bias) or the residual (conv2: out = res + conv + bias; res may
// be out).
struct ConvArgs {
  const float* in[NBR];
  const float* res[NBR];
  float* out[NBR];
  const void* w[NBR];     // this conv's packed weight stream
  const float* bias[NBR]; // (C)
  int k[NBR], d[NBR];
  int batch, C, T;
  int wmax;               // window frames of the largest pad: the slot size
  int stages;             // weight ring slots
};

struct Item {
  int b, n, tile, nc;
};

template <typename T, int NT, int MB>
__device__ __forceinline__ Item item_at(const ConvArgs& a, int i) {
  using G = Geom<T, NT, MB>;
  const int tiles = (a.T + G::M - 1) / G::M, nct = a.C / NT;
  const int per_b = a.batch * tiles * nct;
  Item it;
  it.b = i / per_b;
  int r = i % per_b;
  it.nc = r % nct;
  r /= nct;
  it.tile = r % tiles;
  it.n = r / tiles;
  return it;
}

// Stage rows [t_lo, t_lo + W) x channels [c0, c0 + KC) of item n of `in`
// into a window slot: leaky ReLU, rounded to the operand type, fp32 split
// into the hi plane and the lo plane (`lo` bytes on); zero outside [0, T)
// and in bf16 C 8's padding group.
template <typename T, int NT, int MB>
__device__ __forceinline__ void stage_window(const float* in, uint8_t* slot, int lo, int n,
                                             int t_lo, int W, int c0, int C, int seq, int sid) {
  using G = Geom<T, NT, MB>;
  constexpr int V = sizeof(T) == 4 ? 1 : 2;   // float4 loads a 16-byte group
  constexpr int BATCH = 8;                     // groups a thread has in flight
  const size_t item = (size_t)n * seq;
  const int total = W * G::G;
  for (int e0 = sid; e0 < total; e0 += BATCH * STAGERS) {
    float4 v[BATCH][V];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int e = e0 + i * STAGERS;
      const int u = e / G::G, g = e % G::G, t = t_lo + u;
      const bool ok = e < total && t >= 0 && t < seq && g * Op<T>::CPG < G::KC;
      const float4* src = reinterpret_cast<const float4*>(
          in + (item + (size_t)(ok ? t : 0)) * C + c0 + g * Op<T>::CPG);
#pragma unroll
      for (int h = 0; h < V; ++h)
        v[i][h] = ok ? __ldg(src + h) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int e = e0 + i * STAGERS;
      if (e >= total) break;
      uint8_t* dst = slot + (size_t)(e % G::G) * W * 16 + (size_t)(e / G::G) * 16;
      if constexpr (sizeof(T) == 4) {
        const float f[4] = {lrelu(v[i][0].x), lrelu(v[i][0].y), lrelu(v[i][0].z),
                            lrelu(v[i][0].w)};
        uint32_t hi[4], lw[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi[j]) : "f"(f[j]));
          lw[j] = __float_as_uint(f[j] - __uint_as_float(hi[j]));  // exact
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(dst + lo) = make_uint4(lw[0], lw[1], lw[2], lw[3]);
      } else {
        const float4 a = v[i][0], b = v[i][V - 1];
        __nv_bfloat162 p[4] = {__floats2bfloat162_rn(lrelu(a.x), lrelu(a.y)),
                               __floats2bfloat162_rn(lrelu(a.z), lrelu(a.w)),
                               __floats2bfloat162_rn(lrelu(b.x), lrelu(b.y)),
                               __floats2bfloat162_rn(lrelu(b.z), lrelu(b.w))};
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<uint4*>(p);
      }
    }
  }
}

template <typename T, int NT, int MB>
__global__ void __launch_bounds__(THREADS, 1) mrf_conv_kernel(const ConvArgs a) {
  using G = Geom<T, NT, MB>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int slot_bytes = G::G * a.wmax * 16 * Op<T>::SPLIT;
  uint8_t* windows = smem + a.stages * G::WSTAGE;
  const uint32_t bars = smem_addr(windows + 2 * slot_bytes);
  const uint32_t wfull = bars, wempty = bars + 8 * STAGES_MAX;
  const uint32_t xfull = bars + 16 * STAGES_MAX, xempty = xfull + 16;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, CONSUMERS / 32);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(xfull + 8 * s, STAGERS);
      mbar_init(xempty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles = (a.T + G::M - 1) / G::M;
  const int items = NBR * a.batch * tiles * (a.C / NT);
  const int chunks = a.C / G::KC;

  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n" ::: "memory");
    const int ptid = threadIdx.x - CONSUMERS;
    if (ptid < 32) {
      // warp 0: one thread streams every weight stage, in the consumers' order
      if (ptid == 0) {
        Ring ring{wfull, wempty, a.stages, 0, 0};
        const uint32_t base = smem_addr(smem);
        for (int i = blockIdx.x; i < items; i += gridDim.x) {
          const Item it = item_at<T, NT, MB>(a, i);
          const int stages = chunks * a.k[it.b];
          const uint8_t* src =
              static_cast<const uint8_t*>(a.w[it.b]) + (size_t)it.nc * stages * G::WSTAGE;
          for (int s = 0; s < stages; ++s) {
            ring.wait_empty();
            mbar_expect_tx(wfull + 8 * ring.slot, G::WSTAGE);
            bulk_load(base + ring.slot * G::WSTAGE, src + (size_t)s * G::WSTAGE, G::WSTAGE,
                      wfull + 8 * ring.slot);
            ring.advance();
          }
        }
      }
    } else {
      // warps 1-3: stage each chunk's input window
      const int sid = ptid - 32;
      Ring ring{xfull, xempty, 2, 0, 0};
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const Item it = item_at<T, NT, MB>(a, i);
        const int pad = (a.k[it.b] - 1) / 2 * a.d[it.b];
        const int W = G::M + 2 * pad;
        for (int c = 0; c < chunks; ++c) {
          ring.wait_empty();
          stage_window<T, NT, MB>(a.in[it.b], windows + ring.slot * slot_bytes,
                                  G::G * W * 16, it.n, it.tile * G::M - pad, W, c * G::KC, a.C,
                                  a.T, sid);
          fence_async_shared();
          mbar_arrive(xfull + 8 * ring.slot);
          ring.advance();
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const int r = 16 * (warp & 3) + (lane >> 2);   // accumulator rows r, r + 8
  const int q = lane & 3;
  Ring wring{wfull, wempty, a.stages, 0, 0};   // the stages taken
  Ring wfree = wring;                          // the stages handed back
  Ring xring{xfull, xempty, 2, 0, 0};
  const uint32_t wbase = smem_addr(smem), xbase = smem_addr(windows);
  constexpr uint32_t B_LBO = NT * 16;

  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const Item it = item_at<T, NT, MB>(a, i);
    const int k = a.k[it.b], dil = a.d[it.b];
    const int W = G::M + 2 * ((k - 1) / 2 * dil);
    const uint32_t a_lbo = W * 16, a_lo = G::G * W * 16;
    float acc[MB][G::ACC];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int e = 0; e < G::ACC; ++e) acc[mb][e] = 0.f;

    for (int c = 0; c < chunks; ++c) {
      xring.acquire();
      const uint32_t xw = xbase + xring.slot * slot_bytes;
      // the chunk's taps in groups of GROUP: one fresh tensor-core sum each
      constexpr int GROUP = Op<T>::GROUP;
#pragma unroll 1
      for (int j0 = 0; j0 < k; j0 += GROUP) {
        const int jn = k - j0 < GROUP ? k - j0 : GROUP;
        float t[MB][G::ACC];
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) reg_fence(t[mb]);
        wg_fence();
#pragma unroll 1
        for (int j = j0; j < j0 + jn; ++j) {
          wring.acquire();
          const uint32_t wb = wbase + wring.slot * G::WSTAGE;
          wring.advance();
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            const uint32_t xa = xw + (uint32_t)(64 * (wg * MB + mb) + j * dil) * 16;
#pragma unroll
            for (int ks = 0; ks < G::KS; ++ks)
              mma<T, NT>(t[mb], xa + ks * 2 * a_lbo, a_lbo, a_lo, wb + ks * 2 * B_LBO, B_LBO,
                         G::PLANE, j > j0 || ks > 0);
          }
        }
        wg_commit();
        wg_wait0();
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) reg_fence(t[mb]);
        for (int j = 0; j < jn; ++j) wfree.release();
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int e = 0; e < G::ACC; ++e) acc[mb][e] += t[mb][e];
      }
      xring.release();
    }

    // epilogue: rows are frames, columns output channels
    const float* bias = a.bias[it.b];
    const float* res = a.res[it.b];
    float* out = a.out[it.b];
    const size_t item = (size_t)it.n * a.T;
    // every load of the item first, all in flight together (res may be out:
    // the compiler would not move a load above an earlier store)
    float2 bv[NT / 8], rv[MB][NT / 8][2];
#pragma unroll
    for (int jn = 0; jn < NT / 8; ++jn) {
      const int co = it.nc * NT + 8 * jn + 2 * q;
      bv[jn] = make_float2(__ldg(bias + co), __ldg(bias + co + 1));
    }
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int jn = 0; jn < NT / 8; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = it.tile * G::M + 64 * (wg * MB + mb) + r + 8 * h;
          const int co = it.nc * NT + 8 * jn + 2 * q;
          rv[mb][jn][h] = res != nullptr && t < a.T
                              ? *reinterpret_cast<const float2*>(res + (item + t) * a.C + co)
                              : make_float2(0.f, 0.f);
        }
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int jn = 0; jn < NT / 8; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = it.tile * G::M + 64 * (wg * MB + mb) + r + 8 * h;
          const int co = it.nc * NT + 8 * jn + 2 * q;
          if (t >= a.T) continue;
          // conv2: res + (conv + bias); conv1: conv + bias (rv is 0)
          const float2 v = make_float2(acc[mb][4 * jn + 2 * h] + bv[jn].x,
                                       acc[mb][4 * jn + 2 * h + 1] + bv[jn].y);
          *reinterpret_cast<float2*>(out + (item + t) * a.C + co) =
              make_float2(rv[mb][jn][h].x + v.x, rv[mb][jn][h].y + v.y);
        }
  }
}

// ---- the stage's ends: x to channels-last fp32, the average back ------------

// xt[n, t, c] = x[n, c, t] (rounded to the operand type already: exact)
template <typename T>
__global__ void mrf_to_channels_last(const T* x, float* xt, int C, int seq) {
  __shared__ float tile[32][33];
  const int n = blockIdx.z, c0 = blockIdx.y * 32, t0 = blockIdx.x * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, t = t0 + threadIdx.x;
    if (c < C && t < seq) tile[i][threadIdx.x] = load_f(x, ((size_t)n * C + c) * seq + t);
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int t = t0 + i, c = c0 + threadIdx.x;
    if (c < C && t < seq) xt[((size_t)n * seq + t) * C + c] = tile[threadIdx.x][i];
  }
}

// y[n, c, t] = ((y_0 + y_1) + y_2)[n, t, c] / 3, in the plain version's order
template <typename T>
__global__ void mrf_average_channels_first(const float* y0, const float* y1, const float* y2,
                                           T* y, int C, int seq) {
  __shared__ float tile[32][33];
  const int n = blockIdx.z, c0 = blockIdx.y * 32, t0 = blockIdx.x * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int t = t0 + i, c = c0 + threadIdx.x;
    if (c < C && t < seq) {
      const size_t idx = ((size_t)n * seq + t) * C + c;
      tile[i][threadIdx.x] = (y0[idx] + y1[idx] + y2[idx]) / 3.f;
    }
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, t = t0 + threadIdx.x;
    if (c < C && t < seq) store_f(y, ((size_t)n * C + c) * seq + t, tile[threadIdx.x][i]);
  }
}

// ---- the stage --------------------------------------------------------------

struct Stage {
  const void* x;
  void* y;
  float* scratch;        // 7 planes (B, T, C) fp32: x^T, y_0..y_2, h_0..h_2
  const void* w[NBR];    // per branch: (6, C / NT, C / KC, k, SPLIT, plane) in the operand type
  const float* bias;     // (NBR * 6, C)
  int batch, C, T;
  int k[NBR];
  int d[NBR][NDIL];
};

template <typename T, int NT, int MB>
cudaError_t run_convs(const Stage& s, int sms, cudaStream_t stream) {
  using G = Geom<T, NT, MB>;
  auto kernel = mrf_conv_kernel<T, NT, MB>;
  const size_t plane = (size_t)s.batch * s.T * s.C;
  const float* xt = s.scratch;
  float* y[NBR];
  float* h[NBR];
  for (int b = 0; b < NBR; ++b) {
    y[b] = s.scratch + (1 + b) * plane;
    h[b] = s.scratch + (4 + b) * plane;
  }
  // branches by falling k, so that the heavy items come first
  int order[NBR] = {0, 1, 2};
  for (int i = 0; i < NBR; ++i)
    for (int j = i + 1; j < NBR; ++j)
      if (s.k[order[j]] > s.k[order[i]]) {
        const int o = order[i];
        order[i] = order[j];
        order[j] = o;
      }
  const int tiles = (s.T + G::M - 1) / G::M;
  const int items = NBR * s.batch * tiles * (s.C / NT);
  const int grid = items < sms ? items : sms;
  for (int conv = 0; conv < 2 * NDIL; ++conv) {
    const int di = conv / 2;
    const bool first = conv % 2 == 0;
    ConvArgs a{};
    a.batch = s.batch;
    a.C = s.C;
    a.T = s.T;
    int pad_max = 0;
    for (int slot = 0; slot < NBR; ++slot) {
      const int b = order[slot];
      const int k = s.k[b];
      const size_t conv_elems = (size_t)k * s.C * G::KCP * (s.C / G::KC) * Op<T>::SPLIT;
      a.in[slot] = first ? (di == 0 ? xt : y[b]) : h[b];
      a.res[slot] = first ? nullptr : (di == 0 ? xt : y[b]);
      a.out[slot] = first ? h[b] : y[b];
      a.w[slot] = static_cast<const T*>(s.w[b]) + conv * conv_elems;
      a.bias[slot] = s.bias + (size_t)(2 * NDIL * b + conv) * s.C;
      a.k[slot] = k;
      a.d[slot] = first ? s.d[b][di] : 1;
      const int pad = (k - 1) / 2 * a.d[slot];
      pad_max = pad > pad_max ? pad : pad_max;
    }
    a.wmax = G::M + 2 * pad_max;
    // the weight ring takes up to RING_BYTES of what the two windows leave
    const size_t fixed = 2 * (size_t)G::G * a.wmax * 16 * Op<T>::SPLIT + 16 * STAGES_MAX + 32;
    const long room = ((long)SMEM_MAX - (long)fixed) / G::WSTAGE;
    a.stages = (int)(room < RING_BYTES / G::WSTAGE ? room : RING_BYTES / G::WSTAGE);
    a.stages = a.stages < STAGES_MAX ? a.stages : STAGES_MAX;
    // room for two groups: the next streams while one is multiplied
    if (a.stages < 2 * GROUP_MAX) return cudaErrorInvalidValue;
    const size_t smem = fixed + (size_t)a.stages * G::WSTAGE;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, THREADS, smem, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t run_stage(const Stage& s, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const size_t plane = (size_t)s.batch * s.T * s.C;
  const dim3 tgrid((s.T + 31) / 32, (s.C + 31) / 32, s.batch), tblock(32, 8);
  mrf_to_channels_last<T><<<tgrid, tblock, 0, stream>>>(static_cast<const T*>(s.x), s.scratch,
                                                        s.C, s.T);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  switch (s.C) {
    case 8: err = run_convs<T, 8, 4>(s, sms, stream); break;
    case 16: err = run_convs<T, 16, 4>(s, sms, stream); break;
    case 32: err = run_convs<T, 32, 4>(s, sms, stream); break;
    case 64: err = run_convs<T, 64, 2>(s, sms, stream); break;
    case 128: case 256: case 512: err = run_convs<T, 128, 1>(s, sms, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  mrf_average_channels_first<T><<<tgrid, tblock, 0, stream>>>(
      s.scratch + plane, s.scratch + 2 * plane, s.scratch + 3 * plane, static_cast<T*>(s.y),
      s.C, s.T);
  return cudaGetLastError();
}

// ---- one pass per frame tile: bf16 at C <= 64 -------------------------------
//
// One launch a stage, one CTA per (item, frame tile) in a strided loop, all
// 18 convs of the tile on chip. The window of a tile is W = M_OUT + 2 * 64
// frames: the M_OUT output frames and 64 frames of halo on each side (the
// stage reaches 60). Window row u is frame t0 - 64 + u; each conv cuts its
// rows into 64-row tiles, the M of one wgmma, and its tile i belongs to
// warpgroup i % 2. Per branch (in order 0, 1, 2, so that the average sums
// (y_0 + y_1) + y_2 as the plain version does):
//   * y = x, fp32 in shared memory ([C / 8][W][8]: a warp's accumulator rows
//     read and write 256 contiguous bytes), and X = bf16(lrelu(x)), the
//     first conv's A operand: the K-major no-swizzle window of the conv chain
//     (each 8-channel group its own column of W + 2 * 32 rows, 16 bytes a
//     row; a tap's shift is the descriptor's start moved 16 bytes a frame,
//     the 32 margin rows take the widest reach, 25 frames);
//   * conv c computes as few 64-row tiles as cover the rows that the convs
//     after it need, centred on them (the needed range shrinks by each conv's
//     reach, down to the output tiles at the branch's last conv; the tiles
//     past the output's are 0, 1 or 2); its output, + bias, zeroed outside
//     [0, T), goes to H = bf16(lrelu(h)) (conv1) or to y += (conv2, with X =
//     bf16(lrelu(y)) for the next conv1). One barrier ends each conv;
//   * the last conv2 adds y into the branch sum, fp32 in shared memory over
//     the output frames ([C / 8][M_OUT][8], each element read and written by
//     the thread that owns it); after branch 2 the output, sum / 3 rounded
//     to bf16 once, goes from there to (B, C, T).
// Weights: the conv chain's stream (`pack_mrf_kernel_weights`, bf16), one bulk copy
// per group of up to GROUP_MAX taps of a 32-channel chunk, into a ring that
// warp 0 keeps RING - 2 groups ahead of the consumers. The CTA is the two
// consumer warpgroups alone: with a ninth warp one of the SM's four register
// files would hold three warps, and ptxas caps every thread at 168 registers
// (C 64 spilled 252 bytes at that cap). Each group is one fresh tensor-core
// sum (K <= 128) per tile, added to the tile's fp32 accumulator on the CUDA
// cores, chunk by chunk and group by group: the order and grouping of the chain's
// bf16 design, so the two designs compute the same numbers. A warpgroup
// issues the group's sums of all its tiles before it waits once.
// What bounds it. Device memory sees x read three times (once from DRAM, then
// from L2) and the output written; every tile reads all 126 C^2 weights from
// L2; the tensor cores do 1.19x (C 32) to 1.58x (C 64) the stage's operations
// for the recomputed halo, with A read from shared memory for every tap (at
// C 32 a m64n32k16 reads 3 KB of A and B for 16 tensor-core cycles). None of
// these binds it on an H100: the two warpgroups multiply, then both run their
// epilogues and the next window's load, and meet at one barrier a conv, so
// that work does not overlap the tensor cores (chip_smoke phase 8 prints the
// design's bytes and operations beside the time). At C 64 the conv chain is
// the faster design.

constexpr int OP_THREADS = 256;                 // two warpgroups (8 warps: 255 registers a thread)
constexpr int OP_HALO = 64;                     // window frames before the output frames
constexpr int OP_MARGIN = 32;                   // rows a tap may read past the window

template <int C, int TPW>
struct OnePass {
  using T = __nv_bfloat16;
  using G = Geom<T, C, 1>;
  static constexpr int KC = G::KC, KCP = G::KCP, KS = G::KS;
  static constexpr int CHUNKS = C / KC;
  static constexpr int GROUPS = CHUNKS * KCP / 8;      // 16-byte groups of a window row
  static constexpr int NTILE = 2 * TPW;                // 64-row tiles of the window
  static constexpr int W = 64 * NTILE;
  static constexpr int M_OUT = W - 2 * OP_HALO;
  static constexpr int WR = W + 2 * OP_MARGIN;         // rows of a window buffer
  static constexpr int ACC = C / 2;                    // accumulators a thread per tile
  static constexpr uint32_t A_LBO = WR * 16;
  static constexpr uint32_t B_LBO = C * 16;
  static constexpr int PLANE = G::PLANE;               // bytes of one tap of one chunk
  static constexpr int SLOT = GROUP_MAX * PLANE;
  static constexpr int WIN_BYTES = GROUPS * WR * 16;
  static constexpr int Y_BYTES = C * W * 4;
  static constexpr int SUM_BYTES = C * M_OUT * 4;       // the branch sum, [C / 8][M_OUT][8]
  static constexpr int FIXED = 2 * WIN_BYTES + Y_BYTES + SUM_BYTES + 16 * STAGES_MAX;
  static constexpr int RING_ROOM = (SMEM_MAX - FIXED) / SLOT;
  static constexpr int RING = RING_ROOM < STAGES_MAX ? RING_ROOM : STAGES_MAX;
  static constexpr int SMEM = RING * SLOT + FIXED;
  static_assert(RING >= 2, "shared memory");
  static_assert(2 * TPW * ACC <= 160, "registers");
  static_assert(C * (W / 8) % OP_THREADS == 0, "the window's loads");
};

struct OnePassArgs {
  const __nv_bfloat16* x;
  __nv_bfloat16* y;
  const __nv_bfloat16* w[NBR];   // per branch: pack_mrf_kernel_weights, bf16
  const float* bias;             // (NBR * 6, C)
  int batch, T;
  int k[NBR];
  int d[NBR][NDIL];
};

// A branch's scalars, read from the kernel parameters at constant indices
// (a parameter array indexed at run time is copied to the stack)
struct Branch {
  const uint8_t* w;
  int k, p, d0, d1, d2;
};
__device__ __forceinline__ Branch branch_of(const OnePassArgs& a, int b) {
  const int i = b == 0 ? 0 : b == 1 ? 1 : 2;
  Branch r;
  if (i == 0) {
    r = {reinterpret_cast<const uint8_t*>(a.w[0]), a.k[0], 0, a.d[0][0], a.d[0][1], a.d[0][2]};
  } else if (i == 1) {
    r = {reinterpret_cast<const uint8_t*>(a.w[1]), a.k[1], 0, a.d[1][0], a.d[1][1], a.d[1][2]};
  } else {
    r = {reinterpret_cast<const uint8_t*>(a.w[2]), a.k[2], 0, a.d[2][0], a.d[2][1], a.d[2][2]};
  }
  r.p = (r.k - 1) / 2;
  return r;
}

// The weight groups in the consumers' order: (item, branch, conv, chunk,
// group of taps), one bulk copy each, issued by warp 0 ahead of
// the consumers into the ring.
template <int C, int TPW>
struct Producer {
  using P = OnePass<C, TPW>;
  Ring ring;
  uint32_t base;
  int it, b, conv, c, j0, issued;
  // issue groups [issued, want): waiting for a free slot while fewer than
  // `need` are issued, else only while slots are free already. Run by a
  // whole warp in step (every lane holds the same state; lane 0 copies), so
  // that no lane waits on a barrier while another issues
  __device__ __forceinline__ void issue(const OnePassArgs& a, int items, int need, int want,
                                        int lane) {
    while (issued < want && it < items) {
      // lane 0's reading for the whole warp: the phase may complete between
      // two lanes' tests
      if (issued >= need &&
          !__shfl_sync(0xffffffffu, mbar_test(ring.empty + 8 * ring.slot, ring.phase ^ 1), 0))
        return;
      const Branch br = branch_of(a, b);
      const int jn = br.k - j0 < GROUP_MAX ? br.k - j0 : GROUP_MAX;
      ring.wait_empty();
      if (lane == 0) {
        mbar_expect_tx(ring.full + 8 * ring.slot, jn * P::PLANE);
        bulk_load(base + ring.slot * P::SLOT,
                  br.w + ((size_t)(conv * P::CHUNKS + c) * br.k + j0) * P::PLANE, jn * P::PLANE,
                  ring.full + 8 * ring.slot);
      }
      __syncwarp();
      ring.advance();
      ++issued;
      if ((j0 += GROUP_MAX) < br.k) continue;
      j0 = 0;
      if (++c < P::CHUNKS) continue;
      c = 0;
      if (++conv < 2 * NDIL) continue;
      conv = 0;
      if (++b < NBR) continue;
      b = 0;
      it += gridDim.x;
    }
  }
};

template <int C, int TPW>
__global__ void __launch_bounds__(OP_THREADS, 1) mrf_onepass_kernel(const OnePassArgs a) {
  using P = OnePass<C, TPW>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* xwin = smem + P::RING * P::SLOT;            // conv1's A: bf16(lrelu(y))
  uint8_t* hwin = xwin + P::WIN_BYTES;                 // conv2's A: bf16(lrelu(h))
  float* ys = reinterpret_cast<float*>(hwin + P::WIN_BYTES);
  float* sums = ys + P::Y_BYTES / 4;
  const uint32_t bars = smem_addr(hwin + P::WIN_BYTES + P::Y_BYTES + P::SUM_BYTES);
  const uint32_t wfull = bars, wempty = bars + 8 * STAGES_MAX;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  // the warpgroup, known to the compiler as uniform across the warp (wgmma
  // under a branch it thinks divergent is serialized)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int r = 16 * (warp & 3) + (lane >> 2);   // accumulator rows r, r + 8
  const int q = lane & 3;
  const uint32_t xbase = smem_addr(xwin), hbase = smem_addr(hwin), wbase = smem_addr(smem);
  const int tiles = (a.T + P::M_OUT - 1) / P::M_OUT;
  const int items = a.batch * tiles;
  if (tid == 0) {
    for (int s = 0; s < P::RING; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, OP_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // both windows zero once: the margins and bf16 C 8's padding group are
  // never written again
  for (int i = tid; i < 2 * P::WIN_BYTES / 16; i += OP_THREADS)
    reinterpret_cast<uint4*>(xwin)[i] = make_uint4(0, 0, 0, 0);
  fence_async_shared();
  __syncthreads();

  Producer<C, TPW> prod{{wfull, wempty, P::RING, 0, 0}, wbase, (int)blockIdx.x, 0, 0, 0, 0, 0};
  Ring wring{wfull, wempty, P::RING, 0, 0};
  int group = 0;                                  // weight groups taken so far

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int n = it / tiles, t0 = (it % tiles) * P::M_OUT;
    const int f_lo = t0 - OP_HALO;                  // frame of window row 0
    const __nv_bfloat16* xn = a.x + (size_t)n * C * a.T;

#pragma unroll 1
    for (int b = 0; b < NBR; ++b) {
      const Branch br = branch_of(a, b);
      const int k = br.k, p = br.p;
      // y = x and X = bf16(lrelu(x)) over the window, zero outside [0, T):
      // each thread 8 frames of one channel at a time, every load first
      constexpr int XITER = C * (P::W / 8) / OP_THREADS;
      uint4 raw[XITER];
#pragma unroll
      for (int n8 = 0; n8 < XITER; ++n8) {
        const int e = tid + n8 * OP_THREADS;
        const int c = e % C, f0 = f_lo + (e / C) * 8;
        const unsigned short* src =
            reinterpret_cast<const unsigned short*>(xn) + (size_t)c * a.T + f0;
        if (f0 >= 0 && f0 + 8 <= a.T && (a.T & 7) == 0) {
          raw[n8] = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          uint32_t v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = f0 + i >= 0 && f0 + i < a.T ? __ldg(src + i) : 0u;
          raw[n8] = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                               v[6] | v[7] << 16);
        }
      }
#pragma unroll
      for (int n8 = 0; n8 < XITER; ++n8) {
        const int e = tid + n8 * OP_THREADS;
        const int c = e % C, u0 = (e / C) * 8;
        const uint32_t words[4] = {raw[n8].x, raw[n8].y, raw[n8].z, raw[n8].w};
        float* yrow = ys + ((size_t)(c >> 3) * P::W + u0) * 8 + (c & 7);
        __nv_bfloat16* xrow = reinterpret_cast<__nv_bfloat16*>(
            xwin + (c >> 3) * P::A_LBO + (OP_MARGIN + u0) * 16) + (c & 7);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // two bf16 frames a word: bf16 -> fp32 is a 16-bit shift
          const float lo = __uint_as_float(words[i] << 16);
          const float hi = __uint_as_float(words[i] & 0xffff0000u);
          yrow[16 * i] = lo;
          yrow[16 * i + 8] = hi;
          xrow[16 * i] = __float2bfloat16(lrelu(lo));
          xrow[16 * i + 8] = __float2bfloat16(lrelu(hi));
        }
      }
      fence_async_shared();
      __syncthreads();

      // ext: the conv's one-sided reach past the output frames that the
      // convs after it need (its output rows are [64 - ext, 64 + M_OUT + ext))
      int ext = p * (3 + br.d1 + br.d2);
#pragma unroll 1
      for (int conv = 0; conv < 2 * NDIL; ++conv) {
        const bool first = conv % 2 == 0, last = conv == 2 * NDIL - 1;
        const int dil = !first ? 1 : conv == 0 ? br.d0 : conv == 2 ? br.d1 : br.d2;
        // the conv's nt 64-row tiles from window row lo: as few as cover its
        // rows, centred on them (0, 1 or 2 tiles past the output's)
        const int c2 = (2 * ext + 63) >> 6;
        const int nt = P::M_OUT / 64 + c2, lo = OP_HALO - 32 * c2;
        const uint32_t in = first ? xbase : hbase;
        float acc[TPW][P::ACC];
#pragma unroll
        for (int s = 0; s < TPW; ++s)
#pragma unroll
          for (int e = 0; e < P::ACC; ++e) acc[s][e] = 0.f;

        const float* bias = a.bias + (size_t)(2 * NDIL * b + conv) * C;
        float2 bv[C / 8];
#pragma unroll
        for (int g = 0; g < C / 8; ++g)
          bv[g] = __ldg(reinterpret_cast<const float2*>(bias + 8 * g + 2 * q));
#pragma unroll 1
        for (int c = 0; c < P::CHUNKS; ++c)
#pragma unroll 1
          for (int j0 = 0; j0 < k; j0 += GROUP_MAX) {
            const int jn = k - j0 < GROUP_MAX ? k - j0 : GROUP_MAX;
            const bool final_group = c == P::CHUNKS - 1 && j0 + GROUP_MAX >= k;
            // group `group` must be in flight; keep up to RING - 2 more
            // ahead where their slots are free already
            if (warp == 0) prod.issue(a, items, group + 1, group + P::RING - 1, lane);
            wring.acquire();
            const uint32_t wb = wbase + wring.slot * P::SLOT;
            float t[TPW][P::ACC];
            wg_fence();
#pragma unroll
            for (int s = 0; s < TPW; ++s) {
              const int i = 2 * s + wg;
              if (i >= nt) continue;
              reg_fence(t[s]);
#pragma unroll 1
              for (int j = j0; j < j0 + jn; ++j) {
                const uint32_t xa = in + (uint32_t)(OP_MARGIN + lo + 64 * i + (j - p) * dil) * 16 +
                                    (uint32_t)(c * (P::KCP / 8)) * P::A_LBO;
                const uint32_t wj = wb + (j - j0) * P::PLANE;
#pragma unroll
                for (int ks = 0; ks < P::KS; ++ks)
                  Wgmma<C>::bf16(t[s], desc_of(xa + ks * 2 * P::A_LBO, P::A_LBO),
                                 desc_of(wj + ks * 2 * P::B_LBO, P::B_LBO), j > j0 || ks > 0);
              }
            }
            wg_commit();
            wg_wait0();
#pragma unroll
            for (int s = 0; s < TPW; ++s) {
              const int i = 2 * s + wg;
              if (i >= nt) continue;
              reg_fence(t[s]);
#pragma unroll
              for (int e = 0; e < P::ACC; ++e) acc[s][e] += t[s][e];
              if (!final_group) continue;

              // the tile's epilogue after the conv's last group: rows are
              // window rows, columns output channels. Every load first (a
              // store may alias a later load, so the compiler would keep them
              // in program order)
              float2 yo[C / 8][2], so[C / 8][2];
#pragma unroll
              for (int g = 0; g < C / 8; ++g) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  yo[g][h] = first ? make_float2(0.f, 0.f)
                                   : *reinterpret_cast<const float2*>(
                                         ys + ((size_t)g * P::W + lo + 64 * i + r + 8 * h) * 8 + 2 * q);
                  so[g][h] = make_float2(0.f, 0.f);
                  if (last && b > 0)
                    so[g][h] = *reinterpret_cast<const float2*>(
                        sums + ((size_t)g * P::M_OUT + 64 * i + r + 8 * h) * 8 + 2 * q);
                }
              }
#pragma unroll
              for (int g = 0; g < C / 8; ++g)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int u = lo + 64 * i + r + 8 * h, f = f_lo + u;
                  const bool valid = f >= 0 && f < a.T;
                  // the conv's output, + bias, zero outside [0, T)
                  const float v0 = valid ? acc[s][4 * g + 2 * h] + bv[g].x : 0.f;
                  const float v1 = valid ? acc[s][4 * g + 2 * h + 1] + bv[g].y : 0.f;
                  const uint32_t at = g * P::A_LBO + (OP_MARGIN + u) * 16 + q * 4;
                  if (first) {
                    *reinterpret_cast<__nv_bfloat162*>(hwin + at) =
                        __floats2bfloat162_rn(lrelu(v0), lrelu(v1));
                    continue;
                  }
                  const float2 yn = make_float2(yo[g][h].x + v0, yo[g][h].y + v1);
                  if (!last) {
                    *reinterpret_cast<float2*>(ys + ((size_t)g * P::W + u) * 8 + 2 * q) = yn;
                    *reinterpret_cast<__nv_bfloat162*>(xwin + at) =
                        __floats2bfloat162_rn(lrelu(yn.x), lrelu(yn.y));
                    continue;
                  }
                  // the branch's last conv computes the output tiles alone
                  float2 sn = make_float2(so[g][h].x + yn.x, so[g][h].y + yn.y);
                  if (b == 0) sn = yn;
                  if (b == NBR - 1) sn = make_float2(sn.x / 3.f, sn.y / 3.f);
                  *reinterpret_cast<float2*>(
                      sums + ((size_t)g * P::M_OUT + 64 * i + r + 8 * h) * 8 + 2 * q) = sn;
                }
                        }
            wring.release();
            ++group;
          }
        if (!last) fence_async_shared();
        __syncthreads();
        ext -= first ? p : p * (conv == 1 ? br.d1 : br.d2);
      }
    }

    // the output, rounded to bf16 once, from the branch sum to (B, C, T)
    __nv_bfloat16* yn = a.y + (size_t)n * C * a.T;
    for (int e = tid; e < C * (P::M_OUT / 8); e += OP_THREADS) {
      const int c = e / (P::M_OUT / 8), m0 = (e % (P::M_OUT / 8)) * 8, f0 = t0 + m0;
      if (f0 >= a.T) continue;
      const float* src = sums + ((size_t)(c >> 3) * P::M_OUT + m0) * 8 + (c & 7);
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(src[16 * i], src[16 * i + 8]);
        w[i] = *reinterpret_cast<const uint32_t*>(&v);
      }
      if (f0 + 8 <= a.T && (a.T & 7) == 0) {
        *reinterpret_cast<uint4*>(yn + (size_t)c * a.T + f0) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        for (int i = 0; i < 8 && f0 + i < a.T; ++i)
          yn[(size_t)c * a.T + f0 + i] = __float2bfloat16(src[8 * i]);
      }
    }
  }
}

template <int C, int TPW>
cudaError_t run_onepass(const OnePassArgs& a, cudaStream_t stream) {
  using P = OnePass<C, TPW>;
  auto kernel = mrf_onepass_kernel<C, TPW>;
  int device = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int items = a.batch * ((a.T + P::M_OUT - 1) / P::M_OUT);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<items < sms ? items : sms, OP_THREADS, P::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// ---- one launch per residual unit: bf16 at C 64, 128 and 256 ---------------
//
// A stage is 4 launches: one per dilation (the residual unit conv1 ->
// leaky ReLU -> conv2 + residual of each branch, the three branches' units
// side by side, as the chain's launches are), then the average. A CTA of
// the chain's shape (two consumer warpgroups, a producer warpgroup: one
// thread streams the weights, three warps stage windows) walks (item, frame
// tile, branch) work items, the branch fastest, in a strided loop. Per item,
// frames [t0, t0 + M):
//   * the stagers write X = bf16(lrelu(y)) over frames [t0 - 64, t0 + M +
//     64), zero outside [0, T), all C channels, in the chain's K-major
//     no-swizzle layout (one column of WX rows a group of 8 channels). y is
//     x itself at the first unit (read (B, C, T) bf16: the chain's copy to
//     channels-last is folded in here), else the previous unit's fp32
//     residual stream (B, T, C). One X buffer: the next item's X is staged
//     while the consumers run this item's conv2;
//   * conv1 computes rows [t0 - 32, t0 + M + 32) (N1 = M / 64 + 1 wgmma
//     tiles: conv2's reach of at most 32 frames, rounded up to the tile)
//     and writes H = bf16(lrelu(conv + bias)), zero outside [0, T), into
//     shared memory, in the same layout as X: h never reaches device memory;
//   * conv2 computes the M output rows from H and writes y = res + (conv +
//     bias), fp32 (B, T, C), res read from the input stream (or x); the
//     streams ping-pong between two sets of three planes, as a tile reads
//     its neighbours' frames;
//   * the average kernel of the chain sums ((y_0 + y_1) + y_2) / 3 and
//     rounds it to bf16 once, back to (B, C, T).
// A pass is one sweep of a conv's weights: per 32-channel chunk and group
// of up to GROUP_MAX taps one fresh tensor-core sum, added to the fp32
// accumulator on the CUDA cores, as the chain sums (so the two designs give
// the same bits; summed in the tensor cores' accumulator over a whole conv
// instead, 1.5-5.5% of the outputs differed from the chain's in a variant on
// an H100, each by one bf16 ulp). A consumer thread holds 64
// accumulators and 64 of the fresh sum: two 64 x 64 tiles (C 64: the two
// warpgroups take different rows of the 64 channels, a pass 256 rows; C 256:
// the two 64-channel halves of one packed 128-channel plane, a pass 128 rows
// x 128 channels) or one 64 x 128 tile (C 128: different rows, a pass 128
// rows). The weights are the chain's bf16 stream (pack_mrf_kernel_weights),
// one tap of a chunk of one packed plane a ring stage.
// The count, per width (M output frames a tile; B 16 at the served T;
// chip_smoke.py::mrf_unit_design prints it):
//   C 64  (T 128000): M 192, conv1 256 rows (4 tiles) in 1 pass, conv2 192
//     rows in 1 (one warpgroup's second tile idle): 1.17x the stage's tensor
//     work, the recomputed halo; shared memory X 40 KB + H 32 KB + a 64 KB
//     ring; the weights from L2 11.0 GB a stage (the chain 8.3);
//   C 128 (T 64000):  M 192, m64n128, conv1 2 passes, conv2 2 (the second
//     one warpgroup's): 1.17x; X 80 KB + H 64 KB + an 80 KB ring; 44.1 GB of
//     weights (the chain 33.0);
//   C 256 (T 8000):   M 64, conv1 128 rows, conv2 64, each in 2 passes (one
//     a plane): 1.5x; X 96 KB + H 64 KB + a 64 KB ring: a larger tile does
//     not fit beside both windows; 33.0 GB of weights (the chain 16.6).
// Device memory a stage, in fp32 planes of (B, T, C): x read (bf16, 0.5;
// the three branches of a tile run side by side, so once from DRAM), each
// unit's three streams written (3) and read by the next (3), the average's
// reads (3) and the output (0.5): 19 planes against the chain's 51-52, 9.96
// GB at C 128 and C 64 (3.0 ms at 3.35 TB/s), 2.49 GB at C 256. Each tile's
// window re-reads its 128 halo frames from L2 (7.9 GB at C 64 and 128).
// What bounds it on an H100: neither DRAM nor the tensor cores. A
// clock64-stamped copy found the consumers 2-6% of their cycles waiting on
// the tensor cores, 7-15% on weight stages and, until the epilogue loaded
// its residual a few column groups at a time, 21-46% in spilling
// epilogues; m64n64 products read as many bytes of shared memory as they
// multiply (A and B 4 KB a 32-cycle product), and at C 128 the weight stream
// is 1.33x the chain's. Registers: setmaxnreg 200 a consumer thread (ptxas
// reports the launch's 168, but a variant without setmaxnreg spilled up to
// 1.1 KB and ran twice as long), 104 a producer thread (88 spilled the
// stagers); the conv loop is unrolled (its constants out of registers).

constexpr int UNIT_MARGIN = 32;     // X rows past conv1's on each side: a conv's reach, at most

// Tile per width: M output frames, NT channels a warpgroup's wgmma (N), MB
// 64-row tiles a warpgroup holds, NS channels a pass (one packed plane, a
// ring stage a tap); the warpgroups take different row tiles of the pass's
// channels, or (COLS) the same row tiles of different NT-channel halves.
template <int C>
struct Unit {
  static constexpr int M = C == 256 ? 64 : 192;
  static constexpr int N1 = M / 64 + 1;             // conv1's 64-row tiles, from frame t0 - 32
  static constexpr int N2 = M / 64;                 // conv2's: the output frames
  static constexpr int R1 = 64 * N1;
  static constexpr int WX = R1 + 2 * UNIT_MARGIN;   // X rows, from frame t0 - 64
  static constexpr int NT = C == 128 ? 128 : 64;
  static constexpr int MB = C == 128 ? 1 : 2;
  static constexpr bool COLS = C == 256;
  static constexpr int NS = C < 128 ? C : 128;      // = kernel_tile's NT: one plane of the stream
  static constexpr int RT = COLS ? MB : 2 * MB;     // row tiles a pass
  static constexpr int KC = 32, CHUNKS = C / KC, BLOCKS = C / NS;
  static constexpr uint32_t X_LBO = WX * 16, H_LBO = R1 * 16, B_LBO = NS * 16;
  static constexpr int X_BYTES = C / 8 * WX * 16, H_BYTES = C / 8 * R1 * 16;
  static constexpr int STAGE = NS * KC * 2;         // one tap of a chunk, the pass's channels
  static constexpr int ACC = NT / 2;                // accumulators a thread per tile
  static constexpr int EB = NT == 128 ? 4 : 8;      // 8-channel groups a residual batch
  static constexpr int FIXED = X_BYTES + H_BYTES + 16 * STAGES_MAX + 32;
  static constexpr int ROOM = (SMEM_MAX - FIXED) / STAGE;
  static constexpr int RING0 = ROOM < RING_BYTES / STAGE ? ROOM : RING_BYTES / STAGE;
  static constexpr int RING = RING0 < STAGES_MAX ? RING0 : STAGES_MAX;
  static constexpr int SMEM = RING * STAGE + FIXED;
  static_assert(RING >= 2 * GROUP_MAX, "shared memory");
  static_assert(MB * ACC <= 64, "registers");
  static_assert(NT * (COLS ? 2 : 1) == NS, "a pass's channels");
  static_assert((WX * (C / 8)) % 8 == 0 && WX % 16 == 0, "the stagers' walk");
};

struct UnitArgs {
  const __nv_bfloat16* x;        // (B, C, T): the first unit's input and residual, else null
  const float* yin[NBR];         // per slot (B, T, C) fp32: a later unit's input and residual
  float* yout[NBR];              // per slot (B, T, C) fp32
  const __nv_bfloat16* w[NBR];   // per slot: this unit's conv1 stream, conv2's after it
  const float* bias[NBR];        // per slot: conv1's biases (C), conv2's after them
  int k[NBR], d[NBR];
  int batch, T;
};

// a slot's scalars, read from the kernel parameters at constant indices
struct UnitSlot {
  const float* yin;
  float* yout;
  const uint8_t* w;
  const float* bias;
  int k, d;
};
__device__ __forceinline__ UnitSlot unit_slot(const UnitArgs& a, int s) {
  if (s == 0)
    return {a.yin[0], a.yout[0], reinterpret_cast<const uint8_t*>(a.w[0]), a.bias[0], a.k[0],
            a.d[0]};
  if (s == 1)
    return {a.yin[1], a.yout[1], reinterpret_cast<const uint8_t*>(a.w[1]), a.bias[1], a.k[1],
            a.d[1]};
  return {a.yin[2], a.yout[2], reinterpret_cast<const uint8_t*>(a.w[2]), a.bias[2], a.k[2],
          a.d[2]};
}

// X over WX rows from frame f_lo, from the fp32 stream y (B, T, C): a
// thread takes 8 channels of a frame (two float4), 8 consecutive threads
// 8 consecutive frames of one group (128 contiguous bytes of X)
template <int C>
__device__ __forceinline__ void unit_stage_cl(const float* y, uint8_t* X, int n, int f_lo,
                                              int seq, int sid) {
  using U = Unit<C>;
  constexpr int G = C / 8, TOTAL = U::WX * G, BATCH = 8;
  const size_t item = (size_t)n * seq;
  for (int e0 = sid; e0 < TOTAL; e0 += BATCH * STAGERS) {
    float4 v[BATCH][2];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int e = e0 + i * STAGERS;
      const int u = e / (8 * G) * 8 + e % 8, g = e / 8 % G, f = f_lo + u;
      const bool ok = e < TOTAL && f >= 0 && f < seq;
      const float4* src =
          reinterpret_cast<const float4*>(y + (item + (size_t)(ok ? f : 0)) * C + 8 * g);
      v[i][0] = ok ? __ldg(src) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[i][1] = ok ? __ldg(src + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int e = e0 + i * STAGERS;
      if (e >= TOTAL) break;
      const int u = e / (8 * G) * 8 + e % 8, g = e / 8 % G;
      const float4 a = v[i][0], b = v[i][1];
      __nv_bfloat162 p[4] = {__floats2bfloat162_rn(lrelu(a.x), lrelu(a.y)),
                             __floats2bfloat162_rn(lrelu(a.z), lrelu(a.w)),
                             __floats2bfloat162_rn(lrelu(b.x), lrelu(b.y)),
                             __floats2bfloat162_rn(lrelu(b.z), lrelu(b.w))};
      *reinterpret_cast<uint4*>(X + g * U::X_LBO + u * 16) = *reinterpret_cast<uint4*>(p);
    }
  }
}

// X over WX rows from frame f_lo, from x (B, C, T) bf16: a thread takes 16
// frames of one channel (two 16-byte loads), consecutive threads
// consecutive channels
template <int C>
__device__ __forceinline__ void unit_stage_cf(const __nv_bfloat16* x, uint8_t* X, int n,
                                              int f_lo, int seq, int sid) {
  using U = Unit<C>;
  constexpr int TOTAL = C * (U::WX / 16), BATCH = 4;
  const unsigned short* xn = reinterpret_cast<const unsigned short*>(x) + (size_t)n * C * seq;
  const bool vec = (seq & 7) == 0;
  for (int e0 = sid; e0 < TOTAL; e0 += BATCH * STAGERS) {
    uint4 raw[BATCH][2];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int e = e0 + i * STAGERS;
      const int c = e % C, f0 = f_lo + e / C * 16;
      const size_t row = (size_t)c * seq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int fh = f0 + 8 * h;
        if (e < TOTAL && vec && fh >= 0 && fh + 8 <= seq) {
          raw[i][h] = __ldg(reinterpret_cast<const uint4*>(xn + row + fh));
        } else {
          uint32_t v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = e < TOTAL && fh + j >= 0 && fh + j < seq ? __ldg(xn + row + fh + j) : 0u;
          raw[i][h] = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                                 v[6] | v[7] << 16);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int e = e0 + i * STAGERS;
      if (e >= TOTAL) break;
      const int c = e % C, u0 = e / C * 16;
      __nv_bfloat16* xrow =
          reinterpret_cast<__nv_bfloat16*>(X + (c >> 3) * U::X_LBO + u0 * 16) + (c & 7);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t words[4] = {raw[i][h].x, raw[i][h].y, raw[i][h].z, raw[i][h].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // two bf16 frames a word: bf16 -> fp32 is a 16-bit shift
          xrow[(8 * h + 2 * j) * 8] = __float2bfloat16(lrelu(__uint_as_float(words[j] << 16)));
          xrow[(8 * h + 2 * j + 1) * 8] =
              __float2bfloat16(lrelu(__uint_as_float(words[j] & 0xffff0000u)));
        }
      }
    }
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1) mrf_unit_kernel(const UnitArgs a) {
  using U = Unit<C>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* xwin = smem + U::RING * U::STAGE;
  uint8_t* hwin = xwin + U::X_BYTES;
  const uint32_t bars = smem_addr(hwin + U::H_BYTES);
  const uint32_t wfull = bars, wempty = bars + 8 * STAGES_MAX;
  const uint32_t xfull = bars + 16 * STAGES_MAX, xempty = xfull + 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < U::RING; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, CONSUMERS / 32);
    }
    mbar_init(xfull, STAGERS);
    mbar_init(xempty, CONSUMERS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles = (a.T + U::M - 1) / U::M;
  const int items = NBR * a.batch * tiles;

  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n" ::: "memory");
    const int ptid = threadIdx.x - CONSUMERS;
    if (ptid < 32) {
      // warp 0: one thread streams every weight stage, in the consumers' order
      if (ptid == 0) {
        Ring ring{wfull, wempty, U::RING, 0, 0};
        const uint32_t base = smem_addr(smem);
        for (int i = blockIdx.x; i < items; i += gridDim.x) {
          const UnitSlot sl = unit_slot(a, i % NBR);
          for (int conv = 0; conv < 2; ++conv) {
            const uint8_t* wc = sl.w + (size_t)conv * sl.k * C * C * 2;
            const int passes = ((conv == 0 ? U::N1 : U::N2) + U::RT - 1) / U::RT;
            for (int cb = 0; cb < U::BLOCKS; ++cb)
              for (int rp = 0; rp < passes; ++rp)
                for (int c = 0; c < U::CHUNKS; ++c)
                  for (int j = 0; j < sl.k; ++j) {
                    ring.wait_empty();
                    const uint32_t bar = wfull + 8 * ring.slot;
                    mbar_expect_tx(bar, U::STAGE);
                    bulk_load(base + ring.slot * U::STAGE,
                              wc + (size_t)((cb * U::CHUNKS + c) * sl.k + j) * U::STAGE, U::STAGE,
                              bar);
                    ring.advance();
                  }
          }
        }
      }
    } else {
      // warps 1-3: stage each item's X
      const int sid = ptid - 32;
      Ring ring{xfull, xempty, 1, 0, 0};
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const int r = i / NBR, n = r / tiles, t0 = r % tiles * U::M;
        ring.wait_empty();
        if (a.x != nullptr)
          unit_stage_cf<C>(a.x, xwin, n, t0 - 64, a.T, sid);
        else
          unit_stage_cl<C>(unit_slot(a, i % NBR).yin, xwin, n, t0 - 64, a.T, sid);
        fence_async_shared();
        mbar_arrive(xfull);
        ring.advance();
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  // warp and warpgroup, known to the compiler as uniform across the warp
  // (wgmma under a branch it thinks divergent is serialized)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int r = 16 * (warp & 3) + (lane >> 2);   // accumulator rows r, r + 8
  const int q = lane & 3;
  // the warpgroup's first row tile in a pass, and its first channel in the pass's block
  const int rw = U::COLS ? 0 : U::MB * wg;
  const int cw = U::COLS ? U::NT * wg : 0;
  Ring wring{wfull, wempty, U::RING, 0, 0};      // the stages taken
  Ring wfree = wring;                            // the stages handed back
  Ring xring{xfull, xempty, 1, 0, 0};
  const uint32_t wbase = smem_addr(smem), xbase = smem_addr(xwin), hbase = smem_addr(hwin);

  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int rr = i / NBR, n = rr / tiles, t0 = rr % tiles * U::M;
    const UnitSlot sl = unit_slot(a, i % NBR);
    const int k = sl.k, p = (k - 1) / 2;
    xring.acquire();
#pragma unroll
    for (int conv = 0; conv < 2; ++conv) {   // unrolled: each conv's constants
      const bool first = conv == 0;
      const int nt = first ? U::N1 : U::N2;
      const int passes = (nt + U::RT - 1) / U::RT;
      const int dil = first ? sl.d : 1;
      // conv1 reads X (row u of its tiles at X row u + 32), conv2 H (row m at H row m + 32)
      const uint32_t abase = first ? xbase : hbase;
      const uint32_t alb = first ? U::X_LBO : U::H_LBO;
      const float* bias = sl.bias + conv * C;
#pragma unroll 1
      for (int pass = 0; pass < U::BLOCKS * passes; ++pass) {
        const int cb = pass / passes * U::NS + cw;        // the warpgroup's first channel
        const int rt = pass % passes * U::RT + rw;        // and its first row tile
        float acc[U::MB][U::ACC];
#pragma unroll
        for (int mb = 0; mb < U::MB; ++mb)
#pragma unroll
          for (int e = 0; e < U::ACC; ++e) acc[mb][e] = 0.f;
#pragma unroll 1
        for (int c = 0; c < U::CHUNKS; ++c)
#pragma unroll 1
          for (int j0 = 0; j0 < k; j0 += GROUP_MAX) {
            const int jn = k - j0 < GROUP_MAX ? k - j0 : GROUP_MAX;
            float t[U::MB][U::ACC];
#pragma unroll
            for (int mb = 0; mb < U::MB; ++mb) reg_fence(t[mb]);
            wg_fence();
#pragma unroll 1
            for (int j = j0; j < j0 + jn; ++j) {
              wring.acquire();
              const uint32_t wb = wbase + wring.slot * U::STAGE + cw % U::NS * 16;
              wring.advance();
#pragma unroll
              for (int mb = 0; mb < U::MB; ++mb) {
                if (rt + mb >= nt) continue;
                const uint32_t xa = abase + (uint32_t)(4 * c) * alb +
                                    (uint32_t)(64 * (rt + mb) + 32 + (j - p) * dil) * 16;
#pragma unroll
                for (int ks = 0; ks < 2; ++ks)
                  Wgmma<U::NT>::bf16(t[mb], desc_of(xa + ks * 2 * alb, alb),
                                     desc_of(wb + ks * 2 * U::B_LBO, U::B_LBO), j > j0 || ks > 0);
              }
            }
            wg_commit();
            wg_wait0();
#pragma unroll
            for (int mb = 0; mb < U::MB; ++mb) reg_fence(t[mb]);
            for (int jj = 0; jj < jn; ++jj) wfree.release();
#pragma unroll
            for (int mb = 0; mb < U::MB; ++mb) {
              if (rt + mb >= nt) continue;
#pragma unroll
              for (int e = 0; e < U::ACC; ++e) acc[mb][e] += t[mb][e];
            }
          }

        // epilogue: rows are frames, columns output channels, 8 columns
        // (jn) at a time, two rows (h) each
        if (first) {
          // H = bf16(lrelu(conv + bias)), zero outside [0, T)
#pragma unroll
          for (int mb = 0; mb < U::MB; ++mb) {
            if (rt + mb >= nt) continue;
#pragma unroll
            for (int jn = 0; jn < U::NT / 8; ++jn) {
              const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + cb + 8 * jn + 2 * q));
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int u = 64 * (rt + mb) + r + 8 * h, f = t0 - 32 + u;
                const bool valid = f >= 0 && f < a.T;
                const float v0 = valid ? acc[mb][4 * jn + 2 * h] + bv.x : 0.f;
                const float v1 = valid ? acc[mb][4 * jn + 2 * h + 1] + bv.y : 0.f;
                *reinterpret_cast<__nv_bfloat162*>(hwin + (cb / 8 + jn) * U::H_LBO + u * 16 +
                                                   q * 4) =
                    __floats2bfloat162_rn(lrelu(v0), lrelu(v1));
              }
            }
          }
          continue;
        }
        // y = res + (conv + bias), fp32 (B, T, C), EB x 8 columns at a
        // time: the loads first (the compiler keeps a load after a store it
        // might alias)
        const size_t item = (size_t)n * a.T;
#pragma unroll
        for (int mb = 0; mb < U::MB; ++mb) {
          if (rt + mb >= nt) continue;
#pragma unroll
          for (int j8 = 0; j8 < U::NT / 8; j8 += U::EB) {
            float2 rv[U::EB][2];
#pragma unroll
            for (int jn = 0; jn < U::EB; ++jn)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int f = t0 + 64 * (rt + mb) + r + 8 * h, co = cb + 8 * (j8 + jn) + 2 * q;
                rv[jn][h] = make_float2(0.f, 0.f);
                if (f >= a.T) continue;
                if (a.x != nullptr) {
                  const __nv_bfloat16* xs = a.x + ((size_t)n * C + co) * a.T + f;
                  rv[jn][h] = make_float2(__bfloat162float(xs[0]), __bfloat162float(xs[a.T]));
                } else {
                  rv[jn][h] =
                      __ldg(reinterpret_cast<const float2*>(sl.yin + (item + f) * C + co));
                }
              }
#pragma unroll
            for (int jn = 0; jn < U::EB; ++jn) {
              const int co = cb + 8 * (j8 + jn) + 2 * q;
              const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + co));
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int f = t0 + 64 * (rt + mb) + r + 8 * h;
                if (f >= a.T) continue;
                const float2 v = make_float2(acc[mb][4 * (j8 + jn) + 2 * h] + bv.x,
                                             acc[mb][4 * (j8 + jn) + 2 * h + 1] + bv.y);
                *reinterpret_cast<float2*>(sl.yout + (item + f) * C + co) =
                    make_float2(rv[jn][h].x + v.x, rv[jn][h].y + v.y);
              }
            }
          }
        }
      }
      if (first) {
        xring.release();        // every warp's products on X are done: restage it
        fence_async_shared();   // H's stores, to conv2's products
        consumers_sync();
      }
    }
    consumers_sync();           // conv2 done with H before the next item's conv1 writes it
  }
}

template <int C>
cudaError_t run_units(const Stage& s, int sms, cudaStream_t stream) {
  using U = Unit<C>;
  auto kernel = mrf_unit_kernel<C>;
  const size_t plane = (size_t)s.batch * s.T * C;
  // the residual streams: unit di writes set di % 2, reads the other
  float* y[2][NBR];
  for (int set = 0; set < 2; ++set)
    for (int b = 0; b < NBR; ++b) y[set][b] = s.scratch + (set * NBR + b) * plane;
  int order[NBR] = {0, 1, 2};   // branches by falling k, as the chain's slots
  for (int i = 0; i < NBR; ++i)
    for (int j = i + 1; j < NBR; ++j)
      if (s.k[order[j]] > s.k[order[i]]) {
        const int o = order[i];
        order[i] = order[j];
        order[j] = o;
      }
  const int items = NBR * s.batch * ((s.T + U::M - 1) / U::M);
  // a grid of a multiple of 3 would give every CTA one branch only
  const int grid = items < sms ? items : sms % NBR == 0 ? sms - 1 : sms;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, U::SMEM);
  if (err != cudaSuccess) return err;
  for (int di = 0; di < NDIL; ++di) {
    UnitArgs a{};
    a.x = di == 0 ? static_cast<const __nv_bfloat16*>(s.x) : nullptr;
    a.batch = s.batch;
    a.T = s.T;
    for (int slot = 0; slot < NBR; ++slot) {
      const int b = order[slot], k = s.k[b];
      a.yin[slot] = di == 0 ? nullptr : y[(di + 1) % 2][b];
      a.yout[slot] = y[di % 2][b];
      a.w[slot] = static_cast<const __nv_bfloat16*>(s.w[b]) + (size_t)2 * di * k * C * C;
      a.bias[slot] = s.bias + (size_t)(2 * NDIL * b + 2 * di) * C;
      a.k[slot] = k;
      a.d[slot] = s.d[b][di];
    }
    kernel<<<grid, THREADS, U::SMEM, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const dim3 tgrid((s.T + 31) / 32, (C + 31) / 32, s.batch), tblock(32, 8);
  mrf_average_channels_first<__nv_bfloat16><<<tgrid, tblock, 0, stream>>>(
      y[(NDIL - 1) % 2][0], y[(NDIL - 1) % 2][1], y[(NDIL - 1) % 2][2],
      static_cast<__nv_bfloat16*>(s.y), C, s.T);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16 (x, y and
// the packed weights); scratch (7 x B x T x C) and biases (18 x C) are
// float32. `w0`..`w2`: each branch's weights from
// ops/mrf.py::pack_mrf_kernel_weights. C in {8, 16, 32, 64, 128, 256, 512},
// odd kernel sizes up to 11, dilations >= 1. Returns a cudaError_t (0 =
// launched).
extern "C" int mrf_stage_fwd(const void* x, void* y, void* scratch, const void* w0,
                             const void* w1, const void* w2, const void* bias, int batch, int C,
                             int T, int k0, int k1, int k2, int d00, int d01, int d02, int d10,
                             int d11, int d12, int d20, int d21, int d22, int dtype,
                             void* stream) {
  const Stage s{x, y, static_cast<float*>(scratch), {w0, w1, w2}, static_cast<const float*>(bias),
                batch, C, T, {k0, k1, k2}, {{d00, d01, d02}, {d10, d11, d12}, {d20, d21, d22}}};
  if (batch <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  for (int b = 0; b < NBR; ++b) {
    if (s.k[b] < 1 || s.k[b] > KMAX || s.k[b] % 2 == 0) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < NDIL; ++i)
      if (s.d[b][i] < 1) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_stage<float>(s, st);
  if (dtype == 1) return (int)run_stage<__nv_bfloat16>(s, st);
  return (int)cudaErrorInvalidValue;
}

// Plain C entry point of the one-pass design (bf16 only): x, y (B, C, T)
// bf16, `w0`..`w2` the branches' bf16 streams from
// ops/mrf.py::pack_mrf_kernel_weights, biases (18 x C) fp32; no scratch. C in
// {8, 16, 32, 64}, odd kernel sizes up to 11, dilations >= 1, the stage's
// reach at most 64 frames and no conv's at most 32 (ops/mrf.py::mrf_route).
// Returns a cudaError_t (0 = launched).
extern "C" int mrf_stage_onepass_fwd(const void* x, void* y, const void* w0, const void* w1,
                                     const void* w2, const void* bias, int batch, int C, int T,
                                     int k0, int k1, int k2, int d00, int d01, int d02, int d10,
                                     int d11, int d12, int d20, int d21, int d22, void* stream) {
  const OnePassArgs a{static_cast<const __nv_bfloat16*>(x),
                      static_cast<__nv_bfloat16*>(y),
                      {static_cast<const __nv_bfloat16*>(w0), static_cast<const __nv_bfloat16*>(w1),
                       static_cast<const __nv_bfloat16*>(w2)},
                      static_cast<const float*>(bias),
                      batch, T, {k0, k1, k2},
                      {{d00, d01, d02}, {d10, d11, d12}, {d20, d21, d22}}};
  if (batch <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  for (int b = 0; b < NBR; ++b) {
    const int k = a.k[b], p = (k - 1) / 2;
    if (k < 1 || k > KMAX || k % 2 == 0) return (int)cudaErrorInvalidValue;
    int reach = 3 * p;
    for (int i = 0; i < NDIL; ++i) {
      if (a.d[b][i] < 1 || p * a.d[b][i] > OP_MARGIN) return (int)cudaErrorInvalidValue;
      reach += p * a.d[b][i];
    }
    if (reach > OP_HALO) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return (int)run_onepass<8, 8>(a, st);
    case 16: return (int)run_onepass<16, 8>(a, st);
    case 32: return (int)run_onepass<32, 4>(a, st);
    case 64: return (int)run_onepass<64, 2>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Plain C entry point of the unit design (bf16 only): x, y (B, C, T) bf16,
// scratch (6 x B x T x C) fp32, `w0`..`w2` the branches' bf16 streams from
// ops/mrf.py::pack_mrf_kernel_weights, biases (18 x C) fp32. C in {64, 128,
// 256}, odd kernel sizes up to 11, dilations >= 1, no conv reaching further
// than 32 frames (ops/mrf.py::unit_takes). Returns a cudaError_t (0 =
// launched).
extern "C" int mrf_stage_unit_fwd(const void* x, void* y, void* scratch, const void* w0,
                                  const void* w1, const void* w2, const void* bias, int batch,
                                  int C, int T, int k0, int k1, int k2, int d00, int d01, int d02,
                                  int d10, int d11, int d12, int d20, int d21, int d22,
                                  void* stream) {
  const Stage s{x, y, static_cast<float*>(scratch), {w0, w1, w2}, static_cast<const float*>(bias),
                batch, C, T, {k0, k1, k2}, {{d00, d01, d02}, {d10, d11, d12}, {d20, d21, d22}}};
  if (batch <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  for (int b = 0; b < NBR; ++b) {
    const int k = s.k[b], p = (k - 1) / 2;
    if (k < 1 || k > KMAX || k % 2 == 0) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < NDIL; ++i)
      if (s.d[b][i] < 1 || p * s.d[b][i] > UNIT_MARGIN) return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64: return (int)run_units<64>(s, sms, st);
    case 128: return (int)run_units<128>(s, sms, st);
    case 256: return (int)run_units<256>(s, sms, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
