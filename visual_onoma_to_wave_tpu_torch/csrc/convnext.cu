// ConvNeXt block and whole ConvNeXt trunk of the Vocos vocoder (Hopper).
//
// Replaces the TPU kernels visual_onoma_to_wave_tpu/ops/pallas_convnext.py::
// convnext_block (body _block_kernel / _block_math) and ::convnext_trunk
// (body _trunk_kernel). Per batch item, on x (T, C) feature-last:
//
//     h = depthwise_conv_k(x) + db            (zero padding at the item's edges,
//                                              fp32 accumulation)
//     h = LayerNorm(h) * ls + lb              (fp32 statistics, eps)
//     a = GELU(h W1 + b1)                     (W1: C x M; tanh or erf form)
//     y = x + gamma * (a W2 + b2)             (W2: M x C)
//
// Operands are fp32 or bf16 with every product accumulated in fp32; for bf16
// h and a are rounded to bf16 before their products and y on its store, where
// the TPU kernel rounds them (pallas_convnext.py:78, :83, :88).
//
// Design. The TPU kernel keeps one whole item's (T, C) tile and the (T, M)
// GELU activation in VMEM. At T = 1000, C = 512 the tile alone is 2 MB fp32,
// far past a block's 227 KB of shared memory, so here one block (CTA) owns a
// tile of 64 frames of one item, which is wgmma's M:
//   * 384 threads: two consumer warpgroups and a producer warpgroup, one
//     thread of which issues the weight copies (setmaxnreg: 240 registers a
//     consumer thread, 24 a producer thread). The consumers run the depthwise
//     conv over 32-channel slabs of x staged in shared memory (the 3-frame
//     halo included, zero outside the item, the ragged last tile masked, the
//     next slab's loads in flight) and the LayerNorm, into a (64, C) fp32
//     tile h in shared memory;
//   * M is walked in chunks of 64. Per chunk, each warpgroup computes the
//     chunk's 64 columns of h W1 over its half of C on the tensor cores
//     (wgmma m64n64, A = h from registers, B = W1^T from shared memory); the
//     two partial sums meet in shared memory, where each warpgroup finishes
//     32 columns with b1 and GELU into a (64, 64) chunk (a 64-wide wgmma
//     does twice the work per A fragment of the 32-wide one that splitting
//     the columns would give). After a named barrier each warpgroup
//     accumulates o += a W2[chunk] for its half of C (two wgmma m64n(C/4) in
//     turn), so o (64 x C fp32, C/4 registers a thread) stays in registers
//     across the whole M loop and the (T, M) activation never leaves the
//     chip;
//   * fp32 operands run as 3xTF32: x = hi + lo with hi = tf32(x) and lo the
//     exact fp32 remainder, and each k-step issues hi*lo, lo*hi and hi*hi
//     (lo*lo, ~2^-22 relative, is dropped). One TF32 product alone lands
//     ~3e-3 off the fp32 result over 8 blocks, 60x past the port's 5e-5
//     bound; three land ~5e-6 (tests/test_torch_convnext_pack.py). h and the
//     GELU chunk are split in registers as they are loaded (wgmma takes A
//     from registers), so the lo half needs no shared memory. bf16 operands
//     run one bf16 wgmma (bf16 products are exact in fp32);
//   * the tensor cores' own fp32 accumulation truncates: summed in one chain
//     over K = 1536 the block landed past the 5e-5 bound at C 512 on the
//     H100. So every stage (at most 64 of K) is a fresh tensor-core sum that
//     the consumers add to their fp32 registers with the CUDA cores, and the
//     block lands within 1e-5 (chip_smoke phase 2b);
//   * the weights are packed once by the wrapper (ops/convnext.py::
//     pack_convnext_weights), transposed to K-major (wgmma on tf32 takes no
//     other), split into tf32 hi and lo planes for fp32, cut into 16 KB planes
//     of 8-row x 16-byte core matrices in the order the kernel consumes them
//     (per chunk: the W1^T planes, then the W2^T planes). So each stage of the
//     weight stream is one contiguous cp.async.bulk completing on an mbarrier;
//     the producer keeps a 64 KB ring (2 fp32 / 4 bf16 stages) in flight
//     while the warpgroups multiply.
// What bounds it: per tile 4*64*C*M FLOPs (x3 for fp32 as 3xTF32) and the
// whole packed weight stream (12.6 MB fp32 hi + lo, 3.1 MB bf16 at C 512, M
// 1536), which every tile reads from L2. Measured at B 16, T 1000 on the H100
// (tools/convnext_phases.py, PERF.md): the M loop is 88% (fp32) and 74% (bf16)
// of a tile and takes ~1340 / ~940 SM cycles per weight stage against 768 /
// 256 cycles of tensor-core work. bf16 takes fewer bytes per cycle than fp32,
// so the L2's rate is not the wall: the per-stage latency is (the wait for
// the stage, the A fragments loaded and split, at most two wgmma groups in
// flight, the CUDA-core adds of each fresh sum). Deeper wgmma pipelines and
// two tiles per weight load (a cluster multicast) are the next levers.
// Shared memory at C 512: 64 KB ring + 129 KB h + 17 KB GELU chunk / staged
// conv slab; one CTA per SM.
//
// The trunk (all L blocks in one launch) is the same kernel launched
// persistent and cooperative: one CTA per SM walks the (item, tile) work of
// layer l, then the consumers meet at a grid barrier (a counter in device
// memory; the producer keeps streaming layer l + 1's weights meanwhile), then
// layer l + 1. The activation ping-pongs between the output and a scratch
// tensor of the same shape (the wrapper allocates it), the last layer writing
// the output. Chosen over a tile with a 3*L-frame halo running all L layers
// on chip (24 halo frames per side at L = 8). A block launch is the same
// kernel with one layer and one CTA per tile, so the trunk equals L block
// launches bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;                    // frames per tile: wgmma's M
constexpr int MC = 64;                      // intermediate features per chunk
constexpr int CONSUMERS = 256;              // two warpgroups
constexpr int THREADS = CONSUMERS + 128;    // + the producer warpgroup
constexpr int PLANE_BYTES = 16384;          // one packed weight plane
constexpr int RING_BYTES = 65536;           // the weight ring
constexpr int KMAX = 35;                    // largest conv kernel (staged in `as`)

template <typename T>
struct Operand;
template <>
struct Operand<float> {                     // 3xTF32: hi and lo planes, wgmma k 8
  static constexpr int SPLIT = 2, KSTEP = 8, PAD = 4;
};
template <>
struct Operand<__nv_bfloat16> {             // one bf16 plane, wgmma k 16
  static constexpr int SPLIT = 1, KSTEP = 16, PAD = 8;
};

// Tile geometry. The first product's stage is a plane of W1^T holding two
// (MC, KS1 / 2) blocks, a slice of each half of C (one per warpgroup); the
// second's a (C, KS2) plane of W2^T; all K-major. A chunk of M is S1 + S2
// stages.
// The row paddings keep the A-fragment loads free of bank conflicts.
template <typename T, int C>
struct Geom {
  static constexpr int PLANE = PLANE_BYTES / sizeof(T);
  static constexpr int STAGE_BYTES = PLANE_BYTES * Operand<T>::SPLIT;
  static constexpr int STAGES = RING_BYTES / STAGE_BYTES;
  static constexpr int KS1 = PLANE / MC, S1 = C / KS1;
  static constexpr int KS2 = PLANE / C, S2 = MC / KS2;
  static constexpr int LDH = C + Operand<T>::PAD, LDA = MC + Operand<T>::PAD;
  static constexpr size_t H_OFF = RING_BYTES;
  static constexpr size_t A_OFF = H_OFF + (size_t)TILE * LDH * sizeof(float);
  static constexpr size_t BAR_OFF = A_OFF + (size_t)TILE * LDA * sizeof(float);
  static constexpr size_t SMEM = BAR_OFF + 2 * STAGES * sizeof(uint64_t);
  static_assert(S1 * KS1 == C && S2 * KS2 == MC, "stage geometry");
  static_assert(KS1 % Operand<T>::KSTEP == 0 && KS2 % Operand<T>::KSTEP == 0, "k-steps");
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(TILE * LDA >= (TILE + 2 * KMAX - 1) * 32, "the conv's staged slab fits `as`");
};

__device__ __forceinline__ float load_f(const float* p, size_t i) { return __ldcg(p + i); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(__ldcg(p + i));
}
__device__ __forceinline__ float ldg_f(const float* p, size_t i) { return __ldg(p + i); }
__device__ __forceinline__ float ldg_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(__ldg(p + i));
}
__device__ __forceinline__ void store_f(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16(x);
}
// round to the operand type (the TPU kernel's astype(x.dtype))
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <bool TANH>
__device__ __forceinline__ float gelu(float x) {
  if (TANH) {  // jax.nn.gelu(approximate=True)
    return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
  }
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// one contiguous copy from device memory to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// consumers only (the producer warpgroup does not take part): named barrier 1
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
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
// and 128 bytes apart along N.
__device__ __forceinline__ uint64_t desc_of(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// wgmma m64nNk8 (tf32) and m64nNk16 (bf16), A from registers, B from shared
// memory (K-major), fp32 accumulators d[N / 2]: d = A B^T + (scale_d ? d : 0).
template <int N>
struct Wgmma;
template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a, uint64_t desc,
                                         int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15"
                 "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a, uint64_t desc,
                                         int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15"
                 "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a, uint64_t desc,
                                         int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31"
                 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
                   "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a, uint64_t desc,
                                         int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31"
                 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
                   "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a, uint64_t desc,
                                         int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
                 "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
                 "%60, %61, %62, %63"
                 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a, uint64_t desc,
                                         int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
                 "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
                 "%60, %61, %62, %63"
                 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// ---- A fragments ----------------------------------------------------------
//
// A thread's share of one k-step of A: rows r and r + 8 (r = 16 * its warp in
// the warpgroup + lane / 4) of a row-major fp32 matrix in shared memory, `p`
// pointing at row r, column lane % 4 (tf32: columns +0, +4) or 2 * (lane % 4)
// (bf16: column pairs +0, +8).
struct FragTF32 {
  uint32_t hi[4], lo[4];
};
struct FragBF16 {
  uint32_t v[4];
};
template <typename T>
struct FragOf {
  using type = FragTF32;
};
template <>
struct FragOf<__nv_bfloat16> {
  using type = FragBF16;
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void load_frag(const float* p, int ld, FragTF32& f) {
  const float v[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = tf32_rna(v[i]);
    f.lo[i] = __float_as_uint(v[i] - __uint_as_float(f.hi[i]));  // exact
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f.hi[i]), "+r"(f.lo[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);  // h and a are bf16 already: exact
  return *reinterpret_cast<uint32_t*>(&b);
}

__device__ __forceinline__ void load_frag(const float* p, int ld, FragBF16& f) {
  f.v[0] = pack_bf16(*reinterpret_cast<const float2*>(p));
  f.v[1] = pack_bf16(*reinterpret_cast<const float2*>(p + 8 * ld));
  f.v[2] = pack_bf16(*reinterpret_cast<const float2*>(p + 8));
  f.v[3] = pack_bf16(*reinterpret_cast<const float2*>(p + 8 * ld + 8));
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f.v[i])::"memory");
}

// One k-step: 3xTF32 (the stage holds the hi plane, then the lo plane) or bf16.
template <int N>
__device__ __forceinline__ void mma(float* d, const FragTF32& a, uint32_t b, uint32_t lbo,
                                    int scale_d) {
  Wgmma<N>::tf32(d, a.hi, desc_of(b + PLANE_BYTES, lbo), scale_d);  // hi * lo
  Wgmma<N>::tf32(d, a.lo, desc_of(b, lbo), 1);                      // lo * hi
  Wgmma<N>::tf32(d, a.hi, desc_of(b, lbo), 1);                      // hi * hi
}
template <int N>
__device__ __forceinline__ void mma(float* d, const FragBF16& a, uint32_t b, uint32_t lbo,
                                    int scale_d) {
  Wgmma<N>::bf16(d, a.v, desc_of(b, lbo), scale_d);
}

// d (64 x N of this warpgroup) = A[:, 0:KS] B^T over one stage of the ring,
// a fresh tensor-core sum: one wgmma group per k-step, at most two in flight
// (A's registers stay in use until their group is done). `b` is the shared
// address of B's first core matrix, `lbo` the byte step between core
// matrices along K.
template <typename T, int N, int KS>
__device__ __forceinline__ void stage_mma(float (&d)[N / 2], const float* a, int ld, uint32_t b,
                                          uint32_t lbo) {
  constexpr int KSTEP = Operand<T>::KSTEP;
  reg_fence(d);
#pragma unroll
  for (int kk = 0; kk < KS / KSTEP; ++kk) {
    typename FragOf<T>::type f;
    load_frag(a + kk * KSTEP, ld, f);
    wg_fence();
    mma<N>(d, f, b + kk * 2 * lbo, lbo, kk > 0);
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
  reg_fence(d);
}

// ---- the weight ring --------------------------------------------------------

template <int STAGES>
struct Ring {
  uint32_t base, full, empty;  // shared addresses: stage 0, full[0], empty[0]
  int slot;
  uint32_t phase;
  __device__ __forceinline__ void advance() {
    if (++slot == STAGES) {
      slot = 0;
      phase ^= 1;
    }
  }
  // consumers: wait for the current stage to land
  __device__ __forceinline__ void acquire() {
    mbar_wait(full + 8 * slot, phase);
    __syncwarp();  // converged again before the warpgroup's .aligned wgmma
  }
  // consumers: every warp hands the stage back once its wgmma groups are done
  __device__ __forceinline__ void release() {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * slot);
    advance();
  }
};

// ---- the block ---------------------------------------------------------------

// Launch arguments. Per-layer tensors are stacked on a leading layer axis:
// dw (L, K, C) in the operand type; db, ls, lb, b2, gamma (L, C) and b1 (L, M)
// in fp32; `packed` holds each layer's weight stream (pack_convnext_weights).
struct Params {
  const void* x;
  void* y;
  void* scratch;   // trunk only: (batch, seq, C) in the operand type
  unsigned* sync;  // trunk only: the grid barrier's counter, zeroed
  const void* dw;
  const float* db;
  const float* ls;
  const float* lb;
  const void* packed;
  const float* b1;
  const float* b2;
  const float* gamma;
  int layers, batch, seq, M, K;
  float eps;
};

template <typename T>
struct Layer {
  const T* dw;
  const float *db, *ls, *lb, *b1, *b2, *gamma;
};

template <typename T, int C>
__device__ __forceinline__ Layer<T> layer_at(const Params& p, int l) {
  return Layer<T>{static_cast<const T*>(p.dw) + (size_t)l * p.K * C, p.db + (size_t)l * C,
                  p.ls + (size_t)l * C,  p.lb + (size_t)l * C,
                  p.b1 + (size_t)l * p.M, p.b2 + (size_t)l * C,
                  p.gamma + (size_t)l * C};
}

// Consumers: frames [t0, t0 + TILE) of item b, y = block(x). The activations
// are read through L2 (__ldcg): in the trunk other CTAs wrote them earlier in
// the same launch.
template <typename T, int C, bool TANH>
__device__ __forceinline__ void tile_fwd(const T* x, T* y, const Layer<T>& w, int b, int t0,
                                         int seq, int M, int K, float eps, float* hs, float* as,
                                         Ring<Geom<T, C>::STAGES>& ring) {
  using G = Geom<T, C>;
  constexpr int NC = C / 32;   // channels per lane in the conv / LayerNorm
  constexpr int NO = C / 4;    // accumulators of this warpgroup's (64, C / 2) output
  constexpr int COL = sizeof(T) == 4 ? 1 : 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2;                        // warpgroup 0 or 1
  const int r = 16 * (warp & 3) + (lane >> 2);     // accumulator rows r, r + 8
  const int q = lane & 3;
  const size_t item = (size_t)b * seq * C;
  const int half = (K - 1) / 2;

  // 1a. depthwise conv, 32 channels at a time: the slab's TILE + K - 1 rows
  // of x (zero outside the item) and its K taps of dw go through registers
  // into `as`, coalesced, the next slab's loads in flight while each thread
  // sums 8 frames of one channel of this slab over the K taps
  constexpr int RX = (TILE + KMAX - 1 + 7) / 8, RW = (KMAX + 7) / 8;  // rows per warp, at most
  const int rows = TILE + K - 1;                       // x rows, then K rows of dw
  float xs[RX], ws[RW];
  auto stage_load = [&](int c0) {
#pragma unroll
    for (int i = 0; i < RX; ++i) {
      const int tt = t0 - half + warp + 8 * i;
      xs[i] = 0.f;
      if (warp + 8 * i < rows && tt >= 0 && tt < seq)
        xs[i] = load_f(x, item + (size_t)tt * C + c0 + lane);
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      ws[i] = 0.f;
      if (warp + 8 * i < K) ws[i] = ldg_f(w.dw, (size_t)(warp + 8 * i) * C + c0 + lane);
    }
  };
  stage_load(0);
  for (int c0 = 0; c0 < C; c0 += 32) {
#pragma unroll
    for (int i = 0; i < RX; ++i)
      if (warp + 8 * i < rows) as[(warp + 8 * i) * 32 + lane] = xs[i];
#pragma unroll
    for (int i = 0; i < RW; ++i)
      if (warp + 8 * i < K) as[(rows + warp + 8 * i) * 32 + lane] = ws[i];
    consumer_sync();
    if (c0 + 32 < C) stage_load(c0 + 32);
    const int c = c0 + lane;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float wk = as[(rows + k) * 32 + lane];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(as[(8 * warp + j + k) * 32 + lane], wk, acc[j]);
    }
    const float db = __ldg(w.db + c);
#pragma unroll
    for (int j = 0; j < 8; ++j) hs[(8 * warp + j) * G::LDH + c] = acc[j] + db;
    consumer_sync();  // `as` is staged again for the next slab
  }

  // 1b. LayerNorm of the warp's own 8 frames, one frame at a time
  for (int j = 0; j < 8; ++j) {
    float* hrow = hs + (8 * warp + j) * G::LDH;
    if (t0 + 8 * warp + j >= seq) {  // ragged tail: zeros, never stored
#pragma unroll
      for (int i = 0; i < NC; ++i) hrow[lane + 32 * i] = 0.f;
      continue;
    }
    float h[NC];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      h[i] = hrow[lane + 32 * i];
      s += h[i];
    }
    const float mean = warp_sum(s) / C;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float d = h[i] - mean;
      v = fmaf(d, d, v);
    }
    const float rs = 1.f / sqrtf(warp_sum(v) / C + eps);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      const float n = (h[i] - mean) * rs;
      hrow[c] = round_to(fmaf(n, __ldg(w.ls + c), __ldg(w.lb + c)), x);
    }
  }
  consumer_sync();

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  const float* h_frag = hs + r * G::LDH + COL * q;
  const float* a_frag = as + r * G::LDA + COL * q;

  for (int m0 = 0; m0 < M; m0 += MC) {
    // 2a. h W1[:, m0:m0+MC] over this warpgroup's half of C (wgmma N = MC),
    // one slice of it in each of the S1 stages
    float acc[MC / 2];
#pragma unroll
    for (int i = 0; i < MC / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int s = 0; s < G::S1; ++s) {
      ring.acquire();
      const uint32_t bw = ring.base + ring.slot * G::STAGE_BYTES + wg * (PLANE_BYTES / 2);
      float t[MC / 2];
      stage_mma<T, MC, G::KS1 / 2>(t, h_frag + wg * (C / 2) + s * (G::KS1 / 2), G::LDH, bw,
                                   (MC / 8) * 128);
      ring.release();
#pragma unroll
      for (int i = 0; i < MC / 2; ++i) acc[i] += t[i];
    }
    // the two halves' sums meet in `as`: each warpgroup hands over the
    // other's 32 columns, then finishes its own with b1 and GELU
    consumer_sync();  // both warpgroups are done with the previous chunk of `as`
#pragma unroll
    for (int j = 0; j < MC / 8; ++j) {
      if (j / (MC / 16) == wg) continue;
      const int m = 8 * j + 2 * q;
      *reinterpret_cast<float2*>(as + r * G::LDA + m) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(as + (r + 8) * G::LDA + m) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    consumer_sync();
#pragma unroll
    for (int j = 0; j < MC / 8; ++j) {
      if (j / (MC / 16) != wg) continue;
      const int m = 8 * j + 2 * q;
      const float c0 = __ldg(w.b1 + m0 + m), c1 = __ldg(w.b1 + m0 + m + 1);
      float* p0 = as + r * G::LDA + m;
      float* p1 = as + (r + 8) * G::LDA + m;
      p0[0] = round_to(gelu<TANH>(acc[4 * j] + p0[0] + c0), x);
      p0[1] = round_to(gelu<TANH>(acc[4 * j + 1] + p0[1] + c1), x);
      p1[0] = round_to(gelu<TANH>(acc[4 * j + 2] + p1[0] + c0), x);
      p1[1] = round_to(gelu<TANH>(acc[4 * j + 3] + p1[1] + c1), x);
    }
    consumer_sync();  // the whole (64, MC) GELU chunk is in `as`

    // 2b. o += a W2[m0:m0+MC, this warpgroup's half of C], over MC in S2
    // stages, each half of the half (C / 4 columns) in turn
#pragma unroll 1
    for (int s = 0; s < G::S2; ++s) {
      ring.acquire();
      const uint32_t bw = ring.base + ring.slot * G::STAGE_BYTES + wg * (C / 2 / 8) * 128;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float t[C / 8];
        stage_mma<T, C / 4, G::KS2>(t, a_frag + s * G::KS2, G::LDA, bw + hh * (C / 4 / 8) * 128,
                                    (C / 8) * 128);
#pragma unroll
        for (int i = 0; i < C / 8; ++i) o[hh * (C / 8) + i] += t[i];
      }
      ring.release();
    }
  }

  // 3. y = x + gamma * (o + b2). o goes through shared memory (h is no
  // longer read: both warpgroups are past the last chunk's barrier), so that
  // x is read and y written a whole row per warp instruction, a row's loads
  // in flight together
#pragma unroll
  for (int j = 0; j < C / 16; ++j) {
    const int c = wg * (C / 2) + 8 * j + 2 * q;
    *reinterpret_cast<float2*>(hs + r * G::LDH + c) = make_float2(o[4 * j], o[4 * j + 1]);
    *reinterpret_cast<float2*>(hs + (r + 8) * G::LDH + c) =
        make_float2(o[4 * j + 2], o[4 * j + 3]);
  }
  consumer_sync();
  for (int f = 8 * warp; f < 8 * warp + 8; ++f) {
    const int t = t0 + f;
    if (t >= seq) break;
    float xv[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) xv[i] = load_f(x, item + (size_t)t * C + lane + 32 * i);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      store_f(y, item + (size_t)t * C + c,
              xv[i] + __ldg(w.gamma + c) * (hs[f * G::LDH + c] + __ldg(w.b2 + c)));
    }
  }
}

// The trunk's barrier between layers, among the consumers of every CTA (all
// resident: cooperative launch). The producers keep streaming meanwhile.
__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned target) {
  consumer_sync();  // this CTA's stores of the layer are issued
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned seen = 0;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
      if (seen >= target) break;
      __nanosleep(64);
    }
    __threadfence();
  }
  consumer_sync();
}

// One kernel for both entry points: a block launch is one layer with one CTA
// per tile; the trunk is `layers` layers, persistent, one CTA per SM.
template <typename T, int C, bool TANH>
__global__ void __launch_bounds__(THREADS, 1) convnext_kernel(const Params p) {
  using G = Geom<T, C>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t full = smem_addr(smem + G::BAR_OFF), empty = full + 8 * G::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles_t = (p.seq + TILE - 1) / TILE;
  const int n_tiles = tiles_t * p.batch;
  const size_t layer_bytes = (size_t)(p.M / MC) * (G::S1 + G::S2) * G::STAGE_BYTES;
  const uint8_t* packed = static_cast<const uint8_t*>(p.packed);

  if (threadIdx.x >= CONSUMERS) {
    // producer: one thread streams every stage the consumers will take, in
    // their order, as far ahead as the ring allows; the warpgroup hands most
    // of its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS) {
      Ring<G::STAGES> ring{smem_addr(smem), full, empty, 0, 0};
      for (int l = 0; l < p.layers; ++l)
        for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
          for (size_t off = 0; off < layer_bytes; off += G::STAGE_BYTES) {
            mbar_wait(empty + 8 * ring.slot, ring.phase ^ 1);
            mbar_expect_tx(full + 8 * ring.slot, G::STAGE_BYTES);
            bulk_load(ring.base + ring.slot * G::STAGE_BYTES, packed + l * layer_bytes + off,
                      G::STAGE_BYTES, full + 8 * ring.slot);
            ring.advance();
          }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    Ring<G::STAGES> ring{smem_addr(smem), full, empty, 0, 0};
    float* hs = reinterpret_cast<float*>(smem + G::H_OFF);
    float* as = reinterpret_cast<float*>(smem + G::A_OFF);
    const T* src = static_cast<const T*>(p.x);
    for (int l = 0; l < p.layers; ++l) {
      // ping-pong so that the last layer writes the output
      T* dst = static_cast<T*>((p.layers - 1 - l) % 2 == 0 ? p.y : p.scratch);
      const Layer<T> w = layer_at<T, C>(p, l);
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        tile_fwd<T, C, TANH>(src, dst, w, tile / tiles_t, (tile % tiles_t) * TILE, p.seq, p.M,
                             p.K, p.eps, hs, as, ring);
      if (l + 1 < p.layers) grid_barrier(p.sync, (unsigned)(l + 1) * gridDim.x);
      src = dst;
    }
  }
}

template <typename T, int C, bool TANH>
cudaError_t launch(const Params& p, bool trunk, cudaStream_t stream) {
  constexpr size_t smem = Geom<T, C>::SMEM;
  auto kernel = convnext_kernel<T, C, TANH>;
  // above 48 KB of dynamic shared memory needs an opt-in
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (p.seq + TILE - 1) / TILE * p.batch;
  if (!trunk) {
    kernel<<<n_tiles, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = per_sm * sms < n_tiles ? per_sm * sms : n_tiles;
  Params args = p;
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid, THREADS, kargs, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool TANH>
cudaError_t dispatch_width(int C, bool trunk, const Params& p, cudaStream_t s) {
  switch (C) {
    case 128: return launch<T, 128, TANH>(p, trunk, s);
    case 256: return launch<T, 256, TANH>(p, trunk, s);
    case 512: return launch<T, 512, TANH>(p, trunk, s);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(bool trunk, const Params& p, int C, int dtype, int gelu_tanh, void* stream) {
  if (p.batch <= 0 || p.seq <= 0 || p.layers <= 0 || p.M <= 0 || p.M % 128 || p.K <= 0 ||
      p.K % 2 == 0 || p.K > KMAX || (trunk && p.layers > 1 && p.sync == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(gelu_tanh ? dispatch_width<float, true>(C, trunk, p, s)
                           : dispatch_width<float, false>(C, trunk, p, s));
  if (dtype == 1)
    return (int)(gelu_tanh ? dispatch_width<__nv_bfloat16, true>(C, trunk, p, s)
                           : dispatch_width<__nv_bfloat16, false>(C, trunk, p, s));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points for ctypes. dtype: 0 = float32, 1 = bfloat16 (x, y,
// dw, the packed weights and the trunk's scratch); the vectors are float32.
// `packed`: pack_convnext_weights(w1, w2, dtype) (ops/convnext.py), each
// layer's weight stream. gelu_tanh: 1 = tanh GELU, 0 = erf GELU. C in {128,
// 256, 512}, M a multiple of 128, odd K up to 35. `sync`: one zeroed unsigned int.
// Returns a cudaError_t (0 = launched).
extern "C" int convnext_block_fwd(const void* x, void* y, const void* dw, const void* db,
                                  const void* ls, const void* lb, const void* packed,
                                  const void* b1, const void* b2, const void* gamma, int batch,
                                  int seq, int C, int M, int K, int dtype, int gelu_tanh,
                                  float eps, void* stream) {
  const Params p{x, y, nullptr, nullptr, dw,
                 static_cast<const float*>(db), static_cast<const float*>(ls),
                 static_cast<const float*>(lb), packed, static_cast<const float*>(b1),
                 static_cast<const float*>(b2), static_cast<const float*>(gamma),
                 1, batch, seq, M, K, eps};
  return dispatch(false, p, C, dtype, gelu_tanh, stream);
}

extern "C" int convnext_trunk_fwd(const void* x, void* y, void* scratch, void* sync,
                                  const void* dw, const void* db, const void* ls, const void* lb,
                                  const void* packed, const void* b1, const void* b2,
                                  const void* gamma, int layers, int batch, int seq, int C, int M,
                                  int K, int dtype, int gelu_tanh, float eps, void* stream) {
  const Params p{x, y, scratch, static_cast<unsigned*>(sync), dw,
                 static_cast<const float*>(db), static_cast<const float*>(ls),
                 static_cast<const float*>(lb), packed, static_cast<const float*>(b1),
                 static_cast<const float*>(b2), static_cast<const float*>(gamma),
                 layers, batch, seq, M, K, eps};
  return dispatch(true, p, C, dtype, gelu_tanh, stream);
}
