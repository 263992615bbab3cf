// B7: a 1-D convolution with SAME padding on feature-last (B, T, C) input,
// on Hopper's tensor cores in 3xTF32.
//
// Replaces no TPU kernel: the JAX package runs the acoustic model's conv FFNs
// and PostNet through XLA (visual_onoma_to_wave_tpu/models/layers.py:
// PositionwiseFeedForward, PostNet). The port ran them through cuDNN, whose
// fp32 path with TF32 off is a SIMT implicit GEMM on the CUDA cores (67
// TFLOP/s at most) on channels-first (B, C, T) data, with a transpose and a
// copy around every conv. This kernel runs the same convs at fp32 accuracy
// on the tensor cores and reads and writes the models' own (B, T, C) layout.
//
// On x (batch, T, cin) and a Conv1d weight W (cout, cin, k), k odd, pad =
// (k - 1) / 2, for every frame t of every item:
//
//     v[t, co] = sum_j sum_ci x[t + j - pad, ci] W[co, ci, j] + bias[co]
//                (x zero outside [0, T))
//     v = (v - mean[co]) * (1 / sqrt(var[co] + eps)) * gamma[co] + beta[co]
//                (optional: an eval BatchNorm's running statistics)
//     y[t, co] = v, relu(v) or tanh(v)
//
// the arithmetic, in that order, of ops/conv1d.py::conv1d_tc_reference.
//
// What bounds it. 2 * cin * k * cout operations a frame: at the acoustic
// model's shapes (B 64 x T 1000) 302 GFLOP for a decoder FFN's first conv
// (256 -> 1024, k 9), 34 for its second (1024 -> 256, k 1), 556 for the
// PostNet's five (k 5), against bytes of well under 1 GB a conv: bound by
// the tensor cores. fp32 runs as 3xTF32, three TF32 products a
// multiply-add, so at 495 TFLOP/s a decoder FFN's two convs take at least
// 2.0 ms and the whole acoustic model's 25 convs 15.6 ms.
//
// Layout: rows (frames) on wgmma's M, output channels on N, K = (input
// channel, tap). The items of a batch are laid end to end in one row space,
// item n's frame t at row n * S + t, with S - T zero rows after each item. A
// tile is 128 rows of that space (64 a consumer warpgroup) by NT output
// channels: NT = 128 where cout is a multiple of 128, 80 at cout 80. Only the
// rows of real frames are written.
//   * The input window of a tile (its 128 rows and P rows each side) is
//     staged once per chunk of 16 input channels, in the no-swizzle K-major
//     layout of csrc/mrf.cu: each 16-byte group of 4 channels is its own
//     column of W = 128 + 2 P rows, so a tap's shift by j rows is the A
//     descriptor's start address plus 16 j bytes, with no copy per tap. One
//     thread of producer warp 1 fetches it with TMA, the tensor map's zero
//     fill giving every row outside an item's frames. The row space adapts
//     to the items' length:
//       - items of at least 128 frames (the decoder's and the PostNet's
//         1000): S = T rounded up to 128, so no tile holds two items, and
//         P = pad; the window is one box of W rows x 4 groups of 4 channels
//         in the slot's [group][row][4] layout, the groups one stride of 16
//         bytes in the tensor map. At k = 1 the batch's frames are one item
//         of B x T rows.
//       - shorter items (the encoder's 8 text positions): S = T + pad and P
//         = pad, each rounded up to 16, so a batch of items fills whole
//         tiles; one box of 16 rows x 4 channels per (16-row block, group),
//         each block inside one item's span.
//     (Fetched in many small pieces, a k = 1 window takes longer than its
//     products, ~2.2 us a chunk against 0.4: so it went with 32 boxes of
//     16 rows, and with cp.async of 16 bytes a thread.) Warps 2-3 then
//     split each landed window into hi = tf32(v) in place and lo = tf32(v -
//     hi) in the lo plane, fence and hand it to the consumers.
//   * The weights are packed once, by ops/conv1d.py::pack_conv1d_weight, as
//     the stream a tile reads: per (chunk, tap) the (NT, 16) block W_j^T[co,
//     ci] K-major in core-matrix order, a hi and a lo TF32 plane. Producer
//     warp 0 fetches each (chunk, tap) plane pair with one cp.async.bulk
//     completing on an mbarrier into a ring of up to 128 KB.
//   * The taps of a chunk are cut into as few groups of at most TAPS_MAX
//     as they need, near equal (k 9: 5 + 4; k 5: one of 5), each one fresh
//     tensor-core sum (two k-steps of hi*lo, lo*hi and hi*hi a tap; lo*lo,
//     ~2^-22 relative, is dropped). (One sum a tap, waiting for the tensor
//     cores 9 times a chunk, ran 7-10% slower at k 9 and 8% at k 5; sums
//     of 3 taps 2% faster than 5 + 4 at k 9 and 8% slower at k 5. Against
//     float64 the error of 5-tap sums read 2.8-3.1e-6 of max at the
//     PostNet's tanh outputs, 1-tap sums 2.1-2.5e-6, cuDNN's fp32 1.0e-5.)
//     Both lo planes are rounded to TF32, not left for the tensor cores to
//     truncate. The consumers add each fresh sum to their fp32 accumulators
//     on the CUDA cores: K here is up to 1024 x 1 or 512 x 5 deep, and the
//     tensor cores' own accumulation truncates (csrc/mrf.cu measured what
//     that costs). Two consumer warpgroups take turns, so one's wait and
//     additions hide behind the other's products.
//   * The epilogue adds the bias, applies the BatchNorm and the activation
//     in the order above, and stores each row of a real frame.
// One CTA per SM walks the (frame tile, channel tile) items in a strided
// loop, the channel tile fastest, so that the CTAs in flight share their
// input windows in L2. The weight stream is read from L2 once per tile: 16
// KB per 128 x 128 x 16 multiply-adds, ~5 TB/s at the bound, which with the
// B operand's shared-memory reads keeps this design below the tensor cores'
// rate: over a call's 25 convs it reaches 67% of it (76% at a decoder FFN's
// first conv, 38% at its second; PERF.md's kernel table).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace {

constexpr int CONSUMERS = 256;              // two warpgroups
constexpr int THREADS = CONSUMERS + 128;    // + the producer warpgroup
constexpr int SPLITTERS = 64;               // producer warps 2-3 split windows
constexpr int BOXH = 16;                    // rows of a window's TMA box
constexpr int M = 128;                      // rows a tile, 64 a consumer warpgroup
constexpr int KC = 16;                      // input channels a chunk
constexpr int G = KC / 4;                   // 16-byte groups a window row
constexpr int STAGES_MAX = 8;               // weight ring slots, at most
constexpr int XSLOTS_MAX = 6;               // window ring slots, at most
constexpr int XSLOTS_MIN = 3;               // one copied, one split, one multiplied
constexpr int TAPS_MAX = 5;                 // taps a fresh tensor-core sum, at most
constexpr int KMAX = 31;                    // largest kernel size
constexpr int SMEM_MAX = 232448;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_TANH = 2 };

template <int NT>
struct Tile {
  static constexpr int PLANE = NT * KC * 4;   // bytes of one TF32 plane
  static constexpr int WSTAGE = 2 * PLANE;    // hi, then lo
  static constexpr int ACC = NT / 2;          // accumulators a thread
  static constexpr uint32_t B_LBO = NT * 16;  // bytes between K groups of the B operand
};

struct Args {
  const float* x;         // (batch, T, cin)
  float* y;               // (batch, T, cout)
  const float* w;         // (cout / NT, cin / KC, k, 2, NT * KC): pack_conv1d_weight
  const float* bias;      // (cout)
  const float* bn_w;      // (cout) each, or all null: no BatchNorm
  const float* bn_b;
  const float* bn_mean;
  const float* bn_var;
  float eps;
  int batch, T, cin, cout, k, act;
  int whole;              // one TMA box a window (items of >= M frames, a tile in one)
  int stride;             // rows an item takes in the row space: S
  int P;                  // window rows before a tile's first
  int W;                  // window rows: M + 2 P
  int taps;               // taps a fresh tensor-core sum
  int stages;             // weight ring slots
  int xslots;             // window ring slots
};

// ---- TMA boxes, wgmma at N 80 (the rest: hopper_ptx.cuh) ------------------

// TMA: the box of a 3-D / 4-D `map` at the given coordinates to shared
// address `dst`, counted on `bar`; coordinates outside the tensor read as
// zeros
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int x, int y, int z,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int x, int y, int z,
                                        int w, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(w), "r"(bar)
      : "memory");
}

// wgmma m64n80k8 tf32, A and B from shared memory (both K-major), fp32
// accumulators d[40]: d = A B^T + (scale_d ? d : 0); hopper_ptx.cuh has the
// other N.
template <>
struct Wgmma<80> {
  static __device__ __forceinline__ void tf32(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
                 "%36, %37, %38, %39"
                 "}, %40, %41, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
                   "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
                   "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
                 : "l"(da), "l"(db), "r"(scale_d));
  }
};
// One k-step of 8 channels of a fresh sum in 3xTF32: each operand's lo plane
// lies `a_lo` / `b_lo` bytes past its hi plane.
template <int N>
__device__ __forceinline__ void mma3(float* d, uint32_t a, uint32_t a_lbo, uint32_t a_lo,
                                     uint32_t b, uint32_t b_lbo, uint32_t b_lo, int scale_d) {
  Wgmma<N>::tf32(d, desc_of(a, a_lbo), desc_of(b + b_lo, b_lbo), scale_d);  // hi * lo
  Wgmma<N>::tf32(d, desc_of(a + a_lo, a_lbo), desc_of(b, b_lbo), 1);        // lo * hi
  Wgmma<N>::tf32(d, desc_of(a, a_lbo), desc_of(b, b_lbo), 1);               // hi * hi
}

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

// ---- the window -------------------------------------------------------------

// One chunk's window: rows [v_lo, v_lo + W) of the row space x channels
// [c0, c0 + 16) into the slot's hi plane. Whole: one box (channel in group,
// frames t0 - P.., group, item) of the tile's item. Else one box per (16-row
// block, 4-channel group): v_lo and S are multiples of 16, so a block is
// rows [t, t + 16) of one item n (n -1 before the batch). Rows past T, and
// item -1, read as zeros.
__device__ __forceinline__ void stage_window(const Args& a, const CUtensorMap* map, uint32_t slot,
                                             int v_lo, int c0, uint32_t bar) {
  if (a.whole) {
    const int v0 = v_lo + a.P, n = v0 / a.stride;
    tma_box(slot, map, 0, v0 - n * a.stride - a.P, c0 / 4, n, bar);
    return;
  }
  for (int b = 0; b < a.W / BOXH; ++b) {
    const int v = v_lo + b * BOXH;
    const int n = v >= 0 ? v / a.stride : -1;
    const int t = v - n * a.stride;
#pragma unroll
    for (int g = 0; g < G; ++g)
      tma_box(slot + (uint32_t)(g * a.W + b * BOXH) * 16, map, c0 + 4 * g, t, n, bar);
  }
}

// A landed window split in place by splitter `id`: hi = tf32(v) stays, lo =
// tf32(v - hi) goes `lo` bytes on. Thread id takes group id % 4 of every
// 16th row from id / 4, four rows' loads in flight at a time.
__device__ __forceinline__ void stage_split(const Args& a, uint8_t* slot, int lo, int id) {
  constexpr int STEP = SPLITTERS / G, UNROLL = 4;
  uint8_t* col = slot + (size_t)(id % G) * a.W * 16;
  for (int u0 = id / G; u0 < a.W; u0 += UNROLL * STEP) {
    float4 v[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i)
      if (u0 + i * STEP < a.W) v[i] = *reinterpret_cast<const float4*>(col + (u0 + i * STEP) * 16);
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      if (u0 + i * STEP >= a.W) break;
      uint8_t* p = col + (u0 + i * STEP) * 16;
      const float f[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
      uint32_t hi[4], lw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi[j]) : "f"(f[j]));
        asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lw[j]) : "f"(f[j] - __uint_as_float(hi[j])));
      }
      *reinterpret_cast<uint4*>(p) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(p + lo) = make_uint4(lw[0], lw[1], lw[2], lw[3]);
    }
  }
}

// The epilogue of one column: bias, then the BatchNorm (if any), in the order
// of ops/conv1d.py::conv1d_tc_reference.
struct Column {
  float bias, mean, invstd, gamma, beta;
};

__device__ __forceinline__ Column column(const Args& a, int co) {
  Column c{__ldg(a.bias + co), 0.f, 1.f, 1.f, 0.f};
  if (a.bn_w != nullptr) {
    c.mean = __ldg(a.bn_mean + co);
    c.invstd = 1.f / sqrtf(__ldg(a.bn_var + co) + a.eps);
    c.gamma = __ldg(a.bn_w + co);
    c.beta = __ldg(a.bn_b + co);
  }
  return c;
}

__device__ __forceinline__ float epilogue(const Args& a, const Column& c, float v) {
  v += c.bias;
  if (a.bn_w != nullptr) v = (v - c.mean) * c.invstd * c.gamma + c.beta;
  if (a.act == ACT_RELU) return v < 0.f ? 0.f : v;
  if (a.act == ACT_TANH) return tanhf(v);
  return v;
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
    conv1d_tc_kernel(const __grid_constant__ CUtensorMap xmap, const Args a) {
  using TL = Tile<NT>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int slot_bytes = 2 * G * a.W * 16;
  const int lo_off = G * a.W * 16;
  uint8_t* windows = smem + a.stages * TL::WSTAGE;
  const uint32_t bars = smem_addr(windows + a.xslots * slot_bytes);
  const uint32_t wfull = bars, wempty = bars + 8 * STAGES_MAX;
  const uint32_t xlanded = bars + 16 * STAGES_MAX, xfull = xlanded + 8 * XSLOTS_MAX;
  const uint32_t xempty = xfull + 8 * XSLOTS_MAX;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, CONSUMERS / 32);
    }
    for (int s = 0; s < a.xslots; ++s) {
      mbar_init(xlanded + 8 * s, 1);
      mbar_init(xfull + 8 * s, SPLITTERS);
      mbar_init(xempty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nct = a.cout / NT;
  const int tiles = (a.batch * a.stride + M - 1) / M;
  const int items = tiles * nct;
  const int chunks = a.cin / KC;
  const int pad = (a.k - 1) / 2;

  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n" ::: "memory");
    const int ptid = threadIdx.x - CONSUMERS;
    if (ptid < 32) {
      // warp 0: one thread streams every weight stage, in the consumers' order
      if (ptid == 0) {
        Ring ring{wfull, wempty, a.stages, 0, 0};
        const uint32_t base = smem_addr(smem);
        const int stages = chunks * a.k;
        for (int i = blockIdx.x; i < items; i += gridDim.x) {
          const uint8_t* src = reinterpret_cast<const uint8_t*>(a.w) +
                               (size_t)(i % nct) * stages * TL::WSTAGE;
          for (int s = 0; s < stages; ++s) {
            ring.wait_empty();
            mbar_expect_tx(wfull + 8 * ring.slot, TL::WSTAGE);
            bulk_load(base + ring.slot * TL::WSTAGE, src + (size_t)s * TL::WSTAGE, TL::WSTAGE,
                      wfull + 8 * ring.slot);
            ring.advance();
          }
        }
      }
    } else if (ptid < 64) {
      // warp 1: one thread fetches each chunk's window into a free slot,
      // landing on the slot's `landed` barrier
      if (ptid == 32) {
        Ring ring{xlanded, xempty, a.xslots, 0, 0};
        const uint32_t xbase = smem_addr(windows);
        for (int i = blockIdx.x; i < items; i += gridDim.x) {
          const int v_lo = (i / nct) * M - a.P;
          for (int c = 0; c < chunks; ++c) {
            ring.wait_empty();
            mbar_expect_tx(xlanded + 8 * ring.slot, G * a.W * 16);
            stage_window(a, &xmap, xbase + ring.slot * slot_bytes, v_lo, c * KC,
                         xlanded + 8 * ring.slot);
            ring.advance();
          }
        }
      }
    } else {
      // warps 2-3: split each landed window, then hand it to the consumers
      const int id = ptid - 64;
      Ring ring{xlanded, xfull, a.xslots, 0, 0};
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(xlanded + 8 * ring.slot, ring.phase);
          stage_split(a, windows + ring.slot * slot_bytes, lo_off, id);
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
  Ring xring{xfull, xempty, a.xslots, 0, 0};
  const uint32_t wbase = smem_addr(smem), xbase = smem_addr(windows);
  const uint32_t a_lbo = a.W * 16;

  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int nc = i % nct, v0 = (i / nct) * M;
    float acc[TL::ACC];
#pragma unroll
    for (int e = 0; e < TL::ACC; ++e) acc[e] = 0.f;

    for (int c = 0; c < chunks; ++c) {
      xring.acquire();
      const uint32_t xw = xbase + xring.slot * slot_bytes + (uint32_t)(a.P - pad + 64 * wg) * 16;
      // the chunk's taps in groups of `taps`: one fresh tensor-core sum each
#pragma unroll 1
      for (int j0 = 0; j0 < a.k; j0 += a.taps) {
        const int jn = a.k - j0 < a.taps ? a.k - j0 : a.taps;
        float t[TL::ACC];
        reg_fence(t);
        wg_fence();
#pragma unroll 1
        for (int j = j0; j < j0 + jn; ++j) {
          wring.acquire();
          const uint32_t wb = wbase + wring.slot * TL::WSTAGE;
          wring.advance();
          const uint32_t xa = xw + (uint32_t)j * 16;
          mma3<NT>(t, xa, a_lbo, lo_off, wb, TL::B_LBO, TL::PLANE, j > j0);
          mma3<NT>(t, xa + 2 * a_lbo, a_lbo, lo_off, wb + 2 * TL::B_LBO, TL::B_LBO, TL::PLANE, 1);
        }
        wg_commit();
        wg_wait<0>();
        reg_fence(t);
        for (int j = 0; j < jn; ++j) wfree.release();
#pragma unroll
        for (int e = 0; e < TL::ACC; ++e) acc[e] += t[e];
      }
      xring.release();
    }

    // epilogue: rows are the row space's, columns output channels; the
    // columns' parameters are loaded two 8-column groups at a time, before
    // the stores that might alias them
    float* out[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = v0 + 64 * wg + r + 8 * h;
      const int n = v / a.stride, t = v - n * a.stride;
      out[h] = n < a.batch && t < a.T ? a.y + ((size_t)n * a.T + t) * a.cout + nc * NT + 2 * q
                                      : nullptr;
    }
#pragma unroll
    for (int jn0 = 0; jn0 < NT / 8; jn0 += 2) {
      Column col[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) col[jj][e] = column(a, nc * NT + 8 * (jn0 + jj) + 2 * q + e);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (out[h] == nullptr) continue;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int jn = jn0 + jj;
          *reinterpret_cast<float2*>(out[h] + 8 * jn) =
              make_float2(epilogue(a, col[jj][0], acc[4 * jn + 2 * h]),
                          epilogue(a, col[jj][1], acc[4 * jn + 2 * h + 1]));
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  return encode;
}

// x (batch, T, cin) fp32 as a tensor read in boxes without swizzle,
// coordinates outside it reading as zeros. Whole: 4-D (4 channels of a
// group, frames, cin / 4 groups 16 bytes apart, items) in boxes of 4 x W
// frames x G groups x 1, the slot's [group][row][4] layout. Else 3-D
// (channels, frames, items) in boxes of 4 channels (16 bytes) x BOXH frames.
bool tensor_map(CUtensorMap* map, const Args& a) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t cin = a.cin, T = a.T, batch = a.batch;
  const cuuint64_t dims4[4] = {4, T, cin / 4, batch}, dims3[3] = {cin, T, batch};
  const cuuint64_t strides4[3] = {cin * 4, 16, cin * T * 4}, strides3[2] = {cin * 4, cin * T * 4};
  const cuuint32_t box4[4] = {4, (cuuint32_t)a.W, G, 1}, box3[3] = {4, BOXH, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.whole ? 4 : 3, const_cast<float*>(a.x),
                a.whole ? dims4 : dims3, a.whole ? strides4 : strides3, a.whole ? box4 : box3,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NT>
cudaError_t launch(Args a, cudaStream_t stream) {
  using TL = Tile<NT>;
  int device = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int pad = (a.k - 1) / 2;
  if (a.k == 1) {       // no padding: the batch's frames are one item
    a.T *= a.batch;
    a.batch = 1;
  }
  a.whole = a.T >= M;
  a.stride = a.whole ? (a.T + M - 1) / M * M : (a.T + pad + BOXH - 1) / BOXH * BOXH;
  a.P = a.whole ? pad : (pad + BOXH - 1) / BOXH * BOXH;
  a.W = M + 2 * a.P;
  CUtensorMap xmap;
  if (!tensor_map(&xmap, a)) return cudaErrorInvalidValue;
  // the weight ring takes up to STAGES_MAX slots, the windows as many slots
  // as the rest of shared memory holds, at most XSLOTS_MAX and at least
  // XSLOTS_MIN
  const size_t slot_bytes = 2 * (size_t)G * a.W * 16;
  const size_t bars = 8 * (2 * STAGES_MAX + 3 * XSLOTS_MAX);
  a.stages = STAGES_MAX;
  const int groups = (a.k + TAPS_MAX - 1) / TAPS_MAX;
  a.taps = (a.k + groups - 1) / groups;       // a group's stages fit the ring
  long room = ((long)SMEM_MAX - (long)(a.stages * TL::WSTAGE + bars)) / (long)slot_bytes;
  a.xslots = (int)(room < XSLOTS_MAX ? room : XSLOTS_MAX);
  if (a.xslots < XSLOTS_MIN) return cudaErrorInvalidValue;
  const size_t smem = a.stages * TL::WSTAGE + a.xslots * slot_bytes + bars;
  const long tiles = ((long)a.batch * a.stride + M - 1) / M;
  const long items = tiles * (a.cout / NT);
  if (items > (1L << 30)) return cudaErrorInvalidValue;
  const int grid = items < sms ? (int)items : sms;
  auto kernel = conv1d_tc_kernel<NT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(xmap, a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. x (batch, T, cin) and y (batch, T, cout)
// fp32, 16-byte aligned; `w` the weight's stream from
// ops/conv1d.py::pack_conv1d_weight; bias (cout) fp32; bn_w, bn_b, bn_mean,
// bn_var (cout) fp32, all four or none (null); act 0 none, 1 ReLU, 2 tanh.
// cin a multiple of 16; cout a multiple of 128, or 80; k odd, 1 to 31.
// Returns a cudaError_t (0 = launched).
extern "C" int conv1d_tc_fwd(const void* x, void* y, const void* w, const void* bias,
                             const void* bn_w, const void* bn_b, const void* bn_mean,
                             const void* bn_var, float eps, int batch, int T, int cin, int cout,
                             int k, int act, void* stream) {
  Args a{};
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.bn_w = static_cast<const float*>(bn_w);
  a.bn_b = static_cast<const float*>(bn_b);
  a.bn_mean = static_cast<const float*>(bn_mean);
  a.bn_var = static_cast<const float*>(bn_var);
  a.eps = eps;
  a.batch = batch;
  a.T = T;
  a.cin = cin;
  a.cout = cout;
  a.k = k;
  a.act = act;
  const bool bn = bn_w != nullptr;
  if (batch <= 0 || T <= 0 || cin <= 0 || cin % KC != 0 || k < 1 || k > KMAX || k % 2 == 0 ||
      act < ACT_NONE || act > ACT_TANH || bias == nullptr ||
      (bn_b != nullptr) != bn || (bn_mean != nullptr) != bn || (bn_var != nullptr) != bn)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cout > 0 && cout % 128 == 0) return (int)launch<128>(a, st);
  if (cout == 80) return (int)launch<80>(a, st);
  return (int)cudaErrorInvalidValue;
}
