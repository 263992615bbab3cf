// One HiFi-GAN multi-receptive-field (MRF) stage in one launch (Hopper).
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
// What bounds it. Per output position a stage does 6 * (3 + 7 + 11) * C^2 =
// 126 C^2 multiply-adds; the bytes are x, the output and 126 C^2 weights. At
// the served shapes (C 32-512, B 16, T 1000-256000) that is ~250-2500 FLOP
// per byte, so the stage is bound by arithmetic, on the CUDA cores in IEEE
// fp32 here (67 TFLOP/s on an H100 SXM; TF32 is off for parity).
//
// Design. The TPU kernel keeps a (C, t_tile + 2 * 128) block and all 18
// convs of a stage in VMEM. Here a stage's intermediates at C = 256-512 do
// not fit a block's 227 KB of shared memory, and recomputing a 60-frame halo
// per conv would waste most of a tile at small T. So the stage is one
// persistent cooperative kernel that walks the 18 convs in 6 phases with a
// grid barrier after each, the three branches' convs of one phase running
// side by side:
//   * scratch (the wrapper allocates it: 6 x (B, C, T) fp32) holds each
//     branch's residual stream y_b and its conv1 output h_b, so every conv
//     reads its input once from device memory (or L2) with its own halo;
//   * phase 0 copies x into y_0, y_1, y_2; phases 1-6 are the convs (conv1
//     writes h_b = lrelu(conv + bias), conv2 adds into y_b in place, each
//     element by the one thread that read it); the last phase averages;
//   * a conv is an implicit GEMM: out[co, t] = sum_{j, ci} A[co, j*C + ci] *
//     in[ci, t + (j - (k-1)/2) * d]. A block computes a tile of 64 output
//     channels (32 at C = 32) x 128 frames; per chunk of 16 input channels it
//     stages the weights of all k taps and ONE input window of 128 + 2 * pad
//     frames in shared memory (each tap is a shifted view of the window), and
//     each of its 256 threads accumulates 4 (or 2) channels x 8 frames in
//     registers with fp32 FMA on the CUDA cores (no tensor cores, no TMA);
//   * the work items of a phase (branch, item, channel tile, frame tile) are
//     spread over the resident blocks in a strided loop, branch-major so that
//     every block gets a share of the heavy k = 11 tiles.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;   // 16 (frames) x 16 (channels)
constexpr int TT = 128;        // frames per tile
constexpr int TN = TT / 16;    // frames per thread
constexpr int KC = 16;         // input channels per shared-memory chunk
constexpr int KMAX = 11;       // largest kernel size
constexpr int NBR = 3;         // branches
constexpr int NDIL = 3;        // dilations per branch
constexpr int NCONV = 2 * NDIL;
constexpr float SLOPE = 0.1f;

struct Params {
  const void* x;
  void* y;
  float* scratch;          // (NBR, 2, B, C, T): y_b, h_b
  const void* w[NBR];      // (NCONV, C, k_b * C) in the operand type
  const float* bias;       // (NBR * NCONV, C)
  int batch, C, T;
  int k[NBR];
  int d[NBR][NDIL];
};

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float ldg_f(const float* p, size_t i) { return __ldg(p + i); }
__device__ __forceinline__ float ldg_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(__ldg(p + i));
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}
// round to the operand type (the TPU kernel's astype(dtype) before a product)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : SLOPE * v; }

// One conv tile: output channels [co0, co0 + CO_T) x frames [t0, t0 + TT) of
// item n. `in` is y_b (conv1: leaky ReLU on load) or h_b (conv2: stored
// activated); conv1 writes h_b = lrelu(acc + bias), conv2 adds acc + bias
// into y_b. `in` and `out` are written by other blocks of this launch, so
// they are read with plain (coherent) loads.
template <typename T, int CO_T>
__device__ void conv_tile(const float* in, float* out, bool first, const T* A, const float* bias,
                          int k, int d, int n, int co0, int t0, int C, int seq, int lda_rows,
                          float* smem) {
  constexpr int TM = CO_T / 16;    // output channels per thread
  constexpr int LDA = CO_T + 4;    // keeps float4 alignment, spreads banks
  const int pad = (k - 1) / 2 * d;
  const int W = TT + 2 * pad;      // input window of the tile
  float* As = smem;                        // (KMAX, KC, LDA): weights of every tap
  float* Bs = smem + lda_rows * LDA;       // (KC, W): the input window
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t kc_row = (size_t)k * C;     // stride of an output channel in A
  const float* item = in + (size_t)n * C * seq;

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[m][q] = 0.f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    for (int e = tid; e < CO_T * k * KC; e += THREADS) {
      const int cl = e % KC, j = (e / KC) % k, col = e / (KC * k);
      As[(j * KC + cl) * LDA + col] = ldg_f(A, (size_t)(co0 + col) * kc_row + (size_t)j * C + c0 + cl);
    }
    for (int e = tid; e < KC * W; e += THREADS) {
      const int cl = e / W, u = e % W, t = t0 - pad + u;
      float v = 0.f;
      if (t >= 0 && t < seq) {
        v = item[(size_t)(c0 + cl) * seq + t];
        if (first) v = lrelu(v);
        v = round_to(v, A);
      }
      Bs[e] = v;
    }
    __syncthreads();
    for (int cl = 0; cl < KC; ++cl) {
      const float* brow = Bs + cl * W + tx;
      for (int j = 0; j < k; ++j) {
        const float* ap = As + (j * KC + cl) * LDA + ty * TM;
        float a[TM], b[TN];
        if constexpr (TM == 4) {
          const float4 v = *reinterpret_cast<const float4*>(ap);
          a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
        } else {
#pragma unroll
          for (int m = 0; m < TM; ++m) a[m] = ap[m];
        }
#pragma unroll
        for (int q = 0; q < TN; ++q) b[q] = brow[j * d + 16 * q];
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int q = 0; q < TN; ++q) acc[m][q] = fmaf(a[m], b[q], acc[m][q]);
      }
    }
    __syncthreads();   // the next chunk overwrites As and Bs
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int co = co0 + ty * TM + m;
    const float bv = __ldg(bias + co);
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int t = t0 + tx + 16 * q;
      if (t >= seq) continue;
      const size_t idx = ((size_t)n * C + co) * seq + t;
      const float v = acc[m][q] + bv;
      if (first)
        out[idx] = lrelu(v);
      else
        out[idx] = out[idx] + v;
    }
  }
}

template <typename T, int CO_T>
__global__ void __launch_bounds__(THREADS) mrf_kernel(Params p, int lda_rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const size_t plane = (size_t)p.batch * p.C * p.T;
  const size_t stride = (size_t)gridDim.x * THREADS;
  const size_t first_i = (size_t)blockIdx.x * THREADS + threadIdx.x;

  // phase 0: every branch's residual stream starts as x (rounded to the operand type)
  const T* x = static_cast<const T*>(p.x);
  for (size_t i = first_i; i < plane; i += stride) {
    const float v = load_f(x, i);
#pragma unroll
    for (int b = 0; b < NBR; ++b) p.scratch[(size_t)(2 * b) * plane + i] = v;
  }
  grid.sync();

  const int co_tiles = p.C / CO_T;
  const int t_tiles = (p.T + TT - 1) / TT;
  const int per_branch = p.batch * co_tiles * t_tiles;
  for (int conv = 0; conv < NCONV; ++conv) {
    const int di = conv / 2;
    const bool first = conv % 2 == 0;
    for (int item = blockIdx.x; item < NBR * per_branch; item += gridDim.x) {
      const int b = item / per_branch;
      int r = item % per_branch;
      const int tt = r % t_tiles;
      r /= t_tiles;
      const int ct = r % co_tiles;
      const int n = r / co_tiles;
      const int k = p.k[b];
      float* yb = p.scratch + (size_t)(2 * b) * plane;
      float* hb = yb + plane;
      const T* A = static_cast<const T*>(p.w[b]) + (size_t)conv * p.C * k * p.C;
      const float* bias = p.bias + (size_t)(NCONV * b + conv) * p.C;
      conv_tile<T, CO_T>(first ? yb : hb, first ? hb : yb, first, A, bias, k,
                         first ? p.d[b][di] : 1, n, ct * CO_T, tt * TT, p.C, p.T, lda_rows, smem);
    }
    grid.sync();   // conv `conv` of every branch is complete and visible
  }

  // the average of the branches, in the plain version's order
  T* y = static_cast<T*>(p.y);
  for (size_t i = first_i; i < plane; i += stride) {
    float s = p.scratch[i] + p.scratch[2 * plane + i];
    s = s + p.scratch[4 * plane + i];
    store_f(y, i, s / 3.f);
  }
}

template <typename T, int CO_T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  int kmax = 1, pad = 0;
  for (int b = 0; b < NBR; ++b) {
    kmax = p.k[b] > kmax ? p.k[b] : kmax;
    for (int i = 0; i < NDIL; ++i) {
      const int pb = (p.k[b] - 1) / 2 * p.d[b][i];
      pad = pb > pad ? pb : pad;
    }
  }
  const int lda_rows = kmax * KC;
  const size_t smem = ((size_t)lda_rows * (CO_T + 4) + (size_t)KC * (TT + 2 * pad)) * sizeof(float);
  auto kernel = mrf_kernel<T, CO_T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long items = (long)NBR * p.batch * (p.C / CO_T) * ((p.T + TT - 1) / TT);
  const int grid = (long)per_sm * sms < items ? per_sm * sms : (int)items;
  Params args = p;
  int rows = lda_rows;
  void* kargs[] = {&args, &rows};
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid, THREADS, kargs, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_width(const Params& p, cudaStream_t s) {
  switch (p.C) {
    case 32: return launch<T, 32>(p, s);
    case 64: case 128: case 256: case 512: return launch<T, 64>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16 (x, y and
// the weights); scratch and biases are float32. C in {32, 64, 128, 256, 512},
// odd kernel sizes up to 11, dilations >= 1. Returns a cudaError_t (0 =
// launched).
extern "C" int mrf_stage_fwd(const void* x, void* y, void* scratch, const void* w0,
                             const void* w1, const void* w2, const void* bias, int batch, int C,
                             int T, int k0, int k1, int k2, int d00, int d01, int d02, int d10,
                             int d11, int d12, int d20, int d21, int d22, int dtype,
                             void* stream) {
  Params p{x, y, static_cast<float*>(scratch), {w0, w1, w2}, static_cast<const float*>(bias),
           batch, C, T, {k0, k1, k2}, {{d00, d01, d02}, {d10, d11, d12}, {d20, d21, d22}}};
  if (batch <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  for (int b = 0; b < NBR; ++b) {
    if (p.k[b] < 1 || p.k[b] > KMAX || p.k[b] % 2 == 0) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < NDIL; ++i)
      if (p.d[b][i] < 1) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_width<float>(p, s);
  if (dtype == 1) return (int)dispatch_width<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
