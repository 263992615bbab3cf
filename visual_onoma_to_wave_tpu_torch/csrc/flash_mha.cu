// Key-masked multi-head attention core for the acoustic FFT blocks (Hopper).
//
// Replaces the TPU kernel visual_onoma_to_wave_tpu/ops/pallas_attention.py::
// flash_mha (body _mha_kernel). Per batch item b and head h:
//
//     ctx = softmax(Q K^T / sqrt(dk) + keymask(-inf)) V
//
// with logits and softmax in fp32, fully-masked query rows exactly 0, and
// Q/K/V/ctx in the packed (B, T, H*dk) layout of the projection outputs
// (head h occupies features [h*dk, (h+1)*dk)), so no transposes are needed.
//
// Design. The TPU kernel keeps the whole (T, T) score tile in VMEM; at the
// serving decoder's T = 1000 that does not fit in a block's 227 KB of shared
// memory, so this kernel streams keys with an online softmax instead:
//   * one block of 128 threads per (item, head, 64-query tile);
//   * a loop over 64-key tiles: K and V staged in shared memory (fp32), the
//     64x64 score tile computed as 4x8 register micro-tiles per thread, the
//     running max / running sum / fp32 context accumulator rescaled per tile;
//   * any T: the ragged last query and key tiles are masked, no padding;
//   * dk templated for 64 and 128; fp32 or bf16 inputs, fp32 accumulation.
//     bf16 rounds at another point than the TPU kernel: that one normalises
//     the probabilities and then casts them to bf16 before the product with
//     V (pallas_attention.py:83); here the unnormalised exp(s - running max)
//     is cast to bf16 for the product, the running sum stays in fp32 from
//     the unrounded values, and the context is divided by it at the end.
//
// What bounds it. Per (item, head) the score tile costs 4*T*T*dk FLOPs
// (0.5 GFLOP at T = 1000, dk = 128) against 4*T*dk*4 bytes of unique Q/K/V/ctx
// traffic (2 MB): ~256 FLOP/byte, far above the card's fp32 ridge, and the
// (T, T) scores never touch device memory (the plain PyTorch version writes
// and re-reads them several times: B*H*T*T*4 bytes per pass). So the kernel
// is bound by arithmetic; this first version does it on the CUDA cores with
// shared-memory operands (no tensor cores, no TMA), which is the limit that
// later work (wgmma, TMA-fed pipelines) removes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;   // queries per block
constexpr int BLOCK_N = 64;   // keys per tile
constexpr int THREADS = 128;  // 16 row groups x 8 key/column groups
constexpr int ROWS = 4;       // query rows per thread: rg + 16*i
constexpr int KEYS = 8;       // keys per thread per tile: kg + 8*j

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16(x);
}
__device__ __forceinline__ float round_p(float x, const float*) { return x; }
__device__ __forceinline__ float round_p(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int DK>
constexpr int smem_floats() {
  // Q, K and V tiles with a padded row stride (DK + 1: conflict-free column
  // reads); the probability tile reuses the K buffer once scores are done.
  return 3 * BLOCK_M * (DK + 1);
}

template <typename T, int DK>
__global__ void __launch_bounds__(THREADS)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const uint8_t* __restrict__ mask,
               T* __restrict__ out, int seq, int n_head, float scale) {
  constexpr int LD = DK + 1;
  constexpr int LDP = BLOCK_N + 1;
  constexpr int COLS = DK / 8;  // context columns per thread: kg + 8*c
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BLOCK_M * LD;
  float* vs = ks + BLOCK_N * LD;
  float* ps = ks;  // reused after the score pass of each tile
  __shared__ int key_ok[BLOCK_N];

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // 0..15
  const int kg = tid & 7;   // 0..7
  const int q0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row_stride = (size_t)n_head * DK;
  const size_t base = (size_t)b * seq * row_stride + (size_t)h * DK;

  for (int e = tid; e < BLOCK_M * DK; e += THREADS) {
    const int r = e / DK, d = e % DK;
    const int t = q0 + r;
    qs[r * LD + d] = t < seq ? load_f(q, base + (size_t)t * row_stride + d) : 0.f;
  }

  float m_run[ROWS], l_run[ROWS], acc[ROWS][COLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += BLOCK_N) {
    __syncthreads();  // previous tile's P and V reads are done
    for (int e = tid; e < BLOCK_N * DK; e += THREADS) {
      const int r = e / DK, d = e % DK;
      const int t = k0 + r;
      const bool in = t < seq;
      ks[r * LD + d] = in ? load_f(k, base + (size_t)t * row_stride + d) : 0.f;
      vs[r * LD + d] = in ? load_f(v, base + (size_t)t * row_stride + d) : 0.f;
    }
    if (tid < BLOCK_N) {
      const int t = k0 + tid;
      key_ok[tid] = t < seq && (mask == nullptr || mask[(size_t)b * seq + t] == 0);
    }
    __syncthreads();

    float s[ROWS][KEYS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KEYS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DK; ++d) {
      float qv[ROWS], kv[KEYS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = qs[(rg + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < KEYS; ++j) kv[j] = ks[(kg + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < KEYS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        s[i][j] = key_ok[kg + 8 * j] ? s[i][j] * scale : -INFINITY;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      // the 8 threads sharing these rows are lanes differing in bits 0..2
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, o));
      const float m_new = fmaxf(m_run[i], tile_max);
      // m_new == -inf only while every key so far is masked; acc and l are
      // then 0, and the guards keep exp(-inf - -inf) = NaN out of them
      alpha[i] = m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        row_sum += p;
        s[i][j] = round_p(p, q);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, o);
      l_run[i] = l_run[i] * alpha[i] + row_sum;
      m_run[i] = m_new;
    }

    __syncthreads();  // every thread is done reading K: reuse it for P
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KEYS; ++j) ps[(rg + 16 * i) * LDP + kg + 8 * j] = s[i][j];
    __syncthreads();

#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[i][c] *= alpha[i];
    const int n_keys = min(BLOCK_N, seq - k0);
    for (int kk = 0; kk < n_keys; ++kk) {
      float pv[ROWS], vv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = ps[(rg + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < COLS; ++c) vv[c] = vs[kk * LD + kg + 8 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int t = q0 + rg + 16 * i;
    if (t >= seq) continue;
    // fully-masked row: l == 0 -> exactly 0 (the reference's nan_to_num)
    const float inv = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      store_f(out, base + (size_t)t * row_stride + kg + 8 * c, acc[i][c] * inv);
  }
}

template <typename T, int DK>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* out, int batch, int seq,
                   int n_head, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<DK>() * sizeof(float);
  // above 48 KB of dynamic shared memory needs an opt-in (set per device;
  // cheap enough to repeat on every launch)
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_kernel<T, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((seq + BLOCK_M - 1) / BLOCK_M, n_head, batch);
  mha_fwd_kernel<T, DK><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), seq, n_head, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16.
// mask: (batch, seq) uint8, nonzero = padding key; may be null (no mask).
// Returns a cudaError_t (0 = launched).
extern "C" int flash_mha_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* out, int batch, int seq,
                             int n_head, int dk, int dtype, float scale,
                             void* stream) {
  if (seq <= 0 || batch <= 0 || n_head <= 0) return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dk == 64)
    return (int)launch<float, 64>(q, k, v, m, out, batch, seq, n_head, scale, s);
  if (dtype == 0 && dk == 128)
    return (int)launch<float, 128>(q, k, v, m, out, batch, seq, n_head, scale, s);
  if (dtype == 1 && dk == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, m, out, batch, seq, n_head, scale, s);
  if (dtype == 1 && dk == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, m, out, batch, seq, n_head, scale, s);
  return (int)cudaErrorInvalidValue;
}
