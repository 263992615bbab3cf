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
// far past a block's 227 KB of shared memory, so here:
//   * one block of 256 threads per (item, tile of 32 frames), any T (the
//     ragged last tile is masked); the conv reads its 3-frame halo (k = 7)
//     straight from device memory, zero outside the item;
//   * the conv and LayerNorm run one warp per frame, and the normalised
//     (32, C) tile stays in shared memory;
//   * M is walked in chunks of 128: a = GELU(h W1[:, m:m+128] + b1) goes to
//     shared memory, then o += a W2[m:m+128, :] accumulates in registers
//     (8 frames x C/64 columns per thread), so the (T, M) activation never
//     reaches device memory;
//   * the products run on the CUDA cores in fp32 FMA (no tensor cores, no
//     TMA): the register tiles reuse each weight load for 8 frames and each
//     shared-memory load of h or a for 2 (first product) or C/64 (second)
//     columns.
// What bounds it: per tile 4*32*C*M FLOPs (0.1 GFLOP at C 512, M 1536)
// against W1 and W2, which every tile re-reads from L2 (6.3 MB fp32 at full
// width; 3.2 GB per layer over the 512 tiles of B 16 x T 1000). So it is
// bound by the fp32 FMA rate and the L2 bandwidth of the weight stream; a
// wider frame tile (fewer weight passes) and wgmma on tensor cores are the
// later work.
//
// The trunk (all L blocks in one launch). The TPU trunk keeps the activation
// in VMEM and streams the weights; an item does not fit in shared memory
// here, so the trunk is a persistent cooperative kernel: grid = the blocks
// that fit on the card at once, each walks the (item, tile) work of layer l,
// then a grid-wide barrier, then layer l + 1. The activation ping-pongs
// between the output and a scratch tensor of the same shape (the wrapper
// allocates it; 32.8 MB at B 16 x T 1000 x C 512 fp32, inside the 50 MB L2),
// the last layer writing the output. Chosen over a tile with a 3*L-frame halo
// running all L layers on chip (24 halo frames per side at L = 8, so most of
// a 32-frame tile's work would be recomputed). Every tile runs the same code
// as the block kernel, so the trunk equals L block launches bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 32;       // frames per tile
constexpr int THREADS = 256;   // 8 warps
constexpr int MC = 128;        // intermediate features per chunk
constexpr int ROWS = 8;        // frames per thread in the products
constexpr int COLS = 64;       // column groups: thread = (TILE / ROWS) x COLS
// Two blocks per SM (launch bounds below): at most 128 registers a thread.
// At C = 512 that costs a few spilled bytes and, on the H100, measured 1.5x
// faster than one block per SM at 130 registers (PERF.md).
static_assert((TILE / ROWS) * COLS == THREADS, "thread layout");

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
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

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Launch arguments. Per-layer tensors are stacked on a leading layer axis:
// dw (L, K, C) and w1 (L, C, M), w2 (L, M, C) in the operand type; db, ls,
// lb, b2, gamma (L, C) and b1 (L, M) in fp32.
struct Params {
  const void* x;
  void* y;
  void* scratch;  // trunk only: (batch, seq, C) in the operand type
  const void* dw;
  const float* db;
  const float* ls;
  const float* lb;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  const float* gamma;
  int layers, batch, seq, M, K;
  float eps;
};

template <typename T>
struct Layer {
  const T* dw;
  const float *db, *ls, *lb;
  const T* w1;
  const float* b1;
  const T* w2;
  const float *b2, *gamma;
};

template <typename T, int C>
__device__ __forceinline__ Layer<T> layer_at(const Params& p, int l) {
  const size_t cm = (size_t)C * p.M;
  return Layer<T>{static_cast<const T*>(p.dw) + (size_t)l * p.K * C,
                  p.db + (size_t)l * C, p.ls + (size_t)l * C, p.lb + (size_t)l * C,
                  static_cast<const T*>(p.w1) + l * cm, p.b1 + (size_t)l * p.M,
                  static_cast<const T*>(p.w2) + l * cm, p.b2 + (size_t)l * C,
                  p.gamma + (size_t)l * C};
}

template <int C>
constexpr size_t smem_bytes() {
  return (size_t)TILE * ((C + 4) + (MC + 4)) * sizeof(float);
}

// One block, frames [t0, t0 + TILE) of item b: y = block(x). The activations
// x and y are read and written with plain (coherent) accesses: in the trunk
// they were written earlier in the same launch by other blocks.
template <typename T, int C, bool TANH>
__device__ void block_tile(const T* x, T* y, const Layer<T>& w, int b, int t0,
                           int seq, int M, int K, float eps, float* smem) {
  constexpr int LDH = C + 4;   // row strides keep float4 alignment
  constexpr int LDA = MC + 4;
  constexpr int NC = C / 32;   // channels per lane in the conv / LayerNorm
  constexpr int NJ = C / COLS; // output columns per thread
  float* hs = smem;                // (TILE, LDH): normalised h
  float* as = smem + TILE * LDH;   // (TILE, LDA): GELU activation chunk
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t item = (size_t)b * seq * C;
  const int half = (K - 1) / 2;

  // 1. depthwise conv + LayerNorm, one warp per frame
  for (int r = tid >> 5; r < TILE; r += THREADS / 32) {
    const int t = t0 + r;
    if (t >= seq) {  // ragged tail: zeros, never stored
#pragma unroll
      for (int i = 0; i < NC; ++i) hs[r * LDH + lane + 32 * i] = 0.f;
      continue;
    }
    float h[NC];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      float acc = 0.f;
      for (int k = 0; k < K; ++k) {
        const int tt = t + k - half;
        if (tt >= 0 && tt < seq)
          acc = fmaf(load_f(x, item + (size_t)tt * C + c), ldg_f(w.dw, (size_t)k * C + c), acc);
      }
      h[i] = acc + __ldg(w.db + c);
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
      hs[r * LDH + c] = round_to(fmaf(n, __ldg(w.ls + c), __ldg(w.lb + c)), x);
    }
  }
  __syncthreads();

  const int rg = tid / COLS;  // frames rg*ROWS .. +ROWS-1 of the tile
  const int cg = tid % COLS;  // columns cg + COLS*j
  float o[ROWS][NJ];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[i][j] = 0.f;

  for (int m0 = 0; m0 < M; m0 += MC) {
    // 2a. a = GELU(h W1[:, m0:m0+MC] + b1): columns cg and cg + 64 of the chunk
    float a[ROWS][2];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) a[i][0] = a[i][1] = 0.f;
    const T* w1 = w.w1 + m0 + cg;
#pragma unroll 2
    for (int k = 0; k < C; k += 4) {
      float4 hv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        hv[i] = *reinterpret_cast<const float4*>(hs + (rg * ROWS + i) * LDH + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float w0 = ldg_f(w1, (size_t)(k + kk) * M);
        const float w64 = ldg_f(w1, (size_t)(k + kk) * M + COLS);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float hk = lane_of(hv[i], kk);
          a[i][0] = fmaf(hk, w0, a[i][0]);
          a[i][1] = fmaf(hk, w64, a[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = cg + COLS * j;
        as[(rg * ROWS + i) * LDA + m] =
            round_to(gelu<TANH>(a[i][j] + __ldg(w.b1 + m0 + m)), x);
      }
    __syncthreads();

    // 2b. o += a W2[m0:m0+MC, :]
    const T* w2 = w.w2 + (size_t)m0 * C + cg;
#pragma unroll 2
    for (int k = 0; k < MC; k += 4) {
      float4 av[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (rg * ROWS + i) * LDA + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float wv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) wv[j] = ldg_f(w2, (size_t)(k + kk) * C + COLS * j);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float ak = lane_of(av[i], kk);
#pragma unroll
          for (int j = 0; j < NJ; ++j) o[i][j] = fmaf(ak, wv[j], o[i][j]);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites `as`
  }

  // 3. y = x + gamma * (o + b2)
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int t = t0 + rg * ROWS + i;
    if (t >= seq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = cg + COLS * j;
      const size_t idx = item + (size_t)t * C + c;
      store_f(y, idx, load_f(x, idx) + __ldg(w.gamma + c) * (o[i][j] + __ldg(w.b2 + c)));
    }
  }
}

template <typename T, int C, bool TANH>
__global__ void __launch_bounds__(THREADS, 2) block_kernel(Params p) {
  extern __shared__ float4 smem4[];
  block_tile<T, C, TANH>(static_cast<const T*>(p.x), static_cast<T*>(p.y), layer_at<T, C>(p, 0),
                         blockIdx.y, blockIdx.x * TILE, p.seq, p.M, p.K, p.eps,
                         reinterpret_cast<float*>(smem4));
}

template <typename T, int C, bool TANH>
__global__ void __launch_bounds__(THREADS, 2) trunk_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int tiles_t = (p.seq + TILE - 1) / TILE;
  const int n_tiles = tiles_t * p.batch;
  const T* src = static_cast<const T*>(p.x);
  for (int l = 0; l < p.layers; ++l) {
    // ping-pong so that the last layer writes the output
    T* dst = static_cast<T*>((p.layers - 1 - l) % 2 == 0 ? p.y : p.scratch);
    const Layer<T> w = layer_at<T, C>(p, l);
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
      block_tile<T, C, TANH>(src, dst, w, tile / tiles_t, (tile % tiles_t) * TILE, p.seq, p.M,
                             p.K, p.eps, smem);
    grid.sync();  // layer l is complete and visible before layer l + 1 reads it
    src = dst;
  }
}

template <typename T, int C, bool TANH>
cudaError_t launch_block(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C>();
  // above 48 KB of dynamic shared memory needs an opt-in
  cudaError_t err = cudaFuncSetAttribute(
      block_kernel<T, C, TANH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.seq + TILE - 1) / TILE, p.batch);
  block_kernel<T, C, TANH><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int C, bool TANH>
cudaError_t launch_trunk(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C>();
  auto kernel = trunk_kernel<T, C, TANH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int n_tiles = (p.seq + TILE - 1) / TILE * p.batch;
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
    case 128: return trunk ? launch_trunk<T, 128, TANH>(p, s) : launch_block<T, 128, TANH>(p, s);
    case 256: return trunk ? launch_trunk<T, 256, TANH>(p, s) : launch_block<T, 256, TANH>(p, s);
    case 512: return trunk ? launch_trunk<T, 512, TANH>(p, s) : launch_block<T, 512, TANH>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(bool trunk, const Params& p, int C, int dtype, int gelu_tanh, void* stream) {
  if (p.batch <= 0 || p.seq <= 0 || p.layers <= 0 || p.M <= 0 || p.M % MC || p.K <= 0 ||
      p.K % 2 == 0)
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
// dw, w1, w2 and the trunk's scratch); the vectors are float32. gelu_tanh:
// 1 = tanh GELU, 0 = erf GELU. C in {128, 256, 512}, M a multiple of 128,
// odd K. Returns a cudaError_t (0 = launched).
extern "C" int convnext_block_fwd(const void* x, void* y, const void* dw, const void* db,
                                  const void* ls, const void* lb, const void* w1, const void* b1,
                                  const void* w2, const void* b2, const void* gamma, int batch,
                                  int seq, int C, int M, int K, int dtype, int gelu_tanh,
                                  float eps, void* stream) {
  const Params p{x, y, nullptr, dw,
                 static_cast<const float*>(db), static_cast<const float*>(ls),
                 static_cast<const float*>(lb), w1, static_cast<const float*>(b1), w2,
                 static_cast<const float*>(b2), static_cast<const float*>(gamma),
                 1, batch, seq, M, K, eps};
  return dispatch(false, p, C, dtype, gelu_tanh, stream);
}

extern "C" int convnext_trunk_fwd(const void* x, void* y, void* scratch, const void* dw,
                                  const void* db, const void* ls, const void* lb, const void* w1,
                                  const void* b1, const void* w2, const void* b2,
                                  const void* gamma, int layers, int batch, int seq, int C, int M,
                                  int K, int dtype, int gelu_tanh, float eps, void* stream) {
  const Params p{x, y, scratch, dw,
                 static_cast<const float*>(db), static_cast<const float*>(ls),
                 static_cast<const float*>(lb), w1, static_cast<const float*>(b1), w2,
                 static_cast<const float*>(b2), static_cast<const float*>(gamma),
                 layers, batch, seq, M, K, eps};
  return dispatch(true, p, C, dtype, gelu_tanh, stream);
}
