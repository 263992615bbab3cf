// BigVGAN's anti-aliased snake-beta activation (one AMP activation site) in
// one pass on Hopper.
//
// Replaces no TPU kernel: the JAX package runs BigVGAN's activations through
// XLA (visual_onoma_to_wave_tpu/models/bigvgan.py: upsample2, snake_beta,
// downsample2). The port's plain version (models/bigvgan.py::SnakeAct) runs
// each site as six to eight PyTorch ops at twice the local rate: a replicate
// pad, a depthwise transposed conv, a crop, snake-beta's elementwise ops, a
// second pad and a depthwise conv, each a round trip of a (B, C, 2T) tensor
// through device memory. This kernel reads the operand once and writes the
// activated operand once.
//
// On one row x[0, T) of (B, C, T), with a = exp(log_alpha[c]),
// b = exp(log_beta[c]) and the two 12-tap filters of ops/amp.py (`up` the
// gain-2 interpolator, `down` the lowpass, both symmetric):
//
//     p = round(x + g + bias[c])            (g and bias optional; p = x without)
//     u[2s]     = sum_i up[2i + 1] p[s + 2 - i]      i = 0..5
//     u[2s + 1] = sum_i up[2i]     p[s + 3 - i]
//     v[n]      = u[n] + sin^2(a u[n]) / (b + 1e-9)
//     out[s]    = sum_j down[j] v[2s + j - 5]       j = 0..11
//
// with p's index clamped to [0, T) and v's to [0, 2T): the replicate pads of
// upsample2 and downsample2 (the transposed conv's polyphase form, cropped
// as upsample2 crops it). Everything between the operand and the output is
// fp32; the output is rounded once to the operand type. sin^2 has period
// pi: its argument is reduced by the nearest multiple of pi in two fp32
// parts before __sinf, which is accurate to ~2^-21 on [-pi/2, pi/2].
//
// The same pass optionally writes p itself (the residual stream after
// y + conv2 + bias: `y_out`) and the mean of three branches' streams,
// round((m0 + m1 + p) * (1/3)) (`mean_out`), so a stage of ops/mrf.py's AMP kind
// reads each residual plane once where it updates it and activates it.
//
// What bounds it. Per output sample: 2 bytes read and 2 written in bf16
// (more with g, y_out or the mean), and ~50 fp32 instructions (two 2x
// samples of 6 taps, two reduced sines, 12 taps down). At 3.35 TB/s a bf16
// plane of (64, 24, 256000) takes 0.23 ms each way; the instructions and
// the shared-memory traffic take about as long on 132 SMs, so the kernel is
// built to spend few of either: the operand window is loaded in 16-byte
// chunks (rows of T % 8 == 0 on 16-byte addresses; element by element
// otherwise), a thread computes four consecutive 2x pairs (v[2s], v[2s + 1])
// from 10 operand samples read as five float2, and four consecutive
// outputs from 10 pairs read as five float4, stored as one 8-byte vector.
//
// Layout: one CTA of 256 threads per (row, tile of 2032 output samples); the
// operand window is the tile plus 8 samples a side (6 needed): 2048, one
// 16-byte chunk a thread; the 2x window the tile's 4064 samples plus 6 a side
// (and 2 pairs of slack): two groups of four pairs a thread. 24.6 KB of
// static shared memory; 48 registers a thread hold 5 CTAs on an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int K = 12;                       // taps of each resampling FIR
constexpr int TILE = 2032;                  // output samples a CTA: the window 2048
constexpr int THREADS = 256;
constexpr int PH = 8;                       // operand halo a side, samples
constexpr float THIRD = 1.f / 3.f;          // the mean's scale (a product, as PyTorch divides)
constexpr int PW = TILE + 2 * PH;           // operand window
constexpr int VG = (TILE + 6 + 3) / 4;      // 2x pairs in fours: s in [t0 - 3, t0 + TILE + 3)

struct Taps {
  float up[K];
  float down[K];
};

struct Args {
  const void* x;          // (rows, T) operand
  const void* g;          // (rows, T) added to it, or null
  const float* bias;      // (C,) added to it, or null
  void* y_out;            // p, or null
  void* a_out;            // the activated p, or null
  const void* m0;         // two branches' streams for the mean, or null
  const void* m1;
  void* mean_out;         // round((m0 + m1 + p) * (1/3)), or null
  const float* log_alpha; // (C,) of this site
  const float* log_beta;
  int64_t rows;
  int C;
  int T;
  int vec;               // T % 8 == 0 and every row pointer on 16 bytes
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// x + sin^2(alpha x) * inv_b, sin^2 reduced by its period pi
__device__ __forceinline__ float snake_beta(float x, float alpha, float inv_b) {
  const float z = alpha * x;
  const float k = rintf(z * 0.318309886183790672f);
  float r = fmaf(-k, 3.14159274101257324f, z);        // pi, fp32 head
  r = fmaf(-k, -8.74227800037248965e-8f, r);          // pi - head
  const float s = __sinf(r);
  return fmaf(s * s, inv_b, x);
}

// 8 elements of a row at `i` (16 bytes of bf16, 32 of fp32) as floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
// 4 floats rounded to the row's type, stored at p (8 bytes of bf16, 16 of fp32)
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(f[0], f[1]), __floats2bfloat162_rn(f[2], f[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}
__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

template <typename E>
__global__ void __launch_bounds__(THREADS) amp_act_kernel(const Args a, const Taps taps) {
  __shared__ __align__(16) float sp[PW];
  __shared__ __align__(16) float2 sv[VG * 4];
  const int tiles = (a.T + TILE - 1) / TILE;
  const int64_t row = static_cast<int64_t>(blockIdx.x) / tiles;
  const int t0 = static_cast<int>(blockIdx.x % tiles) * TILE;
  const int c = static_cast<int>(row % a.C);
  const int64_t base = row * a.T;
  const int T = a.T;
  // 16-byte rows: every chunk of 8 samples inside [0, T) is one vector load
  const bool vec = a.vec != 0;
  const E* x = static_cast<const E*>(a.x) + base;
  const E* g = a.g ? static_cast<const E*>(a.g) + base : nullptr;
  const float bias = a.bias ? a.bias[c] : 0.f;
  const bool pre = g != nullptr || a.bias != nullptr;

  // 1. the operand window: sp[j] = p[clamp(t0 - PH + j)], in chunks of 8
  for (int ch = threadIdx.x; ch < PW / 8; ch += THREADS) {
    const int i0 = t0 - PH + 8 * ch;
    float v[8], w[8];
    if (vec && i0 >= 0 && i0 + 8 <= T) {
      load8(x + i0, v);
      if (g) load8(g + i0, w);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = min(max(i0 + e, 0), T - 1);
        v[e] = to_f(x[i]);
        if (g) w[e] = to_f(g[i]);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (pre) v[e] = to_f(from_f<E>((g ? v[e] + w[e] : v[e]) + bias));
      sp[8 * ch + e] = v[e];
    }
  }
  __syncthreads();

  if (a.a_out) {
    const float alpha = expf(a.log_alpha[c]);
    const float inv_b = 1.f / (expf(a.log_beta[c]) + 1e-9f);
    // 2. the 2x window as pairs: sv[r] = (v[2s], v[2s + 1]), s = t0 - 3 + r,
    //    four consecutive pairs a thread (their 10 operand samples loaded
    //    once); outside [0, T) both members are v at the clamped end (v[0]
    //    below, v[2T - 1] above)
    for (int grp = threadIdx.x; grp < VG; grp += THREADS) {
      const int r0 = 4 * grp, s0 = t0 - 3 + r0;
      float q[10];                                  // p[s0 - 3 + i], clamped
      if (s0 - 3 >= 0 && s0 + 6 < T) {
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          const float2 v = *reinterpret_cast<const float2*>(sp + r0 + 2 + 2 * i);
          q[2 * i] = v.x;
          q[2 * i + 1] = v.y;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 10; ++i) q[i] = sp[min(max(s0 - 3 + i, 0), T - 1) - (t0 - PH)];
      }
      float2 out[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int s = s0 + m;
        float ue = 0.f, uo = 0.f;
        if (s >= 0 && s < T) {
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            ue = fmaf(taps.up[2 * i + 1], q[m + 5 - i], ue);
            uo = fmaf(taps.up[2 * i], q[m + 6 - i], uo);
          }
        } else {    // a clamped end: the pair at the end sample, on its clamped operands
          const int sc = min(max(s, 0), T - 1);
          for (int i = 0; i < 6; ++i) {
            ue = fmaf(taps.up[2 * i + 1], sp[min(max(sc + 2 - i, 0), T - 1) - (t0 - PH)], ue);
            uo = fmaf(taps.up[2 * i], sp[min(max(sc + 3 - i, 0), T - 1) - (t0 - PH)], uo);
          }
        }
        const float ve = snake_beta(ue, alpha, inv_b);
        const float vo = snake_beta(uo, alpha, inv_b);
        out[m] = s < 0 ? make_float2(ve, ve) : (s >= T ? make_float2(vo, vo) : make_float2(ve, vo));
      }
      float4* dst = reinterpret_cast<float4*>(sv + r0);
      dst[0] = make_float4(out[0].x, out[0].y, out[1].x, out[1].y);
      dst[1] = make_float4(out[2].x, out[2].y, out[3].x, out[3].y);
    }
    __syncthreads();
    // 3. out[s] = sum_j down[j] v[2s + j - 5]: the 2x window's entries
    //    2 (s - t0) + 1 .. + 12, four consecutive outputs a thread from the
    //    pairs (s - t0) .. (s - t0) + 9
    E* dst = static_cast<E*>(a.a_out) + base;
    for (int grp = threadIdx.x; grp < TILE / 4; grp += THREADS) {
      const int q0 = 4 * grp;
      if (t0 + q0 >= T) break;
      float w[20];
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(sv + q0 + 2 * i);
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
      float acc[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        acc[m] = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j) acc[m] = fmaf(taps.down[j], w[2 * m + j + 1], acc[m]);
      }
      if (vec && t0 + q0 + 4 <= T) {
        store4(dst + t0 + q0, acc);
      } else {
        for (int m = 0; m < 4 && t0 + q0 + m < T; ++m) dst[t0 + q0 + m] = from_f<E>(acc[m]);
      }
    }
  }

  if (a.y_out || a.mean_out) {    // p, or the mean, in chunks of 8
    E* y = a.y_out ? static_cast<E*>(a.y_out) + base : nullptr;
    E* m = a.mean_out ? static_cast<E*>(a.mean_out) + base : nullptr;
    const E* m0 = a.mean_out ? static_cast<const E*>(a.m0) + base : nullptr;
    const E* m1 = a.mean_out ? static_cast<const E*>(a.m1) + base : nullptr;
    for (int ch = threadIdx.x; ch < TILE / 8 && t0 + 8 * ch < T; ch += THREADS) {
      const int i0 = t0 + 8 * ch;
      float p[8], u[8] = {}, w[8] = {};
#pragma unroll
      for (int e = 0; e < 8; ++e) p[e] = sp[8 * ch + PH + e];
      if (m) {
        if (vec && i0 + 8 <= T) {
          load8(m0 + i0, u);
          load8(m1 + i0, w);
        } else {
          for (int e = 0; e < 8 && i0 + e < T; ++e) {
            u[e] = to_f(m0[i0 + e]);
            w[e] = to_f(m1[i0 + e]);
          }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) u[e] = (u[e] + w[e] + p[e]) * THIRD;
      }
      if (vec && i0 + 8 <= T) {
        if (y) {
          store4(y + i0, p);
          store4(y + i0 + 4, p + 4);
        }
        if (m) {
          store4(m + i0, u);
          store4(m + i0 + 4, u + 4);
        }
      } else {
        for (int e = 0; e < 8 && i0 + e < T; ++e) {
          if (y) y[i0 + e] = from_f<E>(p[e]);
          if (m) m[i0 + e] = from_f<E>(u[e]);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Args& a, const Taps& taps, cudaStream_t stream) {
  const int64_t blocks = a.rows * ((a.T + TILE - 1) / TILE);
  if (blocks <= 0 || blocks > INT32_MAX) return cudaErrorInvalidValue;
  amp_act_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(a, taps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point: one activation site over `rows` = B * C rows of T
// samples, operands of `dtype` (0 fp32, 1 bf16). x (rows, T); g (rows, T) or
// null; bias, log_alpha, log_beta (C,) fp32 on the device (bias may be null;
// the log parameters may be null only when a_out is); y_out, a_out, mean_out
// (rows, T) or null, with m0 and m1 given with mean_out; `taps` 24 host
// floats, the up filter then the down filter. Returns a cudaError_t (0 =
// launched).
extern "C" int amp_act_fwd(const void* x, const void* g, const void* bias, void* y_out,
                           void* a_out, const void* m0, const void* m1, void* mean_out,
                           const void* log_alpha, const void* log_beta, const float* taps,
                           long long rows, int C, int T, int dtype, void* stream) {
  if (x == nullptr || rows <= 0 || C <= 0 || T <= 0 || rows % C != 0 || taps == nullptr)
    return (int)cudaErrorInvalidValue;
  if (a_out != nullptr && (log_alpha == nullptr || log_beta == nullptr))
    return (int)cudaErrorInvalidValue;
  if (mean_out != nullptr && (m0 == nullptr || m1 == nullptr)) return (int)cudaErrorInvalidValue;
  if (y_out == nullptr && a_out == nullptr && mean_out == nullptr)
    return (int)cudaErrorInvalidValue;
  Taps t;
  for (int i = 0; i < K; ++i) {
    t.up[i] = taps[i];
    t.down[i] = taps[K + i];
  }
  const uintptr_t vectors = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
                            reinterpret_cast<uintptr_t>(a_out) |
                            reinterpret_cast<uintptr_t>(y_out) | reinterpret_cast<uintptr_t>(m0) |
                            reinterpret_cast<uintptr_t>(m1) | reinterpret_cast<uintptr_t>(mean_out);
  const Args a{x, g, static_cast<const float*>(bias), y_out, a_out, m0, m1, mean_out,
               static_cast<const float*>(log_alpha), static_cast<const float*>(log_beta),
               static_cast<int64_t>(rows), C, T, T % 8 == 0 && vectors % 16 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, t, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, t, st);
  return (int)cudaErrorInvalidValue;
}
