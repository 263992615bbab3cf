// Fused mel-spectrogram frontend of corpus preprocessing (Hopper).
//
// Replaces the TPU kernel visual_onoma_to_wave_tpu/ops/pallas_mel.py::
// _run_mel_kernel (body _mel_kernel). For item b and frame t of the
// reflect-pre-padded clip x (B, L), with n_frames = (L - n_fft) / hop + 1:
//
//     frame  = clip(x, -1, 1)[t*hop : t*hop + n_fft] * w
//     P[f]   = |rfft(frame)[f]|^2,  f <= n_fft / 2
//     logmel = log(max(fb^T sqrt(P), 1e-5))       -> logmel (B, n_frames, n_mels)
//     e      = sqrt(sum P), ps = sum P,
//     lps    = sum log(P + 1e-8)                   -> three (B, n_frames) outputs
//
// w is the periodic Hann window of win_length zero-padded to the centre of
// n_fft, fb the (n_fft/2 + 1, n_mels) slaney/HTK filterbank.
//
// Design. The TPU kernel takes the DFT as two products against a dense
// (n_fft, 640) cos/sin basis on the MXU (~2.1 MFLOP a frame at n_fft 1024).
// On the CUDA cores an FFT does the same in ~20 kFLOP. Here:
//   * the n_fft real samples of a frame are packed as N = n_fft/2 complex
//     values z[n] = x[2n] + i x[2n+1] and transformed by a Stockham FFT
//     whose butterflies run in registers: one radix-2 or radix-4 pass where
//     log2 N is not a multiple of 3, then radix-8 passes (512 = 8·8·8: three
//     passes, two exchanges through shared memory). One kernel is
//     instantiated per size (n_fft 16 ... 2048), so that every register
//     index is a compile-time constant; the entry point picks it by n_fft;
//   * a lane holds LANE_VALUES = 16 complex values (two radix-8
//     butterflies), a frame takes N / 16 lanes: one warp at n_fft 1024, two
//     at 2048, several frames a warp below 1024. The first pass reads its
//     inputs straight from device memory (clip, window, float64); the last
//     keeps its outputs in registers: a lane takes butterflies j and M - j
//     of it (M = N / 8; lane 0 takes 0 and M / 2), so that it holds z[k] and
//     z[N - k] of every bin pair k, N - k it splits into the real spectrum
//     (no exchange for the split);
//   * the exchange buffer (one per frame in flight) places element e at
//     slot e + e / 8 (one 16-byte pad per 8): every store and every gather
//     before the last pass is free of bank conflicts, the last pass's
//     mirrored gathers (butterflies M - j) take 2 wavefronts where 1 would
//     do (tests/test_torch_mel_fft.py holds the model);
//   * the FFT, the split and each bin's power P are float64: the log at the
//     end amplifies error near the 1e-5 clamp, where an fp32 FFT of a frame
//     is rounding noise (plain fp32 FFTs are 5e-3 to 3.2e-2 off float64 in
//     log-mel there). Once P is known fp32 is enough: the magnitude
//     (sqrtf), log(P + 1e-8) (logf, summed in float64), the mel product
//     (fp32 FMA over each filter's non-zero bins, host-packed as start,
//     end, offset) and its log;
//   * twiddles come from the host in float64 (ops/mel.py::twiddle_table:
//     W_{n_fft}^k for the split, then one block a pass laid out by (r, j mod
//     Ns) so that a warp reads consecutive entries) and are staged in
//     shared memory: no sin/cos on the device and no fast-math anywhere;
//   * a block of 128 threads takes ROUNDS rounds of 128 / (N / 16)
//     consecutive frames of one item; the ragged last round computes a
//     clamped frame and stores nothing. Three blocks an SM (12 warps) with
//     up to 170 registers a lane: ptxas takes 156-168 at n_fft 64-2048 and
//     spills nothing. On an H100 the 16 values a lane beat occupancy:
//     8 values a lane at 24 warps an SM, and 16 at 16 warps with 128
//     registers (which spills), were no faster (PERF.md, B3's variants).
//     ops/mel.py mirrors THREADS, ROUNDS and LANE_VALUES.
//
// What bounds it. At n_fft 1024 a frame is ~21k float64 instructions (FFT
// ~14k, split and power ~6k, window 1k), against the card's 64 float64
// FMA a clock an SM, and ~56 KB of shared-memory traffic (two exchanges 32
// KB, twiddles 18 KB, magnitudes for the mel walk ~5 KB), against 128 bytes
// a clock an SM; device memory (4 KB of audio read, 332 bytes written a
// frame) is far below both. fp64 issue and shared memory are of one order,
// and with 12 warps an SM the latency of each pass's dependent float64
// chain and its barriers is not fully hidden.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 4;
constexpr int LANE_VALUES = 16;   // complex float64 values a lane holds
constexpr int MIN_BLOCKS = 3;     // blocks an SM: caps registers at 170 a lane
constexpr float MEL_CLAMP = 1.0e-5f;
constexpr float KURTOSIS_EPS = 1.0e-8f;
constexpr double SQRT_HALF = 0.70710678118654752440;

// The FFT of N = 2^LOG2N complex points: pass p has radix radix(p) and
// stride stride(p) (Ns, the product of the earlier radices); twiddle rows
// as in ops/mel.py::twiddle_table.
template <int LOG2N>
struct Plan {
  static constexpr int N = 1 << LOG2N;
  static constexpr int FIRST = (LOG2N % 3) ? (1 << (LOG2N % 3)) : 8;
  static constexpr int PASSES = (LOG2N + 2) / 3;
  static constexpr int V = N < LANE_VALUES ? N : LANE_VALUES;
  static constexpr int TPF = N / V;              // lanes a frame
  static constexpr int M = N / 8;                // butterflies of the last pass
  static constexpr int GROUPS = THREADS / TPF;   // frames in flight a block
  static constexpr int SLOTS = N + N / 8;        // padded exchange slots a frame
  __host__ __device__ static constexpr int radix(int p) { return p == 0 ? FIRST : 8; }
  __host__ __device__ static constexpr int stride(int p) {
    return p == 0 ? 1 : FIRST << (3 * (p - 1));
  }
  // first row of pass p's block (p >= 1): N + 7 (stride(1) + ... + stride(p-1))
  __host__ __device__ static constexpr int table_row(int p) {
    return N + FIRST * ((1 << (3 * (p - 1))) - 1);
  }
  static constexpr int TABLE = N + FIRST * ((1 << (3 * (PASSES - 1))) - 1);  // table_row(PASSES)
  static constexpr size_t SMEM = (size_t)(TABLE + GROUPS * SLOTS + WARPS) * sizeof(double2);
};

__device__ __forceinline__ int pad(int e) { return e + (e >> 3); }

__device__ __forceinline__ double2 add(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 sub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 mul(double2 a, double2 w) {
  return make_double2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
__device__ __forceinline__ double2 mul_minus_i(double2 a) { return make_double2(a.y, -a.x); }

// c[0..3] -> its 4-point DFT in out[0], out[s], out[2s], out[3s]
__device__ __forceinline__ void dft4(double2 c0, double2 c1, double2 c2, double2 c3,
                                     double2* out, int s) {
  const double2 d0 = add(c0, c2), d1 = sub(c0, c2), d2 = add(c1, c3);
  const double2 d3 = mul_minus_i(sub(c1, c3));
  out[0] = add(d0, d2);
  out[s] = add(d1, d3);
  out[2 * s] = sub(d0, d2);
  out[3 * s] = sub(d1, d3);
}

template <int R>
__device__ __forceinline__ void dft(double2* v) {
  if constexpr (R == 2) {
    const double2 a = v[0];
    v[0] = add(a, v[1]);
    v[1] = sub(a, v[1]);
  } else if constexpr (R == 4) {
    dft4(v[0], v[1], v[2], v[3], v, 1);
  } else {
    // decimation in frequency: X[2q] from v[k] + v[k+4], X[2q+1] from
    // (v[k] - v[k+4]) W8^k
    double2 a[4], b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k] = add(v[k], v[k + 4]);
      b[k] = sub(v[k], v[k + 4]);
    }
    b[1] = make_double2((b[1].x + b[1].y) * SQRT_HALF, (b[1].y - b[1].x) * SQRT_HALF);
    b[2] = mul_minus_i(b[2]);
    b[3] = make_double2((b[3].y - b[3].x) * SQRT_HALF, -(b[3].x + b[3].y) * SQRT_HALF);
    dft4(a[0], a[1], a[2], a[3], v, 2);
    dft4(b[0], b[1], b[2], b[3], v + 1, 2);
  }
}

template <int TPF>
__device__ __forceinline__ void frame_sync() {
  if constexpr (TPF > 32) __syncthreads();  // every group runs the same steps
  else __syncwarp();
}

// butterfly b of lane t in pass PASS: t + b * TPF, except in the last pass,
// where the lane takes j and M - j (lane 0: 0 and M / 2)
template <int LOG2N, int PASS>
__device__ __forceinline__ int butterfly(int t, int b) {
  using P = Plan<LOG2N>;
  if constexpr (PASS == P::PASSES - 1 && P::M > 1) {
    return b == 0 ? t : (t == 0 ? P::M / 2 : P::M - t);
  } else {
    return t + b * P::TPF;
  }
}

// pass 0's inputs from device memory: z[n] = (clip(x[2n]) w[2n], clip(x[2n+1]) w[2n+1])
template <int LOG2N>
__device__ __forceinline__ void load_frame(double2 (&v)[Plan<LOG2N>::V],
                                           const float* __restrict__ f,
                                           const float* __restrict__ window, int t) {
  using P = Plan<LOG2N>;
  constexpr int R = P::FIRST, B = P::V / R, Q = P::N / R;
  const bool aligned = (reinterpret_cast<uintptr_t>(f) & 7) == 0;
  const float2* f2 = reinterpret_cast<const float2*>(f);
  const float2* w2 = reinterpret_cast<const float2*>(window);
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = butterfly<LOG2N, 0>(t, b);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = j + r * Q;
      const float2 s =
          aligned ? __ldg(f2 + n) : make_float2(__ldg(f + 2 * n), __ldg(f + 2 * n + 1));
      const float2 w = __ldg(w2 + n);
      v[b * R + r] = make_double2((double)fminf(fmaxf(s.x, -1.f), 1.f) * (double)w.x,
                                  (double)fminf(fmaxf(s.y, -1.f), 1.f) * (double)w.y);
    }
  }
}

// one Stockham pass: gather (after pass 0), twiddle, R-point DFTs, scatter
// (before the last pass)
template <int LOG2N, int PASS>
__device__ __forceinline__ void fft_pass(double2 (&v)[Plan<LOG2N>::V], double2* buf,
                                         const double2* tw, int t) {
  using P = Plan<LOG2N>;
  constexpr int R = P::radix(PASS), NS = P::stride(PASS), B = P::V / R, Q = P::N / R;
  if constexpr (PASS > 0) {
    frame_sync<P::TPF>();  // the previous pass's outputs are in place
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int j = butterfly<LOG2N, PASS>(t, b);
#pragma unroll
      for (int r = 0; r < R; ++r) v[b * R + r] = buf[pad(j + r * Q)];
    }
    frame_sync<P::TPF>();  // every input is read before the buffer is reused
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    if constexpr (NS > 1) {
      constexpr int ROW = P::table_row(PASS);
      const int s = butterfly<LOG2N, PASS>(t, b) & (NS - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) v[b * R + r] = mul(v[b * R + r], tw[ROW + (r - 1) * NS + s]);
    }
    dft<R>(v + b * R);
  }
  if constexpr (PASS < P::PASSES - 1) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int j = butterfly<LOG2N, PASS>(t, b);
      const int base = (j / NS) * NS * R + (j & (NS - 1));
#pragma unroll
      for (int q = 0; q < R; ++q) buf[pad(base + q * NS)] = v[b * R + q];
    }
  }
}

// one bin's outputs from q = 4 P: its fp32 magnitude, and log(P + 1e-8) in
// fp32, added in float64
__device__ __forceinline__ void store_bin(double q, int k, float* mag, double& lps) {
  const float f = (float)q;
  mag[k] = 0.5f * sqrtf(f);
  lps += (double)logf(fmaf(0.25f, f, KURTOSIS_EPS));
}

// bins k and N - k from A = z[k], B = z[N - k] and w = W_{n_fft}^k:
// 2 X[k] = S + w O', 2 conj X[N-k] = S - w O' with S = A + conj B,
// O' = -i (A - conj B). Adds 4 P of both to ps.
__device__ __forceinline__ void split_pair(double2 A, double2 B, double2 w, int k, int n,
                                           float* mag, double& ps, double& lps) {
  const double sx = A.x + B.x, sy = A.y - B.y;
  const double dx = A.x - B.x, dy = A.y + B.y;
  const double ox = w.x * dy + w.y * dx, oy = w.y * dy - w.x * dx;
  const double re1 = sx + ox, im1 = sy + oy, re2 = sx - ox, im2 = sy - oy;
  const double q1 = re1 * re1 + im1 * im1, q2 = re2 * re2 + im2 * im2;
  ps += q1 + q2;
  store_bin(q1, k, mag, lps);
  store_bin(q2, n - k, mag, lps);
}

template <int LOG2N>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mel_frontend_kernel(const float* __restrict__ audio, int length, int n_frames, int hop,
                    const double2* __restrict__ twiddle, const float* __restrict__ window,
                    const int* __restrict__ mel_index, const float* __restrict__ mel_weight,
                    int n_mels, float* __restrict__ logmel, float* __restrict__ energy,
                    float* __restrict__ power_sum, float* __restrict__ log_power_sum) {
  using P = Plan<LOG2N>;
  constexpr int N = P::N, M = P::M, TPF = P::TPF;
  extern __shared__ double2 smem[];
  double2* tw = smem;
  double2* red = smem + P::TABLE + P::GROUPS * P::SLOTS;  // per-warp sums, TPF > 32
  for (int i = threadIdx.x; i < P::TABLE; i += THREADS) tw[i] = twiddle[i];
  __syncthreads();

  const int group = threadIdx.x / TPF;
  const int t = threadIdx.x % TPF;
  double2* buf = smem + P::TABLE + group * P::SLOTS;
  float* mag = reinterpret_cast<float*>(buf);  // the magnitudes reuse the buffer
  const int item = blockIdx.y;
  const float* x = audio + (size_t)item * length;
  const int* mel_start = mel_index;
  const int* mel_end = mel_index + n_mels;
  const int* mel_offset = mel_index + 2 * n_mels;

  for (int round = 0; round < ROUNDS; ++round) {
    const int first = (blockIdx.x * ROUNDS + round) * P::GROUPS;
    if (first >= n_frames) break;  // uniform across the block
    const int frame = first + group;
    const bool valid = frame < n_frames;
    const float* f = x + (size_t)(valid ? frame : n_frames - 1) * hop;

    double2 v[P::V];
    load_frame<LOG2N>(v, f, window, t);
    frame_sync<TPF>();  // the previous frame's mel walk is done with the buffer
    fft_pass<LOG2N, 0>(v, buf, tw, t);
    if constexpr (P::PASSES > 1) fft_pass<LOG2N, 1>(v, buf, tw, t);
    if constexpr (P::PASSES > 2) fft_pass<LOG2N, 2>(v, buf, tw, t);
    if constexpr (P::PASSES > 3) fft_pass<LOG2N, 3>(v, buf, tw, t);

    // split: v[q] = z[j0 + qM], v[8 + q] = z[j1 + qM], so slot q pairs
    // v[q] = z[k] with v[15 - q] = z[N - k], k = t + qM. Lane 0 holds the
    // self-paired butterflies 0 and M/2; it moves its registers so that the
    // same slots pair z[qM] with z[N - qM] (q < 4) and z[M/2 + (q-4) M] with
    // z[N - M/2 - (q-4) M] (q >= 4), and takes bin N/2 = conj z[N/2] apart.
    double ps = 0.0, lps = 0.0;
    const bool lead = t == 0;
    const double2 half_bin = v[4];
    if constexpr (M == 1) {  // n_fft 16: one butterfly, one lane
#pragma unroll
      for (int q = 0; q < 4; ++q) split_pair(v[q], v[(8 - q) & 7], tw[q], q, N, mag, ps, lps);
    } else {
      if (lead) {
        const double2 z0 = v[0], z5 = v[5], z6 = v[6], z7 = v[7];
#pragma unroll
        for (int i = 4; i < 12; ++i) v[i] = v[i + 4];
        v[12] = z5;
        v[13] = z6;
        v[14] = z7;
        v[15] = z0;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int k = lead ? (q < 4 ? q * M : M / 2 + (q - 4) * M) : t + q * M;
        split_pair(v[q], v[15 - q], tw[k], k, N, mag, ps, lps);
      }
    }
    if (lead) {
      const double q = 4.0 * (half_bin.x * half_bin.x + half_bin.y * half_bin.y);
      ps += q;
      store_bin(q, N / 2, mag, lps);
    }
#pragma unroll
    for (int o = (TPF < 32 ? TPF : 32) / 2; o > 0; o >>= 1) {
      ps += __shfl_xor_sync(0xffffffffu, ps, o);
      lps += __shfl_xor_sync(0xffffffffu, lps, o);
    }
    if constexpr (TPF > 32) {
      if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_double2(ps, lps);
    }
    frame_sync<TPF>();  // magnitudes (and per-warp sums) are in place

    const size_t row = (size_t)item * n_frames + frame;
    for (int m = t; m < n_mels; m += TPF) {
      const int k0 = __ldg(mel_start + m);
      const int n = __ldg(mel_end + m) - k0;
      const float* wm = mel_weight + __ldg(mel_offset + m);
      float acc = 0.f;
      for (int i = 0; i < n; ++i) acc = fmaf(__ldg(wm + i), mag[k0 + i], acc);
      if (valid) logmel[row * n_mels + m] = logf(fmaxf(acc, MEL_CLAMP));
    }
    if (lead && valid) {
      if constexpr (TPF > 32) {
        ps = 0.0;
        lps = 0.0;
#pragma unroll
        for (int w = 0; w < TPF / 32; ++w) {
          ps += red[group * (TPF / 32) + w].x;
          lps += red[group * (TPF / 32) + w].y;
        }
      }
      ps *= 0.25;  // the pairs summed 4 P
      energy[row] = (float)sqrt(ps);
      power_sum[row] = (float)ps;
      log_power_sum[row] = (float)lps;
    }
  }
}

template <int LOG2N>
int launch(const float* audio, const double2* twiddle, const float* window,
           const int* mel_index, const float* mel_weight, float* logmel, float* energy,
           float* power_sum, float* log_power_sum, int batch, int length, int n_frames,
           int hop, int n_mels, cudaStream_t stream) {
  using P = Plan<LOG2N>;
  // above 48 KB of dynamic shared memory needs an opt-in
  cudaError_t err = cudaFuncSetAttribute(mel_frontend_kernel<LOG2N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)P::SMEM);
  if (err != cudaSuccess) return (int)err;
  constexpr int FRAMES_PER_BLOCK = ROUNDS * P::GROUPS;
  dim3 grid((n_frames + FRAMES_PER_BLOCK - 1) / FRAMES_PER_BLOCK, batch);
  mel_frontend_kernel<LOG2N><<<grid, THREADS, P::SMEM, stream>>>(
      audio, length, n_frames, hop, twiddle, window, mel_index, mel_weight, n_mels, logmel,
      energy, power_sum, log_power_sum);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. audio (batch, length) fp32, reflect
// pre-padded; twiddle float64 (ops/mel.py::twiddle_table(n_fft)); window
// (n_fft) fp32; mel_index (3, n_mels) int32 rows start, end (exclusive) and
// offset of each filter's non-zero bins in mel_weight (fp32). Outputs, fp32:
// logmel (batch, n_frames, n_mels); energy, power_sum, log_power_sum (batch,
// n_frames). n_fft picks the kernel's instantiation. Returns a cudaError_t
// (0 = launched).
extern "C" int mel_frontend_fwd(const void* audio, const void* twiddle,
                                const void* window, const void* mel_index,
                                const void* mel_weight, void* logmel,
                                void* energy, void* power_sum,
                                void* log_power_sum, int batch, int length,
                                int n_fft, int hop, int n_mels, void* stream) {
  int log2_half = 3;  // n_fft 16 ... 2048: instantiations 3 ... 10
  while (log2_half < 10 && (2 << log2_half) < n_fft) ++log2_half;
  if ((2 << log2_half) != n_fft || hop <= 0 || length < n_fft || batch <= 0 || batch > 65535 ||
      n_mels <= 0)
    return (int)cudaErrorInvalidValue;
  static constexpr decltype(&launch<3>) instances[] = {launch<3>, launch<4>, launch<5>, launch<6>,
                                                       launch<7>, launch<8>, launch<9>, launch<10>};
  return instances[log2_half - 3](
      static_cast<const float*>(audio), static_cast<const double2*>(twiddle),
      static_cast<const float*>(window), static_cast<const int*>(mel_index),
      static_cast<const float*>(mel_weight), static_cast<float*>(logmel),
      static_cast<float*>(energy), static_cast<float*>(power_sum),
      static_cast<float*>(log_power_sum), batch, length, (length - n_fft) / hop + 1, hop, n_mels,
      static_cast<cudaStream_t>(stream));
}
