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
// (n_fft, 640) cos/sin basis on the MXU, views the clip as hop-wide rows so
// that framing is aligned loads (n_fft % hop == 0 only), pads the bins to
// 640 and the mels to 128 lanes, and stores the three sums in spare mel
// columns. None of that is math, and on the CUDA cores (no MXU) the basis
// product costs ~2.1 MFLOP per frame. Here instead:
//   * one warp per frame: the n_fft real samples are read by direct
//     indexing (any hop), clipped, windowed and packed as n_fft/2 complex
//     values (even + i*odd) in bit-reversed order into the warp's slice of
//     shared memory; a radix-2 decimation-in-time FFT of n_fft/2 points runs
//     in place there (__syncwarp between stages) and one split pass turns it
//     into the n_fft/2 + 1 bins of the real spectrum: ~50 kFLOP per frame at
//     n_fft 1024, about 40x fewer than the basis product;
//   * every intermediate is float64, and each output is rounded once to
//     fp32. The log at the end amplifies error near the 1e-5 clamp: over
//     tones under Hann envelopes many mel bins sit just above it, where an
//     fp32 FFT of the frame is rounding noise (plain fp32 FFTs are 5e-3 to
//     3.2e-2 off float64 in log-mel there, this kernel in fp32 7e-3 to
//     1.6e-2, against a 2e-3 budget). The H100 runs fp64 at half its fp32
//     rate, and this kernel is not bound by arithmetic;
//   * the twiddles e^{-2 pi i k / n_fft} come from the host in float64 and
//     are staged in shared memory with the fp32 window (the same window the
//     plain version multiplies by), so no sin/cos on the device and no
//     fast-math anywhere;
//   * power, magnitude and the three sums over the real bins only (no pad
//     columns, so no log(eps) correction); sums as per-lane partials and a
//     warp shuffle tree;
//   * the mel projection walks each filter's contiguous non-zero range of
//     bins (host-packed: start, end, offset into the packed fp32 weights)
//     instead of the dense (513, 80) matrix;
//   * 8 warps per block, each taking 4 frames in turn: one block covers 32
//     consecutive frames of one item, so the ragged last tile and clips
//     shorter than a tile only idle warps.
//
// What bounds it. At n_fft 1024, hop 256, 80 mels a frame reads 4 KB of
// audio (each sample is shared by n_fft / hop = 4 frames through L1/L2) and
// writes 332 bytes, against ~50 kFLOP plus ~10k shared memory accesses of 8
// or 16 bytes; the radix-2 stages' shared-memory traffic (with bank
// conflicts at strides 1..16) is expected to be the limit, not device memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int FRAMES_PER_WARP = 4;
constexpr int FRAMES_PER_BLOCK = WARPS * FRAMES_PER_WARP;
constexpr double MEL_CLAMP = 1.0e-5;
constexpr double KURTOSIS_EPS = 1.0e-8;
constexpr int MIN_N_FFT = 16;
constexpr int MAX_N_FFT = 2048;  // 216 KB of shared memory per block

// shared memory in 16-byte slots: twiddles (n_fft/2 double2), the fp32
// window (n_fft/4 slots), then per warp n_fft/2 complex values and
// n_fft/2 + 2 magnitudes (double, one pad to keep 16-byte alignment)
__host__ __device__ __forceinline__ int warp_slots(int n_fft) {
  return n_fft / 2 + n_fft / 4 + 1;
}

__host__ __device__ __forceinline__ int smem_slots(int n_fft) {
  return n_fft / 2 + n_fft / 4 + WARPS * warp_slots(n_fft);
}

__global__ void __launch_bounds__(THREADS)
mel_frontend_kernel(const float* __restrict__ audio, int length, int n_frames,
                    int n_fft, int log2_half, int hop,
                    const double2* __restrict__ twiddle,
                    const float* __restrict__ window,
                    const int* __restrict__ mel_index,
                    const float* __restrict__ mel_weight, int n_mels,
                    float* __restrict__ logmel, float* __restrict__ energy,
                    float* __restrict__ power_sum,
                    float* __restrict__ log_power_sum) {
  extern __shared__ double2 smem[];
  const int half = n_fft >> 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  double2* tw = smem;
  float* win = reinterpret_cast<float*>(smem + half);
  double2* z = smem + half + n_fft / 4 + warp * warp_slots(n_fft);
  double* mag = reinterpret_cast<double*>(z + half);

  for (int i = threadIdx.x; i < half; i += THREADS) tw[i] = twiddle[i];
  for (int i = threadIdx.x; i < n_fft; i += THREADS) win[i] = window[i];
  __syncthreads();

  const int b = blockIdx.y;
  const float* x = audio + (size_t)b * length;
  const int* mel_start = mel_index;
  const int* mel_end = mel_index + n_mels;
  const int* mel_offset = mel_index + 2 * n_mels;

  for (int r = 0; r < FRAMES_PER_WARP; ++r) {
    const int t = blockIdx.x * FRAMES_PER_BLOCK + r * WARPS + warp;
    if (t >= n_frames) break;  // uniform across the warp
    const float* frame = x + (size_t)t * hop;

    // clip, window, pack even + i*odd into bit-reversed positions
    for (int j = lane; j < half; j += 32) {
      const double a = (double)fminf(fmaxf(frame[2 * j], -1.f), 1.f) * win[2 * j];
      const double c =
          (double)fminf(fmaxf(frame[2 * j + 1], -1.f), 1.f) * win[2 * j + 1];
      z[__brev(j) >> (32 - log2_half)] = make_double2(a, c);
    }
    __syncwarp();

    // radix-2 DIT over n_fft/2 points; stage s pairs i0 and i0 + 2^s with
    // twiddle W_{2^(s+1)}^j = e^{-2 pi i j / 2^(s+1)} = tw[j * (half >> s)]
    for (int s = 0; s < log2_half; ++s) {
      const int h = 1 << s;
      const int stride = half >> s;
      for (int bf = lane; bf < (half >> 1); bf += 32) {
        const int j = bf & (h - 1);
        const int i0 = ((bf >> s) << (s + 1)) + j;
        const double2 w = tw[j * stride];
        const double2 u = z[i0];
        const double2 v = z[i0 + h];
        const double cx = v.x * w.x - v.y * w.y;
        const double cy = v.x * w.y + v.y * w.x;
        z[i0] = make_double2(u.x + cx, u.y + cy);
        z[i0 + h] = make_double2(u.x - cx, u.y - cy);
      }
      __syncwarp();
    }

    // split: X[k] = E[k] + W_N^k O[k] with E = (Z[k] + conj Z[half-k]) / 2,
    // O = (Z[k] - conj Z[half-k]) / 2i, Z[half] = Z[0], W_N^half = -1
    double ps = 0.0, lps = 0.0;
    for (int k = lane; k <= half; k += 32) {
      const double2 A = z[k & (half - 1)];
      const double2 B = z[(half - k) & (half - 1)];
      const double2 w = k < half ? tw[k] : make_double2(-1.0, 0.0);
      const double ex = 0.5 * (A.x + B.x);
      const double ey = 0.5 * (A.y - B.y);
      const double ox = 0.5 * (A.y + B.y);
      const double oy = -0.5 * (A.x - B.x);
      const double re = ex + (w.x * ox - w.y * oy);
      const double im = ey + (w.x * oy + w.y * ox);
      const double p = re * re + im * im;
      ps += p;
      lps += log(p + KURTOSIS_EPS);
      mag[k] = sqrt(p);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ps += __shfl_xor_sync(0xffffffffu, ps, o);
      lps += __shfl_xor_sync(0xffffffffu, lps, o);
    }
    __syncwarp();

    const size_t row = (size_t)b * n_frames + t;
    for (int m = lane; m < n_mels; m += 32) {
      const int k0 = mel_start[m];
      const int n = mel_end[m] - k0;
      const float* wm = mel_weight + mel_offset[m];
      double acc = 0.0;
      for (int i = 0; i < n; ++i) acc = fma((double)wm[i], mag[k0 + i], acc);
      logmel[row * n_mels + m] = (float)log(fmax(acc, MEL_CLAMP));
    }
    if (lane == 0) {
      energy[row] = (float)sqrt(ps);
      power_sum[row] = (float)ps;
      log_power_sum[row] = (float)lps;
    }
    __syncwarp();  // this frame's magnitudes are read before the next frame
  }
}

}  // namespace

// Plain C entry point for ctypes. audio (batch, length) fp32, reflect
// pre-padded; twiddle (n_fft/2, 2) float64 = (cos, -sin)(2 pi k / n_fft);
// window (n_fft) fp32; mel_index (3, n_mels) int32 rows start, end
// (exclusive) and offset of each filter's non-zero bins in mel_weight (fp32).
// Outputs, fp32: logmel (batch, n_frames, n_mels); energy, power_sum,
// log_power_sum (batch, n_frames). Returns a cudaError_t (0 = launched).
extern "C" int mel_frontend_fwd(const void* audio, const void* twiddle,
                                const void* window, const void* mel_index,
                                const void* mel_weight, void* logmel,
                                void* energy, void* power_sum,
                                void* log_power_sum, int batch, int length,
                                int n_fft, int hop, int n_mels, void* stream) {
  if (n_fft < MIN_N_FFT || n_fft > MAX_N_FFT || (n_fft & (n_fft - 1)) != 0 ||
      hop <= 0 || length < n_fft || batch <= 0 || batch > 65535 || n_mels <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_frames = (length - n_fft) / hop + 1;
  int log2_half = 0;
  while ((2 << log2_half) < n_fft) ++log2_half;
  const size_t smem = (size_t)smem_slots(n_fft) * sizeof(double2);
  // above 48 KB of dynamic shared memory needs an opt-in
  cudaError_t err = cudaFuncSetAttribute(
      mel_frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_frames + FRAMES_PER_BLOCK - 1) / FRAMES_PER_BLOCK, batch);
  mel_frontend_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), length, n_frames, n_fft, log2_half, hop,
      static_cast<const double2*>(twiddle), static_cast<const float*>(window),
      static_cast<const int*>(mel_index), static_cast<const float*>(mel_weight),
      n_mels, static_cast<float*>(logmel), static_cast<float*>(energy),
      static_cast<float*>(power_sum), static_cast<float*>(log_power_sum));
  return (int)cudaGetLastError();
}
