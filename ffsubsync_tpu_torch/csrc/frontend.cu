// Fused audio frontend for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel ffsubsync_tpu/ops/pallas/frontend.py::
// _frontend_kernel (launched by _frontend_call, wrapped by fused_frontend).
// One pass over framed PCM per tile of kTile 10 ms windows emits, per window:
//
//   - 40 log-mel values: Hann window -> real DFT -> power -> mel -> log(x+1e-6)
//   - 6 webrtc sub-band powers: real DFT (no window) -> power -> sum over the
//     contiguous bin range of each band
//   - total power: sum(x^2) / window, at raw int16 scale
//
// The wire decode runs in the load: int16 samples, narrow mu-law int8 codes
// [T, window], or packed 6-bit mu-law [T, window*3/4] (4 biased codes per 3
// bytes; silence is code 31, not a zero byte). The TPU path ran that decode
// as a separate XLA pass before the kernel.
//
// What bounds it: at the 12 kHz analysis tier (window 120, 61 bins) one
// window costs 2 spectra x 120 x 61 x 2 x 2 ~= 59 kFLOP, ~32 GFLOP for 90
// minutes of audio, against ~65 MB of int8 read and ~100 MB of f32 written.
// That is far below the tensor cores' ridge point, so the design aims at the
// memory floor: every intermediate (decoded tile, both power spectra) stays
// in shared memory and only the final features are written. As written the
// kernel does not reach that floor. It is issue-bound: the O(W*F) twiddle
// loop of scalar FMAs and shared-memory loads sets its time, about 70x the
// memory floor per 45-minute chunk on an H100 80GB HBM3 at 700 W (PERF.md,
// section 7).
//
// The TPU kernel ran the DFT as a matmul against [wpad, 512] cos/sin
// matrices; here a W-entry twiddle table is enough, because e^{-2 pi i t k / W} = table[(t k) mod W], and the Hann
// factor is applied to the sample instead of being folded into a matrix.
// All sums are float32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;      // windows per block
constexpr int kThreads = 256;  // threads per block
constexpr int kMels = 40;
constexpr int kBands = 6;
constexpr float kMulawScale = 32768.0f / 255.0f;

enum Wire { kWireI16 = 0, kWireMulaw = 1, kWireMulaw6 = 2 };

struct BandRanges {
  int lo[kBands];  // first rfft bin of each band
  int hi[kBands];  // one past the last bin
};

// mu-law expansion of a signed code c in [-levels, levels] to int16 scale
// (ops/frontend.mulaw_decode / unpack_mulaw6 are the plain versions).
__device__ __forceinline__ float mulaw_expand(float c, float inv_levels) {
  const float mag = fabsf(c) * inv_levels;
  const float sign = (c > 0.f) ? 1.f : ((c < 0.f) ? -1.f : 0.f);
  return sign * kMulawScale * (exp2f(mag * 8.0f) - 1.0f);
}

// Shared memory layout (floats):
//   cos[W] | sin[W] | hann[W] | mel[F*40] | raw[kTile*W] | p_hann[kTile*F] |
//   p_plain[kTile*F]
// The first 3W + 40F come verbatim from the `consts` buffer.
template <int WIRE>
__global__ void __launch_bounds__(kThreads) frontend_kernel(
    const void* __restrict__ framed, int n_windows, int window, int n_freqs,
    const float* __restrict__ consts, BandRanges br,
    float* __restrict__ logmel, float* __restrict__ bands,
    float* __restrict__ total) {
  extern __shared__ float smem[];
  float* s_cos = smem;
  float* s_sin = s_cos + window;
  float* s_hann = s_sin + window;
  float* s_mel = s_hann + window;
  float* s_raw = s_mel + n_freqs * kMels;
  float* s_pm = s_raw + kTile * window;
  float* s_pp = s_pm + kTile * n_freqs;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kTile;
  const int rows = min(kTile, n_windows - row0);

  const int n_const = 3 * window + n_freqs * kMels;
  for (int i = tid; i < n_const; i += blockDim.x) smem[i] = consts[i];

  // decode the tile into s_raw at int16 scale
  if (WIRE == kWireMulaw6) {
    const int groups = window / 4;  // 4 codes per 3 bytes
    const uint8_t* src =
        static_cast<const uint8_t*>(framed) + (size_t)row0 * groups * 3;
    for (int g = tid; g < rows * groups; g += blockDim.x) {
      const int b0 = src[3 * g], b1 = src[3 * g + 1], b2 = src[3 * g + 2];
      const int u0 = b0 >> 2;
      const int u1 = ((b0 & 3) << 4) | (b1 >> 4);
      const int u2 = ((b1 & 15) << 2) | (b2 >> 6);
      const int u3 = b2 & 63;
      float* dst = s_raw + 4 * g;
      dst[0] = mulaw_expand((float)(u0 - 31), 1.0f / 31.0f);
      dst[1] = mulaw_expand((float)(u1 - 31), 1.0f / 31.0f);
      dst[2] = mulaw_expand((float)(u2 - 31), 1.0f / 31.0f);
      dst[3] = mulaw_expand((float)(u3 - 31), 1.0f / 31.0f);
    }
  } else {
    const size_t base = (size_t)row0 * window;
    for (int i = tid; i < rows * window; i += blockDim.x) {
      if (WIRE == kWireI16) {
        s_raw[i] = (float)static_cast<const int16_t*>(framed)[base + i];
      } else {
        s_raw[i] = mulaw_expand(
            (float)static_cast<const int8_t*>(framed)[base + i], 1.0f / 127.0f);
      }
    }
  }
  __syncthreads();

  // both power spectra; a thread owns (window, bin) pairs
  const float inv_norm = 1.0f / 32768.0f;
  for (int p = tid; p < rows * n_freqs; p += blockDim.x) {
    const int w = p / n_freqs;
    const int k = p - w * n_freqs;
    const float* x = s_raw + w * window;
    float re_m = 0.f, im_m = 0.f, re_p = 0.f, im_p = 0.f;
    int idx = 0;  // (t * k) mod window
    for (int t = 0; t < window; ++t) {
      const float xn = x[t] * inv_norm;
      const float xh = xn * s_hann[t];
      const float c = s_cos[idx];
      const float s = s_sin[idx];
      re_m = fmaf(xh, c, re_m);
      im_m = fmaf(xh, s, im_m);
      re_p = fmaf(xn, c, re_p);
      im_p = fmaf(xn, s, im_p);
      idx += k;
      if (idx >= window) idx -= window;
    }
    s_pm[p] = re_m * re_m + im_m * im_m;
    s_pp[p] = re_p * re_p + im_p * im_p;
  }
  __syncthreads();

  for (int p = tid; p < rows * kMels; p += blockDim.x) {
    const int w = p / kMels;
    const int m = p - w * kMels;
    const float* pw = s_pm + w * n_freqs;
    float acc = 0.f;
    for (int f = 0; f < n_freqs; ++f) acc = fmaf(pw[f], s_mel[f * kMels + m], acc);
    logmel[(size_t)(row0 + w) * kMels + m] = logf(acc + 1e-6f);
  }
  for (int p = tid; p < rows * kBands; p += blockDim.x) {
    const int w = p / kBands;
    const int b = p - w * kBands;
    const float* pw = s_pp + w * n_freqs;
    float acc = 0.f;
    for (int f = br.lo[b]; f < br.hi[b]; ++f) acc += pw[f];
    bands[(size_t)(row0 + w) * kBands + b] = acc;
  }
  for (int w = tid; w < rows; w += blockDim.x) {
    const float* x = s_raw + w * window;
    float acc = 0.f;
    for (int t = 0; t < window; ++t) acc = fmaf(x[t], x[t], acc);
    total[row0 + w] = acc / (float)window;
  }
}

template <int WIRE>
cudaError_t launch(const void* framed, int n_windows, int window, int n_freqs,
                   const float* consts, const BandRanges& br, float* logmel,
                   float* bands, float* total, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * window + n_freqs * kMels +
                                       kTile * window + 2 * kTile * n_freqs);
  cudaError_t err = cudaFuncSetAttribute(
      frontend_kernel<WIRE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_windows + kTile - 1) / kTile);
  frontend_kernel<WIRE><<<grid, kThreads, smem, stream>>>(
      framed, n_windows, window, n_freqs, consts, br, logmel, bands, total);
  return cudaGetLastError();
}

}  // namespace

// Launches the frontend on `stream`; returns a cudaError_t code (0 = ok).
// consts: float32 [3*window + n_freqs*40] = cos | sin | hann | mel filterbank
// ([n_freqs, 40] row-major). band_lo_hi: host int[12], 6 first bins then 6
// end bins. Outputs are float32 [n_windows, 40], [n_windows, 6], [n_windows].
extern "C" int ffs_frontend_launch(const void* framed, int wire, int n_windows,
                                   int window, int n_freqs, const float* consts,
                                   const int* band_lo_hi, float* logmel,
                                   float* bands, float* total, void* stream) {
  if (n_windows <= 0) return (int)cudaSuccess;
  BandRanges br;
  for (int b = 0; b < kBands; ++b) {
    br.lo[b] = band_lo_hi[b];
    br.hi[b] = band_lo_hi[kBands + b];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wire) {
    case kWireI16:
      return (int)launch<kWireI16>(framed, n_windows, window, n_freqs, consts,
                                   br, logmel, bands, total, s);
    case kWireMulaw:
      return (int)launch<kWireMulaw>(framed, n_windows, window, n_freqs,
                                     consts, br, logmel, bands, total, s);
    case kWireMulaw6:
      if (window % 4 != 0) return (int)cudaErrorInvalidValue;
      return (int)launch<kWireMulaw6>(framed, n_windows, window, n_freqs,
                                      consts, br, logmel, bands, total, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ffs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
