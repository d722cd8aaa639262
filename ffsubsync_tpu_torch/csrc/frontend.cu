// Fused audio frontend for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel ffsubsync_tpu/ops/pallas/frontend.py::
// _frontend_kernel (launched by _frontend_call, wrapped by fused_frontend).
// Per 10 ms window of framed PCM it emits:
//
//   - 40 log-mel values: Hann window -> real DFT -> power -> mel -> log(x+1e-6)
//   - 6 webrtc sub-band powers: real DFT (no window) -> power -> sum over the
//     contiguous bin range of each band
//   - total power: sum(x^2) / window, at raw int16 scale
//
// What bounds it. At the 12 kHz tier (window W = 120, F = 61 bins) a
// 45-minute chunk is [270000, 120] int8 in and [270000, 47] f32 out: 83 MB,
// 25 us at 3.35 TB/s. The work the function needs as a DFT (one real DFT
// of F bins, since the Hann spectrum follows from the plain one; the mel
// filters' nonzero weights; powers, bands, logs and the total) is 8.3
// GFLOP: 0.124 ms on the CUDA cores' 67 TFLOP/s of float32
// (chip_smoke.frontend_bounds). So the work, not the memory, bounds it,
// and the tensor cores are the way below that bound. (An FFT would need
// fewer operations still, down to the byte floor.)
//
// Design:
//   - One DFT on the tensor cores. The Hann window is periodic
//     (0.5 - 0.5 cos(2 pi t / W)), so the windowed spectrum follows from the
//     plain one: Xh[k] = 0.5 X[k] - 0.25 (X[k-1] + X[k+1]), with
//     X[-1] = conj X[1] and X[F] = conj X[W-F]. One product [rows, W] x
//     [W, N] against a cos | sin basis (/32768 folded in, N = 2F padded)
//     gives both power spectra, half the TPU kernel's two products.
//   - float32 accuracy from TF32 tensor cores (3xTF32): each operand is
//     split into hi = tf32(x) and lo = tf32(x - hi), and hi*hi + hi*lo +
//     lo*hi accumulate in f32 on mma.sync.m16n8k8.tf32. One TF32 pass
//     (~5e-4 relative per operand) would put weak bins of loud frames out
//     of the bands' tolerance. The basis arrives split on the host
//     (ops/frontend.py) in the order of the mma fragments; the samples are
//     split in registers at fragment load. 3 x 2 x 270000 x 120 x 128 =
//     24.9 GFLOP of TF32 at the 12 kHz tier.
//   - Decode in the load, overlapped: the wire bytes of the next tile
//     (int16, mu-law int8 [T, W] or packed 6-bit mu-law [T, 3W/4], whose
//     silence is code 31) stream into shared memory by cp.async while the
//     current tile runs; a persistent grid of about one block per SM walks
//     the tiles. The decode (a 256-entry table for the mu-law codes)
//     writes the samples in A-fragment order and sums x^2 per row. The
//     DFT's sum over samples is order-free, so a lane's two fragment
//     columns are made adjacent samples (2tig, 2tig + 1 of each k-step; the
//     basis rows follow): one 16-bit (mu-law) or 32-bit (int16) load gives
//     both, where the window is even.
//   - Epilogue from shared memory: the accumulators go to a [rows, N]
//     buffer (aliasing the samples when one pass over N suffices). Threads
//     sweep each row's bins once: the plain power into the 6 band sums
//     (their bin ranges), the Hann power from the identity written in
//     place. Then each thread keeps one mel filter's weights in registers
//     and sums only its nonzero bins (a triangle: at most 2 filters per
//     bin, ~2F multiply-adds per window instead of 40F), two rows at a
//     time, unrolled to the widest filter of the table (6 bins at 12 kHz),
//     and takes log(x + 1e-6) with the fast __logf (absolute error <= 2^-21
//     near 1, 3 ulp elsewhere, far inside the log-mel tolerance 2e-3). The
//     total power sums x^2 in the decode. All f32 on the CUDA cores. (On
//     the H100, a mel product on the tensor cores, 3xTF32, with the total
//     by Parseval ran slower, and so did band sums taken out of the sweep.)
//   - Shared memory at the 12 kHz tier with the int8 wire: the split basis
//     (120 x 128 x 8 B = 123 KB) stays resident; 128 rows of samples or
//     spectra (70 KB), two raw tiles (31 KB) and the tables make 227,344 B
//     of the 232,448 a block may use. Wider windows, or the int16 wire,
//     take fewer rows per tile; where the basis does not fit (W >= 160) it
//     is read from global memory, where it stays in L2. choose_config
//     picks the shape; ffs_frontend_config tells the caller the basis
//     width to build.
//   - Where the time goes (H100, 45-minute chunk, PERF.md): ~0.1 ms is the
//     3xTF32 product at mma.sync's rate; decode, sweep and mel sums run in
//     turn with it, one block of 8 warps per SM, and take about as much
//     again.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kMels = 40;
constexpr int kBands = 6;
constexpr int kMelThreads = kThreads / kMels * kMels;  // rows x 40 filters at a time
constexpr int kMaxMelBins = 12;  // mel weights a thread keeps in registers
constexpr int kMaxMelWeights = 512;  // 2 filters per bin, F <= 256
constexpr float kMulawScale = 32768.0f / 255.0f;

enum Wire { kWireI16 = 0, kWireMulaw = 1, kWireMulaw6 = 2 };

// Mel runs, band ranges and mel weights (ops/frontend._kernel_consts lays
// them out in a device buffer); copied to shared memory.
struct Tables {
  int mel_lo[kMels];   // first nonzero bin of each mel filter
  int mel_hi[kMels];   // one past the last
  int mel_off[kMels];  // its first weight in mel_w
  int band_lo[kBands];
  int band_hi[kBands];
  float mel_w[kMaxMelWeights];
};

struct Params {
  const uint8_t* framed;
  int wire, n_windows, window, kp, n_freqs, n_cols, row_bytes, n_tiles;
  const float4* basis;  // [kp/8][n_cols/8][32 lanes] (hi0, hi1, lo0, lo1)
  float* logmel;
  float* bands;
  float* total;
  const int* tables;  // struct Tables
};

// mu-law expansion of a signed code c in [-levels, levels] to int16 scale
// (ops/frontend.mulaw_decode / unpack_mulaw6 are the plain versions).
__device__ __forceinline__ float mulaw_expand(float c, float inv_levels) {
  const float mag = fabsf(c) * inv_levels;
  const float sign = (c > 0.f) ? 1.f : ((c < 0.f) ? -1.f : 0.f);
  return sign * kMulawScale * (exp2f(mag * 8.0f) - 1.0f);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One sample of a raw tile at int16 scale (0 past the window: K padding).
__device__ __forceinline__ float sample(const uint8_t* raw, const float* lut,
                                        int wire, int row_bytes, int window,
                                        int r, int c) {
  if (c >= window) return 0.f;
  const uint8_t* row = raw + r * row_bytes;
  if (wire == kWireI16) {
    return (float)reinterpret_cast<const int16_t*>(row)[c];
  }
  if (wire == kWireMulaw) return lut[row[c]];
  const uint8_t* b = row + 3 * (c >> 2);  // 4 codes per 3 bytes
  int u;
  switch (c & 3) {
    case 0: u = b[0] >> 2; break;
    case 1: u = ((b[0] & 3) << 4) | (b[1] >> 4); break;
    case 2: u = ((b[1] & 15) << 2) | (b[2] >> 6); break;
    default: u = b[2] & 63; break;
  }
  return lut[u];
}

// log(x + 1e-6) of one mel filter's sums over rows r, r + kStep, ... of the
// Hann power: x is the filter's first bin in row 0, n its bins, w its
// weights; two rows at a time, NB weights in registers (the rest, for a
// filter wider than NB, read from shared memory).
template <int NB>
__device__ __forceinline__ void mel_sums(const float* x, int xs, int n, const float* w,
                                         int r, int rows, float* out) {
  constexpr int kStep = kMelThreads / kMels;
  float wr[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) wr[k] = k < n ? w[k] : 0.f;
  for (; r < rows; r += 2 * kStep) {
    const int r1 = r + kStep;
    const float* x0 = x + r * xs;
    const float* x1 = x + min(r1, rows - 1) * xs;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      if (k < n) {
        a0 = fmaf(x0[k], wr[k], a0);
        a1 = fmaf(x1[k], wr[k], a1);
      }
    }
    for (int k = NB; k < n; ++k) {
      a0 = fmaf(x0[k], w[k], a0);
      a1 = fmaf(x1[k], w[k], a1);
    }
    out[(size_t)r * kMels] = __logf(a0 + 1e-6f);
    if (r1 < rows) out[(size_t)r1 * kMels] = __logf(a1 + 1e-6f);
  }
}

// Shared memory of one configuration, in bytes.
inline size_t smem_bytes(int rows, int kp, int n_cols, int passes,
                         int row_bytes, bool resident) {
  const size_t basis = resident ? (size_t)kp * n_cols * 8 : 0;
  const size_t a = (size_t)rows * kp * 4;
  const size_t x = (size_t)rows * (n_cols + 8) * 4;
  const size_t ax = passes == 1 ? (a > x ? a : x) : a + x;
  const size_t raw = 2 * (((size_t)rows * row_bytes + 15) / 16 * 16);
  const size_t part = kWarps * 16 * 4;  // partial sums of x^2: decode warps x rows
  const size_t lut = 256 * 4;
  const size_t tab = (sizeof(Tables) + 15) / 16 * 16;
  return basis + ax + raw + part + lut + tab;
}

// R rows per tile, WN columns per warp and pass, RESIDENT: the basis is
// copied to shared memory once per block.
template <int R, int WN, bool RESIDENT>
__global__ void __launch_bounds__(kThreads, 1) frontend_kernel(const Params p) {
  constexpr int MT = R / 16;            // 16-row mma tiles per tile
  constexpr int WPM = kWarps / MT;      // decode warps per mma row tile
  constexpr int WARPS_M = R / 32;       // each warp: 32 rows (2 mma tiles)
  constexpr int WARPS_N = kWarps / WARPS_M;
  constexpr int NTW = WN / 8;           // 8-column mma tiles per warp
  constexpr int TPR = kThreads / R;     // epilogue threads per row
  static_assert(R % 32 == 0 && R <= 128 && WN % 8 == 0, "tile shape");

  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int KS = p.kp / 8, NT = p.n_cols / 8, F = p.n_freqs, W = p.window;
  const int passes = p.n_cols / (WARPS_N * WN);
  const int xs = p.n_cols + 8;  // spectrum row stride: conflict-free float2

  // carve shared memory (every piece a multiple of 16 bytes)
  size_t off = RESIDENT ? (size_t)p.kp * p.n_cols * 8 : 0;
  float4* s_basis = reinterpret_cast<float4*>(smem);
  float* s_a = reinterpret_cast<float*>(smem + off);
  float* s_x = passes == 1 ? s_a : s_a + R * p.kp;
  const size_t a_bytes = (size_t)R * p.kp * 4, x_bytes = (size_t)R * xs * 4;
  off += passes == 1 ? (a_bytes > x_bytes ? a_bytes : x_bytes) : a_bytes + x_bytes;
  const int raw_tile = R * p.row_bytes;
  const int raw_stride = (raw_tile + 15) / 16 * 16;
  uint8_t* s_raw = smem + off;
  off += 2 * (size_t)raw_stride;
  float* s_part = reinterpret_cast<float*>(smem + off);
  off += kWarps * 16 * 4;
  float* s_lut = reinterpret_cast<float*>(smem + off);
  off += 256 * 4;
  Tables* s_tab = reinterpret_cast<Tables*>(smem + off);

  const size_t total_bytes = (size_t)p.n_windows * p.row_bytes;
  // raw bytes of `tile` into buffer `buf`, 16 bytes per cp.async; the
  // ragged end of the input is read with a shorter source size
  auto issue = [=](int tile, int buf) {
    if (tile < p.n_tiles) {
      const size_t start = (size_t)tile * raw_tile;
      const size_t left = total_bytes - start;
      const int valid = left < (size_t)raw_tile ? (int)left : raw_tile;
      uint8_t* dst = s_raw + buf * raw_stride;
      for (int c = tid * 16; c < valid; c += kThreads * 16) {
        cp_async16(dst + c, p.framed + start + c, min(16, valid - c));
      }
    }
    cp_async_commit();
  };
  // the basis (if resident) and the tables join the first tile's group
  if (RESIDENT) {
    for (int i = tid; i < KS * NT * 32; i += kThreads) cp_async16(s_basis + i, p.basis + i, 16);
  }
  for (int i = tid * 4; i < (int)(sizeof(Tables) / 4); i += kThreads * 4) {
    cp_async16(reinterpret_cast<int*>(s_tab) + i, p.tables + i, 16);
  }
  issue(blockIdx.x, 0);
  for (int i = tid; i < 256; i += kThreads) {
    if (p.wire == kWireMulaw) {
      s_lut[i] = mulaw_expand((float)(int8_t)i, 1.0f / 127.0f);
    } else if (p.wire == kWireMulaw6) {
      s_lut[i] = i < 64 ? mulaw_expand((float)(i - 31), 1.0f / 31.0f) : 0.f;
    }
  }

  const float4* basis = RESIDENT ? s_basis : p.basis;
  float4* afrag = reinterpret_cast<float4*>(s_a);
  int buf = 0;
  int mel_max = -1;  // the widest mel filter, in bins (once the tables are in)
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, buf ^= 1) {
    issue(tile + gridDim.x, buf ^ 1);
    cp_async_wait<1>();
    __syncthreads();  // this tile's bytes (and, first time, the tables) are in
    const int row0 = tile * R;
    const int rows = min(R, p.n_windows - row0);
    if (mel_max < 0) {
      for (int m = 0; m < kMels; ++m) mel_max = max(mel_max, s_tab->mel_hi[m] - s_tab->mel_lo[m]);
    }

    // decode into A-fragment order: lane (g, tig) of m-tile mt and k-step
    // ks holds rows (g, g+8) x fragment columns (tig, tig+4), as mma's
    // a0..a3, which are samples 8ks + 2tig and 8ks + 2tig + 1
    {
      const uint8_t* raw = s_raw + buf * raw_stride;
      const int mt = warp % MT, kg = warp / MT;
      const int r0 = mt * 16 + g, r1 = r0 + 8;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll 4
      for (int ks = kg; ks < KS; ks += WPM) {
        const int c0 = ks * 8 + 2 * tig, c1 = c0 + 1;
        float v00, v10, v01, v11;
        if (p.wire == kWireMulaw && !(W & 1)) {  // even rows: 2-byte aligned pairs
          const uint32_t u0 = c0 < W ? *reinterpret_cast<const uint16_t*>(raw + r0 * W + c0) : 0u;
          const uint32_t u1 = c0 < W ? *reinterpret_cast<const uint16_t*>(raw + r1 * W + c0) : 0u;
          v00 = s_lut[u0 & 255];
          v01 = s_lut[u0 >> 8];
          v10 = s_lut[u1 & 255];
          v11 = s_lut[u1 >> 8];
        } else if (p.wire == kWireI16 && !(W & 1)) {  // 4-byte aligned pairs
          const short2 zero = make_short2(0, 0);
          const short2 u0 = c0 < W ? *reinterpret_cast<const short2*>(raw + r0 * 2 * W + 2 * c0) : zero;
          const short2 u1 = c0 < W ? *reinterpret_cast<const short2*>(raw + r1 * 2 * W + 2 * c0) : zero;
          v00 = (float)u0.x;
          v01 = (float)u0.y;
          v10 = (float)u1.x;
          v11 = (float)u1.y;
        } else {
          v00 = sample(raw, s_lut, p.wire, p.row_bytes, W, r0, c0);
          v10 = sample(raw, s_lut, p.wire, p.row_bytes, W, r1, c0);
          v01 = sample(raw, s_lut, p.wire, p.row_bytes, W, r0, c1);
          v11 = sample(raw, s_lut, p.wire, p.row_bytes, W, r1, c1);
        }
        afrag[(mt * KS + ks) * 32 + lane] = make_float4(v00, v10, v01, v11);
        sum0 = fmaf(v00, v00, fmaf(v01, v01, sum0));
        sum1 = fmaf(v10, v10, fmaf(v11, v11, sum1));
      }
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
      if (tig == 0) {
        s_part[kg * R + r0] = sum0;
        s_part[kg * R + r1] = sum1;
      }
    }
    __syncthreads();

    // [rows, kp] x [kp, n_cols] in 3xTF32, one pass per WARPS_N * WN columns
    const int wm = warp % WARPS_M, wn = warp / WARPS_M;
    const int mt0 = wm * 2;
    for (int pass = 0; pass < passes; ++pass) {
      const int nt0 = (pass * WARPS_N + wn) * NTW;
      float acc[2][NTW][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float4 v = afrag[((mt0 + i) * KS + ks) * 32 + lane];
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ahi[i][e] = to_tf32(vs[e]);
            alo[i][e] = to_tf32(vs[e] - __uint_as_float(ahi[i][e]));
          }
        }
        float4 b[NTW];  // (hi, hi, lo, lo) of each column tile
#pragma unroll
        for (int j = 0; j < NTW; ++j) b[j] = basis[(ks * NT + nt0 + j) * 32 + lane];
        // three sweeps of 2 x NTW independent products, so that no mma
        // waits on the one before it: the small terms first
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma_tf32(acc[i][j], alo[i], __float_as_uint(b[j].x), __float_as_uint(b[j].y));
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma_tf32(acc[i][j], ahi[i], __float_as_uint(b[j].z), __float_as_uint(b[j].w));
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma_tf32(acc[i][j], ahi[i], __float_as_uint(b[j].x), __float_as_uint(b[j].y));
      }
      if (passes == 1) __syncthreads();  // s_x aliases the samples
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = (mt0 + i) * 16 + g;
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int col = (nt0 + j) * 8 + 2 * tig;
          *reinterpret_cast<float2*>(&s_x[r * xs + col]) =
              make_float2(acc[i][j][0], acc[i][j][1]);
          *reinterpret_cast<float2*>(&s_x[(r + 8) * xs + col]) =
              make_float2(acc[i][j][2], acc[i][j][3]);
        }
      }
    }
    __syncthreads();

    // epilogue, step 1: row x = [C_0 .. C_{F-1} | S_0 .. S_{F-1}], X = C - iS.
    // TPR threads per row sweep contiguous runs of bins: the plain power
    // into the band sums, the Hann power (the identity) written over C_k.
    // The two neighbours just outside a run are read before the barrier.
    {
      const int r = tid / TPR, part = tid % TPR;
      const int chunk = (F + TPR - 1) / TPR;
      const int k0 = min(F, part * chunk), k1 = min(F, k0 + chunk);
      float* xr = s_x + r * xs;
      float pc = 0.f, ps = 0.f, nc = 0.f, ns = 0.f;  // X[k0 - 1], X[k1]
      if (k0 < k1) {
        const int km = k0 == 0 ? 1 : k0 - 1;  // X[-1] = conj X[1]
        pc = xr[km];
        ps = k0 == 0 ? -xr[F + km] : xr[F + km];
        const int kn = k1 == F ? W - F : k1;  // X[F] = conj X[W - F]
        nc = xr[kn];
        ns = k1 == F ? -xr[F + kn] : xr[F + kn];
      }
      if (tid < rows) {  // the total power: the decode's partial sums of x^2
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < WPM; ++j) t += s_part[j * R + tid];
        p.total[row0 + tid] = t / (float)W;
      }
      __syncthreads();
      int blo[kBands], bhi[kBands];
      float band[kBands];
#pragma unroll
      for (int b = 0; b < kBands; ++b) {
        blo[b] = s_tab->band_lo[b];
        bhi[b] = s_tab->band_hi[b];
        band[b] = 0.f;
      }
      if (k0 < k1) {
        float cc = xr[k0], cs = xr[F + k0];
        for (int k = k0; k < k1; ++k) {
          const bool last = k + 1 == k1;
          const float xc = last ? nc : xr[k + 1], xsn = last ? ns : xr[F + k + 1];
          const float ch = 0.5f * cc - 0.25f * (pc + xc);
          const float sh = 0.5f * cs - 0.25f * (ps + xsn);
          const float pw = fmaf(cc, cc, cs * cs);
#pragma unroll
          for (int b = 0; b < kBands; ++b) {
            if (k >= blo[b] && k < bhi[b]) band[b] += pw;
          }
          xr[k] = fmaf(ch, ch, sh * sh);
          pc = cc;
          ps = cs;
          cc = xc;
          cs = xsn;
        }
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) {
#pragma unroll
        for (int b = 0; b < kBands; ++b) band[b] += __shfl_xor_sync(0xffffffffu, band[b], o);
      }
      if (part == 0 && r < rows) {
#pragma unroll
        for (int b = 0; b < kBands; ++b) p.bands[(size_t)(row0 + r) * kBands + b] = band[b];
      }
    }
    __syncthreads();

    // step 2: each of the first kMelThreads threads keeps one mel filter
    // (its weights in registers) and sums its bins of the Hann power, row
    // after row
    if (tid < kMelThreads) {
      const int m = tid % kMels;
      const int lo = s_tab->mel_lo[m], n = s_tab->mel_hi[m] - lo;
      const float* w = s_tab->mel_w + s_tab->mel_off[m];
      float* out = p.logmel + (size_t)row0 * kMels + m;
      if (mel_max <= 4) {
        mel_sums<4>(s_x + lo, xs, n, w, tid / kMels, rows, out);
      } else if (mel_max <= 8) {
        mel_sums<8>(s_x + lo, xs, n, w, tid / kMels, rows, out);
      } else {
        mel_sums<kMaxMelBins>(s_x + lo, xs, n, w, tid / kMels, rows, out);
      }
    }
  }
  cp_async_wait<0>();
}

template <int R, int WN, bool RESIDENT>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = frontend_kernel<R, WN, RESIDENT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = p.n_tiles < sms * per_sm ? p.n_tiles : sms * per_sm;  // persistent
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const Params&, size_t, cudaStream_t);

// The tile shapes, in order of preference: rows per tile, basis columns per
// warp and pass, and the instantiation with the basis resident or not.
struct Shape {
  int rows, warp_cols;
  LaunchFn resident, streamed;
};
constexpr Shape kShapes[] = {
    {128, 64, launch<128, 64, true>, launch<128, 64, false>},
    {128, 32, launch<128, 32, true>, launch<128, 32, false>},
    {64, 64, launch<64, 64, true>, launch<64, 64, false>},
    {64, 32, launch<64, 32, true>, launch<64, 32, false>},
    {32, 64, launch<32, 64, true>, launch<32, 64, false>},
};

struct Config {
  const Shape* shape;
  int n_cols;  // the cos | sin basis width, 2 * n_freqs padded to a pass
  bool resident;
  size_t smem;
};

int row_bytes_of(int wire, int window) {
  if (wire == kWireI16) return 2 * window;
  if (wire == kWireMulaw) return window;
  if (wire == kWireMulaw6 && window % 4 == 0) return window * 3 / 4;
  return -1;
}

// The first shape whose block fits the current device's shared memory,
// with the basis resident if any fits so, else read from global memory.
cudaError_t choose_config(int window, int wire, Config* c) {
  const int row_bytes = row_bytes_of(wire, window);
  if (row_bytes < 0 || window < 2 || window / 2 + 1 > 256) return cudaErrorInvalidValue;
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const int kp = (window + 7) / 8 * 8, cols = 2 * (window / 2 + 1);
  for (int pass = 0; pass < 2; ++pass) {
    const bool resident = pass == 0;
    for (const Shape& s : kShapes) {
      const int per_pass = kWarps / (s.rows / 32) * s.warp_cols;
      const int n_cols = (cols + per_pass - 1) / per_pass * per_pass;
      const size_t smem = smem_bytes(s.rows, kp, n_cols, n_cols / per_pass, row_bytes, resident);
      if (smem <= (size_t)limit) {
        *c = Config{&s, n_cols, resident, smem};
        return cudaSuccess;
      }
    }
  }
  return cudaErrorInvalidConfiguration;
}

}  // namespace

// The configuration the kernel takes for `window` and `wire` on the
// current device: out = {rows per tile, basis columns per warp and pass,
// n_cols (the width the basis must be built at), resident basis (0 or 1),
// shared memory bytes per block}. Returns a cudaError_t code (0 = ok).
extern "C" int ffs_frontend_config(int window, int wire, int* out) {
  Config c;
  const cudaError_t err = choose_config(window, wire, &c);
  if (err != cudaSuccess) return (int)err;
  out[0] = c.shape->rows;
  out[1] = c.shape->warp_cols;
  out[2] = c.n_cols;
  out[3] = c.resident ? 1 : 0;
  out[4] = (int)c.smem;
  return (int)cudaSuccess;
}

// Launches the frontend on `stream`; returns a cudaError_t code (0 = ok).
// basis: device float4 [kp/8][n_cols/8][32], the tf32 hi/lo split of the
// cos | sin basis in mma B-fragment order, built at the n_cols that
// ffs_frontend_config gives (anything else is refused). tables: device
// int32, struct Tables (mel lo, hi and offset, 40 each; band lo and hi, 6
// each; then kMaxMelWeights float weights). Outputs are float32
// [n_windows, 40], [n_windows, 6], [n_windows].
extern "C" int ffs_frontend_launch(const void* framed, int wire, int n_windows,
                                   int window, int n_cols, const void* basis,
                                   const void* tables, float* logmel,
                                   float* bands, float* total, void* stream) {
  if (n_windows <= 0) return (int)cudaSuccess;
  Config c;
  const cudaError_t err = choose_config(window, wire, &c);
  if (err != cudaSuccess) return (int)err;
  if (n_cols != c.n_cols || (reinterpret_cast<uintptr_t>(framed) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.framed = static_cast<const uint8_t*>(framed);
  p.wire = wire;
  p.n_windows = n_windows;
  p.window = window;
  p.kp = (window + 7) / 8 * 8;
  p.n_freqs = window / 2 + 1;
  p.n_cols = n_cols;
  p.row_bytes = row_bytes_of(wire, window);
  p.n_tiles = (n_windows + c.shape->rows - 1) / c.shape->rows;
  p.basis = static_cast<const float4*>(basis);
  p.logmel = logmel;
  p.bands = bands;
  p.total = total;
  p.tables = static_cast<const int*>(tables);
  const LaunchFn fn = c.resident ? c.shape->resident : c.shape->streamed;
  return (int)fn(p, c.smem, static_cast<cudaStream_t>(stream));
}

extern "C" const char* ffs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
