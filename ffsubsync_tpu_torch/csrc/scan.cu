// Inclusive scans along dim 0 for Hopper (sm_90a), bound to Python with
// ctypes.
//
// Replaces the XLA scans of ffsubsync_tpu/ops/vad.py::_webrtc_from_bands,
// every one a call of _blocked_scan (the two-level associative scan of
// _SCAN_BLOCK = 4096 rows): the EMA's affine recurrence, the noise floor's
// running minimum, the four prefix sums of the flux and modulation boxes,
// and the hangover's running max and reverse running min. The same calls
// run per shard in the sequence-parallel detector (parallel/vad_shard.py).
//
// What it computes: y[i, c] = x[0, c] o x[1, c] o ... o x[i, c] for a
// row-major [n, C] tensor, with o one of
//   - add (float32), min and max (float32 or int32);
//   - the affine pair (a, b) o (a', b') = (a a', a' b + b'), the
//     composition of y -> a y + b then y -> a' y + b' (float32; the
//     reference's _affine), read from and written to two [n, C] tensors;
// and optionally in reverse (y[i] = x[i] o ... o x[n - 1], for min and max:
// the hangover's flipped scan without the two flips).
//
// What bounds it. Each scan reads its input once and writes its output
// once; per 45-minute chunk (270,000 windows) the detector's eight scans
// move about 60 MB, 18 us at 3.35 TB/s, and do one or three float
// operations per element. So bytes bound it, far below the time the host
// takes to launch the rest of the detector; the design aims at a short,
// correct launch sequence, not at the byte bound.
//
// Design. A block cannot hand a carry to the next (blocks run in no order),
// so the scan takes two levels, those of the reference's _blocked_scan:
//   1. scan_tiles<..., kReduce>: each block scans one tile of 4096 logical
//      rows (1024 threads x 4 consecutive rows) and writes the tile's last
//      local value, its total;
//   2. scan_totals: one block scans the tile totals in place (in steps of
//      4096, each step seeded with the last one's total);
//   3. scan_tiles<..., kApply>: each block scans its tile again and
//      combines the earlier tiles' total with each local value.
// A sequence of one tile takes step 3 alone. Within a tile, each thread
// scans its 4 rows in order, a warp scans its 32 thread totals by
// shuffles (Kogge-Stone), warp 0 scans the 32 warp totals the same way,
// and each row's local value is (warp prefix o lane prefix) o its thread
// value. The final value is (tile prefix) o (local value), the
// reference's order: a prefix sum over a long chunk adds a large tile
// prefix to a small local sum once, so box means taken as prefix
// differences within a tile round as the reference's do. Every float
// operation is explicitly rounded (__fadd_rn, __fmul_rn): nvcc contracts
// no multiply-add, so tests/test_torch_scan.py emulates the order bit for
// bit on the CPU. Columns are scanned one after the other by the same
// block (C is 1, 2 or 6 here), each thread reading its 4 rows of a column
// with stride C; the other columns' bytes of those lines wait in L1.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kRowsPerThread = 4;
constexpr int kTile = kThreads * kRowsPerThread;  // ffsubsync_tpu's _SCAN_BLOCK
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// ops/scan.py's _OPS: the codes the wrapper passes
enum OpCode { kAddF32 = 0, kMinF32 = 1, kMaxF32 = 2, kMinI32 = 3, kMaxI32 = 4, kAffineF32 = 5 };

struct Params {
  const void* x0;  // input [n, c] (the affine pair's a)
  const void* x1;  // the affine pair's b
  void* y0;        // output [n, c] (the affine pair's a)
  void* y1;        // the affine pair's b
  void* t0;        // tile totals [n_tiles, c] (the affine pair's a)
  void* t1;        // the affine pair's b
  long long n;
  int c;
  int reverse;
  int n_tiles;
};

template <class T>
struct Scalar {
  using V = T;
  __device__ static V load(const void* p0, const void*, long long i) {
    return static_cast<const T*>(p0)[i];
  }
  __device__ static void store(void* p0, void*, long long i, V v) { static_cast<T*>(p0)[i] = v; }
  __device__ static V shfl_up(V v, int d) { return __shfl_up_sync(kFull, v, d); }
};

struct AddF32 : Scalar<float> {
  // -0 is the exact identity of IEEE addition (x + -0 = x for x = +0 too)
  __device__ static float identity() { return -0.0f; }
  __device__ static float combine(float l, float r) { return __fadd_rn(l, r); }
};

// min and max propagate NaN, as torch.cummin and torch.cummax do
struct MinF32 : Scalar<float> {
  __device__ static float identity() { return INFINITY; }
  __device__ static float combine(float l, float r) { return (l < r || l != l) ? l : r; }
};

struct MaxF32 : Scalar<float> {
  __device__ static float identity() { return -INFINITY; }
  __device__ static float combine(float l, float r) { return (l > r || l != l) ? l : r; }
};

struct MinI32 : Scalar<int> {
  __device__ static int identity() { return INT32_MAX; }
  __device__ static int combine(int l, int r) { return r < l ? r : l; }
};

struct MaxI32 : Scalar<int> {
  __device__ static int identity() { return INT32_MIN; }
  __device__ static int combine(int l, int r) { return r > l ? r : l; }
};

struct AffineF32 {
  using V = float2;  // (a, b): y -> a y + b
  __device__ static V identity() { return make_float2(1.0f, -0.0f); }
  __device__ static V combine(V l, V r) {
    return make_float2(__fmul_rn(l.x, r.x), __fadd_rn(__fmul_rn(r.x, l.y), r.y));
  }
  __device__ static V load(const void* p0, const void* p1, long long i) {
    return make_float2(static_cast<const float*>(p0)[i], static_cast<const float*>(p1)[i]);
  }
  __device__ static void store(void* p0, void* p1, long long i, V v) {
    static_cast<float*>(p0)[i] = v.x;
    static_cast<float*>(p1)[i] = v.y;
  }
  __device__ static V shfl_up(V v, int d) {
    return make_float2(__shfl_up_sync(kFull, v.x, d), __shfl_up_sync(kFull, v.y, d));
  }
};

// Inclusive scan of one tile's column: v holds this thread's 4 consecutive
// rows on entry and their local inclusive values on exit. `warp_tot` is
// shared scratch of kWarps values; every thread of the block must call.
template <class Op>
__device__ void tile_scan(typename Op::V (&v)[kRowsPerThread], typename Op::V* warp_tot) {
  using V = typename Op::V;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 1; i < kRowsPerThread; ++i) v[i] = Op::combine(v[i - 1], v[i]);
  V incl = v[kRowsPerThread - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const V up = Op::shfl_up(incl, d);
    if (lane >= d) incl = Op::combine(up, incl);
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    V w = warp_tot[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const V up = Op::shfl_up(w, d);
      if (lane >= d) w = Op::combine(up, w);
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  V lane_excl = Op::shfl_up(incl, 1);
  if (lane == 0) lane_excl = Op::identity();
  const V warp_excl = warp == 0 ? Op::identity() : warp_tot[warp - 1];
  const V prefix = Op::combine(warp_excl, lane_excl);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) v[i] = Op::combine(prefix, v[i]);
  __syncthreads();  // warp_tot is reused by the next call
}

// physical row of logical row i
__device__ __forceinline__ long long phys(const Params& p, long long i) {
  return p.reverse ? p.n - 1 - i : i;
}

enum Pass { kReduce = 0, kApply = 1 };

// Steps 1 and 3: one block per tile of kTile logical rows.
template <class Op, int kPass>
__global__ void __launch_bounds__(kThreads) scan_tiles(Params p) {
  using V = typename Op::V;
  __shared__ V warp_tot[kWarps];
  const int tile = blockIdx.x;
  const long long row0 = (long long)tile * kTile + (long long)threadIdx.x * kRowsPerThread;
  for (int col = 0; col < p.c; ++col) {
    V v[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const long long r = row0 + i;
      v[i] = r < p.n ? Op::load(p.x0, p.x1, phys(p, r) * p.c + col) : Op::identity();
    }
    tile_scan<Op>(v, warp_tot);
    if (kPass == kReduce) {
      if (threadIdx.x == kThreads - 1) {
        Op::store(p.t0, p.t1, (long long)tile * p.c + col, v[kRowsPerThread - 1]);
      }
    } else {
      const V prefix =
          tile == 0 ? Op::identity() : Op::load(p.t0, p.t1, (long long)(tile - 1) * p.c + col);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const long long r = row0 + i;
        if (r < p.n) Op::store(p.y0, p.y1, phys(p, r) * p.c + col, Op::combine(prefix, v[i]));
      }
    }
  }
}

// Step 2: one block scans the [n_tiles, c] tile totals in place (inclusive).
template <class Op>
__global__ void __launch_bounds__(kThreads) scan_totals(Params p) {
  using V = typename Op::V;
  __shared__ V warp_tot[kWarps];
  __shared__ V carry;
  for (int col = 0; col < p.c; ++col) {
    if (threadIdx.x == 0) carry = Op::identity();
    __syncthreads();
    for (long long base = 0; base < p.n_tiles; base += kTile) {
      const long long row0 = base + (long long)threadIdx.x * kRowsPerThread;
      V v[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const long long r = row0 + i;
        v[i] = r < p.n_tiles ? Op::load(p.t0, p.t1, r * p.c + col) : Op::identity();
      }
      tile_scan<Op>(v, warp_tot);
      const V seed = carry;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const long long r = row0 + i;
        v[i] = Op::combine(seed, v[i]);
        if (r < p.n_tiles) Op::store(p.t0, p.t1, r * p.c + col, v[i]);
      }
      __syncthreads();  // every thread has read carry
      if (threadIdx.x == kThreads - 1) carry = v[kRowsPerThread - 1];
      __syncthreads();
    }
  }
}

template <class Op>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.n_tiles > 1) {
    scan_tiles<Op, kReduce><<<p.n_tiles, kThreads, 0, stream>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    scan_totals<Op><<<1, kThreads, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  scan_tiles<Op, kApply><<<p.n_tiles, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Rows per tile; the wrapper sizes the tile totals' buffer by it.
extern "C" int ffs_scan_tile_rows() { return kTile; }

// Scans x (x0, and x1 for the affine pair) into y on `stream`; `totals`
// (t0, t1) is scratch of ceil(n / tile) x c elements of the value type,
// unused when n fits one tile. Returns a cudaError_t code (0 = ok).
extern "C" int ffs_scan_launch(int op, int reverse, long long n, int c, const void* x0,
                               const void* x1, void* y0, void* y1, void* t0, void* t1,
                               void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long n_tiles = (n + kTile - 1) / kTile;
  if (c <= 0 || n_tiles > INT32_MAX || (reverse && op != kMinF32 && op != kMaxF32 &&
                                        op != kMinI32 && op != kMaxI32)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{x0, x1, y0, y1, t0, t1, n, c, reverse, (int)n_tiles};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAddF32: return (int)launch<AddF32>(p, s);
    case kMinF32: return (int)launch<MinF32>(p, s);
    case kMaxF32: return (int)launch<MaxF32>(p, s);
    case kMinI32: return (int)launch<MinI32>(p, s);
    case kMaxI32: return (int)launch<MaxI32>(p, s);
    case kAffineF32: return (int)launch<AffineF32>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
