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
// move 60.5 MB, 0.0181 ms at 3.35 TB/s, and do one or three float
// operations per element. So bytes bound it. A chunk is 66 tiles, half
// the card's 132 SMs with one tile each, so a launch costs its fixed
// latency (launch, claim, look-back) plus one tile's load, scan and store
// on each SM, all SMs moving their tiles at once.
//
// Why the tile stays 4096 rows (1024 threads x 4 consecutive rows). The
// order of the float operations is the reference's two levels: a prefix
// sum over a long chunk adds a large tile prefix to a small local sum
// once, so box means taken as prefix differences within a tile round as
// the reference's do. Within a tile each thread scans its 4 rows in order,
// a warp scans its 32 thread totals by shuffles (Kogge-Stone), one warp
// per column scans the 32 warp totals the same way, and each row's local
// value is (warp prefix o lane prefix) o its thread value. The final value
// is (tile prefix) o (local value), and the tile prefixes are the inclusive
// scan of the tile totals by the same tile scan, in steps of 4096 totals,
// each step seeded with the last one's carry. Every float operation is
// explicitly rounded (__fadd_rn, __fmul_rn): nvcc contracts no
// multiply-add, so tests/test_torch_scan.py emulates the order bit for bit
// on the CPU.
//
// The one-pass kernel (scan_one_pass; ffs_scan_launch): one launch per
// scan, one block per tile, the input read once.
//   1. A block takes its tile from an atomic counter in a workspace, not
//      from blockIdx.x: every tile it waits on below belongs to a block
//      that is already running, in whatever order the card starts blocks.
//      The counter is claimed with atomicInc, which wraps to 0 on the
//      launch's last claim, so the next launch on the stream starts clean
//      with no memset and no count of finished blocks.
//   2. Whole rows. A thread's 4 rows x C columns are one contiguous stretch
//      of 16 C bytes. One column is read and written with 16-byte loads
//      and stores straight from and to device memory: neighbouring threads
//      make a warp's accesses contiguous. At 2 and 6 columns the same
//      accesses lie 32 and 96 bytes apart, and on the card (one H100) the
//      6-column scans spent most of their time in them. So such a tile is
//      copied whole into shared memory by a 1D bulk copy (cp.async.bulk,
//      completing on an mbarrier: one thread issues it, no register holds
//      an address), each thread reads its stretch from there with 16-byte
//      loads, and the results go back there and leave in 16-byte pieces,
//      neighbouring threads on neighbouring addresses (a bulk copy out
//      measured no faster). A tile whose bytes are not 16-byte aligned (a
//      ragged edge of some lengths, an unaligned view) is read directly,
//      element by element where a stretch is not aligned. The widths are
//      the detector's, 1, 2 and 6, each an instantiation of its own. All C
//      columns are scanned together in registers: one set of shuffles per
//      column, one round of barriers per tile. The thread totals wait in
//      shared memory across the barriers, and the local values during the
//      look-back, so that registers hold one copy of the rows (the 6-column
//      affine pair still spills a little); the tile prefix is combined
//      with each value on its way out of shared memory.
//   3. Publish, then look back in a fixed order. After its local scan the
//      block publishes its tile total (all columns, both halves of an
//      affine pair): each value goes out as one 64-bit word with this
//      launch's epoch in its high half (st.relaxed.gpu). A 64-bit access is
//      single-copy atomic, so a reader that sees the epoch sees the value
//      beside it: the word is the tile's flag and its total at once, and
//      no fence or second read is needed (a flag and a total apart, with
//      release and acquire, took twice as long on the card). Warp j then
//      looks back for column j: each lane polls its (up to) 4 earlier
//      words (ld.relaxed.gpu) until every one holds the epoch. Each launch
//      takes a fresh epoch from the wrapper, so a word left by an earlier
//      launch never matches and nothing needs a reset. The warp scans the
//      earlier totals itself, in exactly the order of the two-level
//      route's scan_totals, treating the totals after its own predecessor
//      as the identity. In that order the value at position j depends on
//      positions 0..j only, so the prefix it takes is, bit for bit, the one
//      the two-level route computes. Decoupled look-back, which chains the
//      inclusive prefixes that happen to be published, would let the order
//      of publication decide the float32 rounding from run to run; with at
//      most a few hundred tiles on any path, reading every earlier total
//      costs little.
//
// The two-level route (scan_tiles, scan_totals; ffs_scan_launch_two_level)
// is the former design, kept as a yardstick only: chip_smoke.py and the
// cuda tests hold the one-pass kernel against it bit for bit and time the
// two. It takes three launches: scan_tiles<kReduce> writes each tile's
// total, scan_totals scans them on one block, scan_tiles<kApply> scans
// every tile again and combines the prefix.
//
// Left for later: spread a tile's 32 warps over a cluster of 2 blocks that
// exchange warp totals through distributed shared memory, in the same
// order, to use all 132 SMs; or group the independent scans of one
// detector program into one launch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace {

constexpr int kThreads = 1024;
constexpr int kRowsPerThread = 4;
constexpr int kTile = kThreads * kRowsPerThread;  // ffsubsync_tpu's _SCAN_BLOCK
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// the one-pass kernel: the most columns it takes (1, 2 or 6: the
// detector's widths), and the words of its workspace before the published
// tile totals (the tile counter, padding)
constexpr int kMaxCols = 6;
constexpr int kHeaderWords = 32;

#ifdef FFS_SCAN_PHASES
// scan_phases.py's instrumented build (never the port's): thread 0 of each
// block stamps clock64() as the block enters and as each phase ends (the
// claim, the load, the local scan, the look-back, the store), and the
// global timer at entry and exit, per tile: [entry, 5 phases, ns in, ns out]
constexpr int kPhaseTiles = 8192;
__device__ long long g_phases[kPhaseTiles][8];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE_START const long long phase_clock = clock64(), phase_ns = global_ns()
#define PHASE(tile, k)                                       \
  do {                                                       \
    if (threadIdx.x == 0 && (tile) < kPhaseTiles) {          \
      if ((k) == 1) g_phases[tile][0] = phase_clock;         \
      if ((k) == 1) g_phases[tile][6] = phase_ns;            \
      g_phases[tile][k] = clock64();                         \
      if ((k) == 5) g_phases[tile][7] = global_ns();         \
    }                                                        \
  } while (0)
#else
#define PHASE_START
#define PHASE(tile, k)
#endif

// ops/scan.py's _OPS: the codes the wrapper passes
enum OpCode { kAddF32 = 0, kMinF32 = 1, kMaxF32 = 2, kMinI32 = 3, kMaxI32 = 4, kAffineF32 = 5 };

template <class E>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<int> {
  using type = int4;
};

template <class E_>
struct Scalar {
  using E = E_;  // element type of the one array
  using V = E_;
  static constexpr int kArrays = 1;
  __device__ static V load(const void* p0, const void*, long long i) {
    return static_cast<const E*>(p0)[i];
  }
  __device__ static void store(void* p0, void*, long long i, V v) { static_cast<E*>(p0)[i] = v; }
  __device__ static V pack(E a, E) { return a; }
  __device__ static E part(V v, int) { return v; }
  // the value of a published word (its low half)
  __device__ static V unpack(unsigned long long a, unsigned long long) {
    const unsigned bits = static_cast<unsigned>(a);
    E e;
    memcpy(&e, &bits, sizeof(E));
    return e;
  }
  __device__ static V shfl_up(V v, int d) { return __shfl_up_sync(kFull, v, d); }
  __device__ static V shfl_idx(V v, int src) { return __shfl_sync(kFull, v, src); }
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
  using E = float;
  using V = float2;  // (a, b): y -> a y + b
  static constexpr int kArrays = 2;
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
  __device__ static V pack(float a, float b) { return make_float2(a, b); }
  __device__ static float part(V v, int k) { return k ? v.y : v.x; }
  __device__ static V unpack(unsigned long long a, unsigned long long b) {
    return make_float2(__uint_as_float(static_cast<unsigned>(a)),
                       __uint_as_float(static_cast<unsigned>(b)));
  }
  __device__ static V shfl_up(V v, int d) {
    return make_float2(__shfl_up_sync(kFull, v.x, d), __shfl_up_sync(kFull, v.y, d));
  }
  __device__ static V shfl_idx(V v, int src) {
    return make_float2(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src));
  }
};

// ---- the two-level route (the yardstick) ----

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
cudaError_t launch_two_level(const Params& p, cudaStream_t stream) {
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

// ---- the one-pass kernel ----

struct OnePass {
  const void* x0;  // input [n, c] (the affine pair's a)
  const void* x1;  // the affine pair's b
  void* y0;        // output [n, c] (the affine pair's a)
  void* y1;        // the affine pair's b
  // workspace of ffs_scan_workspace_words(cap_tiles) int32 words, zeroed
  // once: the tile counter, padding to kHeaderWords; then the published
  // tile totals, 64-bit words [cap_tiles, kMaxCols] (the affine pair's a)
  // and [cap_tiles, kMaxCols] (its b), each the launch's epoch in the
  // high half and the value's bits in the low half
  int* ws;
  long long n;
  int c;
  int reverse;
  int n_tiles;
  int cap_tiles;
  int epoch;  // stamped on the published totals, unique per workspace
};

// a published total: one 64-bit access, which is single-copy atomic, so a
// reader that sees this launch's epoch sees the value beside it
__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The tile scan of every column at once: v[r][j] holds this thread's row r
// of column j on entry and its local inclusive value on exit, in
// tile_scan's order for each column. `warp_tot` is shared scratch of
// [kWarps][kC]; every thread of the block must call; the caller
// synchronizes before warp_tot is written again. `park`, where given, is
// shared memory of kThreads x kC values that holds the thread totals
// across the barriers, so that registers hold one copy of the rows only.
template <class Op, int kC>
__device__ void tile_scan_cols(typename Op::V (&v)[kRowsPerThread][kC],
                               typename Op::V (*warp_tot)[kC], typename Op::V* park) {
  using V = typename Op::V;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  V incl[kC];
#pragma unroll
  for (int j = 0; j < kC; ++j) {
#pragma unroll
    for (int i = 1; i < kRowsPerThread; ++i) v[i][j] = Op::combine(v[i - 1][j], v[i][j]);
    incl[j] = v[kRowsPerThread - 1][j];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const V up = Op::shfl_up(incl[j], d);
      if (lane >= d) incl[j] = Op::combine(up, incl[j]);
    }
    if (lane == 31) warp_tot[warp][j] = incl[j];
    if (park) park[threadIdx.x * kC + j] = incl[j];
  }
  __syncthreads();
  // warp j scans column j's warp totals
  if (warp < kC) {
    V w = warp_tot[lane][warp];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const V up = Op::shfl_up(w, d);
      if (lane >= d) w = Op::combine(up, w);
    }
    warp_tot[lane][warp] = w;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    if (park) incl[j] = park[threadIdx.x * kC + j];
    V lane_excl = Op::shfl_up(incl[j], 1);
    if (lane == 0) lane_excl = Op::identity();
    const V warp_excl = warp == 0 ? Op::identity() : warp_tot[warp - 1][j];
    const V prefix = Op::combine(warp_excl, lane_excl);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) v[i][j] = Op::combine(prefix, v[i][j]);
  }
}

// ---- the memory operations of the one-pass kernel ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// a 1D bulk copy (the Tensor Memory Accelerator), global -> shared,
// completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// v[r][j] = logical row l0 + r, column j, of the row-major [n_rows, kC]
// arrays a (and b, for the affine pair), read forward or backward
// (logical row l at physical row n_rows - 1 - l); the identity past the
// end. The thread's 4 rows are one contiguous stretch of 16 kC bytes per
// array: a whole, aligned stretch is read with 16-byte loads, any other
// element by element.
template <class Op, int kC>
__device__ void load_stretch(const void* a, const void* b, long long n_rows, long long l0,
                             bool rev, typename Op::V (&v)[kRowsPerThread][kC]) {
  using E = typename Op::E;
  using Vec = typename Vec4<E>::type;
  const long long first = rev ? n_rows - kRowsPerThread - l0 : l0;
  const E* pa = static_cast<const E*>(a) + first * kC;
  const E* pb = Op::kArrays == 2 ? static_cast<const E*>(b) + first * kC : pa;
  if (l0 + kRowsPerThread <= n_rows && aligned16(pa) && aligned16(pb)) {
    E buf[Op::kArrays][kRowsPerThread * kC];
#pragma unroll
    for (int k = 0; k < Op::kArrays; ++k) {
      const Vec* src = reinterpret_cast<const Vec*>(k ? pb : pa);
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const Vec q = src[i];
        buf[k][4 * i] = q.x;
        buf[k][4 * i + 1] = q.y;
        buf[k][4 * i + 2] = q.z;
        buf[k][4 * i + 3] = q.w;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int fwd = r * kC + j, bwd = (kRowsPerThread - 1 - r) * kC + j;
        v[r][j] = Op::pack(rev ? buf[0][bwd] : buf[0][fwd],
                           rev ? buf[Op::kArrays - 1][bwd] : buf[Op::kArrays - 1][fwd]);
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const long long row = l0 + r;
    const long long ph = rev ? n_rows - 1 - row : row;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      v[r][j] = row < n_rows ? Op::load(a, b, ph * kC + j) : Op::identity();
    }
  }
}

// The rows of load_stretch, written back the same way.
template <class Op, int kC>
__device__ void store_stretch(void* a, void* b, long long n_rows, long long l0, bool rev,
                              const typename Op::V (&v)[kRowsPerThread][kC]) {
  using E = typename Op::E;
  using Vec = typename Vec4<E>::type;
  const long long first = rev ? n_rows - kRowsPerThread - l0 : l0;
  E* pa = static_cast<E*>(a) + first * kC;
  E* pb = Op::kArrays == 2 ? static_cast<E*>(b) + first * kC : pa;
  if (l0 + kRowsPerThread <= n_rows && aligned16(pa) && aligned16(pb)) {
#pragma unroll
    for (int k = 0; k < Op::kArrays; ++k) {
      Vec* dst = reinterpret_cast<Vec*>(k ? pb : pa);
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        E e[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // element 4 i + q of the stretch: physical row pr of the 4, column j
          const int pr = (4 * i + q) / kC, j = (4 * i + q) % kC;
          e[q] = Op::part(rev ? v[kRowsPerThread - 1 - pr][j] : v[pr][j], k);
        }
        Vec out;
        out.x = e[0];
        out.y = e[1];
        out.z = e[2];
        out.w = e[3];
        dst[i] = out;
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const long long row = l0 + r;
    const long long ph = rev ? n_rows - 1 - row : row;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      if (row < n_rows) Op::store(a, b, ph * kC + j, v[r][j]);
    }
  }
}

// The inclusive scan of one column's tile totals at position q, in
// scan_totals's order, by one warp; every lane returns it. The value at q
// depends on positions 0..q only, so the totals after q are taken as the
// identity and of tile_scan's 32 warps only those up to q's are formed:
// lane w of `wt` holds warp w's total, and q's warp, formed last, gives
// the lane and row values. Each lane polls its (up to) 4 published words
// (8 for the affine pair) at once until each holds this launch's epoch.
template <class Op, int kC>
__device__ typename Op::V look_back(const OnePass& p, int q, int col) {
  using V = typename Op::V;
  const int lane = threadIdx.x & 31;
  const unsigned long long* pub0 = reinterpret_cast<const unsigned long long*>(p.ws + kHeaderWords);
  const unsigned long long* pub1 = pub0 + (long long)p.cap_tiles * kMaxCols;
  const unsigned long long epoch = static_cast<unsigned long long>(p.epoch);
  V carry = Op::identity();
  for (int base = 0; base <= q; base += kTile) {
    const int target = min(q - base, kTile - 1);  // q, or the step's last total
    const int tw = target / (32 * kRowsPerThread);
    V wt = Op::identity();
    V s[kRowsPerThread];
    V incl;
    for (int w = 0; w <= tw; ++w) {
      // positions past q read q's word, then take the identity
      const int pos0 = base + (w * 32 + lane) * kRowsPerThread;
      for (;;) {
        bool ready = true;
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const long long at = (long long)min(pos0 + r, base + target) * kC + col;
          const unsigned long long wa = ld_relaxed(pub0 + at);
          const unsigned long long wb = Op::kArrays == 2 ? ld_relaxed(pub1 + at) : wa;
          ready &= (wa >> 32) == epoch && (wb >> 32) == epoch;
          s[r] = pos0 + r > base + target ? Op::identity() : Op::unpack(wa, wb);
        }
        if (ready) break;
        __nanosleep(20);
      }
#pragma unroll
      for (int i = 1; i < kRowsPerThread; ++i) s[i] = Op::combine(s[i - 1], s[i]);
      incl = s[kRowsPerThread - 1];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const V up = Op::shfl_up(incl, d);
        if (lane >= d) incl = Op::combine(up, incl);
      }
      const V total = Op::shfl_idx(incl, 31);
      if (w < tw && lane == w) wt = total;
    }
    V warp_excl = Op::identity();
    if (tw > 0) {
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const V up = Op::shfl_up(wt, d);
        if (lane >= d) wt = Op::combine(up, wt);
      }
      warp_excl = Op::shfl_idx(wt, tw - 1);
    }
    V lane_excl = Op::shfl_up(incl, 1);
    if (lane == 0) lane_excl = Op::identity();
    const V prefix = Op::combine(warp_excl, lane_excl);
    V value = s[0];
#pragma unroll
    for (int r = 1; r < kRowsPerThread; ++r) {
      if (r == target % kRowsPerThread) value = s[r];
    }
    value = Op::combine(carry, Op::combine(prefix, value));  // the step's seed o its value
    carry = Op::shfl_idx(value, (target / kRowsPerThread) % 32);
  }
  return carry;
}

// Dynamic shared memory of an instantiation: the staged tile, every array
// (2 or more columns; one column is read whole-row by each warp's 16-byte
// loads already).
template <class Op, int kC>
__host__ __device__ constexpr int stage_bytes() {
  return kC > 1 ? Op::kArrays * kTile * kC * (int)sizeof(typename Op::E) : 0;
}

template <class Op, int kC>
__global__ void __launch_bounds__(kThreads, 1) scan_one_pass(OnePass p) {
  using V = typename Op::V;
  using E = typename Op::E;
  constexpr bool kStage = stage_bytes<Op, kC>() > 0;
  __shared__ V warp_tot[kWarps][kC];
  __shared__ V bcast[kC];
  __shared__ int tile_of_block;
  __shared__ __align__(8) unsigned long long bar;
  extern __shared__ __align__(128) unsigned char stage_raw[];
  E* const stage_a = reinterpret_cast<E*>(stage_raw);
  E* const stage_b = stage_a + kTile * kC;
  PHASE_START;
  unsigned* const counter = reinterpret_cast<unsigned*>(p.ws);
  if (threadIdx.x == 0) {
    // the launch's last claim wraps the counter back to 0
    tile_of_block = (int)atomicInc(counter, (unsigned)p.n_tiles - 1);
    if (kStage) mbar_init(&bar);
  }
  __syncthreads();
  const int tile = tile_of_block;
  PHASE(tile, 1);
  // the tile's rows: physical rows [first, first + rows) of x and y
  const long long tile_row0 = (long long)tile * kTile;
  const int rows = (int)min((long long)kTile, p.n - tile_row0);
  const long long first = p.reverse ? p.n - tile_row0 - rows : tile_row0;
  const int bytes = rows * kC * (int)sizeof(E);
  const E* x0 = static_cast<const E*>(p.x0) + first * kC;
  const E* x1 = Op::kArrays == 2 ? static_cast<const E*>(p.x1) + first * kC : x0;
  E* y0 = static_cast<E*>(p.y0) + first * kC;
  E* y1 = Op::kArrays == 2 ? static_cast<E*>(p.y1) + first * kC : y0;
  // a whole, aligned tile goes through shared memory by bulk copies
  const bool staged = kStage && bytes % 16 == 0 && aligned16(x0) && aligned16(x1) &&
                      aligned16(y0) && aligned16(y1);
  const int l0 = threadIdx.x * kRowsPerThread;
  V v[kRowsPerThread][kC];
  if (staged) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bar, bytes * Op::kArrays);
      bulk_load(stage_a, x0, bytes, &bar);
      if (Op::kArrays == 2) bulk_load(stage_b, x1, bytes, &bar);
    }
    mbar_wait(&bar, 0);
    load_stretch<Op, kC>(stage_a, stage_b, rows, l0, p.reverse, v);
  } else {
    load_stretch<Op, kC>(p.x0, p.x1, p.n, tile_row0 + l0, p.reverse, v);
  }
  // the thread totals wait in the last quarter of the staged tile, which
  // every thread has read by then
  V* const park = kStage ? reinterpret_cast<V*>(stage_raw + stage_bytes<Op, kC>() / 4 * 3)
                         : nullptr;
  if (kStage) __syncthreads();
  PHASE(tile, 2);
  tile_scan_cols<Op, kC>(v, warp_tot, park);
  PHASE(tile, 3);
  // publish the tile's total, its last thread's last row, for later tiles
  if (tile + 1 < p.n_tiles && threadIdx.x == kThreads - 1) {
    unsigned long long* pub =
        reinterpret_cast<unsigned long long*>(p.ws + kHeaderWords) + (long long)tile * kC;
    const unsigned long long stamp = static_cast<unsigned long long>(p.epoch) << 32;
#pragma unroll
    for (int k = 0; k < Op::kArrays; ++k) {
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const E e = Op::part(v[kRowsPerThread - 1][j], k);
        unsigned bits;
        memcpy(&bits, &e, sizeof(E));
        st_relaxed(pub + j, stamp | bits);
      }
      pub += (long long)p.cap_tiles * kMaxCols;
    }
  }
  // the local values of 2 or more columns wait in shared memory, at the
  // tile's physical rows, which leaves the registers to the look-back
  // (once every thread has read its input and its parked thread totals)
  if (kStage) {
    __syncthreads();
    store_stretch<Op, kC>(stage_a, stage_b, rows, l0, p.reverse, v);
  }
  // the earlier tiles' prefix of column j, by warp j, into bcast[j]
  const int warp = threadIdx.x >> 5;
  if (warp < kC && (threadIdx.x & 31) == 0) bcast[warp] = Op::identity();
  if (tile > 0 && warp < kC) {
    const V total = look_back<Op, kC>(p, tile - 1, warp);
    if ((threadIdx.x & 31) == 0) bcast[warp] = total;
  }
  __syncthreads();
  PHASE(tile, 4);
  if (!kStage) {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
      for (int j = 0; j < kC; ++j) v[r][j] = Op::combine(bcast[j], v[r][j]);
    }
    store_stretch<Op, kC>(p.y0, p.y1, p.n, tile_row0 + l0, p.reverse, v);
  } else if (staged) {
    // prefix o local value, out in 16-byte pieces by every thread,
    // neighbours on neighbouring addresses; element e is in column e % kC
    using Vec = typename Vec4<E>::type;
    const Vec* src_a = reinterpret_cast<const Vec*>(stage_a);
    const Vec* src_b = reinterpret_cast<const Vec*>(Op::kArrays == 2 ? stage_b : stage_a);
#pragma unroll
    for (int i = threadIdx.x; i < kTile * kC / 4; i += kThreads) {
      if (i < bytes / 16) {
        const Vec a = src_a[i], b = src_b[i];
        const E ea[4] = {a.x, a.y, a.z, a.w}, eb[4] = {b.x, b.y, b.z, b.w};
        E oa[4], ob[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const V out = Op::combine(bcast[(4 * i + q) % kC], Op::pack(ea[q], eb[q]));
          oa[q] = Op::part(out, 0);
          ob[q] = Op::part(out, 1);
        }
        reinterpret_cast<Vec*>(y0)[i] = Vec{oa[0], oa[1], oa[2], oa[3]};
        if (Op::kArrays == 2) reinterpret_cast<Vec*>(y1)[i] = Vec{ob[0], ob[1], ob[2], ob[3]};
      }
    }
  } else {
    // an unaligned tile: the same, element by element
    for (int e = threadIdx.x; e < rows * kC; e += kThreads) {
      Op::store(y0, y1, e, Op::combine(bcast[e % kC], Op::load(stage_a, stage_b, e)));
    }
  }
  PHASE(tile, 5);
}

constexpr int kMaxDevices = 64;

template <class Op, int kC>
cudaError_t launch_instance(const OnePass& p, int device, cudaStream_t stream) {
  constexpr int kSmem = stage_bytes<Op, kC>();
  // once per device: above 48 KB a block's dynamic shared memory is opted
  // into; and every instance asks for the same split of L1 and shared
  // memory, so that consecutive scans do not reconfigure the SMs
  static std::atomic<bool> configured[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[device].load()) {
    cudaError_t err = cudaFuncSetAttribute(scan_one_pass<Op, kC>,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && kSmem > 48 * 1024) {
      err = cudaFuncSetAttribute(scan_one_pass<Op, kC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    }
    if (err != cudaSuccess) return err;
    configured[device].store(true);
  }
  scan_one_pass<Op, kC><<<p.n_tiles, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <class Op>
cudaError_t launch_one_pass(const OnePass& p, int device, cudaStream_t stream) {
  switch (p.c) {
    case 1: return launch_instance<Op, 1>(p, device, stream);
    case 2: return launch_instance<Op, 2>(p, device, stream);
    case 6: return launch_instance<Op, 6>(p, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_op(int op, int reverse) {
  if (op < kAddF32 || op > kAffineF32) return false;
  return !reverse || op == kMinF32 || op == kMaxF32 || op == kMinI32 || op == kMaxI32;
}

// Runs fn with `device` current, then puts the caller's device back.
template <class Fn>
int on_device(int device, Fn fn) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const cudaError_t status = fn();
  if (current != device && (err = cudaSetDevice(current)) != cudaSuccess) return (int)err;
  return (int)status;
}

}  // namespace

// Rows per tile; the wrapper sizes its tile count by it.
extern "C" int ffs_scan_tile_rows() { return kTile; }

// int32 words of a one-pass workspace for up to cap_tiles tiles.
extern "C" long long ffs_scan_workspace_words(int cap_tiles) {
  return kHeaderWords + (long long)cap_tiles * kMaxCols * 2 * 2;
}

// The one-pass kernel: scans x (x0, and x1 for the affine pair) into y on
// `stream` of `device`, one launch. `ws` is a workspace of
// ffs_scan_workspace_words(cap_tiles) int32 words, zeroed before its first
// launch and used by one stream only; `epoch` is unique to this launch
// among the workspace's (1, 2, ...). Returns a cudaError_t code (0 = ok).
extern "C" int ffs_scan_launch(int device, int op, int reverse, long long n, int c,
                               const void* x0, const void* x1, void* y0, void* y1, int* ws,
                               int cap_tiles, int epoch, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long n_tiles = (n + kTile - 1) / kTile;
  if ((c != 1 && c != 2 && c != 6) || n_tiles > cap_tiles || epoch <= 0 ||
      !valid_op(op, reverse)) {
    return (int)cudaErrorInvalidValue;
  }
  OnePass p{x0, x1, y0, y1, ws, n, c, reverse, (int)n_tiles, cap_tiles, epoch};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> cudaError_t {
    switch (op) {
      case kAddF32: return launch_one_pass<AddF32>(p, device, s);
      case kMinF32: return launch_one_pass<MinF32>(p, device, s);
      case kMaxF32: return launch_one_pass<MaxF32>(p, device, s);
      case kMinI32: return launch_one_pass<MinI32>(p, device, s);
      case kMaxI32: return launch_one_pass<MaxI32>(p, device, s);
      default: return launch_one_pass<AffineF32>(p, device, s);
    }
  });
}

// The two-level route (the yardstick): scans x into y on `stream` of
// `device` in three launches; `totals` (t0, t1) is scratch of
// ceil(n / tile) x c elements of the value type, unused when n fits one
// tile. Returns a cudaError_t code (0 = ok).
extern "C" int ffs_scan_launch_two_level(int device, int op, int reverse, long long n, int c,
                                         const void* x0, const void* x1, void* y0, void* y1,
                                         void* t0, void* t1, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long n_tiles = (n + kTile - 1) / kTile;
  if (c <= 0 || n_tiles > INT32_MAX || !valid_op(op, reverse)) return (int)cudaErrorInvalidValue;
  Params p{x0, x1, y0, y1, t0, t1, n, c, reverse, (int)n_tiles};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> cudaError_t {
    switch (op) {
      case kAddF32: return launch_two_level<AddF32>(p, s);
      case kMinF32: return launch_two_level<MinF32>(p, s);
      case kMaxF32: return launch_two_level<MaxF32>(p, s);
      case kMinI32: return launch_two_level<MinI32>(p, s);
      case kMaxI32: return launch_two_level<MaxI32>(p, s);
      default: return launch_two_level<AffineF32>(p, s);
    }
  });
}

#ifdef FFS_SCAN_PHASES
// Copies the stamps of the last launch's tiles ([kPhaseTiles][8] int64).
extern "C" int ffs_scan_phases(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phases, sizeof(g_phases));
}
extern "C" int ffs_scan_phase_tiles() { return kPhaseTiles; }
#endif
