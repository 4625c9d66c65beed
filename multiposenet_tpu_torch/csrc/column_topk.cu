// Per-column top-8 of the 3x3 peak mask of bf16 maps, for NVIDIA Hopper
// (sm_90a): warps find the peaks of 16-row strips in packed bf16, then a
// thread per column inserts only the rows its strips' masks name.
//
// Replaces the TPU kernel benchmarks/ab/dbench2.py `kern_reduce` (line 37,
// `pallas_call` at :89), the decode micro-benchmark's phase A of the
// heatmap decode without the blur. Per map [H, W], read as f32:
//   m9     = max of the 3x3 window around each element, -inf outside;
//   masked = the element where it is >= m9 (plateau maxima all count),
//            else -inf;
//   then, for every column, 8 rounds each take the column's max of masked
//   and the least packed row (row * 16 + 5) holding it, and set that
//   element to -inf. So each column gets its top 8 by value, ties to the
//   lower row, and a column with fewer than 8 peaks fills the rest with
//   (-inf, row 0). The outputs are column 0's lists, scores [N, 8] f32 and
//   packed rows [N, 8] int32, as the Pallas kernel stores them; with
//   `col_scores`/`col_rows` given, every column's lists [N, 8, W] too. The
//   maxima propagate NaN (max.NaN) as jnp.maximum and max_pool2d do, so it
//   agrees bit for bit with ops/column_topk.py column_topk_plain.
//
// Bound on the card: each map is read once and 2 * N * 8 * 4 bytes are
// written (2176 maps of 128x128 move 71.44 MB, 21.3 us at 3.35 TB/s);
// per element 8 maxima and a comparison (9.6 us at 132 SMs x 128 lanes x
// 1.98 GHz). So bytes bound it.
//
// Design. The earlier design (a thread per column walking all H rows,
// testing and inserting row by row) spent 42% of its cycles in the 3x3
// test and 42% in insertions that diverge on almost every row
// (tools/column_topk_phases.py). Here the two are split:
// - A persistent grid (as many blocks as fit on the SMs, each taking maps
//   gridDim.x apart) walks each map in tiles of `chunk_rows` rows, each
//   with a halo row above and below (-inf outside the map), staged in
//   shared memory in a ring of two: the next tile's copy is in flight
//   while the block works on this one. Where the maps are 16-byte aligned
//   and W % 8 == 0 a tile's rows are one span, moved by one bulk copy
//   (cp.async.bulk: the copy engine, not the threads, moves it and
//   completes an mbarrier), which timed faster than per-thread 16-byte
//   cp.async; other maps take plain loads.
// - Peak test: a warp takes a strip of 16 rows and 128 columns, 4 columns a
//   lane as two bf16x2 words, and walks it top to bottom: vertical maxima
//   of rows pairwise (3 max.NaN.bf16x2 for two rows), the neighbour
//   columns by shuffles (the warp's edge columns from shared memory where
//   the row is wider than 128), the 3x3 maximum by byte permutes and two
//   more maxima, and the comparison by set.ge.bf16x2, whose 0xffff halves
//   are or-ed into one 16-bit mask a column. The maxima and comparisons of
//   bf16 values are exact, so they equal the f32 ones of the plain version.
// - Insertion: after a barrier, the thread of column c reads its strips'
//   masks in row order and, for each peak only, reads the value and
//   inserts it into a sorted list of 8 (value, row) pairs in registers
//   where it is strictly greater than the 8th, which keeps the lower row
//   on ties (rows arrive in ascending order). The masks of a map's strips,
//   its row bands, are merged per column this way, with the list carried
//   across tiles; the thread stores it after the map's last tile.
// The 128x128 maps of the micro-benchmark take an instantiation with the
// sizes fixed (tiles of 64 rows, 128 threads, 34 KB of shared memory, 6
// blocks an SM, the top 8 as one 32-bit key a slot); other sizes run the
// same code with sizes at run time and (value, row) pairs.
// Built with -DCOLUMN_TOPK_PROFILE, thread 0 of every block counts clock64
// cycles per phase (multiposenet_tpu_torch/tools/column_topk_phases.py):
// load (issuing the next tile's copies and waiting for this one's), peak
// test (the strip walks), merge (the barrier that hands the strips' masks
// to the columns), insertion (reading the masks and inserting, up to the
// barrier that frees the stage) and store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTop = 8;               // peaks per column
constexpr int kMaxWidth = 1024;       // a thread per column
constexpr int kMaxRows = 1 << 27;     // packed rows row * 16 + 5 fit int32
constexpr int kStrip = 16;            // rows per peak mask (16 bits)
constexpr int kWarpCols = 128;        // columns a warp walks: 4 a lane
constexpr int kChunkBytes = 32768;    // off the fast path: a tile's rows
constexpr int kStages = 2;            // tiles staged at once, a ring
constexpr int kSmemPerSm = 233472;    // shared memory an SM holds
constexpr int kSmemPerBlock = 1024;   // reserved by the runtime per block
constexpr int kStaticSmem = 48 * 1024;  // dynamic above this needs opt-in
constexpr unsigned kNegInf2 = 0xff80ff80u;  // two bf16 -inf
// The fast path: 128x128 maps in tiles of 64 rows, 128 threads, at most 80
// registers so that 6 blocks fit an SM.
constexpr int kFastSize = 128;
constexpr int kFastChunk = 64;
constexpr int kFastThreads = 128;
constexpr int kFastRegs = 80;
constexpr int kFastMinBlocks = 6;
// Other sizes: up to 1024 threads (a thread per column), at most 64
// registers (the launch bounds of 1024 threads).
constexpr int kGenericRegs = 64;

// The launch plan, from the sizes and the card's SM count alone; ops/
// column_topk.py launch_plan computes the same.
struct Plan {
  int fast;           // 1: the 128x128 instantiation
  int threads;        // per block
  int chunk_rows;     // rows per tile, a multiple of kStrip
  int chunks;         // tiles per map
  int pitch;          // shared row pitch in elements, a multiple of 8
  int smem_bytes;     // dynamic shared memory per block
  int blocks_per_sm;  // by registers, threads and shared memory
  int grid;           // persistent blocks, at most N
};
constexpr int kPlanFields = 8;

Plan make_plan(int N, int H, int W, int sms) {
  Plan p;
  p.fast = H == kFastSize && W == kFastSize;
  p.pitch = (W + 7) / 8 * 8;
  p.threads = p.fast ? kFastThreads
                     : ((W + 31) / 32 * 32 > 128 ? (W + 31) / 32 * 32 : 128);
  if (p.fast) {
    p.chunk_rows = kFastChunk;
  } else {
    const int fit = kChunkBytes / (2 * p.pitch) / kStrip * kStrip;
    const int all = (H + kStrip - 1) / kStrip * kStrip;
    p.chunk_rows = fit < kStrip ? kStrip : (fit < all ? fit : all);
  }
  p.chunks = (H + p.chunk_rows - 1) / p.chunk_rows;
  const int stage = (p.chunk_rows + 2) * p.pitch * 2;
  const int masks = p.chunk_rows / kStrip * p.pitch * 2;
  p.smem_bytes = kStages * stage + masks;
  const int regs = p.fast ? kFastRegs : kGenericRegs;
  int per_sm = 65536 / (p.threads * regs);
  const int by_threads = 2048 / p.threads;
  const int by_smem = kSmemPerSm / (p.smem_bytes + kSmemPerBlock);
  per_sm = per_sm < by_threads ? per_sm : by_threads;
  per_sm = per_sm < by_smem ? per_sm : by_smem;
  per_sm = per_sm < 32 ? per_sm : 32;
  p.blocks_per_sm = per_sm;
  const long long grid = static_cast<long long>(sms) * per_sm;
  p.grid = grid < N ? static_cast<int>(grid) : N;
  return p;
}

enum Phase { load, peak_test, insertion, merge, store, kPhases };
#ifdef COLUMN_TOPK_PROFILE
__device__ unsigned long long phase_cycles[kPhases + 1];
struct PhaseClock {
  long long t[kPhases];
  long long mark;
  __device__ __forceinline__ PhaseClock() : mark(0) {
    for (int i = 0; i < kPhases; ++i) t[i] = 0;
#ifdef __CUDA_ARCH__
    mark = clock64();
#endif
  }
  __device__ __forceinline__ void tick(Phase p) {
    if (threadIdx.x == 0) {
      const long long now = clock64();
      t[p] += now - mark;
      mark = now;
    }
  }
  __device__ __forceinline__ void flush() {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kPhases; ++i) {
        atomicAdd(&phase_cycles[i], static_cast<unsigned long long>(t[i]));
      }
      atomicAdd(&phase_cycles[kPhases], 1ull);
    }
  }
};
#else
struct PhaseClock {
  __device__ __forceinline__ void tick(Phase) {}
  __device__ __forceinline__ void flush() {}
};
#endif
#define CT_MARK(phase) clk.tick(phase)

__device__ __forceinline__ unsigned max2(unsigned a, unsigned b) {
  unsigned d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// 0xffff in each half where a >= b (false where either is NaN).
__device__ __forceinline__ unsigned ge2(unsigned a, unsigned b) {
  unsigned d;
  asm("set.ge.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One bulk copy (the copy engine, no per-thread requests) of `bytes`, a
// multiple of 16, 16-byte aligned at both ends, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)), "l"(gmem),
      "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void wait_parity(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nwait:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait;\n}\n" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

// A column's top 8 as (value, row) pairs, sorted by value desc, row asc,
// born (-inf, row 0). A peak of raw bf16 bits `b` at `row` enters where it
// is strictly greater than the 8th: rows arrive in ascending order, so an
// equal value stays ahead. Each slot j ends up holding old slot j - 1
// where that ranks below v, v where slot j - 1 does not and slot j does,
// else its own entry.
struct PairList {
  float s[kTop];
  int r[kTop];
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int j = 0; j < kTop; ++j) {
      s[j] = -INFINITY;
      r[j] = 0;
    }
  }
  __device__ __forceinline__ void take(unsigned b, int row) {
    const float v = __uint_as_float(b << 16);
    if (!(v > s[kTop - 1])) return;
#pragma unroll
    for (int j = kTop - 1; j > 0; --j) {
      if (s[j - 1] < v) {
        s[j] = s[j - 1];
        r[j] = r[j - 1];
      } else if (s[j] < v) {
        s[j] = v;
        r[j] = row;
      }
    }
    if (s[0] < v) {
      s[0] = v;
      r[0] = row;
    }
  }
  __device__ __forceinline__ float score(int j) const { return s[j]; }
  __device__ __forceinline__ int row(int j) const { return r[j]; }
};

// The same list for maps of at most 256 rows, each entry one 32-bit key
// whose unsigned order is the list's: bits 31..16 the bf16 value mapped
// to an unsigned order (negatives bit-inverted, positives with the sign
// bit set; -0 as +0, so that equal values tie), bits 15..8 255 - row (the
// lower row ranks higher), bit 0 set for -0 (to give it back). Keys of
// distinct rows differ, so an insertion is 8 unsigned max/min pairs.
struct KeyList {
  unsigned k[kTop];
  static constexpr unsigned kBorn = 0x007fff00u;  // (-inf, row 0)
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int j = 0; j < kTop; ++j) k[j] = kBorn;
  }
  __device__ __forceinline__ void take(unsigned b, int row) {
    const unsigned neg_zero = b == 0x8000u;
    const unsigned o =
        neg_zero ? 0x8000u : ((b & 0x8000u) ? b ^ 0xffffu : b | 0x8000u);
    unsigned key = o << 16 | (255u - row) << 8 | neg_zero;
    if (key <= k[kTop - 1]) return;
#pragma unroll
    for (int j = 0; j < kTop; ++j) {
      const unsigned hi = max(k[j], key);
      key = min(k[j], key);
      k[j] = hi;
    }
  }
  __device__ __forceinline__ float score(int j) const {
    const unsigned o = k[j] >> 16;
    const unsigned b =
        (k[j] & 1u) ? 0x8000u : ((o & 0x8000u) ? o & 0x7fffu : ~o & 0xffffu);
    return __uint_as_float(b << 16);
  }
  __device__ __forceinline__ int row(int j) const {
    return 255 - static_cast<int>((k[j] >> 8) & 0xffu);
  }
};

// Sizes, fixed on the fast path (kFast) and given at run time otherwise.
template <bool kFast>
struct Dims {
  int H, W, pitch, chunk_rows, chunks;
  __device__ __forceinline__ int h() const { return kFast ? kFastSize : H; }
  __device__ __forceinline__ int w() const { return kFast ? kFastSize : W; }
  __device__ __forceinline__ int p() const { return kFast ? kFastSize : pitch; }
  __device__ __forceinline__ int ch() const {
    return kFast ? kFastChunk : chunk_rows;
  }
  __device__ __forceinline__ int nch() const {
    return kFast ? kFastSize / kFastChunk : chunks;
  }
};

// Stage the tile `chunk` of map `n`: slot 0 holds row r0 - 1, slots 1..
// n_rows the tile's rows, slot n_rows + 1 row r0 + n_rows; rows outside
// the map are -inf, and so are the columns W..pitch-1.
template <bool kFast, bool kBulk>
__device__ __forceinline__ void stage_tile(
    const __nv_bfloat16* __restrict__ maps, const Dims<kFast>& d, int n,
    int chunk, __nv_bfloat16* stage, uint64_t* bar, int tid, int nthreads) {
  const int H = d.h(), W = d.w(), P = d.p();
  const int r0 = chunk * d.ch();
  const int n_rows = min(d.ch(), H - r0);
  const int lo = max(r0 - 1, 0), hi = min(r0 + n_rows + 1, H);
  const __nv_bfloat16* src = maps + (static_cast<long long>(n) * H + lo) * W;
  __nv_bfloat16* dst = stage + (lo - (r0 - 1)) * P;
  const __nv_bfloat16 neg_inf = __ushort_as_bfloat16(0xff80);
  if (kBulk) {  // aligned, W % 8 == 0: one span of (hi - lo) * W elements
    if (tid == 0) {
      // Order the block's earlier plain accesses to this stage (after the
      // barrier that freed it) before the copy engine's writes.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_copy(dst, src, static_cast<unsigned>((hi - lo) * W * 2), bar);
    }
  } else {
    const int count = (hi - lo) * P;
    for (int i = tid; i < count; i += nthreads) {
      const int row = i / P, col = i - row * P;
      dst[i] = col < W ? src[row * W + col] : neg_inf;
    }
  }
  if (r0 == 0) {
    for (int i = tid; i < P; i += nthreads) stage[i] = neg_inf;
  }
  if (r0 + n_rows == H) {
    for (int i = tid; i < P; i += nthreads) {
      stage[(n_rows + 1) * P + i] = neg_inf;
    }
  }
}

// One row's peaks in a lane's 4 columns: a, b the vertical maxima of its
// two words, up/down (lane 0's left and lane 31's right edge column's,
// both halves) the neighbours; centre words ca, cb. Returns (mask a, mask
// b) as 0xffff halves where the centre is a peak.
__device__ __forceinline__ uint2 row_peaks(unsigned va, unsigned vb,
                                           unsigned ve, unsigned ca,
                                           unsigned cb, int lane) {
  unsigned left = __shfl_up_sync(0xffffffffu, vb, 1);
  unsigned right = __shfl_down_sync(0xffffffffu, va, 1);
  if (lane == 0) left = ve;
  if (lane == 31) right = ve;
  const unsigned l = __byte_perm(left, va, 0x5432);   // cols c-1, c
  const unsigned m = __byte_perm(va, vb, 0x5432);     // cols c+1, c+2
  const unsigned r = __byte_perm(vb, right, 0x5432);  // cols c+3, c+4
  const unsigned ma = max2(max2(l, va), m);
  const unsigned mb = max2(max2(m, vb), r);
  return make_uint2(ge2(ca, ma), ge2(cb, mb));
}

// The warp's strip `strip` of the staged tile, columns g * 128 .. + 127:
// each lane writes its 4 columns' 16-bit peak masks (bit i: row
// strip * 16 + i of the tile) to masks[strip][column].
template <bool kFast>
__device__ __forceinline__ void walk_strip(const __nv_bfloat16* stage,
                                           uint16_t* masks,
                                           const Dims<kFast>& d, int strip,
                                           int g, int n_rows, int lane) {
  const int P = d.p();
  const int c0 = g * kWarpCols + 4 * lane;
  const bool in = c0 < P;
  // Lane 0's left and lane 31's right neighbour column, where it lies in
  // the staged row (the fast path's single warp of columns has none).
  const int e = lane == 0 ? c0 - 1 : c0 + 4;
  const bool edge = !kFast && (lane == 0 || lane == 31) && e >= 0 && e < P;
  const int row0 = strip * kStrip;  // slot row0 holds the row above it
  const int len = min(kStrip, n_rows - row0);
  const unsigned short* base =
      reinterpret_cast<const unsigned short*>(stage);
  auto words = [&](int slot) {
    return in ? *reinterpret_cast<const uint2*>(base + slot * P + c0)
              : make_uint2(kNegInf2, kNegInf2);
  };
  auto edge_word = [&](int slot) {
    const unsigned v = edge ? base[slot * P + e] : 0xff80u;
    return v | (v << 16);
  };
  // Maxima of edge words; none on the fast path.
  auto emax = [](unsigned a, unsigned b) {
    return kFast ? kNegInf2 : max2(a, b);
  };
  uint2 x0 = words(row0), x1 = words(row0 + 1);
  unsigned e0 = edge_word(row0), e1 = edge_word(row0 + 1);
  unsigned acc_a = 0, acc_b = 0;
  int i = 0;
#pragma unroll
  for (; i + 1 < kStrip; i += 2) {  // rows i and i + 1 share max(x1, x2)
    if (!kFast && i + 1 >= len) break;
    const uint2 x2 = words(row0 + i + 2), x3 = words(row0 + i + 3);
    const unsigned e2 = edge_word(row0 + i + 2), e3 = edge_word(row0 + i + 3);
    const unsigned qa = max2(x1.x, x2.x), qb = max2(x1.y, x2.y);
    const unsigned qe = emax(e1, e2);
    uint2 pk = row_peaks(max2(x0.x, qa), max2(x0.y, qb), emax(e0, qe), x1.x,
                         x1.y, lane);
    acc_a |= pk.x & (0x00010001u << i);
    acc_b |= pk.y & (0x00010001u << i);
    pk = row_peaks(max2(qa, x3.x), max2(qb, x3.y), emax(qe, e3), x2.x, x2.y,
                   lane);
    acc_a |= pk.x & (0x00010001u << (i + 1));
    acc_b |= pk.y & (0x00010001u << (i + 1));
    x0 = x2;
    x1 = x3;
    e0 = e2;
    e1 = e3;
  }
  if (!kFast && i < len) {  // an odd last row
    const uint2 x2 = words(row0 + i + 2);
    const unsigned e2 = edge_word(row0 + i + 2);
    const uint2 pk = row_peaks(max2(x0.x, max2(x1.x, x2.x)),
                               max2(x0.y, max2(x1.y, x2.y)),
                               emax(e0, emax(e1, e2)), x1.x, x1.y, lane);
    acc_a |= pk.x & (0x00010001u << i);
    acc_b |= pk.y & (0x00010001u << i);
  }
  if (in) {
    *reinterpret_cast<uint2*>(masks + strip * P + c0) =
        make_uint2(acc_a, acc_b);
  }
}

template <bool kFast, bool kBulk, int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
column_topk_kernel(const __nv_bfloat16* __restrict__ maps, int N, Dims<kFast> d,
                   float* __restrict__ scores,
                   int* __restrict__ rows, float* __restrict__ col_scores,
                   int* __restrict__ col_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[kStages];  // the bulk copies' barriers
  PhaseClock clk;
  const int H = d.h(), W = d.w(), P = d.p(), CH = d.ch(), NCH = d.nch();
  const int nthreads = kFast ? kThreads : blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int stage_elems = (CH + 2) * P;
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  uint16_t* masks =
      reinterpret_cast<uint16_t*>(stages + kStages * stage_elems);
  const int groups = (P + kWarpCols - 1) / kWarpCols;
  const long long my_maps = (N - 1 - blockIdx.x) / gridDim.x + 1;
  const long long tiles = my_maps * NCH;

  // The fast path's 128 rows fit the keyed list.
  typename std::conditional<kFast, KeyList, PairList>::type list;
  list.reset();
  // Tile t of this block: map blockIdx.x + (t / NCH) * gridDim.x, rows
  // from (t % NCH) * CH, in stage t % kStages.
  auto stage_of = [&](long long t) {
    return stages + static_cast<int>(t % kStages) * stage_elems;
  };
  auto fetch = [&](long long t) {
    if (t < tiles) {
      stage_tile<kFast, kBulk>(
          maps, d, blockIdx.x + static_cast<int>(t / NCH) * gridDim.x,
          static_cast<int>(t % NCH), stage_of(t), &bars[t % kStages], tid,
          nthreads);
    }
  };
  if (kBulk && tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(smem_addr(&bars[i])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (kBulk) __syncthreads();
  for (int t = 0; t < kStages - 1; ++t) fetch(t);
  for (long long t = 0; t < tiles; ++t) {
    const int n = blockIdx.x + static_cast<int>(t / NCH) * gridDim.x;
    const int chunk = static_cast<int>(t % NCH);
    const __nv_bfloat16* stage = stage_of(t);
    fetch(t + kStages - 1);
    if (kBulk) {
      wait_parity(&bars[t % kStages], static_cast<unsigned>(t / kStages) & 1);
    }
    __syncthreads();
    CT_MARK(load);
    const int r0 = chunk * CH;
    const int n_rows = min(CH, H - r0);
    const int strips = (n_rows + kStrip - 1) / kStrip;
    for (int item = warp; item < strips * groups; item += nwarps) {
      const int strip = kFast ? item : item / groups;
      walk_strip(stage, masks, d, strip, item - strip * groups, n_rows, lane);
    }
    CT_MARK(peak_test);
    __syncthreads();
    CT_MARK(merge);
    if (tid < W) {  // two strips' masks a word, rows in ascending order
      const unsigned short* col =
          reinterpret_cast<const unsigned short*>(stage) + P + tid;
      for (int st = 0; st < strips; st += 2) {
        unsigned m = masks[st * P + tid];
        if (st + 1 < strips) {
          m |= static_cast<unsigned>(masks[(st + 1) * P + tid]) << 16;
        }
        while (m != 0) {
          const int i = st * kStrip + __ffs(m) - 1;
          m &= m - 1;
          list.take(col[i * P], r0 + i);
        }
      }
    }
    CT_MARK(insertion);
    if (chunk == NCH - 1) {
      if (tid < W) {
        if (col_scores != nullptr) {
#pragma unroll
          for (int j = 0; j < kTop; ++j) {
            const long long o =
                (static_cast<long long>(n) * kTop + j) * W + tid;
            col_scores[o] = list.score(j);
            col_rows[o] = list.row(j) * 16 + 5;
          }
        }
        if (tid == 0) {
#pragma unroll
          for (int j = 0; j < kTop; ++j) {
            const long long o = static_cast<long long>(n) * kTop + j;
            scores[o] = list.score(j);
            rows[o] = list.row(j) * 16 + 5;
          }
        }
      }
      list.reset();
    }
    CT_MARK(store);
    __syncthreads();  // the stage and the masks are free again
    CT_MARK(insertion);
  }
  clk.flush();
}

template <bool kFast, bool kBulk, int kThreads, int kMinBlocks>
int launch(const Plan& p, const void* maps, int N, int H, int W,
           float* scores, int* rows, float* col_scores, int* col_rows,
           cudaStream_t stream) {
  auto kernel = column_topk_kernel<kFast, kBulk, kThreads, kMinBlocks>;
  if (p.smem_bytes > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Dims<kFast> d{H, W, p.pitch, p.chunk_rows, p.chunks};
  kernel<<<p.grid, p.threads, p.smem_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(maps), N, d, scores, rows,
      col_scores, col_rows);
  return static_cast<int>(cudaGetLastError());
}

// The current device's SM count, asked once per device.
int sm_count(int* sms) {
  static int cache[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (cache[dev] == 0) {
    e = cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  *sms = cache[dev];
  return 0;
}

bool refused(int N, int H, int W) {
  return N < 1 || H < 1 || H > kMaxRows || W < 1 || W > kMaxWidth;
}

}  // namespace

extern "C" {

// maps: [N, H, W] bfloat16, contiguous; 1 <= W <= 1024, 1 <= H <= 2^27.
// Outputs scores [N, 8] float32 and rows [N, 8] int32 (row * 16 + 5),
// column 0's lists; col_scores/col_rows, both null or both [N, 8, W]
// (float32, int32), every column's. Returns a cudaError_t code.
int column_topk(const void* maps, int N, int H, int W, float* scores,
                int* rows, float* col_scores, int* col_rows, void* stream) {
  if (refused(N, H, W) || (col_scores == nullptr) != (col_rows == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  const int e = sm_count(&sms);
  if (e != 0) return e;
  const Plan p = make_plan(N, H, W, sms);
  const int aligned =
      reinterpret_cast<uintptr_t>(maps) % 16 == 0 && W % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.fast) {
    return aligned ? launch<true, true, kFastThreads, kFastMinBlocks>(
                         p, maps, N, H, W, scores, rows, col_scores,
                         col_rows, s)
                   : launch<true, false, kFastThreads, kFastMinBlocks>(
                         p, maps, N, H, W, scores, rows, col_scores,
                         col_rows, s);
  }
  return aligned ? launch<false, true, kMaxWidth, 1>(p, maps, N, H, W, scores,
                                                     rows, col_scores,
                                                     col_rows, s)
                 : launch<false, false, kMaxWidth, 1>(p, maps, N, H, W,
                                                      scores, rows,
                                                      col_scores, col_rows,
                                                      s);
}

// The launch plan `column_topk` takes for [N, H, W] maps on a card of
// `sms` SMs (sms < 1: the current device's), as kPlanFields ints in the
// order of struct Plan. Returns a cudaError_t code.
int column_topk_plan(int N, int H, int W, int sms, int* out) {
  if (refused(N, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  if (sms < 1) {
    const int e = sm_count(&sms);
    if (e != 0) return e;
  }
  const Plan p = make_plan(N, H, W, sms);
  const int fields[kPlanFields] = {p.fast, p.threads, p.chunk_rows,
                                   p.chunks, p.pitch, p.smem_bytes,
                                   p.blocks_per_sm, p.grid};
  for (int i = 0; i < kPlanFields; ++i) out[i] = fields[i];
  return 0;
}

#ifdef COLUMN_TOPK_PROFILE
// Reads (and with reset != 0 then zeroes) the phase counters: kPhases + 1
// values.
int column_topk_phase_cycles(unsigned long long* host, int reset) {
  cudaError_t e =
      cudaMemcpyFromSymbol(host, phase_cycles, sizeof(phase_cycles));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[kPhases + 1] = {};
    e = cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
#endif

}  // extern "C"
