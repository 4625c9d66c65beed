// Heatmap peak decode for every config, for NVIDIA Hopper (sm_90a): tiles
// of a map across the blocks of a thread-block cluster, the blur and the
// window max in shared memory, per-thread top-P lists merged in the
// cluster.
//
// The counterpart of the JAX package's jnp decode
// (multiposenet_tpu/ops/decode.py decode_heatmaps), not of a Pallas
// kernel: it decodes what csrc/decode_peaks.cu (B1) and csrc/decode_lanes.cu
// (B2) do not take, that is any peak window, any odd tap count, any
// 1 <= P <= H*W, any W and any strides, with H*W < 2^28, f32 or bf16 maps.
// It computes what ops/decode.py decode_maps_plain computes, bit for bit:
// the zero-padded separable blur (vertical taps, then horizontal, each
// summed tap by tap from +0 with __fmul_rn/__fadd_rn), the window max over
// rows and columns -(window-1)/2 .. window/2 around each element with -inf
// outside the map, plateau ties kept, the top-P by (value desc, flat index
// asc) over the peak-masked map, and the +-shift sub-pixel step toward the
// larger border-clipped neighbour. NaN propagates as in the JAX package:
// the window max is max.NaN, so a window holding a NaN has no peak, and a
// NaN difference of neighbours gives a NaN step.
//
// Bound on the card: the maps read once and the outputs written once over
// 3.35 TB/s, or per element a multiply and an add per tap in each pass and
// window^2 comparisons, unfused, over 132 SMs x 128 lanes x 1.98 GHz.
//
// Design (`decode_tiles_kernel`). The earlier design gave a block a whole
// map and went through two f32 planes in device memory, then took P
// rounds of a block-wide max, each reading the whole map again.
// - A map is cut into tiles of rows and, where W > 128, of columns. The
//   blocks of a cluster (up to 8, chosen at run time) share a map; a block
//   walks tiles rank, rank + cluster, ... Each tile is staged with its
//   halo (ntaps/2 for the blur, plus max((window-1)/2, 1) above and left
//   and max(window/2, 1) below and right for the peak test and the
//   sub-pixel step) as f32 in shared memory, by plain loads through any
//   strides; raw elements outside the map are staged as zeros.
// - The vertical pass (4 rows a thread, sharing their reads), the
//   horizontal pass and the window max (a row max, then a column max, both
//   with max.NaN) run in shared memory. Staging the zero padding and
//   multiplying it keeps the plain version's products and order exactly;
//   an accumulator that starts at +0 can never become -0, so a +0 product
//   leaves it unchanged, as the plain version's padded taps do. The
//   separable max is exact: a max over the window's rows of the max over
//   its columns holds the same values, NaN included, and the mask compares
//   with >=, under which -0 and +0 are equal.
// - Mark first, insert after: each thread marks its elements (at most 16 a
//   tile, 32 with lists of 32) as peaks (value > -inf) or as others in two bit masks, then
//   inserts only its marked peaks into a sorted register list of CAP
//   64-bit keys (B1's key: value bits, then FLAT_MASK - flat, shifted by 4,
//   the sub-pixel code in the low 4 bits, taken while the neighbours are
//   in shared memory). Elements that are no peak rank as -inf in flat
//   order; a map with fewer than P peaks fills its slots with them, so the
//   block also keeps its first CAP others in flat order (a ballot and a
//   prefix per chunk of 256 elements), after its peaks.
// - Lists merge per warp (warp_merge), per block, then in the cluster:
//   block rank 0 reads the blocks' lists over distributed shared memory
//   and writes the outputs. Ties go to the lower flat index by the key.
// - P above the list length CAP (32) takes ceil(P / 32) rounds, each
//   taking the next 32 keys below the last round's last key.
// Taps or windows too wide for a tile's halo in shared memory take
// `decode_global_kernel`: a block per map through a workspace of two f32
// planes in device memory, and P rounds of a block max.
// Built with -DDECODE_GENERIC_PROFILE, thread 0 of every block counts
// clock64 cycles per phase (multiposenet_tpu_torch/tools/decode_phases.py
// --kernel generic): load, vertical blur, horizontal blur, window max and
// peak mask, selection, merge (the lists and the cluster barrier), store.

#include <cooperative_groups.h>

#include "decode_rows.cuh"  // keys, warp_merge, to_f32, max_nan, sign_code

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;            // rows a thread sums or maxes
constexpr int kLoads = 8;           // staging loads in flight a thread
constexpr unsigned char kPeak = 1;  // mask: a peak above -inf
constexpr unsigned char kOther = 2;  // mask: any other element
constexpr int kMaxCluster = 8;      // blocks a map (portable cluster size)
constexpr int kCtasPerSm = 16;      // blocks wanted per SM, before the cap
constexpr int kTileCols = 128;      // widest column tile
constexpr int kTileElems = 4096;    // a tile's elements: 16 a thread
constexpr int kTileElemsLong = 8192;  // with lists of 32: 32 a thread
constexpr int kMaxDynSmem = 228352;  // 232448 less room for static arrays
constexpr int kMaxClusters = 1 << 26;  // clusters in the grid at most
constexpr int kListShort = 8;       // list lengths: P <= 8, else 32
constexpr int kListLong = 32;

// The launch plan, from the sizes and the card's SM count alone;
// ops/decode.py generic_launch_plan computes the same.
struct Plan {
  int path;        // 0: tiles in shared memory; 1: a block per map through
                   // a workspace in device memory
  int tile_rows;   // rows of a tile (path 1: H)
  int tile_cols;   // columns of a tile (path 1: W)
  int row_tiles;   // tiles down a map
  int col_tiles;   // tiles across a map
  int cluster;     // blocks a map, a thread-block cluster
  int grid;        // blocks: clusters of `cluster` walking the maps
  int cap;         // list length (path 1: 0)
  int rounds;      // selection rounds (path 1: P)
  int smem_bytes;  // dynamic shared memory a block
};
constexpr int kPlanFields = 10;

// Dynamic shared memory of a th x tw tile: the taps, the staged raw
// region (then the blurred one), the vertical pass (then the row max),
// f32, and a byte of mask an element.
long long tile_smem(int th, int tw, int ntaps, int window) {
  const int half = ntaps / 2;
  const int bl = max((window - 1) / 2, 1), bh = max(window / 2, 1);
  const long long sh = th + bl + bh, sw = tw + bl + bh;
  const long long rh = sh + 2 * half, rw = sw + 2 * half;
  return 4 * ((ntaps + 3) / 4 * 4 + rh * rw + sh * rw) +
         static_cast<long long>(th) * tw;
}

Plan make_plan(long long n_maps, int H, int W, int ntaps, int window, int p,
               int sms) {
  Plan q;
  const long long want_ll = (static_cast<long long>(sms) * kCtasPerSm +
                             n_maps - 1) / n_maps;
  const int want = static_cast<int>(
      want_ll < 1 ? 1 : (want_ll > kMaxCluster ? kMaxCluster : want_ll));
  // Lists of 32 keys hold a block to 2 an SM by registers: larger tiles
  // then cost no blocks and stage fewer halo rows.
  const int tile_elems = p <= kListShort ? kTileElems : kTileElemsLong;
  int col_tiles = (W + kTileCols - 1) / kTileCols;
  int tw = (W + col_tiles - 1) / col_tiles;
  const int max_rows = max(1, tile_elems / tw);
  const int row_tiles = max((H + max_rows - 1) / max_rows,
                            min(H, (want + col_tiles - 1) / col_tiles));
  int th = (H + row_tiles - 1) / row_tiles;
  while (tile_smem(th, tw, ntaps, window) > kMaxDynSmem &&
         (th > 1 || tw > 1)) {
    if (th > 1) {
      th = (th + 1) / 2;
    } else {
      tw = (tw + 1) / 2;
    }
  }
  if (tile_smem(th, tw, ntaps, window) > kMaxDynSmem) {
    q.path = 1;
    q.tile_rows = H;
    q.tile_cols = W;
    q.row_tiles = q.col_tiles = q.cluster = 1;
    q.grid = static_cast<int>(n_maps);
    q.cap = 0;
    q.rounds = p;
    q.smem_bytes = 0;
    return q;
  }
  q.path = 0;
  q.tile_rows = th;
  q.tile_cols = tw;
  q.row_tiles = (H + th - 1) / th;
  q.col_tiles = (W + tw - 1) / tw;
  const long long tiles = static_cast<long long>(q.row_tiles) * q.col_tiles;
  q.cluster = static_cast<int>(tiles < want ? tiles : want);
  const long long clusters = n_maps < kMaxClusters ? n_maps : kMaxClusters;
  q.grid = static_cast<int>(clusters * q.cluster);
  q.cap = p <= kListShort ? kListShort : kListLong;
  q.rounds = (p + q.cap - 1) / q.cap;
  q.smem_bytes = static_cast<int>(tile_smem(th, tw, ntaps, window));
  return q;
}

enum Phase {
  load,
  vertical_blur,
  horizontal_blur,
  window_max_and_peak_mask,
  selection,
  merge,
  store,
  kPhases
};
#ifdef DECODE_GENERIC_PROFILE
__device__ unsigned long long phase_cycles[kPhases + 1];
struct GenericClock {
  long long t[kPhases];
  long long mark;
  __device__ __forceinline__ GenericClock() : mark(0) {
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
struct GenericClock {
  __device__ __forceinline__ void tick(Phase) {}
  __device__ __forceinline__ void flush() {}
};
#endif
#define DG_MARK(phase) clk.tick(phase)

// Calls f(y, x) for the elements tid, tid + kThreads, ... of a rows x cols
// grid in row-major order, without a division in the loop.
template <class F>
__device__ __forceinline__ void for_each_2d(int rows, int cols, F&& f) {
  const int sy = kThreads / cols, sx = kThreads - sy * cols;
  int y = static_cast<int>(threadIdx.x) / cols;
  int x = static_cast<int>(threadIdx.x) - y * cols;
  while (y < rows) {
    f(y, x);
    x += sx;
    y += sy;
    if (x >= cols) {
      x -= cols;
      ++y;
    }
  }
}

// The order key of value v at flat index `flat`, the sub-pixel code 0.
__device__ __forceinline__ unsigned long long key_of(float v, int flat) {
  return static_cast<unsigned long long>(value_bits(v)) << 32 |
         (FLAT_MASK - static_cast<unsigned int>(flat)) << 4;
}

// The sub-pixel code of the element at S[sy * pitch + sx], map position
// (gy, gx), value v: border-clipped neighbours (a missing one is v).
__device__ __forceinline__ unsigned int subpixel_code(
    const float* S, int pitch, int sy, int sx, int gy, int gx, int H, int W,
    float v) {
  const float* c = S + sy * pitch + sx;
  const float up = gy > 0 ? c[-pitch] : v;
  const float down = gy + 1 < H ? c[pitch] : v;
  const float left = gx > 0 ? c[-1] : v;
  const float right = gx + 1 < W ? c[1] : v;
  return sign_code(__fsub_rn(down, up)) << 2 |
         sign_code(__fsub_rn(right, left));
}

// Writes the peak of `key` to slot o.
__device__ __forceinline__ void store_key(unsigned long long key, int W,
                                          float shift, long long o,
                                          float* __restrict__ scores,
                                          float* __restrict__ ys,
                                          float* __restrict__ xs) {
  const unsigned int lo = static_cast<unsigned int>(key & 0xffffffffull);
  const int flat = static_cast<int>(FLAT_MASK - (lo >> 4));
  const int y = flat / W;
  const int x = flat - y * W;
  scores[o] = key_value(key);
  ys[o] = __fadd_rn(static_cast<float>(y), step_of(lo >> 2 & 3u, shift));
  xs[o] = __fadd_rn(static_cast<float>(x), step_of(lo & 3u, shift));
}

// Sizes of the plan that the kernel reads.
struct TileDims {
  int tile_rows, tile_cols, row_tiles, col_tiles, rounds;
};

// One cluster of blocks a map (maps cluster_id, cluster_id + clusters,
// ...); block `rank` takes tiles rank, rank + cluster, ... in row-major
// tile order. T: map dtype. NT: taps (0: ntaps at run time). CAP: list
// length.
template <typename T, int NT, int CAP>
__global__ void __launch_bounds__(kThreads, CAP > kListShort ? 2 : 4)
decode_tiles_kernel(const T* __restrict__ maps, long long sb, long long sk,
                    long long sh, long long sw, long long n_maps, int K,
                    int H, int W, const float* __restrict__ taps, int ntaps,
                    int window, float shift, int p, TileDims d,
                    float* __restrict__ scores, float* __restrict__ ys,
                    float* __restrict__ xs) {
  extern __shared__ __align__(16) unsigned char smem[];  // as decode_rows
  __shared__ unsigned long long warp_best[kWarps][CAP];
  __shared__ unsigned long long cta_best[CAP];   // the block's top CAP
  __shared__ unsigned long long fill[CAP];       // its first others
  __shared__ unsigned long long tile_fill[CAP];  // a tile's first others
  __shared__ int chunk_count[kWarps];
  __shared__ unsigned long long ceiling_key;     // rank 0's last key
  GenericClock clk;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = NT > 0 ? NT : ntaps;
  const int half = nt / 2;
  const int lo = (window - 1) / 2, hi = window / 2;
  const int bl = max(lo, 1), bh = max(hi, 1);
  const int TH = d.tile_rows, TW = d.tile_cols;
  // The blurred region SH x SW (origin r0 - bl, c0 - bl) and the raw one
  // RH x RW (origin r0 - bl - half, c0 - bl - half).
  const int SH = TH + bl + bh, SW = TW + bl + bh;
  const int RH = SH + 2 * half, RW = SW + 2 * half;
  const int tiles = d.row_tiles * d.col_tiles;
  float* tp = reinterpret_cast<float*>(smem);  // the taps (NT == 0)
  float* A = tp + (nt + 3) / 4 * 4;       // raw, then blurred (pitch SW)
  float* B = A + RH * RW;                 // vertical pass, then row max
  unsigned char* flags =                  // the tile's mask
      reinterpret_cast<unsigned char*>(B + SH * RW);
  float tr[NT > 0 ? NT : 1];              // the taps in registers (NT > 0)
  if constexpr (NT > 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j) tr[j] = taps[j];
  } else {
    for (int j = tid; j < nt; j += kThreads) tp[j] = taps[j];
  }
  auto tap = [&](int j) -> float {
    if constexpr (NT > 0) {
      return tr[j];
    } else {
      return tp[j];
    }
  };

  const long long clusters = gridDim.x / cs;
  for (long long m = blockIdx.x / cs; m < n_maps; m += clusters) {
    const long long b = m / K;
    const T* src = maps + b * sb + (m - b * K) * sk;
    // Keys at or above it (the code bits cleared) were taken in earlier
    // rounds.
    unsigned long long ceiling = ~0ull & ~15ull;
    for (int round = 0; round < d.rounds; ++round) {
      unsigned long long best[CAP];
#pragma unroll
      for (int j = 0; j < CAP; ++j) best[j] = 0ull;
      if (tid < CAP) fill[tid] = 0ull;
      for (int t = rank; t < tiles; t += cs) {
        const int r0 = t / d.col_tiles * TH;
        const int c0 = (t - t / d.col_tiles * d.col_tiles) * TW;
        __syncthreads();  // the previous tile's readers are done
        const int ry0 = r0 - bl - half, rx0 = c0 - bl - half;
        {  // kLoads loads in flight a thread, then their stores
          const int sy = kThreads / RW, sx = kThreads - sy * RW;
          int y = tid / RW, x = tid - y * RW;
          while (y < RH) {
            float v[kLoads];
            int at[kLoads];
#pragma unroll
            for (int u = 0; u < kLoads; ++u) {
              const int gy = ry0 + y, gx = rx0 + x;
              at[u] = y < RH ? y * RW + x : -1;
              v[u] = y < RH && gy >= 0 && gy < H && gx >= 0 && gx < W
                         ? to_f32(src[gy * sh + gx * sw])
                         : 0.f;
              x += sx;
              y += sy;
              if (x >= RW) {
                x -= RW;
                ++y;
              }
            }
#pragma unroll
            for (int u = 0; u < kLoads; ++u) {
              if (at[u] >= 0) A[at[u]] = v[u];
            }
          }
        }
        __syncthreads();
        DG_MARK(load);

        // Vertical pass: V row y sums raw rows y .. y + nt - 1 in tap
        // order; a thread takes kRows rows of a column, each raw value
        // read once for all of them.
        for_each_2d((SH + kRows - 1) / kRows, RW, [&](int g, int x) {
          const int y0 = g * kRows;
          const float* col = A + x;
          float acc[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll
          for (int jj = 0; jj < nt + kRows - 1; ++jj) {
            const float v = col[min(y0 + jj, RH - 1) * RW];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const int kk = jj - r;
              if (kk >= 0 && kk < nt) {
                acc[r] = __fadd_rn(acc[r], __fmul_rn(v, tap(kk)));
              }
            }
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (y0 + r < SH) B[(y0 + r) * RW + x] = acc[r];
          }
        });
        __syncthreads();
        DG_MARK(vertical_blur);

        // Horizontal pass into A (pitch SW): -inf outside the map, for the
        // window max. A thread sums kRows rows of a column, independent
        // chains of adds in flight together.
        for_each_2d((SH + kRows - 1) / kRows, SW, [&](int g, int x) {
          const int y0 = g * kRows;
          float acc[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll
          for (int j = 0; j < nt; ++j) {
            const float t = tap(j);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float v = B[min(y0 + r, SH - 1) * RW + x + j];
              acc[r] = __fadd_rn(acc[r], __fmul_rn(v, t));
            }
          }
          const int gx = c0 - bl + x;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int y = y0 + r, gy = r0 - bl + y;
            if (y < SH) {
              A[y * SW + x] = gy >= 0 && gy < H && gx >= 0 && gx < W
                                  ? acc[r]
                                  : -INFINITY;
            }
          }
        });
        __syncthreads();
        DG_MARK(horizontal_blur);

        // Row max over the window's columns, for blurred rows r0 - lo ..
        // r0 + TH - 1 + hi, into B (pitch TW).
        const int mrows = TH + lo + hi;
        for_each_2d((mrows + kRows - 1) / kRows, TW, [&](int g, int x) {
          const int y0 = g * kRows;
          const float* col = A + (bl - lo + y0) * SW + bl - lo + x;
          float mx[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            mx[r] = col[min(r, mrows - 1 - y0) * SW];
          }
#pragma unroll 4
          for (int j = 1; j < window; ++j) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              mx[r] = max_nan(mx[r], col[min(r, mrows - 1 - y0) * SW + j]);
            }
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (y0 + r < mrows) B[(y0 + r) * TW + x] = mx[r];
          }
        });
        __syncthreads();
        // Column max of kRows rows a thread, sharing their reads, and the
        // mask: kPeak for a peak above -inf, kOther for any other element,
        // each below the ceiling, else 0.
        for_each_2d((TH + kRows - 1) / kRows, TW, [&](int g, int x) {
          const int y0 = g * kRows;
          float mx[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) mx[r] = -INFINITY;
          const int last = min(y0 + kRows - 1 + window, mrows);
#pragma unroll 4
          for (int yy = y0; yy < last; ++yy) {
            const float v = B[yy * TW + x];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              if (yy >= y0 + r && yy < y0 + r + window) {
                mx[r] = max_nan(mx[r], v);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int y = y0 + r, gy = r0 + y, gx = c0 + x;
            if (y < TH) {
              unsigned char flag = 0;
              if (gy < H && gx < W) {
                const float v = A[(bl + y) * SW + bl + x];
                const int flat = gy * W + gx;
                if (v >= mx[r] && v > -INFINITY) {
                  flag = key_of(v, flat) < ceiling ? kPeak : 0;
                } else {
                  flag = key_of(-INFINITY, flat) < ceiling ? kOther : 0;
                }
              }
              flags[y * TW + x] = flag;
            }
          }
        });
        __syncthreads();
        // The thread's elements tid + e * kThreads of the tile: bit e of
        // `peaks` and `others`.
        unsigned int peaks = 0u, others = 0u;
        for (int e = 0, i = tid; i < TH * TW; ++e, i += kThreads) {
          const unsigned char flag = flags[i];
          peaks |= static_cast<unsigned int>(flag == kPeak) << e;
          others |= static_cast<unsigned int>(flag == kOther) << e;
        }
        DG_MARK(window_max_and_peak_mask);

        // Insertion of the marked peaks that beat the thread's CAP-th key.
        while (peaks != 0u) {
          const int i = tid + (__ffs(peaks) - 1) * kThreads;
          peaks &= peaks - 1u;
          const int y = i / TW, x = i - y * TW;
          const int gy = r0 + y, gx = c0 + x;
          const float v = A[(bl + y) * SW + bl + x];
          const unsigned long long key = key_of(v, gy * W + gx);
          if (key > best[CAP - 1]) {
            best[CAP - 1] =
                key | subpixel_code(A, SW, bl + y, bl + x, gy, gx, H, W, v);
#pragma unroll
            for (int j = CAP - 1; j > 0; --j) {
              if (best[j] > best[j - 1]) {
                const unsigned long long s = best[j];
                best[j] = best[j - 1];
                best[j - 1] = s;
              }
            }
          }
        }
        // The tile's first CAP others in flat order (tile order, chunk by
        // chunk of kThreads elements), unless the block holds CAP others
        // that all come before the tile's first element.
        if (!(fill[CAP - 1] > key_of(-INFINITY, r0 * W + c0))) {
          int taken = 0;  // the same in every thread
          const int chunks = (TH * TW + kThreads - 1) / kThreads;
          for (int e = 0; e < chunks && taken < CAP; ++e) {
            const bool mine = others >> e & 1u;
            const unsigned int vote = __ballot_sync(0xffffffffu, mine);
            if (lane == 0) chunk_count[warp] = __popc(vote);
            __syncthreads();
            int before = 0, total = 0;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
              const int c = chunk_count[w];
              before += w < warp ? c : 0;
              total += c;
            }
            const int at = taken + before + __popc(vote & ((1u << lane) - 1u));
            if (mine && at < CAP) {
              const int i = tid + e * kThreads;
              const int y = i / TW, x = i - y * TW;
              const int gy = r0 + y, gx = c0 + x;
              const float v = A[(bl + y) * SW + bl + x];
              tile_fill[at] = key_of(-INFINITY, gy * W + gx) |
                              subpixel_code(A, SW, bl + y, bl + x, gy, gx, H,
                                            W, v);
            }
            taken += total;
            __syncthreads();  // chunk_count is read
          }
          if (tid == 0) {  // fill = the top CAP of fill and tile_fill
            const int n_tile = min(taken, CAP);
            unsigned long long merged[CAP];
            int a = 0, c = 0;
            for (int j = 0; j < CAP; ++j) {
              const unsigned long long fa = fill[a];
              const unsigned long long fb = c < n_tile ? tile_fill[c] : 0ull;
              if (fa >= fb) {
                merged[j] = fa;
                ++a;
              } else {
                merged[j] = fb;
                ++c;
              }
            }
            for (int j = 0; j < CAP; ++j) fill[j] = merged[j];
          }
        }
        DG_MARK(selection);
      }

      // The block's top CAP: its peaks' keys, then its first others.
      unsigned long long mine = warp_merge<CAP>(best, lane);
      if (lane < CAP) warp_best[warp][lane] = mine;
      __syncthreads();
      if (warp == 0) {
        unsigned long long l[CAP];
#pragma unroll
        for (int j = 0; j < CAP; ++j) {
          l[j] = lane < kWarps ? warp_best[lane][j] : 0ull;
        }
        mine = warp_merge<CAP>(l, lane);
        const int c =
            __popc(__ballot_sync(0xffffffffu, lane < CAP && mine != 0ull));
        if (lane < CAP) cta_best[lane] = lane < c ? mine : fill[lane - c];
      }
      cluster.sync();
      DG_MARK(merge);
      if (rank == 0 && warp == 0) {  // the cluster's top CAP, stored
        unsigned long long l[CAP];
        const unsigned long long* remote =
            cluster.map_shared_rank(&cta_best[0], lane < cs ? lane : 0);
#pragma unroll
        for (int j = 0; j < CAP; ++j) l[j] = lane < cs ? remote[j] : 0ull;
        mine = warp_merge<CAP>(l, lane);
        const int slot = round * CAP + lane;
        if (lane < CAP && slot < p) {
          store_key(mine, W, shift, m * p + slot, scores, ys, xs);
        }
        if (lane == CAP - 1) ceiling_key = mine;
      }
      cluster.sync();  // rank 0 is done reading the blocks' lists
      if (round + 1 < d.rounds) {
        ceiling = *cluster.map_shared_rank(&ceiling_key, 0) & ~15ull;
      }
      DG_MARK(store);
    }
  }
  clk.flush();
}

// The path for taps or windows too wide for a tile's halo in shared
// memory: a block per map; its threads stride over the map for the
// vertical pass (into workspace plane 0), the horizontal pass (plane 1,
// the blurred map) and the peak mask (back into plane 0); then P rounds
// each take a block-wide max of the keys below the previous round's
// winner, and thread 0 writes it with its sub-pixel step.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_global_kernel(const T* __restrict__ maps, long long sb, long long sk,
                     long long sh, long long sw, int K, int H, int W,
                     const float* __restrict__ taps, int ntaps, int window,
                     float shift, int p, float* __restrict__ work,
                     float* __restrict__ scores, float* __restrict__ ys,
                     float* __restrict__ xs) {
  __shared__ unsigned long long red[kWarps + 1];
  const long long n = blockIdx.x;
  const long long b = n / K;
  const T* src = maps + b * sb + (n - b * K) * sk;
  const int hw = H * W;
  float* plane0 = work + n * hw;
  float* blurred = work + (static_cast<long long>(gridDim.x) + n) * hw;
  const int half = ntaps / 2;

  for (int e = threadIdx.x; e < hw; e += kThreads) {
    const int y = e / W;
    const int x = e - y * W;
    float acc = 0.f;
    for (int j = 0; j < ntaps; ++j) {
      const int yy = y + j - half;
      const float v = yy >= 0 && yy < H ? to_f32(src[yy * sh + x * sw])
                                        : 0.f;
      acc = __fadd_rn(acc, __fmul_rn(v, taps[j]));
    }
    plane0[e] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < hw; e += kThreads) {
    const int y = e / W;
    const int x = e - y * W;
    float acc = 0.f;
    for (int j = 0; j < ntaps; ++j) {
      const int xx = x + j - half;
      const float v = xx >= 0 && xx < W ? plane0[y * W + xx] : 0.f;
      acc = __fadd_rn(acc, __fmul_rn(v, taps[j]));
    }
    blurred[e] = acc;
  }
  __syncthreads();
  const int lo = (window - 1) / 2, hi = window / 2;
  for (int e = threadIdx.x; e < hw; e += kThreads) {
    const int y = e / W;
    const int x = e - y * W;
    const float v = blurred[e];
    float mx = -INFINITY;
    for (int yy = max(y - lo, 0); yy <= min(y + hi, H - 1); ++yy) {
      for (int xx = max(x - lo, 0); xx <= min(x + hi, W - 1); ++xx) {
        mx = max_nan(mx, blurred[yy * W + xx]);
      }
    }
    plane0[e] = v >= mx ? v : -INFINITY;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned long long prev = ~0ull;
  for (int r = 0; r < p; ++r) {
    unsigned long long best = 0ull;
    for (int e = threadIdx.x; e < hw; e += kThreads) {
      const unsigned long long key = key_of(plane0[e], e);
      if (key < prev && key > best) best = key;
    }
    best = warp_max(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = warp_max(lane < kWarps ? red[lane] : 0ull);
      if (lane == 0) red[kWarps] = best;
    }
    __syncthreads();
    prev = red[kWarps];
    if (threadIdx.x == 0) {
      const int flat = static_cast<int>(
          FLAT_MASK - (static_cast<unsigned int>(prev) >> 4));
      const int y = flat / W;
      const int x = flat - y * W;
      store_key(prev | subpixel_code(blurred, W, y, x, y, x, H, W,
                                     blurred[flat]),
                W, shift, n * p + r, scores, ys, xs);
    }
  }
}

// The current device's SM count and index, asked once per device.
int device_sms(int* sms, int* dev) {
  static int cache[64] = {};
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (*dev < 0 || *dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (cache[*dev] == 0) {
    e = cudaDeviceGetAttribute(&cache[*dev], cudaDevAttrMultiProcessorCount,
                               *dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  *sms = cache[*dev];
  return 0;
}

template <typename T, int NT, int CAP>
int launch_tiles(const Plan& q, int dev, const void* maps, long long sb,
                 long long sk, long long sh, long long sw, long long n_maps,
                 int K, int H, int W, const float* taps, int ntaps,
                 int window, float shift, int p, float* scores, float* ys,
                 float* xs, cudaStream_t stream) {
  auto kernel = decode_tiles_kernel<T, NT, CAP>;
  // The shared memory this instantiation may take on each device so far.
  static int allowed[64] = {};
  if (q.smem_bytes > 48 * 1024 && q.smem_bytes > allowed[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q.smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[dev] = q.smem_bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(q.grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(q.smem_bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(q.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const TileDims d{q.tile_rows, q.tile_cols, q.row_tiles, q.col_tiles,
                   q.rounds};
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(maps), sb, sk, sh, sw, n_maps, K,
      H, W, taps, ntaps, window, shift, p, d, scores, ys, xs);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The tiles kernel's instantiation for the map dtype, the tap count (7,
// the default config's, at compile time) and the list length.
template <typename T>
int launch_tiles_for(const Plan& q, int dev, const void* maps, long long sb,
                     long long sk, long long sh, long long sw,
                     long long n_maps, int K, int H, int W,
                     const float* taps, int ntaps, int window, float shift,
                     int p, float* scores, float* ys, float* xs,
                     cudaStream_t s) {
  if (ntaps == 7) {
    return q.cap == kListShort
               ? launch_tiles<T, 7, kListShort>(q, dev, maps, sb, sk, sh, sw,
                                                n_maps, K, H, W, taps, ntaps,
                                                window, shift, p, scores, ys,
                                                xs, s)
               : launch_tiles<T, 7, kListLong>(q, dev, maps, sb, sk, sh, sw,
                                               n_maps, K, H, W, taps, ntaps,
                                               window, shift, p, scores, ys,
                                               xs, s);
  }
  return q.cap == kListShort
             ? launch_tiles<T, 0, kListShort>(q, dev, maps, sb, sk, sh, sw,
                                              n_maps, K, H, W, taps, ntaps,
                                              window, shift, p, scores, ys,
                                              xs, s)
             : launch_tiles<T, 0, kListLong>(q, dev, maps, sb, sk, sh, sw,
                                             n_maps, K, H, W, taps, ntaps,
                                             window, shift, p, scores, ys,
                                             xs, s);
}

bool refused(int B, int K, int H, int W, int ntaps, int window, int p) {
  return ntaps < 1 || (ntaps & 1) == 0 || window < 1 || B < 1 || K < 1 ||
         H < 1 || W < 1 || static_cast<long long>(H) * W > FLAT_MASK ||
         p < 1 || static_cast<long long>(H) * W < p ||
         static_cast<long long>(B) * K > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// maps: [B, K, H, W] read through the element strides sb, sk, sh, sw;
// dtype: 0 = float32, 1 = bfloat16. taps: ntaps (odd) blur taps in device
// memory; window: the peak window (>= 1); p: peaks per map, 1..H*W.
// work: 2 * B * K * H * W float32 of device memory where the plan's path
// is 1 (decode_generic_plan), else unused (may be null). Outputs
// scores/ys/xs: [B*K, p] float32, contiguous, map n = b*K + k. H*W < 2^28.
// Returns a cudaError_t code.
int decode_generic(const void* maps, int dtype, long long sb, long long sk,
                   long long sh, long long sw, int B, int K, int H, int W,
                   const float* taps, int ntaps, int window, float shift,
                   int p, float* work, float* scores, float* ys, float* xs,
                   void* stream) {
  if (refused(B, K, H, W, ntaps, window, p) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0, dev = 0;
  const int e = device_sms(&sms, &dev);
  if (e != 0) return e;
  const long long n_maps = static_cast<long long>(B) * K;
  const Plan q = make_plan(n_maps, H, W, ntaps, window, p, sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q.path == 1) {
    if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0) {
      decode_global_kernel<float><<<q.grid, kThreads, 0, s>>>(
          static_cast<const float*>(maps), sb, sk, sh, sw, K, H, W, taps,
          ntaps, window, shift, p, work, scores, ys, xs);
    } else {
      decode_global_kernel<__nv_bfloat16><<<q.grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(maps), sb, sk, sh, sw, K, H, W,
          taps, ntaps, window, shift, p, work, scores, ys, xs);
    }
    return static_cast<int>(cudaGetLastError());
  }
  return dtype == 0
             ? launch_tiles_for<float>(q, dev, maps, sb, sk, sh, sw, n_maps,
                                       K, H, W, taps, ntaps, window, shift,
                                       p, scores, ys, xs, s)
             : launch_tiles_for<__nv_bfloat16>(q, dev, maps, sb, sk, sh, sw,
                                               n_maps, K, H, W, taps, ntaps,
                                               window, shift, p, scores, ys,
                                               xs, s);
}

// The launch plan `decode_generic` takes for n_maps maps of H x W with
// ntaps taps, the peak window and p peaks on a card of `sms` SMs (sms < 1:
// the current device's), as kPlanFields ints in the order of struct Plan.
// Returns a cudaError_t code.
int decode_generic_plan(long long n_maps, int H, int W, int ntaps,
                        int window, int p, int sms, int* out) {
  if (n_maps < 1 || n_maps > 0x7fffffffLL ||
      refused(1, 1, H, W, ntaps, window, p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sms < 1) {
    int dev = 0;
    const int e = device_sms(&sms, &dev);
    if (e != 0) return e;
  }
  const Plan q = make_plan(n_maps, H, W, ntaps, window, p, sms);
  const int fields[kPlanFields] = {q.path, q.tile_rows, q.tile_cols,
                                   q.row_tiles, q.col_tiles, q.cluster,
                                   q.grid, q.cap, q.rounds, q.smem_bytes};
  for (int i = 0; i < kPlanFields; ++i) out[i] = fields[i];
  return 0;
}

#ifdef DECODE_GENERIC_PROFILE
// Reads (and with reset != 0 then zeroes) the phase counters: kPhases + 1
// values.
int decode_generic_phase_cycles(unsigned long long* host, int reset) {
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
