// Heatmap peak decode for NVIDIA Hopper (sm_90a): each warp streams the
// rows of one map, or of one band of rows of a map, top to bottom.
//
// Replaces the TPU kernel multiposenet_tpu/ops/decode_pallas.py
// `_decode_kernel` (banded-matmul blur + two-phase masked-argmax top-P).
// Per map [H, W]: zero-padded separable Gaussian blur (vertical taps, then
// horizontal), 3x3 max filter with -inf borders keeping plateau ties,
// top-P by (value desc, flat index asc) over the peak-masked map, where
// non-peaks rank as -inf, and a +-shift sub-pixel offset from the
// border-clipped neighbours of each winner. Each blur pass is summed tap
// by tap from 0.0 in the plain version's order with __fmul_rn/__fadd_rn,
// so nvcc cannot fuse them into FMAs, and the result agrees bit for bit
// with the plain PyTorch version (ops/decode.py decode_maps_plain). A tap
// that falls outside the map adds a zero product, which leaves the sum
// unchanged, as the plain version's zero padding does.
//
// Bound on the card: the kernel must read each map once (2176 bf16 maps
// of 128x128 are 71.3 MB, 21 us at 3.35 TB/s) and do 37 f32 operations
// per element (a multiply and an add per tap in each pass, eight maxima
// and a comparison), none of which may be an FMA: at 132 SMs x 128 lanes
// x 1.98 GHz that is 39 us, so operations bound it.
//
// Design:
// - A warp owns a map, or a band of its rows when there are too few maps
//   to fill the card (a `predict` request's 17 maps take 8 bands each),
//   and a lane owns C neighbouring columns. Raw rows stream through a
//   ring of kRing rows in shared memory. On the path's instantiation
//   (128x128, 7 taps, P = 8) rows arrive by 16-byte cp.async, Q steps
//   ahead of their use, so a warp's loads overlap its own compute and
//   that of the other warps on the SM; a warp needs under 6 KiB of shared
//   memory, and the fast() batch puts about 16 warps on every SM at once.
// - Each step blurs two rows, which share their ring reads and give each
//   lane twice the independent sums: the blur is a chain of dependent
//   adds in a fixed order, so the warps are bound by latency, not issue.
//   The vertical pass reads the ring and the horizontal one zero-padded
//   rows in shared memory, both with vector loads; the taps are kernel
//   parameters at indices known at compile time (no local memory).
// - The peak test keeps the latest blurred rows in registers and takes
//   its column neighbours by shuffles. Each lane keeps a sorted top-P of
//   64-bit keys (value, ~flat index, and the sub-pixel signs in the low 4
//   bits, taken while the neighbours are at hand). A warp-wide floor (a
//   lower bound of the warp's P-th key so far, refreshed after steps 0, 1,
//   3, 7, 15 and every kRefresh after) keeps most elements out of the
//   insertion. The warp merges its lanes' lists in P rounds of a shuffle
//   max, and the warps of a banded map merge once more in warp 0.
// - No division or modulo in the loops: rows and columns are walked in
//   2-D, ring slots are masks, and the path's sizes are template
//   parameters. Other sizes (W up to 512, any odd tap count up to 15, any
//   P) run the same kernel with the sizes given at run time and plain row
//   loads.
// Built with -DDECODE_PEAKS_PROFILE it counts clock64 cycles per phase
// (multiposenet_tpu_torch/tools/decode_phases.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_TAPS 15
#define MAX_PEAKS 16
#define FLAT_MASK 0x0fffffffu  // flat indices below 2^28

namespace {

constexpr int kCenter = MAX_TAPS / 2;  // taps are stored centred here
constexpr int kRing = 16;     // raw rows per warp: >= 2 * half + 1 + PF
constexpr int kPad = 8;       // zero floats each side of the blurred row
constexpr int kMaxBands = 8;  // warps per block (bands of one map)
constexpr int kGenericCols = 16;  // columns per lane off the path: W <= 512
constexpr int kSmemBytes = 232448 - 1024;  // per block, less static arrays
constexpr int kRefresh = 16;  // steps between refreshes of the warp's P-th key

struct Params {
  float taps[MAX_TAPS];  // tap j of n at taps[kCenter - n / 2 + j], else 0
  int ntaps;
  float shift;
};

#ifdef DECODE_PEAKS_PROFILE
// Phase counters of thread 0, summed over blocks (built only with
// -DDECODE_PEAKS_PROFILE, by multiposenet_tpu_torch/tools/decode_phases.py):
// clock64 cycles in the row loads (issue and wait), the vertical blur, the
// horizontal blur, the peak mask with the per-lane top-P, the merge, and
// the sub-pixel step with the store; then the number of blocks.
constexpr int kPhases = 6;
__device__ unsigned long long phase_cycles[kPhases + 1];
#define DP_MARK(i)                       \
  if (threadIdx.x == 0) {                \
    const long long now = clock64();     \
    prof[i] += now - t_mark;             \
    t_mark = now;                        \
  }
#else
#define DP_MARK(i)
#endif

// Order-preserving key: larger key = higher value, then smaller flat
// index; the 4 low bits carry the sub-pixel code and never decide, since
// flat indices are unique within a map.
__device__ __forceinline__ unsigned int value_bits(float v) {
  const unsigned int b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned long long k) {
  unsigned int b = static_cast<unsigned int>(k >> 32);
  b = (b & 0x80000000u) ? (b & 0x7fffffffu) : ~b;
  return __uint_as_float(b);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, v, o);
    v = other > v ? other : v;
  }
  return v;
}

__device__ __forceinline__ int sign_of(float d) {
  return d > 0.f ? 1 : (d < 0.f ? -1 : 0);
}

// P rounds of a max over the lanes' sorted lists; the lane holding the
// winner pops it. Lane r < P returns the r-th key.
template <int P>
__device__ __forceinline__ unsigned long long warp_merge(
    unsigned long long (&best)[P], int lane) {
  unsigned long long mine = 0ull;
#pragma unroll 1
  for (int r = 0; r < P; ++r) {
    const unsigned long long c = warp_max(best[0]);
    if (best[0] == c) {
#pragma unroll
      for (int j = 0; j < P - 1; ++j) best[j] = best[j + 1];
      best[P - 1] = 0ull;
    }
    if (lane == r) mine = c;
  }
  return mine;
}

// A lower bound of the P-th largest key over the lanes' sorted lists
// (which stay as they are): the P-th largest of their value halves, with
// the index half 0. No element below it can reach the warp's top-P.
template <int P>
__device__ __forceinline__ unsigned long long warp_kth(
    const unsigned long long (&best)[P], int lane) {
  unsigned int t[P];  // the value halves of the keys
#pragma unroll
  for (int j = 0; j < P; ++j) t[j] = static_cast<unsigned int>(best[j] >> 32);
  unsigned int c = 0u;
#pragma unroll 1
  for (int r = 0; r < P; ++r) {
    c = t[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      c = max(c, __shfl_xor_sync(0xffffffffu, c, o));
    }
    // One lane pops the winner, the lowest of those that hold it.
    if (lane == __ffs(__ballot_sync(0xffffffffu, t[0] == c)) - 1) {
#pragma unroll
      for (int j = 0; j < P - 1; ++j) t[j] = t[j + 1];
      t[P - 1] = 0u;
    }
  }
  return static_cast<unsigned long long>(c) << 32;
}

// N values at p (aligned to 4 elements) as floats.
template <int N>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x;
    v[i + 1] = q.y;
    v[i + 2] = q.z;
    v[i + 3] = q.w;
  }
}

template <int N>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p + i);
    v[i] = __uint_as_float(q.x << 16);
    v[i + 1] = __uint_as_float(q.x & 0xffff0000u);
    v[i + 2] = __uint_as_float(q.y << 16);
    v[i + 3] = __uint_as_float(q.y & 0xffff0000u);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of one warp: the raw ring, then two vertically blurred
// rows.
template <typename T, int C>
__host__ __device__ constexpr int warp_smem_bytes() {
  return kRing * 32 * C * static_cast<int>(sizeof(T)) +
         2 * (32 * C + 2 * kPad) * static_cast<int>(sizeof(float));
}

// T: map dtype. P: length of each lane's list (>= the p asked for).
// C: columns per lane. NT: taps (0: at run time, up to MAX_TAPS).
// WT, HT: map size (0: at run time). The path's instantiation fixes all
// of them and loads rows by cp.async; the other loads rows with plain
// loads.
template <typename T, int P, int C, int NT, int WT, int HT>
__global__ void __launch_bounds__(32 * kMaxBands)
decode_peaks_kernel(const T* __restrict__ maps, long long batch_stride,
                    int maps_per_batch, int h_rt, int w_rt, int p,
                    Params prm, float* __restrict__ scores,
                    float* __restrict__ ys, float* __restrict__ xs) {
  constexpr bool kAsync = WT > 0;
  constexpr int RP = 32 * C;                  // ring row pitch, elements
  constexpr int KT = NT > 0 ? NT : MAX_TAPS;  // taps walked
  constexpr int KH = KT / 2;
  // Steps staged ahead: the ring holds rows y - half .. y + 1 + half of
  // this step and two rows for each of the Q steps after it, and what a
  // step stages must not overwrite a row of the step before it.
  constexpr int Q = kAsync ? (kRing - 2 * KH - 2) / 2 : 0;
  // Floats read each side of a lane's columns in the horizontal pass.
  constexpr int HV = ((KH + 3) / 4) * 4;
  static_assert(2 * KH + 2 + 2 * Q <= kRing && 2 * KH + 1 + 2 * Q < kRing,
                "ring too small");
  static_assert(!kAsync || Q >= 1, "no prefetch");
  static_assert(HV <= kPad && C % 4 == 0, "row layout");
  const int H = HT > 0 ? HT : h_rt;
  const int W = WT > 0 ? WT : w_rt;
  const int half = NT > 0 ? NT / 2 : prm.ntaps / 2;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long band_best[kMaxBands][P];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bands = blockDim.x >> 5;
  T* ring = reinterpret_cast<T*>(smem + warp * warp_smem_bytes<T, C>());
  float* trow = reinterpret_cast<float*>(ring + kRing * RP);

  const int n = blockIdx.x;
  const int b = n / maps_per_batch;
  const int k = n - b * maps_per_batch;
  const T* src = maps + b * batch_stride + static_cast<long long>(k) * H * W;
#ifdef DECODE_PEAKS_PROFILE
  long long prof[kPhases] = {}, t_mark = clock64();
#endif

  // This warp's band: it tests rows [r0, r1) and blurs rows r0 - 1 .. r1
  // (-inf outside the map) two at a time, in `steps` steps from ya. Step
  // s needs raw rows ya + 2s - half .. ya + 2s + 1 + half (zero outside
  // the map); it stages the two new rows of step s + Q.
  const int rows = (H + bands - 1) / bands;
  const int r0 = min(warp * rows, H);
  const int r1 = min(r0 + rows, H);
  const int ya = r0 - 1;
  const int steps = (r1 - r0 + 3) / 2;
  const int last_raw = ya + 2 * steps - 1 + half;

  for (int i = lane; i < 2 * (RP + 2 * kPad); i += 32) trow[i] = 0.f;

  auto stage = [&](int r) {  // raw row r into its ring slot
    if (r > last_raw) return;
    T* dst = ring + (r & (kRing - 1)) * RP;
    if (r < 0 || r >= H) {
      constexpr int kVec = RP * static_cast<int>(sizeof(T)) / 16;
      for (int i = lane; i < kVec; i += 32) {
        reinterpret_cast<uint4*>(dst)[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    } else if constexpr (kAsync) {
      constexpr int kVec = WT * static_cast<int>(sizeof(T)) / 16;
      const T* row = src + static_cast<long long>(r) * W;
#pragma unroll
      for (int i = lane; i < kVec; i += 32) {
        cp_async16(reinterpret_cast<uint4*>(dst) + i,
                   reinterpret_cast<const uint4*>(row) + i);
      }
    } else {
      const T* row = src + static_cast<long long>(r) * W;
      for (int x = lane; x < W; x += 32) dst[x] = row[x];
    }
  };

  unsigned long long best[P];
#pragma unroll
  for (int j = 0; j < P; ++j) best[j] = 0ull;
  // A lower bound of the warp's P-th key so far (warp_kth): a lane
  // inserts only what beats both it and the lane's own P-th key, so that
  // after the first rows few elements take the insertion.
  unsigned long long floor_key = 0ull;
  // Blurred rows: sp, sc the two before this step's pair s0, s1.
  float sp[C], sc[C], s0[C], s1[C];
#pragma unroll
  for (int c = 0; c < C; ++c) sp[c] = sc[c] = -INFINITY;
  const int x0 = lane * C;

  // Peak test of rows y - 1 (sc, between sp and s0) and y (s0, between
  // sc and s1), those of them in the band. All keys first, then the
  // insertions, which the lanes take one element at a time.
  auto test_pair = [&](int y) {
    const bool in_a = y - 1 >= r0 && y - 1 < r1, in_b = y >= r0 && y < r1;
    float vma[C], vmb[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float t = fmaxf(sc[c], s0[c]);
      vma[c] = fmaxf(sp[c], t);
      vmb[c] = fmaxf(t, s1[c]);
    }
    float vla = __shfl_up_sync(0xffffffffu, vma[C - 1], 1);
    float vra = __shfl_down_sync(0xffffffffu, vma[0], 1);
    float vlb = __shfl_up_sync(0xffffffffu, vmb[C - 1], 1);
    float vrb = __shfl_down_sync(0xffffffffu, vmb[0], 1);
    const float cla = __shfl_up_sync(0xffffffffu, sc[C - 1], 1);
    const float cra = __shfl_down_sync(0xffffffffu, sc[0], 1);
    const float clb = __shfl_up_sync(0xffffffffu, s0[C - 1], 1);
    const float crb = __shfl_down_sync(0xffffffffu, s0[0], 1);
    if (lane == 0) vla = vlb = -INFINITY;
    if (lane == 31) vra = vrb = -INFINITY;
    const unsigned long long lim =
        floor_key > best[P - 1] ? floor_key : best[P - 1];
    const unsigned int lo_a =
        (FLAT_MASK - static_cast<unsigned int>((y - 1) * W + x0)) << 4;
    const unsigned int lo_b = lo_a - (static_cast<unsigned int>(W) << 4);
    unsigned long long key[2 * C];
    unsigned int want = 0u;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const bool col = WT > 0 || x0 + c < W;
      const float ma = fmaxf(fmaxf(c > 0 ? vma[c - 1] : vla, vma[c]),
                             c + 1 < C ? vma[c + 1] : vra);
      const float mb = fmaxf(fmaxf(c > 0 ? vmb[c - 1] : vlb, vmb[c]),
                             c + 1 < C ? vmb[c + 1] : vrb);
      key[c] = (static_cast<unsigned long long>(
                    value_bits(sc[c] >= ma ? sc[c] : -INFINITY)) << 32) |
               (lo_a - (static_cast<unsigned int>(c) << 4));
      key[C + c] = (static_cast<unsigned long long>(
                        value_bits(s0[c] >= mb ? s0[c] : -INFINITY)) << 32) |
                   (lo_b - (static_cast<unsigned int>(c) << 4));
      if (in_a && col && key[c] > lim) want |= 1u << c;
      if (in_b && col && key[C + c] > lim) want |= 1u << (C + c);
    }
    if (!__any_sync(0xffffffffu, want != 0u)) return;
#pragma unroll
    for (int e = 0; e < 2 * C; ++e) {
      const int c = e % C;
      const bool row_b = e >= C;
      if ((want >> e & 1u) && key[e] > best[P - 1]) {
        // Border-clipped neighbours: a missing one is the element itself.
        const int r = row_b ? y : y - 1;
        const int x = x0 + c;
        const float v = row_b ? s0[c] : sc[c];
        const float left =
            x == 0 ? v
            : c > 0 ? (row_b ? s0[c > 0 ? c - 1 : 0] : sc[c > 0 ? c - 1 : 0])
                    : (row_b ? clb : cla);
        const float right =
            x + 1 == W ? v
            : c + 1 < C ? (row_b ? s0[c + 1 < C ? c + 1 : c]
                                 : sc[c + 1 < C ? c + 1 : c])
                        : (row_b ? crb : cra);
        const float above = r > 0 ? (row_b ? sc[c] : sp[c]) : v;
        const float below = r + 1 < H ? (row_b ? s1[c] : s0[c]) : v;
        const int sy = sign_of(__fsub_rn(below, above));
        const int sx = sign_of(__fsub_rn(right, left));
        best[P - 1] =
            key[e] | static_cast<unsigned int>((sy + 1) * 3 + sx + 1);
#pragma unroll
        for (int j = P - 1; j > 0; --j) {
          if (best[j] > best[j - 1]) {
            const unsigned long long t = best[j];
            best[j] = best[j - 1];
            best[j - 1] = t;
          }
        }
      }
    }
  };

  // Horizontal pass of one blurred row held in tr; the zero pads and the
  // zeroed columns past W stand for the blur's zero padding. Rows outside
  // the map are -inf for the peak test.
  auto horizontal = [&](const float* tr, int y, float (&out)[C]) {
    float v[C + 2 * HV];
    load_cols<C + 2 * HV>(tr + kPad + x0 - HV, v);
    const bool inside = y >= 0 && y < H;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float s = 0.f;
#pragma unroll
      for (int jj = 0; jj < KT; ++jj) {
        const int d = jj - KH;
        if (NT > 0 || (d >= -half && d <= half)) {
          s = __fadd_rn(s, __fmul_rn(v[HV + c + d], prm.taps[kCenter + d]));
        }
      }
      out[c] = inside && (WT > 0 || x0 + c < W) ? s : -INFINITY;
    }
  };

  for (int r = ya - half; r < ya + half; ++r) stage(r);
  if constexpr (kAsync) {
    cp_async_commit();
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      stage(ya + 2 * q + half);
      stage(ya + 2 * q + 1 + half);
      cp_async_commit();
    }
  }
  for (int st = 0; st < steps; ++st) {
    const int y = ya + 2 * st;
    stage(y + 2 * Q + half);
    stage(y + 2 * Q + 1 + half);
    if constexpr (kAsync) {
      cp_async_commit();
      cp_async_wait<Q>();
    }
    __syncwarp();
    DP_MARK(0)

    // Vertical pass of rows y and y + 1: each of the KT + 1 ring rows is
    // read once and feeds both sums, each in tap order.
    {
      float a0[C], a1[C];
#pragma unroll
      for (int c = 0; c < C; ++c) a0[c] = a1[c] = 0.f;
#pragma unroll
      for (int jj = 0; jj <= KT; ++jj) {
        const int d0 = jj - KH, d1 = jj - 1 - KH;
        const bool use0 = jj < KT && (NT > 0 || (d0 >= -half && d0 <= half));
        const bool use1 = jj > 0 && (NT > 0 || (d1 >= -half && d1 <= half));
        if (use0 || use1) {
          float v[C];
          load_cols<C>(ring + ((y + d0) & (kRing - 1)) * RP + x0, v);
          if (use0) {
            const float tap = prm.taps[kCenter + d0];
#pragma unroll
            for (int c = 0; c < C; ++c) {
              a0[c] = __fadd_rn(a0[c], __fmul_rn(v[c], tap));
            }
          }
          if (use1) {
            const float tap = prm.taps[kCenter + d1];
#pragma unroll
            for (int c = 0; c < C; ++c) {
              a1[c] = __fadd_rn(a1[c], __fmul_rn(v[c], tap));
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < C; c += 4) {
        float4 q0, q1;
        const bool i0 = WT > 0 || x0 + c < W, i1 = WT > 0 || x0 + c + 1 < W;
        const bool i2 = WT > 0 || x0 + c + 2 < W;
        const bool i3 = WT > 0 || x0 + c + 3 < W;
        q0.x = i0 ? a0[c] : 0.f;
        q0.y = i1 ? a0[c + 1] : 0.f;
        q0.z = i2 ? a0[c + 2] : 0.f;
        q0.w = i3 ? a0[c + 3] : 0.f;
        q1.x = i0 ? a1[c] : 0.f;
        q1.y = i1 ? a1[c + 1] : 0.f;
        q1.z = i2 ? a1[c + 2] : 0.f;
        q1.w = i3 ? a1[c + 3] : 0.f;
        *reinterpret_cast<float4*>(trow + kPad + x0 + c) = q0;
        *reinterpret_cast<float4*>(trow + RP + 3 * kPad + x0 + c) = q1;
      }
    }
    __syncwarp();
    DP_MARK(1)

    horizontal(trow, y, s0);
    horizontal(trow + RP + 2 * kPad, y + 1, s1);
    __syncwarp();  // every lane is done with trow and with the ring rows
    DP_MARK(2)

    test_pair(y);
    // Refreshed after steps 0, 1, 3, 7, 15 and every kRefresh after: the
    // floor rises fastest in the first rows.
    if ((st & (st + 1)) == 0 || (st & (kRefresh - 1)) == kRefresh - 1) {
      floor_key = warp_kth(best, lane);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      sp[c] = s0[c];
      sc[c] = s1[c];
    }
    DP_MARK(3)
  }

  unsigned long long mine = warp_merge<P>(best, lane);
  if (bands > 1) {
    if (lane < P) band_best[warp][lane] = mine;
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        best[j] = lane < bands ? band_best[lane][j] : 0ull;
      }
      mine = warp_merge<P>(best, lane);
    }
  }
  DP_MARK(4)

  if (warp == 0 && lane < p) {
    const unsigned int lo = static_cast<unsigned int>(mine & 0xffffffffull);
    const int flat = static_cast<int>(FLAT_MASK - (lo >> 4));
    const int code = static_cast<int>(lo & 15u);
    const int y = flat / W;
    const int x = flat - y * W;
    const float dy = __fmul_rn(static_cast<float>(code / 3 - 1), prm.shift);
    const float dx = __fmul_rn(static_cast<float>(code % 3 - 1), prm.shift);
    const long long o = static_cast<long long>(n) * p + lane;
    scores[o] = key_value(mine);
    ys[o] = __fadd_rn(static_cast<float>(y), dy);
    xs[o] = __fadd_rn(static_cast<float>(x), dx);
  }
  DP_MARK(5)
#ifdef DECODE_PEAKS_PROFILE
  if (threadIdx.x == 0) {
    for (int i = 0; i < kPhases; ++i) {
      atomicAdd(&phase_cycles[i], static_cast<unsigned long long>(prof[i]));
    }
    atomicAdd(&phase_cycles[kPhases], 1ull);
  }
#endif
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess) {
      count = 132;
    }
  }
  return count;
}

template <typename T, int P, int C, int NT, int WT, int HT>
int launch(const T* maps, long long batch_stride, int n_maps,
           int maps_per_batch, int H, int W, int p, const Params& prm,
           float* scores, float* ys, float* xs, cudaStream_t stream) {
  // Bands of rows per map: enough warps for about 16 per SM, at least 8
  // rows a band, and what shared memory holds.
  constexpr int per_warp = warp_smem_bytes<T, C>();
  const int want = sm_count() * 16 / n_maps;
  const int bands = max(1, min(min(want, kMaxBands),
                               min(H / 8, kSmemBytes / per_warp)));
  const int smem = bands * per_warp;
  auto kernel = decode_peaks_kernel<T, P, C, NT, WT, HT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_maps, 32 * bands, smem, stream>>>(
      maps, batch_stride, maps_per_batch, H, W, p, prm, scores, ys, xs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* maps_v, long long batch_stride, int batches,
             int maps_per_batch, int H, int W, int p, const Params& prm,
             float* scores, float* ys, float* xs, cudaStream_t stream) {
  const T* maps = static_cast<const T*>(maps_v);
  const int n_maps = batches * maps_per_batch;
  // The fast() path: 128x128 maps, 7 taps, 8 peaks, rows 16-byte aligned
  // for cp.async.
  const bool aligned =
      reinterpret_cast<uintptr_t>(maps) % 16 == 0 &&
      (batches == 1 || (batch_stride * sizeof(T)) % 16 == 0);
  if (H == 128 && W == 128 && prm.ntaps == 7 && p == 8 && aligned) {
    return launch<T, 8, 4, 7, 128, 128>(maps, batch_stride, n_maps,
                                        maps_per_batch, H, W, p, prm, scores,
                                        ys, xs, stream);
  }
  return launch<T, MAX_PEAKS, kGenericCols, 0, 0, 0>(
      maps, batch_stride, n_maps, maps_per_batch, H, W, p, prm, scores, ys,
      xs, stream);
}

}  // namespace

extern "C" {

// maps: [batches, maps_per_batch, H, W] with element stride 1 along W,
// W along H, H*W along maps and `batch_stride` along batches.
// dtype: 0 = float32, 1 = bfloat16. taps: ntaps (odd, at most 15) blur
// taps. Outputs scores/ys/xs: [batches * maps_per_batch, p] float32,
// contiguous. W <= 512 and H*W < 2^28. Returns a cudaError_t code.
int decode_peaks(const void* maps, int dtype, long long batch_stride,
                 int batches, int maps_per_batch, int H, int W,
                 const float* taps, int ntaps, float shift, int p,
                 float* scores, float* ys, float* xs, void* stream) {
  if (ntaps < 1 || ntaps > MAX_TAPS || (ntaps & 1) == 0 || p < 1 ||
      p > MAX_PEAKS || batches < 1 || maps_per_batch < 1 || H < 1 ||
      W < 1 || W > 32 * kGenericCols ||
      static_cast<long long>(H) * W > FLAT_MASK ||
      static_cast<long long>(H) * W < p ||
      static_cast<long long>(batches) * maps_per_batch > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm;
  for (int j = 0; j < MAX_TAPS; ++j) prm.taps[j] = 0.f;
  for (int j = 0; j < ntaps; ++j) prm.taps[kCenter - ntaps / 2 + j] = taps[j];
  prm.ntaps = ntaps;
  prm.shift = shift;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(maps, batch_stride, batches, maps_per_batch, H, W,
                           p, prm, scores, ys, xs, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(maps, batch_stride, batches,
                                   maps_per_batch, H, W, p, prm, scores, ys,
                                   xs, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef DECODE_PEAKS_PROFILE
// Reads (and with reset != 0 then zeroes) the phase counters: kPhases + 1
// values.
int decode_peaks_phase_cycles(unsigned long long* host, int reset) {
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
