// Device code shared by the two heatmap peak decode kernels for NVIDIA
// Hopper (sm_90a), csrc/decode_peaks.cu (B1) and csrc/decode_lanes.cu
// (B2): both compute one function, so both run the code below and agree
// bit for bit.
//
// Per map [H, W]: zero-padded separable Gaussian blur (vertical taps, then
// horizontal), 3x3 max filter with -inf borders keeping plateau ties,
// top-P by (value desc, flat index asc) over the peak-masked map, where
// non-peaks rank as -inf, and a +-shift sub-pixel offset from the
// border-clipped neighbours of each winner. Each blur pass is summed tap
// by tap from 0.0 in the plain version's order with __fmul_rn/__fadd_rn,
// so nvcc cannot fuse them into FMAs, and the result agrees bit for bit
// with the plain PyTorch version (ops/decode.py decode_maps_plain). A tap
// that falls outside the map adds a zero product, which leaves the sum
// unchanged, as the plain version's zero padding does. NaN propagates as
// in the JAX package: the window max is max.NaN (a window holding a NaN
// has no peak), and a NaN difference of neighbours gives a NaN step.
//
// Bound on the card: the kernel must read each map once (2176 bf16 maps
// of 128x128 are 71.3 MB, 21 us at 3.35 TB/s) and do 37 f32 operations
// per element (a multiply and an add per tap in each pass, eight maxima
// and a comparison), none of which may be an FMA: at 132 SMs x 128 lanes
// x 1.98 GHz that is 39 us, so operations bound it.
//
// Design of `decode_band`, what one warp does for one map or one band of
// its rows:
// - A lane owns C neighbouring columns. Raw rows stream through a ring of
//   kRing rows in shared memory, staged by a `Rows` policy: a warp's own
//   ring of one map's rows (WarpRows: by 16-byte cp.async Q steps ahead of
//   their use on 16-byte aligned rows, else by plain loads through any
//   strides), or a ring of whole channels-last rows of all K maps of an
//   image that the block's warps share (csrc/decode_lanes.cu SpanRows).
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
//   max.
// - No division or modulo in the loops: rows and columns are walked in
//   2-D, ring slots are masks, and the path's sizes are template
//   parameters. Other sizes (W up to 512, any odd tap count up to 15, any
//   P up to 16) run the same code with the sizes given at run time.
// `decode_rows_kernel` gives each map one block whose warps take bands of
// its rows when there are too few maps to fill the card (a `predict`
// request's 17 maps take 8 bands each), merged once more in warp 0.
// Built with -DDECODE_ROWS_PROFILE (which each kernel's own profile macro
// sets) it counts clock64 cycles per phase
// (multiposenet_tpu_torch/tools/decode_phases.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_TAPS 15
#define MAX_PEAKS 16
#define FLAT_MASK 0x0fffffffu  // flat indices below 2^28

namespace {

constexpr int kCenter = MAX_TAPS / 2;  // taps are stored centred here
constexpr int kRing = 16;     // raw rows per ring: >= 2 * half + 2 + 2 * Q
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

#ifdef DECODE_ROWS_PROFILE
// Phase counters of thread 0, summed over blocks: clock64 cycles in the
// row loads (issue and wait), the vertical blur, the horizontal blur, the
// peak mask with the per-lane top-P, the merge, and the sub-pixel step
// with the store; then the number of blocks.
constexpr int kPhases = 6;
__device__ unsigned long long phase_cycles[kPhases + 1];
struct PhaseClock {
  long long t[kPhases];
  long long mark;
  // clock64() in the body, under __CUDA_ARCH__, not in an initializer
  // list: the host pass of nvcc compiles initializer lists of device
  // constructors too, where clock64 is not declared.
  __device__ __forceinline__ PhaseClock() : mark(0) {
    for (int i = 0; i < kPhases; ++i) t[i] = 0;
#ifdef __CUDA_ARCH__
    mark = clock64();
#endif
  }
  __device__ __forceinline__ void tick(int i) {
    if (threadIdx.x == 0) {
      const long long now = clock64();
      t[i] += now - mark;
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

// Reads (and with reset != 0 then zeroes) the phase counters: kPhases + 1
// values.
int read_phase_cycles(unsigned long long* host, int reset) {
  cudaError_t e =
      cudaMemcpyFromSymbol(host, phase_cycles, sizeof(phase_cycles));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[kPhases + 1] = {};
    e = cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
#else
struct PhaseClock {
  __device__ __forceinline__ void tick(int) {}
  __device__ __forceinline__ void flush() {}
};
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

// The sub-pixel step's sign of d as a 2-bit code: 0, 1, 2 for -1, 0, +1
// and 3 for NaN, which jnp.sign keeps (ops/decode.py decode_maps_plain
// too). A key's low 4 bits hold sign_code(dy) * 4 + sign_code(dx).
__device__ __forceinline__ unsigned int sign_code(float d) {
  return d > 0.f ? 2u : (d < 0.f ? 0u : (d == 0.f ? 1u : 3u));
}

// The step of one axis from its 2-bit code: -shift, 0, +shift or NaN.
__device__ __forceinline__ float step_of(unsigned int code, float shift) {
  return code == 3u ? __int_as_float(0x7fffffff)
                    : __fmul_rn(static_cast<float>(static_cast<int>(code) - 1),
                                shift);
}

// max that propagates NaN, as max_pool2d and lax.max do (fmaxf drops it).
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// Floats of one warp's two vertically blurred rows, zero pads included.
template <int C>
__host__ __device__ constexpr int trow_floats() {
  return 2 * (32 * C + 2 * kPad);
}

// A warp's own ring of kRing raw rows of its map, RP = 32 * C elements a
// row, read four columns at a time. kAsync: rows arrive by 16-byte
// cp.async (WT columns, rows 16-byte aligned); else by plain loads
// through the strides.
template <typename T, int C, int WT, bool kAsync>
struct WarpRows {
  static constexpr bool kCpAsync = kAsync;
  static constexpr int kSlack = 0;  // the warp's own __syncwarp orders it
  static constexpr int RP = 32 * C;
  T* ring;
  const T* src;  // the map's element (0, 0)
  long long sh, sw;
  int H, W, lane;

  __device__ __forceinline__ void stage(int r) {  // raw row r into its slot
    T* dst = ring + (r & (kRing - 1)) * RP;
    if (r < 0 || r >= H) {
      constexpr int kVec = RP * static_cast<int>(sizeof(T)) / 16;
      for (int i = lane; i < kVec; i += 32) {
        reinterpret_cast<uint4*>(dst)[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    } else if constexpr (kAsync) {
      constexpr int kVec = WT * static_cast<int>(sizeof(T)) / 16;
      const T* row = src + r * sh;
#pragma unroll
      for (int i = lane; i < kVec; i += 32) {
        cp_async16(reinterpret_cast<uint4*>(dst) + i,
                   reinterpret_cast<const uint4*>(row) + i);
      }
    } else {
      const T* row = src + r * sh;
      for (int x = lane; x < W; x += 32) dst[x] = row[x * sw];
    }
  }
  __device__ __forceinline__ void sync() { __syncwarp(); }
  template <int N>
  __device__ __forceinline__ void cols(int r, int x0, float (&v)[N]) const {
    load_cols<N>(ring + (r & (kRing - 1)) * RP + x0, v);
  }
};

// One warp's decode of rows [r0, r1) of one map: lane j < P returns the
// j-th key of the band's top-P. `rows` stages raw rows; `trow` is the
// warp's trow_floats<C>() floats of shared memory.
// T: map dtype. P: length of each lane's list (>= the p asked for).
// C: columns per lane. NT: taps (0: at run time, up to MAX_TAPS).
// WT, HT: map size (0: at run time).
template <typename T, int P, int C, int NT, int WT, int HT, class Rows>
__device__ __forceinline__ unsigned long long decode_band(
    Rows& rows, float* trow, int h_rt, int w_rt, int r0, int r1,
    const Params& prm, int lane, PhaseClock& clk) {
  constexpr bool kAsync = Rows::kCpAsync;
  constexpr int RP = 32 * C;                  // blurred row pitch, floats
  constexpr int KT = NT > 0 ? NT : MAX_TAPS;  // taps walked
  constexpr int KH = KT / 2;
  // Steps staged ahead: the ring holds rows y - half .. y + 1 + half of
  // this step and two rows for each of the Q steps after it, and what a
  // step stages must not overwrite a row of the step before it (nor, with
  // one step of slack, of the two steps before it: a ring that a block
  // shares is ordered by one barrier a step).
  constexpr int Q = kAsync ? (kRing - 2 * KH - 2) / 2 - Rows::kSlack : 0;
  // Floats read each side of a lane's columns in the horizontal pass.
  constexpr int HV = ((KH + 3) / 4) * 4;
  static_assert(2 * KH + 2 + 2 * Q <= kRing && 2 * KH + 1 + 2 * Q < kRing,
                "ring too small");
  static_assert(!kAsync || Q >= 1, "no prefetch");
  static_assert(HV <= kPad && C % 4 == 0, "row layout");
  const int H = HT > 0 ? HT : h_rt;
  const int W = WT > 0 ? WT : w_rt;
  const int half = NT > 0 ? NT / 2 : prm.ntaps / 2;

  // This warp's band: it tests rows [r0, r1) and blurs rows r0 - 1 .. r1
  // (-inf outside the map) two at a time, in `steps` steps from ya. Step
  // s needs raw rows ya + 2s - half .. ya + 2s + 1 + half (zero outside
  // the map); it stages the two new rows of step s + Q.
  const int ya = r0 - 1;
  const int steps = (r1 - r0 + 3) / 2;
  const int last_raw = ya + 2 * steps - 1 + half;

  for (int i = lane; i < trow_floats<C>(); i += 32) trow[i] = 0.f;

  auto stage = [&](int r) {
    if (r <= last_raw) rows.stage(r);
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
      const float t = max_nan(sc[c], s0[c]);
      vma[c] = max_nan(sp[c], t);
      vmb[c] = max_nan(t, s1[c]);
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
      const float ma = max_nan(max_nan(c > 0 ? vma[c - 1] : vla, vma[c]),
                               c + 1 < C ? vma[c + 1] : vra);
      const float mb = max_nan(max_nan(c > 0 ? vmb[c - 1] : vlb, vmb[c]),
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
        const unsigned int sy = sign_code(__fsub_rn(below, above));
        const unsigned int sx = sign_code(__fsub_rn(right, left));
        best[P - 1] =
            key[e] | (sy << 2 | sx);
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
    rows.sync();
    clk.tick(0);

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
          rows.template cols<C>(y + d0, x0, v);
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
    clk.tick(1);

    horizontal(trow, y, s0);
    horizontal(trow + RP + 2 * kPad, y + 1, s1);
    __syncwarp();  // every lane is done with trow and with the ring rows
    clk.tick(2);

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
    clk.tick(3);
  }
  return warp_merge<P>(best, lane);
}

// Lane j < p of the warp holding the merged keys writes peak j of map n.
__device__ __forceinline__ void store_peaks(unsigned long long mine,
                                            int lane, int p, int W,
                                            float shift, long long n,
                                            float* __restrict__ scores,
                                            float* __restrict__ ys,
                                            float* __restrict__ xs) {
  if (lane < p) {
    const unsigned int lo = static_cast<unsigned int>(mine & 0xffffffffull);
    const int flat = static_cast<int>(FLAT_MASK - (lo >> 4));
    const int y = flat / W;
    const int x = flat - y * W;
    const float dy = step_of(lo >> 2 & 3u, shift);
    const float dx = step_of(lo & 3u, shift);
    const long long o = n * p + lane;
    scores[o] = key_value(mine);
    ys[o] = __fadd_rn(static_cast<float>(y), dy);
    xs[o] = __fadd_rn(static_cast<float>(x), dx);
  }
}

// Shared memory of one warp of decode_rows_kernel: its raw ring, then its
// two vertically blurred rows.
template <typename T, int C>
__host__ __device__ constexpr int warp_smem_bytes() {
  return kRing * 32 * C * static_cast<int>(sizeof(T)) +
         trow_floats<C>() * static_cast<int>(sizeof(float));
}

// One block per map n = b * K + k, at maps[b * sb + k * sk + y * sh +
// x * sw]; its warps take bands of the map's rows and warp 0 merges them.
template <typename T, int P, int C, int NT, int WT, int HT, bool kAsync>
__global__ void __launch_bounds__(32 * kMaxBands)
decode_rows_kernel(const T* __restrict__ maps, long long sb, long long sk,
                   long long sh, long long sw, int K, int h_rt, int w_rt,
                   int p, Params prm, float* __restrict__ scores,
                   float* __restrict__ ys, float* __restrict__ xs) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long band_best[kMaxBands][P];
  const int H = HT > 0 ? HT : h_rt;
  const int W = WT > 0 ? WT : w_rt;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bands = blockDim.x >> 5;
  T* ring = reinterpret_cast<T*>(smem + warp * warp_smem_bytes<T, C>());
  float* trow = reinterpret_cast<float*>(ring + kRing * 32 * C);

  const int n = blockIdx.x;
  const int b = n / K;
  const int k = n - b * K;
  PhaseClock clk;
  WarpRows<T, C, WT, kAsync> rows{ring, maps + b * sb + k * sk, sh, sw,
                                  H, W, lane};
  const int band_rows = (H + bands - 1) / bands;
  const int r0 = min(warp * band_rows, H);
  const int r1 = min(r0 + band_rows, H);
  unsigned long long mine = decode_band<T, P, C, NT, WT, HT>(
      rows, trow, H, W, r0, r1, prm, lane, clk);
  if (bands > 1) {
    if (lane < P) band_best[warp][lane] = mine;
    __syncthreads();
    if (warp == 0) {
      unsigned long long best[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        best[j] = lane < bands ? band_best[lane][j] : 0ull;
      }
      mine = warp_merge<P>(best, lane);
    }
  }
  clk.tick(4);
  if (warp == 0) store_peaks(mine, lane, p, W, prm.shift, n, scores, ys, xs);
  clk.tick(5);
  clk.flush();
}

// The current device's SM count into *sms, asked once per device; a
// failed query returns its cudaError_t (0 on success).
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

// decode_rows_kernel on n_maps maps of K per batch. Bands of rows per
// map: enough warps for about 16 per SM, at least 8 rows a band, and what
// shared memory holds.
template <typename T, int P, int C, int NT, int WT, int HT, bool kAsync>
int launch_rows(const T* maps, long long sb, long long sk, long long sh,
                long long sw, int n_maps, int K, int H, int W, int p,
                const Params& prm, float* scores, float* ys, float* xs,
                cudaStream_t stream) {
  constexpr int per_warp = warp_smem_bytes<T, C>();
  int sms = 0;
  const int e = sm_count(&sms);
  if (e != 0) return e;
  const int want = sms * 16 / n_maps;
  const int bands = max(1, min(min(want, kMaxBands),
                               min(H / 8, kSmemBytes / per_warp)));
  const int smem = bands * per_warp;
  auto kernel = decode_rows_kernel<T, P, C, NT, WT, HT, kAsync>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_maps, 32 * bands, smem, stream>>>(
      maps, sb, sk, sh, sw, K, H, W, p, prm, scores, ys, xs);
  return static_cast<int>(cudaGetLastError());
}

// The blur's taps, centred, as the kernels take them.
Params make_params(const float* taps, int ntaps, float shift) {
  Params prm;
  for (int j = 0; j < MAX_TAPS; ++j) prm.taps[j] = 0.f;
  for (int j = 0; j < ntaps; ++j) prm.taps[kCenter - ntaps / 2 + j] = taps[j];
  prm.ntaps = ntaps;
  prm.shift = shift;
  return prm;
}

}  // namespace
