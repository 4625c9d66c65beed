// Heatmap peak decode with maps on the fast axis, for NVIDIA Hopper
// (sm_90a): a block of MB maps streams their rows top to bottom.
//
// Replaces the TPU kernel multiposenet_tpu/ops/decode_pallas.py
// `_decode_kernel_lanes`, which decodes [H, W, K*B] maps with the map
// index on the vector lanes. It computes what csrc/decode_peaks.cu (B1)
// computes, bit for bit: per map, the zero-padded separable blur
// (vertical taps, then horizontal, each summed from zero with separate
// multiply and add), the 3x3 plateau-keeping peak test with -inf borders,
// the top-P by (value desc, flat index asc) over the peak-masked map and
// the +-shift sub-pixel step toward the larger border-clipped neighbour.
// The maps are read through their four strides, with no copy: the map
// (b, k) at row y, column x is maps[b*sb + k*sk + y*sh + x*sw].
//
// Bound on the card: the kernel must read each map once (2176 bf16 maps
// of 128x128 are 71.3 MB, ~21 us at 3.35 TB/s) and its 37 f32 operations
// per element take ~20 us at 67 TFLOP/s, so bytes bound it, barely.
// Design: one warp per map and MB maps per block. A ring of `ntaps` raw
// rows, one row of the vertical pass and a ring of three smoothed rows
// live in shared memory (11 f32 rows of W+1 per map at 7 taps, ~45 KB for
// 8 maps of width 128), so a map is never held whole: each step loads one
// raw row, blurs one row and tests the row above it, and each lane keeps
// its own top-P of the elements it tested by insertion. Rows are loaded
// so that neighbouring threads read neighbouring addresses in either
// layout: along the maps when the map stride is the smaller one
// (channels-last: a warp reads neighbouring maps of one pixel in one
// transaction), along the row otherwise (channel-major, as the fused
// keypoint tail writes it). The sub-pixel signs are taken while a row's
// neighbours are in shared memory and ride in the low bits of the 64-bit
// order key, below the flat index; a warp merges its lanes' lists in P
// rounds of a shuffle max.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_TAPS 15
#define MAX_PEAKS 16
#define MB 8                 // maps per block, one warp each
#define THREADS (MB * 32)
#define FLAT_MASK 0x0fffffffu  // flat indices below 2^28

struct Taps {
  float w[MAX_TAPS];
  int n;
};

// Order-preserving key: larger key = higher value, then smaller flat
// index; the 4 low bits carry the sub-pixel code and never decide, since
// flat indices are unique within a map.
__device__ __forceinline__ unsigned long long make_key(float v, int flat,
                                                       int code) {
  unsigned int b = __float_as_uint(v);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  const unsigned int lo =
      ((FLAT_MASK - static_cast<unsigned int>(flat)) << 4) |
      static_cast<unsigned int>(code);
  return (static_cast<unsigned long long>(b) << 32) | lo;
}

__device__ __forceinline__ float key_value(unsigned long long k) {
  unsigned int b = static_cast<unsigned int>(k >> 32);
  b = (b & 0x80000000u) ? (b & 0x7fffffffu) : ~b;
  return __uint_as_float(b);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    unsigned long long other = __shfl_xor_sync(0xffffffffu, v, o);
    v = other > v ? other : v;
  }
  return v;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ int sign_of(float d) {
  return d > 0.f ? 1 : (d < 0.f ? -1 : 0);
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
decode_lanes_kernel(const T* __restrict__ maps, long long sb, long long sk,
                    long long sh, long long sw, int n_maps, int K, int H,
                    int W, Taps taps, float shift, int lanes_load,
                    float* __restrict__ scores, float* __restrict__ ys,
                    float* __restrict__ xs) {
  extern __shared__ float smem[];
  const int WP = W + 1;  // odd pitch: no bank conflicts down a column
  const int R = taps.n;
  const int half = R / 2;
  float* raw = smem;                // [R][MB][WP], row y in slot y % R
  float* tv = raw + R * MB * WP;    // [MB][WP], vertical pass of one row
  float* sm = tv + MB * WP;         // [3][MB][WP], row y in slot y % 3
  __shared__ long long base[MB];

  const int m0 = blockIdx.x * MB;
  if (threadIdx.x < MB) {
    const int n = m0 + threadIdx.x;
    base[threadIdx.x] =
        n < n_maps ? static_cast<long long>(n / K) * sb +
                         static_cast<long long>(n % K) * sk
                   : -1;
  }
  __syncthreads();

  const int m = threadIdx.x >> 5;  // this warp's map in the block
  const int lane = threadIdx.x & 31;

  auto load_row = [&](int y) {
    float* dst = raw + (y % R) * MB * WP;
    for (int e = threadIdx.x; e < MB * W; e += THREADS) {
      int mm, x;
      if (lanes_load) {
        mm = e % MB;
        x = e / MB;
      } else {
        mm = e / W;
        x = e - mm * W;
      }
      const long long o = base[mm];
      dst[mm * WP + x] = o >= 0 ? load_f32(maps + o + y * sh + x * sw) : 0.f;
    }
  };

  auto test_row = [&](int r, unsigned long long* best) {
    const float* c = sm + ((r % 3) * MB + m) * WP;
    const float* up = r > 0 ? sm + (((r - 1) % 3) * MB + m) * WP : nullptr;
    const float* dn = r + 1 < H ? sm + (((r + 1) % 3) * MB + m) * WP : nullptr;
    for (int x = lane; x < W; x += 32) {
      const float v = c[x];
      float mx = v;
      const int xl = max(x - 1, 0), xr = min(x + 1, W - 1);
      const float* rows[3] = {up, c, dn};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float* row = rows[j];
        if (row == nullptr) continue;
        if (x > 0) mx = fmaxf(mx, row[x - 1]);
        mx = fmaxf(mx, row[x]);
        if (x + 1 < W) mx = fmaxf(mx, row[x + 1]);
      }
      const float* below = dn ? dn : c;  // border-clipped neighbours
      const float* above = up ? up : c;
      const int sy = sign_of(below[x] - above[x]);
      const int sx = sign_of(c[xr] - c[xl]);
      const unsigned long long key =
          make_key(v >= mx ? v : -INFINITY, r * W + x, (sy + 1) * 3 + sx + 1);
      if (key > best[P - 1]) {
        best[P - 1] = key;
#pragma unroll
        for (int j = P - 1; j > 0; --j) {
          if (best[j] > best[j - 1]) {
            const unsigned long long s = best[j];
            best[j] = best[j - 1];
            best[j - 1] = s;
          }
        }
      }
    }
  };

  unsigned long long best[P];
#pragma unroll
  for (int j = 0; j < P; ++j) best[j] = 0ull;

  for (int y = 0; y < half && y < H; ++y) load_row(y);
  for (int y = 0; y < H; ++y) {
    __syncthreads();  // the previous step's reads of the ring slot are done
    if (y + half < H) load_row(y + half);
    __syncthreads();
    float* trow = tv + m * WP;
    for (int x = lane; x < W; x += 32) {
      float acc = 0.f;
      for (int j = 0; j < R; ++j) {
        const int yy = y + j - half;
        if (yy >= 0 && yy < H) {
          acc = __fadd_rn(acc, __fmul_rn(raw[((yy % R) * MB + m) * WP + x],
                                         taps.w[j]));
        }
      }
      trow[x] = acc;
    }
    __syncwarp();
    float* srow = sm + ((y % 3) * MB + m) * WP;
    for (int x = lane; x < W; x += 32) {
      float acc = 0.f;
      for (int j = 0; j < R; ++j) {
        const int xx = x + j - half;
        if (xx >= 0 && xx < W) {
          acc = __fadd_rn(acc, __fmul_rn(trow[xx], taps.w[j]));
        }
      }
      srow[x] = acc;
    }
    __syncwarp();
    if (y >= 1) test_row(y - 1, best);
  }
  test_row(H - 1, best);

  // Warp merge: P rounds of a max over the lanes' list heads; the lane
  // holding the winner pops it (keys are unique within a map).
  unsigned long long mine = 0ull;
  for (int r = 0; r < P; ++r) {
    const unsigned long long c = warp_max(best[0]);
    if (best[0] == c) {
#pragma unroll
      for (int j = 0; j < P - 1; ++j) best[j] = best[j + 1];
      best[P - 1] = 0ull;
    }
    if (lane == r) mine = c;
  }
  const int n = m0 + m;
  if (lane < P && n < n_maps) {
    const unsigned int lo = static_cast<unsigned int>(mine & 0xffffffffull);
    const int flat = static_cast<int>(FLAT_MASK - (lo >> 4));
    const int code = static_cast<int>(lo & 15u);
    const int y = flat / W;
    const int x = flat - y * W;
    const float dy = __fmul_rn(static_cast<float>(code / 3 - 1), shift);
    const float dx = __fmul_rn(static_cast<float>(code % 3 - 1), shift);
    const long long o = static_cast<long long>(n) * P + lane;
    scores[o] = key_value(mine);
    ys[o] = __fadd_rn(static_cast<float>(y), dy);
    xs[o] = __fadd_rn(static_cast<float>(x), dx);
  }
}

template <typename T, int P>
static int launch(const void* maps, long long sb, long long sk, long long sh,
                  long long sw, int n_maps, int K, int H, int W,
                  const Taps& taps, float shift, int lanes_load, float* scores,
                  float* ys, float* xs, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(taps.n + 4) * MB * (W + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_lanes_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_lanes_kernel<T, P><<<(n_maps + MB - 1) / MB, THREADS, smem, stream>>>(
      static_cast<const T*>(maps), sb, sk, sh, sw, n_maps, K, H, W, taps,
      shift, lanes_load, scores, ys, xs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(int p, const void* maps, long long sb, long long sk,
                    long long sh, long long sw, int n_maps, int K, int H,
                    int W, const Taps& taps, float shift, int lanes_load,
                    float* scores, float* ys, float* xs,
                    cudaStream_t stream) {
  switch (p) {
#define CASE(P)                                                            \
  case P:                                                                  \
    return launch<T, P>(maps, sb, sk, sh, sw, n_maps, K, H, W, taps, shift, \
                        lanes_load, scores, ys, xs, stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" {

// maps: [B, K, H, W] read through the element strides sb, sk, sh, sw;
// dtype: 0 = float32, 1 = bfloat16; lanes_load: 1 to load rows along the
// maps (channels-last), 0 along the row. Outputs scores/ys/xs: [B*K, p]
// float32, contiguous, map n = b*K + k. Returns a cudaError_t code.
int decode_lanes(const void* maps, int dtype, long long sb, long long sk,
                 long long sh, long long sw, int B, int K, int H, int W,
                 const float* taps, int ntaps, float shift, int p,
                 int lanes_load, float* scores, float* ys, float* xs,
                 void* stream) {
  if (ntaps < 1 || ntaps > MAX_TAPS || (ntaps & 1) == 0 || p < 1 ||
      p > MAX_PEAKS || B < 1 || K < 1 || H < 1 || W < 1 ||
      static_cast<long long>(H) * W > FLAT_MASK ||
      static_cast<long long>(H) * W < p) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps tp;
  for (int j = 0; j < MAX_TAPS; ++j) tp.w[j] = j < ntaps ? taps[j] : 0.f;
  tp.n = ntaps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_maps = B * K;
  if (dtype == 0) {
    return dispatch<float>(p, maps, sb, sk, sh, sw, n_maps, K, H, W, tp,
                           shift, lanes_load, scores, ys, xs, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(p, maps, sb, sk, sh, sw, n_maps, K, H, W,
                                   tp, shift, lanes_load, scores, ys, xs, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
