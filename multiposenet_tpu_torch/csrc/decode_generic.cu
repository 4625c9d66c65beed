// Heatmap peak decode for every config, for NVIDIA Hopper (sm_90a): one
// block per map, through an f32 workspace in device memory.
//
// The counterpart of the JAX package's jnp decode
// (multiposenet_tpu/ops/decode.py decode_heatmaps), not of a Pallas
// kernel: it decodes what csrc/decode_peaks.cu (B1) and csrc/decode_lanes.cu
// (B2) do not take, that is any peak window, any odd tap count, any
// 1 <= P <= H*W, any W and any strides, with H*W < 2^28, f32 or bf16 maps.
// It computes what ops/decode.py decode_maps_plain computes, bit for bit:
// the zero-padded separable blur (vertical taps, then horizontal, each
// summed tap by tap from zero with __fmul_rn/__fadd_rn, a tap outside the
// map adding a zero product as the plain version's zero padding does), the
// window max over rows and columns -(window-1)/2 .. window/2 around each
// element with -inf outside the map, plateau ties kept, the top-P by
// (value desc, flat index asc) over the peak-masked map, and the +-shift
// sub-pixel step toward the larger border-clipped neighbour.
//
// Bound on the card: the maps read once and the outputs written once over
// 3.35 TB/s, or per element a multiply and an add per tap in each pass and
// window^2 comparisons, unfused, over 132 SMs x 128 lanes x 1.98 GHz.
// Design (simple and exact, not fast): a block owns one map; its threads
// stride over the map's elements for the vertical pass (into workspace
// plane 0), the horizontal pass (plane 1, the blurred map) and the peak
// mask (back into plane 0); then P rounds each take a block-wide max of
// the 64-bit keys (value, ~flat index) below the previous round's winner,
// keys being unique within a map. Thread 0 writes each winner with its
// sub-pixel step read from the blurred map.

#include "decode_rows.cuh"  // keys, warp_max, to_f32, sign_of

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_generic_kernel(const T* __restrict__ maps, long long sb, long long sk,
                      long long sh, long long sw, int K, int H, int W,
                      const float* __restrict__ taps, int ntaps, int window,
                      float shift, int p, float* __restrict__ work,
                      float* __restrict__ scores, float* __restrict__ ys,
                      float* __restrict__ xs) {
  __shared__ unsigned long long red[kThreads / 32 + 1];
  const int n = blockIdx.x;
  const int b = n / K;
  const int k = n - b * K;
  const T* src = maps + b * sb + k * sk;
  const int hw = H * W;
  float* plane0 = work + static_cast<long long>(n) * hw;
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
        mx = fmaxf(mx, blurred[yy * W + xx]);
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
      const unsigned long long key =
          (static_cast<unsigned long long>(value_bits(plane0[e])) << 32) |
          (FLAT_MASK - static_cast<unsigned int>(e));
      if (key < prev && key > best) best = key;
    }
    best = warp_max(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = warp_max(lane < kThreads / 32 ? red[lane] : 0ull);
      if (lane == 0) red[kThreads / 32] = best;
    }
    __syncthreads();
    prev = red[kThreads / 32];
    if (threadIdx.x == 0) {
      const int flat =
          static_cast<int>(FLAT_MASK - static_cast<unsigned int>(prev));
      const int y = flat / W;
      const int x = flat - y * W;
      const float* row = blurred + y * W;
      const float up = y > 0 ? row[x - W] : row[x];
      const float down = y + 1 < H ? row[x + W] : row[x];
      const float left = x > 0 ? row[x - 1] : row[x];
      const float right = x + 1 < W ? row[x + 1] : row[x];
      const float dy = __fmul_rn(
          static_cast<float>(sign_of(__fsub_rn(down, up))), shift);
      const float dx = __fmul_rn(
          static_cast<float>(sign_of(__fsub_rn(right, left))), shift);
      const long long o = static_cast<long long>(n) * p + r;
      scores[o] = key_value(prev);
      ys[o] = __fadd_rn(static_cast<float>(y), dy);
      xs[o] = __fadd_rn(static_cast<float>(x), dx);
    }
  }
}

}  // namespace

extern "C" {

// maps: [B, K, H, W] read through the element strides sb, sk, sh, sw;
// dtype: 0 = float32, 1 = bfloat16. taps: ntaps (odd) blur taps in device
// memory; window: the peak window (>= 1); p: peaks per map, 1..H*W.
// work: 2 * B * K * H * W float32 of device memory. Outputs
// scores/ys/xs: [B*K, p] float32, contiguous, map n = b*K + k. H*W < 2^28.
// Returns a cudaError_t code.
int decode_generic(const void* maps, int dtype, long long sb, long long sk,
                   long long sh, long long sw, int B, int K, int H, int W,
                   const float* taps, int ntaps, int window, float shift,
                   int p, float* work, float* scores, float* ys, float* xs,
                   void* stream) {
  if (ntaps < 1 || (ntaps & 1) == 0 || window < 1 || B < 1 || K < 1 ||
      H < 1 || W < 1 || static_cast<long long>(H) * W > FLAT_MASK ||
      p < 1 || static_cast<long long>(H) * W < p ||
      static_cast<long long>(B) * K > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_maps = B * K;
  if (dtype == 0) {
    decode_generic_kernel<float><<<n_maps, kThreads, 0, s>>>(
        static_cast<const float*>(maps), sb, sk, sh, sw, K, H, W, taps, ntaps,
        window, shift, p, work, scores, ys, xs);
  } else if (dtype == 1) {
    decode_generic_kernel<__nv_bfloat16><<<n_maps, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(maps), sb, sk, sh, sw, K, H, W,
        taps, ntaps, window, shift, p, work, scores, ys, xs);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
