// Heatmap peak decode of [B, K, H, W] maps in any layout, for NVIDIA
// Hopper (sm_90a): a warp per map, or per band of a map's rows.
//
// Replaces the TPU kernel multiposenet_tpu/ops/decode_pallas.py
// `_decode_kernel_lanes`, which decodes [H, W, K*B] maps with the map
// index on the vector lanes. It computes what csrc/decode_peaks.cu (B1)
// computes, bit for bit, with the same device code (csrc/decode_rows.cuh:
// the function, its bound, the two-row blur, the peak test and the top-P
// with its warp-wide floor). The maps are read through their four
// strides, with no copy: the map (b, k) at row y, column x is
// maps[b*sb + k*sk + y*sh + x*sw].
//
// Bound on the card: operations, as for B1 (0.0394 ms for 2176 bf16 maps
// of 128x128: 37 unfused f32 operations an element over 132 SMs x 128
// lanes x 1.98 GHz; reading the maps once takes 0.0213 ms at 3.35 TB/s).
// Design: what differs from B1 is how raw rows reach shared memory.
// - Rows contiguous and 16-byte aligned (channel-major, as the fused
//   keypoint tail writes the crowd maps, and the head's 17-of-18 channel
//   slice): B1's kernel, `decode_rows_kernel`, a block per map whose
//   warps take bands of its rows, each warp staging its own rows by
//   16-byte cp.async a few steps ahead.
// - Channels-last (sk == 1, sw == K): one row of all K maps of an image
//   is one contiguous span of W*K elements (4352 bytes in bf16 at
//   128x17). `decode_span_kernel` gives a block the K maps of one image,
//   a warp each; the block's threads stage each span by 16-byte cp.async
//   into a ring of kRing spans that its warps share, three steps ahead
//   (one less than B1's four: a shared ring is ordered by one barrier a
//   step, so a step may not overwrite the rows of the two steps before
//   it), and each warp reads its map at stride K. In bf16 lane l's four
//   columns start 4*17*2 = 136 bytes after lane l-1's, 34 banks, so lanes
//   l and l+16 meet in one bank: a 2-way conflict on every ring read
//   (8-way in f32, which no path takes). It needs B >= half the SMs, so
//   that every SM has an image; fewer images (one request) go by plain
//   loads.
// - Any other strides, or channels-last at few images: decode_rows_kernel
//   with plain strided row loads, still exact.
// Built with -DDECODE_LANES_PROFILE it counts clock64 cycles per phase
// (multiposenet_tpu_torch/tools/decode_phases.py --kernel lanes).

#ifdef DECODE_LANES_PROFILE
#define DECODE_ROWS_PROFILE
#endif
#include "decode_rows.cuh"

namespace {

constexpr int kSpanMaxMaps = 20;  // warps of a span block: K <= 20

// A ring of kRing channels-last spans (row y of all K maps of one image,
// SP elements a span) that the block's warps share; warp k reads map k.
template <typename T>
struct SpanRows {
  static constexpr bool kCpAsync = true;
  static constexpr int kSlack = 1;  // one barrier a step orders the ring
  T* ring;
  const T* src;  // the image's element (0, 0) of map 0
  long long sh;
  int SP, H, K, k;

  __device__ __forceinline__ void stage(int r) {  // span r into its slot
    uint4* dst = reinterpret_cast<uint4*>(ring + (r & (kRing - 1)) * SP);
    const int vecs = SP * static_cast<int>(sizeof(T)) / 16;
    if (r < 0 || r >= H) {
      for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
        dst[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      const uint4* row = reinterpret_cast<const uint4*>(src + r * sh);
      for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
        cp_async16(dst + i, row + i);
      }
    }
  }
  __device__ __forceinline__ void sync() { __syncthreads(); }
  template <int N>
  __device__ __forceinline__ void cols(int r, int x0, float (&v)[N]) const {
    const T* row = ring + (r & (kRing - 1)) * SP + k + x0 * K;
#pragma unroll
    for (int c = 0; c < N; ++c) v[c] = to_f32(row[c * K]);
  }
};

// Bytes of shared memory of a span block: the ring of spans, then two
// blurred rows per warp.
template <typename T, int C>
int span_smem_bytes(int SP, int K) {
  return kRing * SP * static_cast<int>(sizeof(T)) +
         K * trow_floats<C>() * static_cast<int>(sizeof(float));
}

// One block per image b of channels-last maps, warp k on map b * K + k.
template <typename T, int P, int C, int NT, int WT, int HT>
__global__ void __launch_bounds__(32 * kSpanMaxMaps)
decode_span_kernel(const T* __restrict__ maps, long long sb, long long sh,
                   int K, int h_rt, int w_rt, int p, Params prm,
                   float* __restrict__ scores, float* __restrict__ ys,
                   float* __restrict__ xs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = HT > 0 ? HT : h_rt;
  const int W = WT > 0 ? WT : w_rt;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int SP = W * K;
  T* ring = reinterpret_cast<T*>(smem);
  float* trow = reinterpret_cast<float*>(ring + kRing * SP) +
                warp * trow_floats<C>();
  const int b = blockIdx.x;
  PhaseClock clk;
  SpanRows<T> rows{ring, maps + b * sb, sh, SP, H, K, warp};
  const unsigned long long mine = decode_band<T, P, C, NT, WT, HT>(
      rows, trow, H, W, 0, H, prm, lane, clk);
  clk.tick(4);
  store_peaks(mine, lane, p, W, prm.shift,
              static_cast<long long>(b) * K + warp, scores, ys, xs);
  clk.tick(5);
  clk.flush();
}

template <typename T, int P, int C, int NT, int WT, int HT>
int launch_span(const T* maps, long long sb, long long sh, int B, int K,
                int H, int W, int p, const Params& prm, float* scores,
                float* ys, float* xs, cudaStream_t stream) {
  const int smem = span_smem_bytes<T, C>(W * K, K);
  auto kernel = decode_span_kernel<T, P, C, NT, WT, HT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, 32 * K, smem, stream>>>(maps, sb, sh, K, H, W, p, prm, scores,
                                      ys, xs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int p, const void* maps_v, long long sb, long long sk,
             long long sh, long long sw, int B, int K, int H, int W,
             const Params& prm, int lanes_load, float* scores, float* ys,
             float* xs, cudaStream_t stream) {
  const T* maps = static_cast<const T*>(maps_v);
  const int n_maps = B * K;
  const long long es = static_cast<long long>(sizeof(T));
  int sms = 0;
  const int e = sm_count(&sms);
  if (e != 0) return e;
  // Strides of size-1 dims are never used.
  auto aligned = [&](int n, long long stride) {
    return n == 1 || (stride * es) % 16 == 0;
  };
  const bool base = reinterpret_cast<uintptr_t>(maps) % 16 == 0;
  // The crowd path: 128x128 maps, 7 taps, 8 peaks.
  if (H == 128 && W == 128 && prm.ntaps == 7 && p == 8) {
    if (lanes_load && sk == 1 && sw == K && K <= kSpanMaxMaps && base &&
        aligned(B, sb) && aligned(H, sh) && (W * K * es) % 16 == 0 &&
        2 * B >= sms &&
        span_smem_bytes<T, 4>(W * K, K) <= kSmemBytes) {
      return launch_span<T, 8, 4, 7, 128, 128>(maps, sb, sh, B, K, H, W, p,
                                               prm, scores, ys, xs, stream);
    }
    if (sw == 1 && base && aligned(B, sb) && aligned(K, sk) &&
        aligned(H, sh)) {
      return launch_rows<T, 8, 4, 7, 128, 128, true>(
          maps, sb, sk, sh, sw, n_maps, K, H, W, p, prm, scores, ys, xs,
          stream);
    }
    return launch_rows<T, 8, 4, 7, 128, 128, false>(
        maps, sb, sk, sh, sw, n_maps, K, H, W, p, prm, scores, ys, xs,
        stream);
  }
  return launch_rows<T, MAX_PEAKS, kGenericCols, 0, 0, 0, false>(
      maps, sb, sk, sh, sw, n_maps, K, H, W, p, prm, scores, ys, xs, stream);
}

}  // namespace

extern "C" {

// maps: [B, K, H, W] read through the element strides sb, sk, sh, sw;
// dtype: 0 = float32, 1 = bfloat16; lanes_load: 1 where the map stride is
// the smaller (channels-last), which lets whole spans be staged. taps:
// ntaps (odd, at most 15) blur taps. Outputs scores/ys/xs: [B*K, p]
// float32, contiguous, map n = b*K + k. W <= 512 and H*W < 2^28. Returns
// a cudaError_t code.
int decode_lanes(const void* maps, int dtype, long long sb, long long sk,
                 long long sh, long long sw, int B, int K, int H, int W,
                 const float* taps, int ntaps, float shift, int p,
                 int lanes_load, float* scores, float* ys, float* xs,
                 void* stream) {
  if (ntaps < 1 || ntaps > MAX_TAPS || (ntaps & 1) == 0 || p < 1 ||
      p > MAX_PEAKS || B < 1 || K < 1 || H < 1 || W < 1 ||
      W > 32 * kGenericCols || static_cast<long long>(H) * W > FLAT_MASK ||
      static_cast<long long>(H) * W < p ||
      static_cast<long long>(B) * K > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params prm = make_params(taps, ntaps, shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(p, maps, sb, sk, sh, sw, B, K, H, W, prm,
                           lanes_load, scores, ys, xs, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(p, maps, sb, sk, sh, sw, B, K, H, W, prm,
                                   lanes_load, scores, ys, xs, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef DECODE_LANES_PROFILE
// Reads (and with reset != 0 then zeroes) the phase counters: kPhases + 1
// values.
int decode_lanes_phase_cycles(unsigned long long* host, int reset) {
  return read_phase_cycles(host, reset);
}
#endif

}  // extern "C"
