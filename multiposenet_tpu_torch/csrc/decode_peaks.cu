// Heatmap peak decode for NVIDIA Hopper (sm_90a), one thread block per map.
//
// Replaces the TPU kernel multiposenet_tpu/ops/decode_pallas.py
// `_decode_kernel` (banded-matmul blur + two-phase masked-argmax top-P).
// Per map [H, W]: zero-padded separable Gaussian blur (vertical taps, then
// horizontal), 3x3 max filter with -inf borders keeping plateau ties,
// top-P by (value desc, flat index asc) over the peak-masked map, where
// non-peaks rank as -inf, and a +-shift sub-pixel offset from the
// border-clipped neighbours of each winner.
//
// Bound on the card: the kernel must read each map once (N*H*W*2 bytes
// in bf16, 71.3 MB for 2176 128x128 maps, ~21 us at 3.35 TB/s) and writes
// only N*P*3 floats; its arithmetic (a multiply and an add per tap in
// each blur pass, 9 max/compare per element: 37 f32 operations) would
// take ~20 us at the 67 TFLOP/s outside the tensor cores, so bytes bound
// it, barely.
// This first design is simple and exact rather than fast: the map and its
// blurred copy stay in shared memory as f32 (2*H*W*4 bytes, 128 KiB at
// 128x128, so one block per SM), taps are accumulated in the plain
// version's order with __fmul_rn/__fadd_rn so nvcc cannot fuse them into
// FMAs, and the result agrees bit for bit with the plain PyTorch version
// (ops/decode.py decode_maps_plain). Each thread keeps a sorted top-P of
// the elements it visits; the block merges the lists in P rounds of a
// warp-shuffle max over 64-bit keys.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_TAPS 15
#define THREADS 512
#define MAX_PEAKS 16

struct Taps {
  float w[MAX_TAPS];
  int n;
};

// Order-preserving key: larger key = higher value, then smaller flat index.
__device__ __forceinline__ unsigned long long make_key(float v, int flat) {
  unsigned int b = __float_as_uint(v);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(b) << 32) |
         static_cast<unsigned long long>(~static_cast<unsigned int>(flat));
}

__device__ __forceinline__ float key_value(unsigned long long k) {
  unsigned int b = static_cast<unsigned int>(k >> 32);
  b = (b & 0x80000000u) ? (b & 0x7fffffffu) : ~b;
  return __uint_as_float(b);
}

__device__ __forceinline__ int key_flat(unsigned long long k) {
  return static_cast<int>(~static_cast<unsigned int>(k & 0xffffffffull));
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

__device__ __forceinline__ float sign_shift(float d, float shift) {
  const float s = d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
  return __fmul_rn(s, shift);
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
decode_peaks_kernel(const T* __restrict__ maps, long long batch_stride,
                    int maps_per_batch, int H, int W, Taps taps, float shift,
                    float* __restrict__ scores, float* __restrict__ ys,
                    float* __restrict__ xs) {
  extern __shared__ float smem[];
  const int HW = H * W;
  float* a = smem;       // the map, then its blurred copy
  float* t = smem + HW;  // after the vertical pass
  __shared__ unsigned long long warp_best[THREADS / 32];
  __shared__ unsigned long long winners[P];

  const int n = blockIdx.x;
  const int b = n / maps_per_batch;
  const int k = n - b * maps_per_batch;
  const T* src = maps + b * batch_stride + static_cast<long long>(k) * HW;

  for (int i = threadIdx.x; i < HW; i += THREADS) a[i] = load_f32(src + i);
  __syncthreads();

  const int half = taps.n / 2;
  for (int i = threadIdx.x; i < HW; i += THREADS) {
    const int y = i / W;
    const int x = i - y * W;
    float acc = 0.f;
    for (int j = 0; j < taps.n; ++j) {
      const int yy = y + j - half;
      if (yy >= 0 && yy < H) {
        acc = __fadd_rn(acc, __fmul_rn(a[yy * W + x], taps.w[j]));
      }
    }
    t[i] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < HW; i += THREADS) {
    const int y = i / W;
    const int x = i - y * W;
    float acc = 0.f;
    for (int j = 0; j < taps.n; ++j) {
      const int xx = x + j - half;
      if (xx >= 0 && xx < W) {
        acc = __fadd_rn(acc, __fmul_rn(t[y * W + xx], taps.w[j]));
      }
    }
    a[i] = acc;
  }
  __syncthreads();

  // Peak mask and this thread's sorted top-P (keys descending). A thread
  // visits its elements in increasing flat order.
  unsigned long long best[P];
#pragma unroll
  for (int j = 0; j < P; ++j) best[j] = 0ull;
  for (int i = threadIdx.x; i < HW; i += THREADS) {
    const int y = i / W;
    const int x = i - y * W;
    const float v = a[i];
    float m = v;
    for (int dy = -1; dy <= 1; ++dy) {
      const int yy = y + dy;
      if (yy < 0 || yy >= H) continue;
      for (int dx = -1; dx <= 1; ++dx) {
        const int xx = x + dx;
        if (xx < 0 || xx >= W) continue;
        m = fmaxf(m, a[yy * W + xx]);
      }
    }
    const unsigned long long key = make_key(v >= m ? v : -INFINITY, i);
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

  // Block merge: P rounds of a max over every thread's list head; the
  // thread holding the winner pops it (keys are unique per flat index).
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = 0; r < P; ++r) {
    unsigned long long c = warp_max(best[0]);
    if (lane == 0) warp_best[warp] = c;
    __syncthreads();
    if (warp == 0) {
      c = lane < THREADS / 32 ? warp_best[lane] : 0ull;
      c = warp_max(c);
      if (lane == 0) winners[r] = c;
    }
    __syncthreads();
    if (best[0] == winners[r]) {
#pragma unroll
      for (int j = 0; j < P - 1; ++j) best[j] = best[j + 1];
      best[P - 1] = 0ull;
    }
  }

  if (threadIdx.x < P) {
    const unsigned long long key = winners[threadIdx.x];
    const int flat = key_flat(key);
    const int y = flat / W;
    const int x = flat - y * W;
    const int xr = min(x + 1, W - 1), xl = max(x - 1, 0);
    const int yd = min(y + 1, H - 1), yu = max(y - 1, 0);
    const float dx = sign_shift(a[y * W + xr] - a[y * W + xl], shift);
    const float dy = sign_shift(a[yd * W + x] - a[yu * W + x], shift);
    const long long o = static_cast<long long>(n) * P + threadIdx.x;
    scores[o] = key_value(key);
    ys[o] = __fadd_rn(static_cast<float>(y), dy);
    xs[o] = __fadd_rn(static_cast<float>(x), dx);
  }
}

template <typename T, int P>
static int launch(const void* maps, long long batch_stride, int batches,
                  int maps_per_batch, int H, int W, const Taps& taps,
                  float shift, float* scores, float* ys, float* xs,
                  cudaStream_t stream) {
  const size_t smem = 2ull * H * W * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_peaks_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_peaks_kernel<T, P><<<batches * maps_per_batch, THREADS, smem, stream>>>(
      static_cast<const T*>(maps), batch_stride, maps_per_batch, H, W, taps,
      shift, scores, ys, xs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(int p, const void* maps, long long batch_stride,
                    int batches, int maps_per_batch, int H, int W,
                    const Taps& taps, float shift, float* scores, float* ys,
                    float* xs, cudaStream_t stream) {
  switch (p) {
#define CASE(P)                                                           \
  case P:                                                                 \
    return launch<T, P>(maps, batch_stride, batches, maps_per_batch, H, W, \
                        taps, shift, scores, ys, xs, stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" {

// maps: [batches, maps_per_batch, H, W] with element stride 1 along W,
// W along H, H*W along maps and `batch_stride` along batches.
// dtype: 0 = float32, 1 = bfloat16. Outputs scores/ys/xs: [batches *
// maps_per_batch, p] float32, contiguous. Returns a cudaError_t code.
int decode_peaks(const void* maps, int dtype, long long batch_stride,
                 int batches, int maps_per_batch, int H, int W,
                 const float* taps, int ntaps, float shift, int p,
                 float* scores, float* ys, float* xs, void* stream) {
  if (ntaps < 1 || ntaps > MAX_TAPS || p < 1 || p > MAX_PEAKS ||
      p > H * W || batches < 1 || maps_per_batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps tp;
  for (int j = 0; j < MAX_TAPS; ++j) tp.w[j] = j < ntaps ? taps[j] : 0.f;
  tp.n = ntaps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(p, maps, batch_stride, batches, maps_per_batch, H,
                           W, tp, shift, scores, ys, xs, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(p, maps, batch_stride, batches,
                                   maps_per_batch, H, W, tp, shift, scores,
                                   ys, xs, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int decode_peaks_max_peaks() { return MAX_PEAKS; }

}  // extern "C"
