// Fused stride-4 keypoint-head tail for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel multiposenet_tpu/ops/kp_tail_pallas.py
// `_tail_kernel` (row-tiled im2col matmuls on the MXU). Computes
//   out[b, k, y, x] = round(bias[k] + sum_{dy,dx,c} X[b, c, y+dy-1, x+dx-1]
//                                              * W[(dy*3+dx)*C + c, k])
// with X = round(l2 + nearest_up2(z8)) (zero outside the map: SAME
// padding of the sum), f32 accumulation and one rounding at the end,
// written channel-major [B, K, H, W]. The upsample-add is fused into the
// operand load: the kernel reads l2 [B, C, H, W] and z8 [B, C, H/2, W/2]
// and never materialises the sum or a W-doubled z8.
//
// Bound on the card: at the crowd path's shapes (B=128, C=64, 128x128,
// K=17, bf16) the kernel must read 268 MB of l2 and 67 MB of z8 and
// write 71 MB, ~121 us at 3.35 TB/s; its 41 GFLOP would take ~41 us at
// the 989 TFLOP/s bf16 tensor-core peak, so bytes bound it.
// This first design runs the implicit GEMM (M = B*H*W pixels, K = 9C,
// N = K outputs) on the CUDA cores, which puts it far from that bound
// (41 GFLOP at 67 TFLOP/s of f32 FMA is ~0.6 ms): a block owns a
// TH x TW tile of output pixels of one image, stages the rounded sum for
// CC input channels with a one-pixel halo and the matching [9, CC, KP]
// weight slab in shared memory, and each thread accumulates RY vertically
// adjacent pixels x all KP (K padded to a multiple of 4) outputs in
// registers, so each float4 weight read from shared memory (a broadcast)
// feeds 4*RY FMAs and each staged input value 3 taps. Tensor cores
// (mma.sync / wgmma with N padded to 24 or 32) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TH 16                     // output rows per block
#define TW 32                     // output columns per block (one warp)
#define RY 4                      // output rows per thread
#define CC 8                      // input channels staged per step
#define THREADS (TW * TH / RY)    // 128
#define MAX_K 32

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// The sum rounded to the inputs' dtype, as the plain version's add is.
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int KP>
__global__ void __launch_bounds__(THREADS)
kp_tail_kernel(const T* __restrict__ l2, const T* __restrict__ z8,
               const T* __restrict__ wmat, const float* __restrict__ bias,
               T* __restrict__ out, int C, int H, int W, int K) {
  __shared__ float xs[CC][TH + 2][TW + 2];
  __shared__ __align__(16) float ws[9][CC][KP];

  const int tx = threadIdx.x % TW;
  const int ty = threadIdx.x / TW;  // row group
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int b = blockIdx.z;
  const int H2 = H / 2, W2 = W / 2;
  const long long plane = static_cast<long long>(H) * W;
  const long long plane2 = static_cast<long long>(H2) * W2;
  const T* l2b = l2 + static_cast<long long>(b) * C * plane;
  const T* z8b = z8 + static_cast<long long>(b) * C * plane2;

  float acc[RY][KP];
#pragma unroll
  for (int i = 0; i < RY; ++i)
#pragma unroll
    for (int k = 0; k < KP; ++k) acc[i][k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    // Stage the rounded sum with its halo; zero outside the map.
    for (int idx = threadIdx.x; idx < CC * (TH + 2) * (TW + 2);
         idx += THREADS) {
      const int cc = idx / ((TH + 2) * (TW + 2));
      const int rem = idx - cc * (TH + 2) * (TW + 2);
      const int r = rem / (TW + 2);
      const int col = rem - r * (TW + 2);
      const int c = c0 + cc, gy = y0 - 1 + r, gx = x0 - 1 + col;
      float v = 0.f;
      if (c < C && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const float a = load_f32(l2b + c * plane + gy * W + gx);
        const float u = load_f32(z8b + c * plane2 + (gy >> 1) * W2 + (gx >> 1));
        v = round_to(a + u, l2);
      }
      xs[cc][r][col] = v;
    }
    for (int idx = threadIdx.x; idx < 9 * CC * KP; idx += THREADS) {
      const int t = idx / (CC * KP);
      const int rem = idx - t * CC * KP;
      const int cc = rem / KP;
      const int k = rem - cc * KP;
      const int c = c0 + cc;
      ws[t][cc][k] = (c < C && k < K) ? load_f32(wmat + (t * C + c) * K + k)
                                      : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int cc = 0; cc < CC; ++cc) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float v[RY + 2];
#pragma unroll
        for (int j = 0; j < RY + 2; ++j) v[j] = xs[cc][ty * RY + j][tx + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float4* wp =
              reinterpret_cast<const float4*>(&ws[dy * 3 + dx][cc][0]);
#pragma unroll
          for (int q = 0; q < KP / 4; ++q) {
            const float4 w4 = wp[q];
#pragma unroll
            for (int i = 0; i < RY; ++i) {
              const float a = v[i + dy];
              acc[i][4 * q + 0] = fmaf(a, w4.x, acc[i][4 * q + 0]);
              acc[i][4 * q + 1] = fmaf(a, w4.y, acc[i][4 * q + 1]);
              acc[i][4 * q + 2] = fmaf(a, w4.z, acc[i][4 * q + 2]);
              acc[i][4 * q + 3] = fmaf(a, w4.w, acc[i][4 * q + 3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const int x = x0 + tx;
  if (x >= W) return;
  T* outb = out + static_cast<long long>(b) * K * plane;
#pragma unroll
  for (int i = 0; i < RY; ++i) {
    const int y = y0 + ty * RY + i;
    if (y >= H) continue;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      if (k < K) store(outb + k * plane + y * W + x, acc[i][k] + bias[k]);
    }
  }
}

template <typename T, int KP>
static int launch(const void* l2, const void* z8, const void* wmat,
                  const float* bias, void* out, int B, int C, int H, int W,
                  int K, cudaStream_t stream) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kp_tail_kernel<T, KP><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(l2), static_cast<const T*>(z8),
      static_cast<const T*>(wmat), bias, static_cast<T*>(out), C, H, W, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const void* l2, const void* z8, const void* wmat,
                    const float* bias, void* out, int B, int C, int H, int W,
                    int K, cudaStream_t stream) {
  switch ((K + 3) / 4) {
#define CASE(Q)                                                        \
  case Q:                                                              \
    return launch<T, 4 * Q>(l2, z8, wmat, bias, out, B, C, H, W, K, stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" {

// l2: [B, C, H, W], z8: [B, C, H/2, W/2], contiguous, of one dtype;
// wmat: [9*C, K] in that dtype, rows ordered (dy, dx, c); bias: [K] f32;
// out: [B, K, H, W] in that dtype. dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t code.
int kp_tail(const void* l2, const void* z8, const void* wmat,
            const float* bias, void* out, int dtype, int B, int C, int H,
            int W, int K, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || H < 2 || W < 2 || (H & 1) || (W & 1) ||
      K < 1 || K > MAX_K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(l2, z8, wmat, bias, out, B, C, H, W, K, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(l2, z8, wmat, bias, out, B, C, H, W, K, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
