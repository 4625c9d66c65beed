// The train step's update outside the model, over lists of float32 tensors
// on one card: optax's chain(clip_by_global_norm, adamw) (or plain adam)
// and the EMA of the parameters, rounded as XLA's CPU backend compiles the
// JAX package's step (multiposenet_tpu_torch/train/xla_arith.py says what
// that is): every multiply and add rounded on its own except the fused
// multiply-adds the compiler forms, each rounded once; a true division;
// the correctly rounded square root; float32 subnormals flushed to zero of
// the same sign on every input and result. The intrinsics below are never
// contracted or reassociated by nvcc, whatever its flags.
//
// A tensor's elements go to blocks of CHUNK consecutive ones; the table a
// launch reads (int64, on the card) holds, for T tensors:
//   adam: [p ptr T][mu ptr T][nu ptr T][flat offset T][numel T][first block T+1]
//   ema:  [ema ptr T][p ptr T][numel T][first block T+1]
// where "first block" is the running sum of ceil(numel / CHUNK) and the flat
// offset is where the tensor's gradient starts in the flat gradient vector.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int CHUNK = THREADS * ITEMS;

struct AdamScalars {
  float b1, c1, b2, c2;  // b and its 1 - b, in float32
  float bc1, bc2, eps;   // 1 - b^count, eps
  float wd, neg_lr;      // weight decay (when decoupled), -lr
  float clip;            // the global norm's clip (when norm is given)
  int decoupled;         // adamw: p + (p * wd + d) * -lr, else p + d * -lr
  int nu_fuses_moment;   // nu' fuses nu * b2 into the add, else g^2 * c2
};

__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < __int_as_float(0x00800000) ? copysignf(0.0f, x) : x;
}

__device__ __forceinline__ float mul_ftz(float a, float b) {
  return ftz(__fmul_rn(a, b));
}

__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  return ftz(__fmaf_rn(a, b, c));
}

// The tensor whose blocks hold block b: the last t with first[t] <= b.
__device__ __forceinline__ int owner(const int64_t* first, int n_tensors,
                                    int64_t b) {
  int lo = 0, hi = n_tensors - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
adam_kernel(const int64_t* __restrict__ table, int n_tensors,
            const float* __restrict__ grads, const float* __restrict__ norm,
            AdamScalars s) {
  const int64_t* first = table + 5 * n_tensors;
  __shared__ int t_shared;
  if (threadIdx.x == 0) t_shared = owner(first, n_tensors, blockIdx.x);
  __syncthreads();
  const int t = t_shared;
  float* p = reinterpret_cast<float*>(table[t]);
  float* mu = reinterpret_cast<float*>(table[n_tensors + t]);
  float* nu = reinterpret_cast<float*>(table[2 * n_tensors + t]);
  const float* g = grads + table[3 * n_tensors + t];
  const int64_t n = table[4 * n_tensors + t];
  const int64_t base = (blockIdx.x - first[t]) * CHUNK + threadIdx.x;
  // optax clips by clip / norm when the norm is not below the clip.
  const bool scale = norm != nullptr && !(*norm < s.clip);
  const float by = norm != nullptr ? *norm : 1.0f;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t i = base + j * THREADS;
    if (i >= n) break;
    float gi = ftz(g[i]);
    if (scale) gi = mul_ftz(ftz(__fdiv_rn(gi, by)), s.clip);
    const float m = fma_ftz(gi, s.c1, mul_ftz(ftz(mu[i]), s.b1));
    const float g2 = mul_ftz(gi, gi);
    const float nui = ftz(nu[i]);
    const float v = s.nu_fuses_moment
                        ? fma_ftz(nui, s.b2, mul_ftz(g2, s.c2))
                        : fma_ftz(g2, s.c2, mul_ftz(nui, s.b2));
    const float den = __fmul_rn(
        __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps), s.bc1);
    const float d = ftz(__fdiv_rn(m, den));
    const float pi = ftz(p[i]);
    const float step = s.decoupled ? fma_ftz(pi, s.wd, d) : d;
    p[i] = fma_ftz(s.neg_lr, step, pi);
    mu[i] = m;
    nu[i] = v;
  }
}

__global__ void __launch_bounds__(THREADS)
ema_kernel(const int64_t* __restrict__ table, int n_tensors, float decay,
           float weight) {
  const int64_t* first = table + 3 * n_tensors;
  __shared__ int t_shared;
  if (threadIdx.x == 0) t_shared = owner(first, n_tensors, blockIdx.x);
  __syncthreads();
  const int t = t_shared;
  float* e = reinterpret_cast<float*>(table[t]);
  const float* p = reinterpret_cast<const float*>(table[n_tensors + t]);
  const int64_t n = table[2 * n_tensors + t];
  const int64_t base = (blockIdx.x - first[t]) * CHUNK + threadIdx.x;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t i = base + j * THREADS;
    if (i >= n) break;
    e[i] = fma_ftz(ftz(e[i]), decay, mul_ftz(ftz(p[i]), weight));
  }
}

}  // namespace

extern "C" {

// Elements per block, for the caller's table.
int train_update_chunk() { return CHUNK; }

// One Adam step over the tensors of `table` (T = n_tensors, n_blocks =
// first block[T]) with their gradients laid end to end in `grads`; `norm`
// is a device float (the gradients' global norm) to clip by, or null.
int adam_update(const int64_t* table, int n_tensors, long long n_blocks,
                const float* grads, const float* norm, float b1, float c1,
                float b2, float c2, float bc1, float bc2, float eps, float wd,
                float neg_lr, float clip, int decoupled, int nu_fuses_moment,
                void* stream) {
  if (n_blocks <= 0) return 0;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  AdamScalars s{b1, c1, b2, c2, bc1, bc2, eps, wd, neg_lr, clip, decoupled,
                nu_fuses_moment};
  adam_kernel<<<(unsigned)n_blocks, THREADS, 0, (cudaStream_t)stream>>>(
      table, n_tensors, grads, norm, s);
  return (int)cudaGetLastError();
}

// ema <- ema * decay + p * weight over the tensors of `table`.
int ema_update(const int64_t* table, int n_tensors, long long n_blocks,
               float decay, float weight, void* stream) {
  if (n_blocks <= 0) return 0;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ema_kernel<<<(unsigned)n_blocks, THREADS, 0, (cudaStream_t)stream>>>(
      table, n_tensors, decay, weight);
  return (int)cudaGetLastError();
}

}  // extern "C"
