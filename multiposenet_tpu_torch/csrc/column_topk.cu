// Per-column top-8 of the 3x3 peak mask of bf16 maps, for NVIDIA Hopper
// (sm_90a): one block per map, one thread per column.
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
//   maxima propagate NaN (max.NaN.f32) as jnp.maximum and max_pool2d do,
//   so it agrees bit for bit with ops/column_topk.py column_topk_plain.
//
// Bound on the card: each map is read once and 2 * N * 8 * 4 bytes are
// written (2176 maps of 128x128 move 71.44 MB, 21.3 us at 3.35 TB/s);
// per element 8 maxima and a comparison (9.6 us at 132 SMs x 128 lanes x
// 1.98 GHz). So bytes bound it.
// Design (simple, not tuned): a block stages its map's rows in shared
// memory, up to 32 KB of them at a time (a whole 128x128 map), by 16-byte
// cp.async where the rows are 16-byte aligned, else by plain loads, so
// each block has its whole chunk of loads in flight at once and the 7
// blocks an SM holds overlap one another's loads and work. A thread then
// walks its column's rows top to bottom, keeping the rows r-1, r, r+1 of
// its own and its two neighbour columns in registers (across chunks too),
// and inserts a peak into a sorted list of 8 (value, row) pairs in
// registers only where it is strictly greater than the 8th, which keeps
// the lower row on ties.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTop = 8;             // peaks per column
constexpr int kMaxWidth = 1024;     // a thread per column
constexpr int kMaxRows = 1 << 27;   // packed rows row * 16 + 5 fit int32
constexpr int kStageElems = 16384;  // 32 KB of bf16 rows per chunk

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The column's sorted (value desc, row asc) list takes v at `row`, given
// v > s[kTop - 1]: each slot j ends up holding old slot j - 1 where that
// ranks below v, v where slot j - 1 does not and slot j does, else its own
// entry. Rows arrive in ascending order, so an equal value stays ahead.
__device__ __forceinline__ void insert(float (&s)[kTop], int (&r)[kTop],
                                       float v, int row) {
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

// Row `row` of this thread's column: u, m, d hold columns c-1, c, c+1 of
// the rows above, at and below it (-inf outside the map).
__device__ __forceinline__ void consider(float (&s)[kTop], int (&r)[kTop],
                                         const float (&u)[3],
                                         const float (&m)[3],
                                         const float (&d)[3], int row) {
  const float m9 = max_nan(
      max_nan(max_nan(u[0], m[0]), max_nan(d[0], u[1])),
      max_nan(max_nan(m[1], d[1]), max_nan(max_nan(u[2], m[2]), d[2])));
  const float v = m[1];
  if (v >= m9 && v > s[kTop - 1]) insert(s, r, v, row);
}

__global__ void __launch_bounds__(kMaxWidth)
column_topk_kernel(const __nv_bfloat16* __restrict__ maps, int H, int W,
                   int chunk_rows, int aligned, float* __restrict__ scores,
                   int* __restrict__ rows, float* __restrict__ col_scores,
                   int* __restrict__ col_rows) {
  __shared__ __align__(16) __nv_bfloat16 stage[kStageElems];
  const int n = blockIdx.x;
  const int c = threadIdx.x;  // blockDim.x == W
  const __nv_bfloat16* src = maps + static_cast<long long>(n) * H * W;

  float s[kTop];
  int r[kTop];
#pragma unroll
  for (int j = 0; j < kTop; ++j) {
    s[j] = -INFINITY;
    r[j] = 0;
  }
  float u[3] = {-INFINITY, -INFINITY, -INFINITY};
  float m[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int r0 = 0; r0 < H; r0 += chunk_rows) {
    const int n_rows = min(chunk_rows, H - r0);
    const int count = n_rows * W;
    const __nv_bfloat16* chunk = src + static_cast<long long>(r0) * W;
    if (r0 > 0) __syncthreads();  // every thread is done with the last one
    if (aligned) {  // W % 8 == 0: count is a multiple of 8
      for (int i = c * 8; i < count; i += W * 8) {
        cp_async16(stage + i, chunk + i);
      }
      cp_async_wait_all();
    } else {
      for (int i = c; i < count; i += W) stage[i] = chunk[i];
    }
    __syncthreads();
    for (int i = 0; i < n_rows; ++i) {
      const __nv_bfloat16* row = stage + i * W;
      const float d[3] = {
          c > 0 ? __bfloat162float(row[c - 1]) : -INFINITY,
          __bfloat162float(row[c]),
          c + 1 < W ? __bfloat162float(row[c + 1]) : -INFINITY};
      if (r0 + i > 0) consider(s, r, u, m, d, r0 + i - 1);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        u[k] = m[k];
        m[k] = d[k];
      }
    }
  }
  const float below[3] = {-INFINITY, -INFINITY, -INFINITY};
  consider(s, r, u, m, below, H - 1);

  if (col_scores != nullptr) {
#pragma unroll
    for (int j = 0; j < kTop; ++j) {
      const long long o = (static_cast<long long>(n) * kTop + j) * W + c;
      col_scores[o] = s[j];
      col_rows[o] = r[j] * 16 + 5;
    }
  }
  if (c == 0) {
#pragma unroll
    for (int j = 0; j < kTop; ++j) {
      const long long o = static_cast<long long>(n) * kTop + j;
      scores[o] = s[j];
      rows[o] = r[j] * 16 + 5;
    }
  }
}

}  // namespace

extern "C" {

// maps: [N, H, W] bfloat16, contiguous; 1 <= W <= 1024, 1 <= H <= 2^27.
// Outputs scores [N, 8] float32 and rows [N, 8] int32 (row * 16 + 5),
// column 0's lists; col_scores/col_rows, both null or both [N, 8, W]
// (float32, int32), every column's. Returns a cudaError_t code.
int column_topk(const void* maps, int N, int H, int W, float* scores,
                int* rows, float* col_scores, int* col_rows, void* stream) {
  if (N < 1 || H < 1 || H > kMaxRows || W < 1 || W > kMaxWidth ||
      (col_scores == nullptr) != (col_rows == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunk_rows = H < kStageElems / W ? H : kStageElems / W;
  const int aligned =
      reinterpret_cast<uintptr_t>(maps) % 16 == 0 && W % 8 == 0;
  column_topk_kernel<<<N, W, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(maps), H, W, chunk_rows, aligned,
      scores, rows, col_scores, col_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
