// Fused stride-4 keypoint-head tail for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel multiposenet_tpu/ops/kp_tail_pallas.py:67
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
// write 71 MB, 0.1215 ms at 3.35 TB/s; its 41 GFLOP take 0.0415 ms at the
// 989 TFLOP/s bf16 tensor-core peak, so bytes bound it.
//
// bf16 (kp_tail_mma): an implicit GEMM on the tensor cores through
// mma.sync.m16n8k16 (bf16 in, f32 accumulate). M = pixels, reduction
// 9C walked as (16-channel chunk, tap) steps of 16, N = K padded to a
// multiple of 8 (17 -> 24: three n8 tiles; 1..4 tiles for K <= 32).
//  - A block owns 4 output rows x 128 columns of one image (grid: row
//    tiles fastest, so the halo rows of neighbouring blocks are read from
//    L2); 8 warps, each 16 columns x the 4 rows: 4 m16 tiles x NT n8
//    tiles of f32 accumulators.
//  - Per 16-channel chunk the rounded sum for the 6 x 130 haloed pixels
//    is staged channels-last in shared memory, 32 B per pixel, its two
//    16-byte halves swapped on every other group of 4 pixels (an XOR
//    swizzle), so each tap is a whole-pixel shift and one ldmatrix.x4 of
//    16 consecutive pixels is free of bank conflicts at any start. A warp
//    loads each staged row once per dx and feeds it to the 3 dy taps.
//  - l2 and z8 are read 16 and 8 bytes a thread (8 pixels of one
//    channel; each z8 value serves its 2x2 patch). The add is one bf16x2
//    add (a single rounding of the exact sum, equal to the plain
//    version's f32 add rounded to bf16) after a byte permute that turns
//    (channel, pixel pair) words into (pixel, channel pair) words; the
//    32-bit stores are rotated per lane so that a warp's stores hit 32
//    banks.
//  - Two buffers: while the tensor cores run a chunk's three dx phases,
//    the next chunk is staged into the other buffer one item (48 bytes a
//    thread) per phase from registers, and its weight slab is copied with
//    cp.async; one block barrier per chunk. (Holding all three items in
//    registers spilled at the 128-register cap of 2 blocks per SM; raw
//    tiles copied with cp.async and converted in shared memory, with or
//    without blocks that walk many tiles, measured no faster.)
//  - Weights are packed by the wrapper (ops/kp_tail.py) into the order
//    the B fragments are read in, zero beyond C and K: 9 x NT x 256 B per
//    chunk, one 8-byte shared load per lane and fragment.
//  - Epilogue: the f32 bias is added to the accumulators, each value is
//    rounded once, the [K, 4, 128] tile is staged in shared memory and
//    written 16 bytes a thread along the rows of [B, K, H, W].
//  Ragged C, H and W are zero-filled on load and masked on store; widths
//  that are not a multiple of 8 (or misaligned pointers) take scalar
//  loads and stores. 124 registers, 2 blocks (16 warps) per SM.
//  Measured at the crowd path's shapes on an H100 (PERF.md): 0.38-0.41 ms,
//  3.1-3.4x the byte bound, against 2.08 ms for the CUDA-core design and
//  0.88-0.90 ms for cuDNN's bf16 conv of the summed input. Built with
//  -DKP_TAIL_PROFILE it counts clock64 cycles per phase
//  (multiposenet_tpu_torch/tools/kp_tail_phases.py).
//
// f32 (kp_tail_kernel) stays on the CUDA cores, one fmaf per product:
// the port's float32 contract is true f32 products (the card tests hold
// it to 1e-5 and the folded crowd forward in f32 to the CPU), which TF32
// tensor cores would not keep. A block owns a TH x TW tile of output
// pixels, stages the sum for CC input channels with a one-pixel halo and
// the [9, CC, KP] weight slab in shared memory, and each thread
// accumulates RY vertically adjacent pixels x all KP (K padded to a
// multiple of 4) outputs in registers.

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
// The sum rounded to the inputs' dtype, as the plain version's add is.
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

// ---------------------------------------------------------------------------
// bf16: implicit GEMM on the tensor cores (mma.sync.m16n8k16).

namespace mma {

constexpr int kRows = 4;                     // output rows per block
constexpr int kCols = 128;                   // output columns per block
constexpr int kWarps = kCols / 16;           // 8: 16 columns each
constexpr int kThreads = kWarps * 32;        // 256
constexpr int kChunk = 16;                   // channels per reduction step
constexpr int kSRows = kRows + 2;            // staged rows (halo)
constexpr int kSCols = kCols + 2;            // staged columns (halo)
constexpr int kXBytes = kSRows * kSCols * 32;  // one staged chunk: 24960 B
constexpr int kGroups = kCols / 8;           // 8-pixel groups per row
constexpr int kItems = kSRows * kGroups * 8;   // (row, group, pair) items
constexpr int kPerThread = kItems / kThreads;  // 3
constexpr int kEdges = kSRows * 2 * 8;         // halo-column items: 96
constexpr int kOutPlane = kRows * kCols + 8;   // padded [K] plane of the
                                               // staged output tile
static_assert(kItems % kThreads == 0, "items per thread");
static_assert(kEdges <= kThreads, "one edge item per thread");
static_assert(4 * 8 * kOutPlane * 2 <= 2 * kXBytes,
              "the output tile fits over the staging buffers");

#ifdef KP_TAIL_PROFILE
// Phase counters of warp 0, summed over blocks (built only with
// -DKP_TAIL_PROFILE, by multiposenet_tpu_torch/tools/kp_tail_phases.py):
// clock64 cycles in the prologue (first chunk staged), the tensor-core
// work of the dx phases, the staging of the next chunk between them, the
// barrier and weight copy at the top of each chunk, and the epilogue;
// then the number of blocks.
constexpr int kPhases = 5;
__device__ unsigned long long phase_cycles[kPhases + 1];
#define KP_MARK(i)                                   \
  if (tid == 0) {                                    \
    const long long now = clock64();                 \
    prof[i] += now - t_mark;                         \
    t_mark = now;                                    \
  }
#else
#define KP_MARK(i)
#endif

__host__ __device__ constexpr int w_slab(int nt) { return 9 * nt * 256; }
__host__ __device__ constexpr int smem_bytes(int nt) {
  return 2 * kXBytes + 2 * w_slab(nt);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// Byte offset of 16-byte half h of staged pixel p: the halves swap on
// every other group of 4 pixels, so 8 consecutive pixels' same half lie
// in 8 distinct 16-byte bank groups.
__device__ __forceinline__ int x_off(int p, int h) {
  return p * 32 + ((h ^ ((p >> 2) & 1)) << 4);
}

// The raw inputs of one (staged row, 8-pixel group, channel pair) item.
struct Raw {
  uint4 a0, a1;  // l2, channels c and c+1, 8 columns
  uint2 u0, u1;  // z8, channels c and c+1, the 4 columns under them
};

__device__ __forceinline__ void load_item(
    Raw& r, const __nv_bfloat16* l2b, const __nv_bfloat16* z8b, int c,
    int C, int gy, int gx, int H, int W, bool vec) {
  const int H2 = H >> 1, W2 = W >> 1;
  const long long plane = static_cast<long long>(H) * W;
  const long long plane2 = static_cast<long long>(H2) * W2;
  r.a0 = r.a1 = make_uint4(0, 0, 0, 0);
  r.u0 = r.u1 = make_uint2(0, 0);
  if (gy < 0 || gy >= H || gx >= W) return;
  const bool c0ok = c < C, c1ok = c + 1 < C;
  const __nv_bfloat16* p0 = l2b + c * plane + gy * static_cast<long long>(W)
                            + gx;
  const __nv_bfloat16* q0 = z8b + c * plane2
                            + (gy >> 1) * static_cast<long long>(W2)
                            + (gx >> 1);
  if (vec) {  // W % 8 == 0: the whole group lies inside the row
    if (c0ok) {
      r.a0 = __ldg(reinterpret_cast<const uint4*>(p0));
      r.u0 = __ldg(reinterpret_cast<const uint2*>(q0));
    }
    if (c1ok) {
      r.a1 = __ldg(reinterpret_cast<const uint4*>(p0 + plane));
      r.u1 = __ldg(reinterpret_cast<const uint2*>(q0 + plane2));
    }
    return;
  }
  const unsigned short* ps = reinterpret_cast<const unsigned short*>(p0);
  const unsigned short* qs = reinterpret_cast<const unsigned short*>(q0);
  uint32_t a0[4] = {0, 0, 0, 0}, a1[4] = {0, 0, 0, 0};
  uint32_t u0[2] = {0, 0}, u1[2] = {0, 0};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (gx + e < W) {
      const int sh = (e & 1) * 16;
      if (c0ok) a0[e >> 1] |= static_cast<uint32_t>(ps[e]) << sh;
      if (c1ok) a1[e >> 1] |= static_cast<uint32_t>(ps[e + plane]) << sh;
      if (!(e & 1)) {
        const int s2 = ((e >> 1) & 1) * 16;
        if (c0ok) u0[e >> 2] |= static_cast<uint32_t>(qs[e >> 1]) << s2;
        if (c1ok) u1[e >> 2] |= static_cast<uint32_t>(qs[(e >> 1) + plane2])
                                << s2;
      }
    }
  }
  r.a0 = make_uint4(a0[0], a0[1], a0[2], a0[3]);
  r.a1 = make_uint4(a1[0], a1[1], a1[2], a1[3]);
  r.u0 = make_uint2(u0[0], u0[1]);
  r.u1 = make_uint2(u1[0], u1[1]);
}

// The rounded sum of a word of two l2 values and one of two z8 values,
// as bf16x2: one rounding of the exact sum, which equals the plain
// version's f32 add rounded to bf16 (f32 holds more than 2 x 8 + 2 bits,
// so rounding twice cannot differ).
__device__ __forceinline__ uint32_t add2(uint32_t l, uint32_t z) {
  const __nv_bfloat162 s =
      __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&l),
              *reinterpret_cast<const __nv_bfloat162*>(&z));
  return *reinterpret_cast<const uint32_t*>(&s);
}

// Round the sums of one item and store them as channel-pair words: a
// byte permute turns (channel, pixel pair) words into (pixel, channel
// pair) words. Lane group q (= the item's group mod 4) stores pixel
// (s + q) % 8 at step s, so at each step a warp's 32 stores fall in 32
// distinct banks.
__device__ __forceinline__ void store_item(unsigned char* xbuf, const Raw& r,
                                           int row, int group, int pair) {
  const uint32_t l0[4] = {r.a0.x, r.a0.y, r.a0.z, r.a0.w};
  const uint32_t l1[4] = {r.a1.x, r.a1.y, r.a1.z, r.a1.w};
  const uint32_t z0[2] = {r.u0.x, r.u0.y}, z1[2] = {r.u1.x, r.u1.y};
  uint32_t pk[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t z = __byte_perm(z0[q >> 1], z1[q >> 1],
                                   (q & 1) ? 0x7632 : 0x5410);
    pk[2 * q] = add2(__byte_perm(l0[q], l1[q], 0x5410), z);
    pk[2 * q + 1] = add2(__byte_perm(l0[q], l1[q], 0x7632), z);
  }
  const int q = group & 3;
  uint32_t t[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) t[s] = (q & 1) ? pk[(s + 1) & 7] : pk[s];
#pragma unroll
  for (int s = 0; s < 8; ++s) pk[s] = (q & 2) ? t[(s + 2) & 7] : t[s];
  const int p0 = row * kSCols + 1 + 8 * group;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int p = p0 + ((s + q) & 7);
    *reinterpret_cast<uint32_t*>(xbuf + x_off(p, pair >> 2) + (pair & 3) * 4)
        = pk[s];
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// l2 [B, C, H, W], z8 [B, C, H/2, W/2] bf16; wpack: per 16-channel chunk
// [9 taps][NT][32 lanes][4 bf16] B fragments (ops/kp_tail.py
// tail_weight_fragments); bias [K] f32; out [B, K, H, W] bf16.
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
kp_tail_mma(const __nv_bfloat16* __restrict__ l2,
            const __nv_bfloat16* __restrict__ z8,
            const unsigned char* __restrict__ wpack,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
            int C, int H, int W, int K, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const wbase = smem + 2 * kXBytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int y0 = blockIdx.x * kRows;
  const int x0 = blockIdx.y * kCols;
  const int b = blockIdx.z;
  const long long plane = static_cast<long long>(H) * W;
  const __nv_bfloat16* l2b = l2 + static_cast<long long>(b) * C * plane;
  const __nv_bfloat16* z8b = z8 + static_cast<long long>(b) * C * (plane >> 2);
  const int n_chunks = (C + kChunk - 1) / kChunk;
#ifdef KP_TAIL_PROFILE
  long long prof[kPhases] = {}, t_mark = clock64();
#endif

  // This thread's staging items: kPerThread interior (row, group, pair)
  // items and, for the first kEdges threads, one halo column (row, side,
  // pair).
  const int e_pair = tid & 7, e_side = (tid >> 3) & 1, e_row = tid >> 4;
  const int e_col = e_side ? kSCols - 1 : 0;
  const int e_gx = x0 - 1 + e_col;

  Raw raw;             // the item in flight
  uint32_t edge = 0;   // raw l2 (low) and z8 (high) of the halo pixel,
  uint32_t edge1 = 0;  // channels c and c+1

  auto load_interior = [&](int ch, int j) {
    const int it = tid + j * kThreads;
    const int pair = it & 7, group = (it >> 3) % kGroups,
              row = it / (8 * kGroups);
    load_item(raw, l2b, z8b, ch * kChunk + 2 * pair, C, y0 - 1 + row,
              x0 + 8 * group, H, W, vec);
  };
  auto store_interior = [&](unsigned char* xb, int j) {
    const int it = tid + j * kThreads;
    store_item(xb, raw, it / (8 * kGroups), (it >> 3) % kGroups, it & 7);
  };
  auto load_edge = [&](int ch) {
    edge = edge1 = 0;
    const int gy = y0 - 1 + e_row, c = ch * kChunk + 2 * e_pair;
    if (tid < kEdges && gy >= 0 && gy < H && e_gx >= 0 && e_gx < W) {
      const unsigned short* ls = reinterpret_cast<const unsigned short*>(l2b);
      const unsigned short* zs = reinterpret_cast<const unsigned short*>(z8b);
      const long long li = gy * static_cast<long long>(W) + e_gx;
      const long long zi = (gy >> 1) * static_cast<long long>(W >> 1)
                           + (e_gx >> 1);
      if (c < C) {
        edge = ls[c * plane + li] | (static_cast<uint32_t>(
            zs[c * (plane >> 2) + zi]) << 16);
      }
      if (c + 1 < C) {
        edge1 = ls[(c + 1) * plane + li] | (static_cast<uint32_t>(
            zs[(c + 1) * (plane >> 2) + zi]) << 16);
      }
    }
  };
  auto store_edge = [&](unsigned char* xb) {
    if (tid < kEdges) {
      const int p = e_row * kSCols + e_col;
      *reinterpret_cast<uint32_t*>(xb + x_off(p, e_pair >> 2)
                                   + (e_pair & 3) * 4) =
          add2(__byte_perm(edge, edge1, 0x5410),
               __byte_perm(edge, edge1, 0x7632));
    }
  };
  auto copy_weights = [&](int ch) {
    const unsigned char* src = wpack + static_cast<long long>(ch) * w_slab(NT);
    unsigned char* wb = wbase + (ch & 1) * w_slab(NT);
    for (int i = tid; i < w_slab(NT) / 16; i += kThreads) {
      cp_async16(smem_addr(wb + i * 16), src + i * 16);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[kRows][NT][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][n][q] = 0.f;

  copy_weights(0);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    load_interior(0, j);
    store_interior(smem, j);
  }
  load_edge(0);
  store_edge(smem);
  KP_MARK(0)

  // ldmatrix row of this lane: pixel lane % 16 of the warp's 16 columns,
  // half lane / 16 of its 16 channels.
  const int a_col = 16 * warp + (lane & 15), a_half = lane >> 4;
  static_assert(kPerThread == 3, "one staging item per dx phase");

  for (int ch = 0; ch < n_chunks; ++ch) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // While the tensor cores run this chunk's three dx phases, the next
    // chunk is staged one item per phase into the other buffers.
    const bool more = ch + 1 < n_chunks;
    unsigned char* next = smem + ((ch + 1) & 1) * kXBytes;
    if (more) {
      copy_weights(ch + 1);
      load_interior(ch + 1, 0);
    }
    KP_MARK(3)
    const uint32_t xs = smem_addr(smem + (ch & 1) * kXBytes);
    const unsigned char* wb = wbase + (ch & 1) * w_slab(NT);
    // Not unrolled: unrolled, the compiler hoists the next phase's
    // fragments and spills at the 128-register cap.
#pragma unroll 1
    for (int dx = 0; dx < 3; ++dx) {
      uint32_t bfr[3][NT][2];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              wb + (((dy * 3 + dx) * NT + n) * 32 + lane) * 8);
          bfr[dy][n][0] = v.x;
          bfr[dy][n][1] = v.y;
        }
#pragma unroll
      for (int rr = 0; rr < kSRows; ++rr) {
        const int p = rr * kSCols + a_col + dx;
        uint32_t a[4];
        ldmatrix_x4(a, xs + x_off(p, a_half));
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int i = rr - dy;
          if (i >= 0 && i < kRows) {
#pragma unroll
            for (int n = 0; n < NT; ++n) mma_bf16(acc[i][n], a, bfr[dy][n]);
          }
        }
      }
      KP_MARK(1)
      if (more) {
        store_interior(next, dx);
        if (dx < 2) load_interior(ch + 1, dx + 1);
        if (dx == 1) load_edge(ch + 1);
        if (dx == 2) store_edge(next);
      }
      KP_MARK(2)
    }
  }

  // Epilogue: bias, one rounding, the [NT*8, 4, 128] tile through shared
  // memory (over the staging buffers), then rows of 16 bytes.
  __syncthreads();
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int k0 = n * 8 + 2 * t;
    const float b0 = k0 < K ? bias[k0] : 0.f;
    const float b1 = k0 + 1 < K ? bias[k0 + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      __nv_bfloat16* o0 = os + k0 * kOutPlane + i * kCols + 16 * warp + g;
      o0[0] = __float2bfloat16_rn(acc[i][n][0] + b0);
      o0[kOutPlane] = __float2bfloat16_rn(acc[i][n][1] + b1);
      o0[8] = __float2bfloat16_rn(acc[i][n][2] + b0);
      o0[kOutPlane + 8] = __float2bfloat16_rn(acc[i][n][3] + b1);
    }
  }
  __syncthreads();
  __nv_bfloat16* outb = out + static_cast<long long>(b) * K * plane;
  for (int it = tid; it < K * kRows * kGroups; it += kThreads) {
    const int j = it % kGroups, i = (it / kGroups) % kRows,
              k = it / (kGroups * kRows);
    const int y = y0 + i, x = x0 + 8 * j;
    if (y >= H || x >= W) continue;
    const __nv_bfloat16* src = os + k * kOutPlane + i * kCols + 8 * j;
    __nv_bfloat16* dst = outb + k * plane + y * static_cast<long long>(W) + x;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && x + e < W; ++e) dst[e] = src[e];
    }
  }
  KP_MARK(4)
#ifdef KP_TAIL_PROFILE
  if (tid == 0) {
    for (int i = 0; i < kPhases; ++i) {
      atomicAdd(&phase_cycles[i], static_cast<unsigned long long>(prof[i]));
    }
    atomicAdd(&phase_cycles[kPhases], 1ull);
  }
#endif
}

template <int NT>
static int launch(const void* l2, const void* z8, const void* wpack,
                  const float* bias, void* out, int B, int C, int H, int W,
                  int K, cudaStream_t stream) {
  const int smem = smem_bytes(NT);
  cudaError_t e = cudaFuncSetAttribute(
      kp_tail_mma<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec = W % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(l2) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(z8) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((H + kRows - 1) / kRows, (W + kCols - 1) / kCols, B);
  kp_tail_mma<NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(l2),
      static_cast<const __nv_bfloat16*>(z8),
      static_cast<const unsigned char*>(wpack), bias,
      static_cast<__nv_bfloat16*>(out), C, H, W, K, vec);
  return static_cast<int>(cudaGetLastError());
}

static int dispatch(const void* l2, const void* z8, const void* wpack,
                    const float* bias, void* out, int B, int C, int H, int W,
                    int K, cudaStream_t stream) {
  switch ((K + 7) / 8) {
    case 1: return launch<1>(l2, z8, wpack, bias, out, B, C, H, W, K, stream);
    case 2: return launch<2>(l2, z8, wpack, bias, out, B, C, H, W, K, stream);
    case 3: return launch<3>(l2, z8, wpack, bias, out, B, C, H, W, K, stream);
    case 4: return launch<4>(l2, z8, wpack, bias, out, B, C, H, W, K, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mma

extern "C" {

// l2: [B, C, H, W], z8: [B, C, H/2, W/2], contiguous, of one dtype;
// bias: [K] f32; out: [B, K, H, W] in that dtype. dtype: 0 = float32,
// 1 = bfloat16. wmat: for float32 the [9*C, K] matrix in float32, rows
// ordered (dy, dx, c); for bfloat16 its mma.sync B fragments,
// [ceil(C/16)][9][ceil(K/8)][32][4] bf16, zero beyond C and K
// (ops/kp_tail.py tail_weight_fragments). Returns a cudaError_t code.
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
    return mma::dispatch(l2, z8, wmat, bias, out, B, C, H, W, K, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef KP_TAIL_PROFILE
// Reads (and with reset != 0 then zeroes) the bf16 kernel's phase
// counters: kPhases + 1 values.
int kp_tail_phase_cycles(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, mma::phase_cycles,
                                       sizeof(mma::phase_cycles));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[mma::kPhases + 1] = {};
    e = cudaMemcpyToSymbol(mma::phase_cycles, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
#endif

}  // extern "C"
