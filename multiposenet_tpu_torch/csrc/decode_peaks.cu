// Heatmap peak decode for NVIDIA Hopper (sm_90a): each warp streams the
// rows of one map, or of one band of rows of a map, top to bottom.
//
// Replaces the TPU kernel multiposenet_tpu/ops/decode_pallas.py
// `_decode_kernel` (banded-matmul blur + two-phase masked-argmax top-P).
// The function, its bound and the design are those of csrc/decode_rows.cuh,
// whose `decode_rows_kernel` this file launches on [B, K, H, W] maps with
// each [K, H, W] block contiguous: a block per map, a warp per band of
// its rows (8 bands at a `predict` request's 17 maps), 4 columns a lane,
// raw rows by 16-byte cp.async through a 16-row ring 4 steps ahead on the
// path's instantiation (128x128, 7 taps, P = 8, aligned), plain row loads
// on the generic one (sizes at run time, 16 columns a lane, so W <= 512).
// csrc/decode_lanes.cu (B2) runs the same device code on any layout.
// Built with -DDECODE_PEAKS_PROFILE it counts clock64 cycles per phase
// (multiposenet_tpu_torch/tools/decode_phases.py).

#ifdef DECODE_PEAKS_PROFILE
#define DECODE_ROWS_PROFILE
#endif
#include "decode_rows.cuh"

namespace {

template <typename T>
int dispatch(const void* maps_v, long long batch_stride, int batches,
             int maps_per_batch, int H, int W, int p, const Params& prm,
             float* scores, float* ys, float* xs, cudaStream_t stream) {
  const T* maps = static_cast<const T*>(maps_v);
  const int n_maps = batches * maps_per_batch;
  const long long hw = static_cast<long long>(H) * W;
  // The fast() path: 128x128 maps, 7 taps, 8 peaks, rows 16-byte aligned
  // for cp.async.
  const bool aligned =
      reinterpret_cast<uintptr_t>(maps) % 16 == 0 &&
      (batches == 1 || (batch_stride * sizeof(T)) % 16 == 0);
  if (H == 128 && W == 128 && prm.ntaps == 7 && p == 8 && aligned) {
    return launch_rows<T, 8, 4, 7, 128, 128, true>(
        maps, batch_stride, hw, W, 1, n_maps, maps_per_batch, H, W, p, prm,
        scores, ys, xs, stream);
  }
  return launch_rows<T, MAX_PEAKS, kGenericCols, 0, 0, 0, false>(
      maps, batch_stride, hw, W, 1, n_maps, maps_per_batch, H, W, p, prm,
      scores, ys, xs, stream);
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
  const Params prm = make_params(taps, ntaps, shift);
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
  return read_phase_cycles(host, reset);
}
#endif

}  // extern "C"
