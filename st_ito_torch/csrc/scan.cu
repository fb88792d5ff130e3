// K6 and K8 on Hopper: the lone biquad-cascade EQ and the lone compressor
// ballistics, serial first-order recurrences along time.
//
// K6 replaces st_ito_tpu/ops/pallas/scan.py:133 biquad_cascade_pallas
// (kernel _make_biquad_cascade_kernel, scan.py:84): S TDF-II sections in
// series per lane, then, with a bypass mask, act*v + (1-act)*x.
// K8 replaces scan.py:810 ballistics_pallas (kernel _ballistics_kernel,
// scan.py:61): the decoupled detector on the gain computer's output.
// The recurrences and the tile loop are scan_core.cuh's, which K1
// (eqcomp.cu) runs too. The plain PyTorch versions
// (st_ito_torch/ops/kernels/scan.py) do the same operations in the same
// order; built with -fmad=false the kernels match them bitwise.
//
// Bound: bytes. K6 at the CLI's headline (1024 lanes x 262144 samples)
// writes 1.07 GB and reads the 2 MB shared input (0.32 ms at the H100 SXM's
// 3.35 TB/s; 0.64 ms with a per-candidate input); its 58 float32 operations
// per sample take 0.23 ms at 67 TFLOP/s. K8 at the style chain's 512 lanes
// reads 0.54 GB and writes 0.54 GB (0.32 ms). Like K1, both are
// latency-bound instead: one thread carries one lane over all of T with its
// state in registers, so the headline has 1024 or 512 threads in flight.
// The chunked parallel scan (the cascade is linear, the ballistics
// min-affine) is queued in ROADMAP.md beside K1's.
//
// C entry points, each returning cudaGetLastError():
//   biquad_cascade_launch(...), ballistics_launch(...).

#include <cuda_runtime.h>

#include "scan_core.cuh"

namespace {

using scancore::kTile;

template <int S>
__global__ void __launch_bounds__(kTile) biquad_cascade_kernel(
    const float* __restrict__ x, int shared_channels,
    const float* __restrict__ vec, float* __restrict__ out, int lanes,
    long long T, int with_active) {
  const int lane0 = blockIdx.x * kTile;
  scancore::BiquadCascade<S> op(vec, lanes,
                                scancore::lane_index(lanes, lane0),
                                with_active);
  scancore::run_tiles(op, x, shared_channels, out, lanes, T, lane0);
}

// vec rows, each (lanes,): aa, ar.
__global__ void __launch_bounds__(kTile) ballistics_kernel(
    const float* __restrict__ c, const float* __restrict__ vec,
    float* __restrict__ out, int lanes, long long T) {
  const int lane0 = blockIdx.x * kTile;
  const int li = scancore::lane_index(lanes, lane0);
  scancore::Ballistics op(vec[li], vec[lanes + li]);
  scancore::run_tiles(op, c, 0, out, lanes, T, lane0);
}

}  // namespace

extern "C" int biquad_cascade_launch(const float* x, int shared_channels,
                                     const float* vec, float* out, int lanes,
                                     long long T, int num_sections,
                                     int with_active, void* stream) {
  // The basic parametric EQ, the only EQ any chain plans into this kernel,
  // has 6 sections; other counts are instantiated when a chain needs them.
  if (lanes <= 0 || T <= 0 || shared_channels < 0 || num_sections != 6)
    return cudaErrorInvalidValue;
  biquad_cascade_kernel<6><<<scancore::blocks_for(lanes), kTile, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x, shared_channels, vec, out, lanes, T, with_active);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ballistics_launch(const float* c, const float* vec, float* out,
                                 int lanes, long long T, void* stream) {
  if (lanes <= 0 || T <= 0) return cudaErrorInvalidValue;
  ballistics_kernel<<<scancore::blocks_for(lanes), kTile, 0,
                      static_cast<cudaStream_t>(stream)>>>(c, vec, out, lanes,
                                                           T);
  return static_cast<int>(cudaGetLastError());
}
