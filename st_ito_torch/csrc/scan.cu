// K6, K7, K8 and K11 on Hopper: the lone biquad-cascade EQ, the whole
// unlinked compressor, the lone compressor ballistics and the linear
// recurrence, serial first-order recurrences along time.
//
// K6 replaces st_ito_tpu/ops/pallas/scan.py:133 biquad_cascade_pallas
// (kernel _make_biquad_cascade_kernel, scan.py:84): S TDF-II sections in
// series per lane, then, with a bypass mask, act*v + (1-act)*x.
// K7 replaces scan.py:436 compressor_fused_pallas (kernel
// _make_compressor_kernel, scan.py:375): the log-dB envelope, the soft-knee
// gain computer, the decoupled ballistics, x*exp(g*ln10/20)*makeup and,
// with a bypass mask, act*y + (1-act)*x, per lane and sample.
// K8 replaces scan.py:810 ballistics_pallas (kernel _ballistics_kernel,
// scan.py:61): the decoupled detector on the gain computer's output.
// K11 replaces scan.py:836 linear_recurrence_pallas (kernel _linrec_kernel,
// scan.py:478): y[t] = a[t]*y[t-1] + b[t] from y = 0.
// The recurrences and the tile loop are scan_core.cuh's, which K1
// (eqcomp.cu) runs too; K7's compressor is K1's after its cascade. The plain
// PyTorch versions (st_ito_torch/ops/kernels/scan.py) do the same
// operations in the same order; built with -fmad=false the kernels match
// them bitwise.
//
// Bound: bytes. K6 at the CLI's headline (1024 lanes x 262144 samples)
// writes 1.07 GB and reads the 2 MB shared input (0.32 ms at the H100 SXM's
// 3.35 TB/s; 0.64 ms with a per-candidate input); its 58 float32 operations
// per sample take 0.23 ms at 67 TFLOP/s. K7 at the compressor-led chain's
// 1024 lanes x 262144 reads and writes 1.07 GB each (0.64 ms). K8 at the
// style chain's 512 lanes reads 0.54 GB and writes 0.54 GB (0.32 ms). K11
// at 1024 lanes reads two sequences and writes one, 3.22 GB (0.96 ms). Like
// K1, all four are latency-bound instead: one thread carries one lane over
// all of T with its state in registers, so the headline has 1024 or 512
// threads in flight. K1 (eqcomp.cu) now runs as a chunked scan on
// scan_core.cuh's span walk and chunk carries; the same form for these four
// (the cascade and the recurrence are linear, the ballistics min-affine)
// is queued in ROADMAP.md.
//
// C entry points, each returning cudaGetLastError():
//   biquad_cascade_launch(...), compressor_fused_launch(...),
//   ballistics_launch(...), linear_recurrence_launch(...).

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

// vec rows, each (lanes,): th, slope, knee, aa, ar, mk, then act when
// with_active.
struct CompressorFused {
  scancore::Compressor comp;
  float act;
  int with_active;

  __device__ __forceinline__ CompressorFused(const float* __restrict__ vec,
                                             long long L, int li,
                                             int with_active_)
      : comp(vec, L, li, 0),
        act(with_active_ ? vec[6 * L + li] : 1.0f),
        with_active(with_active_) {}

  __device__ __forceinline__ float step(float xin) {
    const float y = comp.step(xin);
    return with_active ? act * y + (1.0f - act) * xin : y;
  }
};

__global__ void __launch_bounds__(kTile) compressor_fused_kernel(
    const float* __restrict__ x, const float* __restrict__ vec,
    float* __restrict__ out, int lanes, long long T, int with_active) {
  const int lane0 = blockIdx.x * kTile;
  CompressorFused op(vec, lanes, scancore::lane_index(lanes, lane0),
                     with_active);
  scancore::run_tiles(op, x, 0, out, lanes, T, lane0);
}

__global__ void __launch_bounds__(kTile) linear_recurrence_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, int lanes, long long T) {
  const int lane0 = blockIdx.x * kTile;
  scancore::LinearRecurrence op;
  const float* const xs[2] = {a, b};
  scancore::run_tiles_n<2>(op, xs, 0, out, lanes, T, lane0);
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

extern "C" int compressor_fused_launch(const float* x, const float* vec,
                                       float* out, int lanes, long long T,
                                       int with_active, void* stream) {
  if (lanes <= 0 || T <= 0) return cudaErrorInvalidValue;
  compressor_fused_kernel<<<scancore::blocks_for(lanes), kTile, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, vec, out, lanes, T, with_active);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int linear_recurrence_launch(const float* a, const float* b,
                                        float* out, int lanes, long long T,
                                        void* stream) {
  if (lanes <= 0 || T <= 0) return cudaErrorInvalidValue;
  linear_recurrence_kernel<<<scancore::blocks_for(lanes), kTile, 0,
                             static_cast<cudaStream_t>(stream)>>>(a, b, out,
                                                                  lanes, T);
  return static_cast<int>(cudaGetLastError());
}
