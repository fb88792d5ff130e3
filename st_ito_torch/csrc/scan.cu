// K6, K7, K8 and K11 on Hopper: the lone biquad-cascade EQ, the whole
// unlinked compressor, the lone compressor ballistics and the linear
// recurrence, first-order recurrences along time.
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
// operations in the same order; built with -fmad=false, K6 and K11 match
// them bitwise, and so does the first chunk of K7 and K8.
//
// Bound: bytes. K6 at the CLI's headline (1024 lanes x 262144 samples)
// writes 1.07 GB and reads the 2 MB shared input (0.32 ms at the H100 SXM's
// 3.35 TB/s; 0.64 ms with a per-candidate input); its 58 float32 operations
// per sample take 0.23 ms at 67 TFLOP/s. K7 at the compressor-led chain's
// 1024 lanes x 262144 reads and writes 1.07 GB each (0.64 ms). K8 at the
// style chain's 512 lanes reads 0.54 GB and writes 0.54 GB (0.32 ms). K11
// at 1024 lanes reads two sequences and writes one, 3.22 GB (0.96 ms).
// K6 and K11 are latency-bound instead: one thread carries one lane over
// all of T with its state in registers, so the headline has 1024 threads
// in flight. K7 and K8 run as chunked scans (scan_core.cuh
// run_chunked_detector: three passes over chunks of Lc samples, each
// (32-lane block, chunk) pair a warp, and two serial carries per lane), so
// that 256 or 512 chunks fill the card; they read their input three times
// and write once, and their carries round differently from the serial
// chain after the first chunk. The carry table is the caller's: 4 floats
// per chunk and lane.
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

// K8's detector policy (scan_core.cuh run_chunked_detector): vec rows,
// each (lanes,): aa, ar; the input is c itself and the output g.
struct BallisticsDetector {
  float aa, ar;

  __device__ __forceinline__ BallisticsDetector(const float* __restrict__ vec,
                                                long long L, int li, int)
      : aa(vec[li]), ar(vec[L + li]) {}

  __device__ __forceinline__ float front(float c) const { return c; }
  __device__ __forceinline__ float tail(float, float g) const { return g; }
};

// K7's: vec rows, each (lanes,): th, slope, knee, aa, ar, mk, then act when
// flags (with_active); the front is the gain computer, the tail the gain
// and the bypass blend, in Compressor::step's order.
struct CompressorDetector {
  scancore::Compressor comp;
  float aa, ar, act;
  int with_active;

  __device__ __forceinline__ CompressorDetector(const float* __restrict__ vec,
                                                long long L, int li,
                                                int with_active_)
      : comp(vec, L, li, 0),
        aa(comp.det.aa),
        ar(comp.det.ar),
        act(with_active_ ? vec[6 * L + li] : 1.0f),
        with_active(with_active_) {}

  __device__ __forceinline__ float front(float x) const {
    return comp.computer(x);
  }

  __device__ __forceinline__ float tail(float x, float g) const {
    const float y = x * expf(g * scancore::kLn10Over20) * comp.mk;
    return with_active ? act * y + (1.0f - act) * x : y;
  }
};

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

// K8 and K7 take a carry table of ceil(T / chunk_len) * 4 * lanes floats;
// chunk_len a positive multiple of 32. stage < 0 runs the whole scan, and
// 0 to 4 only that stage of it (a tool times them apart).
extern "C" int ballistics_launch(const float* c, const float* vec, float* out,
                                 float* table, int lanes, long long T,
                                 long long chunk_len, int stage,
                                 void* stream) {
  if (!scancore::chunked_detector_args_ok(lanes, T, chunk_len))
    return cudaErrorInvalidValue;
  return scancore::run_chunked_detector<BallisticsDetector>(
      c, vec, out, table, lanes, T, chunk_len, 0, stage,
      static_cast<cudaStream_t>(stream));
}

extern "C" int compressor_fused_launch(const float* x, const float* vec,
                                       float* out, float* table, int lanes,
                                       long long T, int with_active,
                                       long long chunk_len, int stage,
                                       void* stream) {
  if (!scancore::chunked_detector_args_ok(lanes, T, chunk_len))
    return cudaErrorInvalidValue;
  return scancore::run_chunked_detector<CompressorDetector>(
      x, vec, out, table, lanes, T, chunk_len, with_active, stage,
      static_cast<cudaStream_t>(stream));
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
