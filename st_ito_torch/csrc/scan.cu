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
// operations in the same order; built with -fmad=false, K11 matches its
// plain version bitwise, and so does the first chunk of K6, K7 and K8.
//
// Bound: bytes. K6 at the CLI's headline (1024 lanes x 262144 samples)
// writes 1.07 GB and reads the 2 MB shared input (0.32 ms at the H100 SXM's
// 3.35 TB/s; 0.64 ms with a per-candidate input); its 58 float32 operations
// per sample take 0.23 ms at 67 TFLOP/s. K7 at the compressor-led chain's
// 1024 lanes x 262144 reads and writes 1.07 GB each (0.64 ms). K8 at the
// style chain's 512 lanes reads 0.54 GB and writes 0.54 GB (0.32 ms). K11
// at 1024 lanes reads two sequences and writes one, 3.22 GB (0.96 ms).
// K11 is latency-bound instead: one thread carries one lane over all of T
// with its state in registers, so 1024 lanes are 1024 threads in flight.
// K6, K7 and K8 run as chunked scans (each (32-lane block, chunk of Lc
// samples) pair a warp, so that 256 or 512 chunks fill the card, and
// serial carries per lane between the chunks), whose carries round
// differently from the serial chain after the first chunk. K6 is
// scan_core.cuh run_chunked_linear: pass A (the cascade from rest over
// each chunk), one carry of the 2S-value state through Phi = A^Lc, formed
// and applied in double, and pass D (the cascade from the carried state,
// then the bypass blend); it reads its input twice and writes once. K7
// and K8 are run_chunked_detector: three passes, two carries; they read
// their input three times and write once. The carry tables are the
// caller's: 2S floats per chunk and lane for K6, 4 for K7 and K8.
//
// C entry points, each returning cudaGetLastError():
//   biquad_cascade_launch(...), compressor_fused_launch(...),
//   ballistics_launch(...), linear_recurrence_launch(...).

#include <cuda_runtime.h>

#include "scan_core.cuh"

namespace {

using scancore::kTile;

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

// K6 takes a carry table of ceil(T / chunk_len) * 2S * lanes floats;
// chunk_len a positive multiple of 32. stage < 0 runs the whole scan, and
// 0 to 2 only that stage of it (a tool times them apart).
extern "C" int biquad_cascade_launch(const float* x, int shared_channels,
                                     const float* vec, float* out,
                                     float* table, int lanes, long long T,
                                     int num_sections, int with_active,
                                     long long chunk_len, int stage,
                                     void* stream) {
  // The basic parametric EQ, the only EQ any chain plans into this kernel,
  // has 6 sections; other counts are instantiated when a chain needs them.
  if (shared_channels < 0 || num_sections != 6 ||
      !scancore::chunked_args_ok(lanes, T, chunk_len))
    return cudaErrorInvalidValue;
  return scancore::run_chunked_linear<scancore::BiquadCascade<6>,
                                      scancore::BiquadCascade<6, double>>(
      x, shared_channels, vec, out, table, lanes, T, chunk_len, with_active,
      stage, static_cast<cudaStream_t>(stream));
}

// K8 and K7 take a carry table of ceil(T / chunk_len) * 4 * lanes floats;
// chunk_len a positive multiple of 32. stage < 0 runs the whole scan, and
// 0 to 4 only that stage of it (a tool times them apart).
extern "C" int ballistics_launch(const float* c, const float* vec, float* out,
                                 float* table, int lanes, long long T,
                                 long long chunk_len, int stage,
                                 void* stream) {
  if (!scancore::chunked_args_ok(lanes, T, chunk_len))
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
  if (!scancore::chunked_args_ok(lanes, T, chunk_len))
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
