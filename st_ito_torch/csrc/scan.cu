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
// operations in the same order; built with -fmad=false, the first chunk of
// each of the four matches its plain version bitwise.
//
// Bound: bytes. K6 at the CLI's headline (1024 lanes x 262144 samples)
// writes 1.07 GB and reads the 2 MB shared input (0.32 ms at the H100 SXM's
// 3.35 TB/s; 0.64 ms with a per-candidate input); its 58 float32 operations
// per sample take 0.23 ms at 67 TFLOP/s. K7 at the compressor-led chain's
// 1024 lanes x 262144 reads and writes 1.07 GB each (0.64 ms). K8 at the
// style chain's 512 lanes reads 0.54 GB and writes 0.54 GB (0.32 ms). K11
// at the fx chain's 1024 lanes reads two sequences and writes one, 3.22 GB
// (0.96 ms).
// All four run as chunked scans: each (32-lane block, chunk of Lc samples)
// pair a warp, so that 256 or 512 chunks fill the card, and serial carries
// per lane between the chunks, which round differently from the serial
// chain after the first chunk. K6 is scan_core.cuh run_chunked_linear:
// pass A (the cascade from rest over each chunk), one carry of the
// 2S-value state through Phi = A^Lc, formed and applied in double, and
// pass D (the cascade from the carried state, then the bypass blend); it
// reads its input twice and writes once. K7 and K8 are
// run_chunked_detector: three passes, two carries; they read their input
// three times and write once. K11 is run_chunked_recurrence below: pass A,
// one carry through each chunk's own product of coefficients, in double,
// and pass D; it reads both inputs twice and writes once (5.37 GB at its
// headline, 1.6 ms). The carry tables are the caller's: 2S floats per
// chunk and lane for K6, 4 for K7 and K8, 2 for K11.
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

// ------------------------------------------------ K11, the chunked scan
//
// y = a*y + b from y = 0 (scancore::LinearRecurrence) in the shape of
// run_chunked_linear, whose transition varies in time: over chunk k it is
// y -> P_k y + z_k, with P_k the product of the chunk's a and z_k its end
// value from rest. Every (32-lane block, chunk) pair of a pass is a warp
// of its own (grid (chunks, lane blocks)). The three stages, in order:
//   A. chunk k < n-1 from rest: z_k in float, in the step's own order, and
//      P_k formed in double, one product a sample (as pow_n forms K7's and
//      K8's chunk powers: float products drift by up to Lc/2 ulp), rounded
//      once to float;
//   1. y_{k+1} = P_k y_k + z_k in double, one thread a lane, serially over
//      the chunks (recurrence_carry), each chunk's starting value stored
//      rounded to float;
//   D. every chunk from y_k with the whole step, the only pass that
//      writes.
// P_k is kept as one float: its rounding moves the term P_k y_k by half an
// ulp of that term, no more than the rounding of the starting value to
// float does, so a second (lo) float would buy nothing the rules can see
// and double the table. Chunk 0 starts from 0, as the serial chain does,
// and matches it bitwise.

// The carry table: kRows floats per chunk and lane, at
// table[(k * kRows + row) * lanes + lane].
struct RecurrenceTable {
  static constexpr int kY = 0;  // z_k, then y at the chunk's start
  static constexpr int kP = 1;  // P_k
  static constexpr int kRows = 2;

  __device__ static long long at(int k, int row, int lanes, int lane) {
    return ((long long)k * kRows + row) * lanes + lane;
  }
};

// pass A's step: the recurrence from rest and the product of the a
struct RecurrenceFromRest {
  scancore::LinearRecurrence r;
  double p = 1.0;

  __device__ __forceinline__ float step(float a, float b) {
    p = p * (double)a;
    r.step(a, b);
    return 0.0f;
  }
};

__global__ void __launch_bounds__(kTile) recurrence_rest_pass(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ table, int lanes, long long T, long long Lc) {
  const scancore::ChunkSpan sp(lanes, T, Lc);
  RecurrenceFromRest op;
  const float* const xs[2] = {a, b};
  sp.walk_n<false>(op, xs, 0, nullptr, lanes, T);
  if (sp.stores(lanes)) {
    float* p = table + RecurrenceTable::at(sp.k, RecurrenceTable::kY, lanes,
                                           sp.li);
    p[0] = op.r.y;
    p[(RecurrenceTable::kP - RecurrenceTable::kY) * lanes] = (float)op.p;
  }
}

// The carry, one thread a lane: row kY of chunk k < n-1 holds z_k on
// entry, and every chunk's row kY holds y_k on exit (y_0 = 0,
// y_{k+1} = P_k y_k + z_k in double), rounded to float.
__global__ void __launch_bounds__(kTile) recurrence_carry(
    float* __restrict__ table, int lanes, int nchunks) {
  const int ln = blockIdx.x * kTile + (int)threadIdx.x;
  if (ln >= lanes) return;
  using Tb = RecurrenceTable;
  double y = 0.0;
  constexpr int kBatch = 8;
  for (int k0 = 0; k0 < nchunks; k0 += kBatch) {
    float z[kBatch], p[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool in = k0 + u < nchunks - 1;
      z[u] = in ? table[Tb::at(k0 + u, Tb::kY, lanes, ln)] : 0.0f;
      p[u] = in ? table[Tb::at(k0 + u, Tb::kP, lanes, ln)] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u;
      if (k >= nchunks) break;
      table[Tb::at(k, Tb::kY, lanes, ln)] = (float)y;
      y = (double)p[u] * y + (double)z[u];
    }
  }
}

__global__ void __launch_bounds__(kTile) recurrence_out_pass(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ table, float* __restrict__ out, int lanes,
    long long T, long long Lc) {
  const scancore::ChunkSpan sp(lanes, T, Lc);
  scancore::LinearRecurrence op;
  op.y = table[RecurrenceTable::at(sp.k, RecurrenceTable::kY, lanes, sp.li)];
  const float* const xs[2] = {a, b};
  sp.walk_n<true>(op, xs, 0, out, lanes, T);
}

// Launch the three stages in order on the stream, or only stage `stage`
// (0 A, 1 the carry, 2 D) when it is not negative, so that a tool can time
// them apart. table: nchunks x kRows x lanes floats.
int run_chunked_recurrence(const float* a, const float* b, float* out,
                           float* table, int lanes, long long T, long long Lc,
                           int stage, cudaStream_t stream) {
  const int nchunks = (int)((T + Lc - 1) / Lc);
  const int lane_blocks = scancore::blocks_for(lanes);
  const bool all = stage < 0;
  if ((all || stage == 0) && nchunks > 1)
    recurrence_rest_pass<<<dim3(nchunks - 1, lane_blocks), kTile, 0,
                           stream>>>(a, b, table, lanes, T, Lc);
  if (all || stage == 1)
    recurrence_carry<<<lane_blocks, kTile, 0, stream>>>(table, lanes,
                                                        nchunks);
  if (all || stage == 2)
    recurrence_out_pass<<<dim3(nchunks, lane_blocks), kTile, 0, stream>>>(
        a, b, table, out, lanes, T, Lc);
  return static_cast<int>(cudaGetLastError());
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

// K11 takes a carry table of ceil(T / chunk_len) * 2 * lanes floats;
// chunk_len a positive multiple of 32. stage < 0 runs the whole scan, and
// 0 to 2 only that stage of it (a tool times them apart).
extern "C" int linear_recurrence_launch(const float* a, const float* b,
                                        float* out, float* table, int lanes,
                                        long long T, long long chunk_len,
                                        int stage, void* stream) {
  if (!scancore::chunked_args_ok(lanes, T, chunk_len))
    return cudaErrorInvalidValue;
  return run_chunked_recurrence(a, b, out, table, lanes, T, chunk_len, stage,
                                static_cast<cudaStream_t>(stream));
}
