// K1 on Hopper: the fused EQ -> compressor -> distortion scan, as a chunked
// scan over time.
//
// Replaces st_ito_tpu/ops/pallas/scan.py:279 eq_compressor_fused_pallas
// (kernel _make_eq_comp_kernel, scan.py:172). Per lane (one candidate x one
// channel) and per sample, in the order of scan.py:216-274:
//   - an S-section TDF-II biquad cascade, then the EQ bypass blend;
//   - the soft-knee gain computer on log(max(|v|, 1e-8)) * 20/ln10;
//   - the decoupled ballistics y1 = min(c, ar*y1 + (1-ar)*c),
//     g = aa*g + (1-aa)*y1;
//   - v * exp(g*ln10/20) * makeup, the compressor blend, then (optionally)
//     tanh(y*drive)*outg and the distortion blend.
// The cascade, the compressor and the tile loop are scan_core.cuh's, which
// K6, K7 and K8 (scan.cu) run too. The plain PyTorch version
// (st_ito_torch/ops/kernels/eqcomp.py) runs the same steps serially.
//
// Bound: the (lanes, T) float32 output write, 1.07 GB at the headline 1024
// lanes x 262144 samples, about 0.32 ms at the H100 SXM's 3.35 TB/s, or
// the 94 float32 operations a sample, 0.38 ms at 67 TFLOP/s; the shared
// (C, T) input is 2 MB and stays in L2. Walked serially, one thread a lane,
// the headline had 1024 threads in flight, each waiting on its own chain.
// Here T is cut into chunks of Lc samples (a multiple of the 32-sample
// tile), and every (32-lane block, chunk) pair is a warp of its own, from
// the state the chunk starts in; 1024 lanes x 256 chunks fill every SM.
// The state passes between chunks exactly in real arithmetic, in four
// passes over the chunks and three serial carries per lane over the chunk
// count:
//   A. the cascade from rest over chunk k < n-1; its end state f_k;
//   1. s_{k+1} = Phi s_k + f_k, Phi = A^Lc the cascade's transition over
//      one chunk (linear_chunk_carry);
//   B. the cascade from s_k, the bypass blend and the gain computer; the
//      release steps composed into one min-affine map (MinAffine);
//   2. y1 at each chunk's start (minaffine_chunk_carry);
//   C. the cascade, the gain computer and y1 from its carry, and g from 0:
//      the chunk's end value gz_k;
//   3. g_{k+1} = aa^Lc g_k + gz_k (onepole_chunk_carry);
//   D. the whole step from (s_k, y1_k, g_k), every blend and the
//      distortion; the only pass that writes the output.
// Pass A and carry 1 are the kernels of K6's chunked linear scan
// (scan_core.cuh linear_state_pass, linear_state_carry), here on the first
// 2S rows of a wider table and with the carry in float. The passes
// recompute the cascade instead of storing v and c (2 GB each way at the
// headline). The carries round differently from the serial
// chain, so the kernel is no longer bitwise equal to its plain version; the
// first chunk is. The carry table holds 2S + 4 rows per chunk and lane:
// the cascade state, then the MinAffine (k, b, m) whose first row becomes
// y1, then g.
//
// C entry point: eqcomp_launch(...) returns cudaGetLastError() after the
// last launch, or cudaErrorInvalidValue for arguments it does not take.

#include <cuda_runtime.h>

#include "scan_core.cuh"

namespace {

using scancore::kTile;

template <int S>
struct Table {
  // rows 0 .. 2S-1: the cascade state (BiquadCascade<S>::kStateRows)
  static constexpr int kY1 = 2 * S;  // MinAffine k, then y1 at the start
  static constexpr int kG = 2 * S + 3;
  static constexpr int kRows = 2 * S + 4;

  // the offset of chunk k's row for one lane
  __device__ static long long at(int k, int row, int lanes, int lane) {
    return ((long long)k * kRows + row) * lanes + lane;
  }
};

// vec rows, each (lanes,): 5 per section (b0, b1, b2, a1, a2), then
// eq_act, th, slope, knee, aa, ar, mk, comp_act, drive, outg, dist_act.
template <int S>
struct EqComp {
  scancore::BiquadCascade<S> eq;  // reads eq_act, row 5*S, as its mask
  scancore::Compressor comp;      // rows 5*S + 1 .. 5*S + 6, as K7's
  float comp_act, drive, outg, dist_act;
  int with_dist;

  __device__ __forceinline__ EqComp(const float* __restrict__ vec,
                                    long long L, int li, int with_dist_)
      : eq(vec, L, li, 1),
        comp(vec, L, li, 5 * S + 1),
        comp_act(vec[(5 * S + 7) * L + li]),
        drive(vec[(5 * S + 8) * L + li]),
        outg(vec[(5 * S + 9) * L + li]),
        dist_act(vec[(5 * S + 10) * L + li]),
        with_dist(with_dist_) {}

  __device__ __forceinline__ float step(float xin) {
    const float v = eq.step(xin);
    float y = comp.step(v);
    y = comp_act * y + (1.0f - comp_act) * v;
    if (with_dist) {
      const float yd = tanhf(y * drive) * outg;
      y = dist_act * yd + (1.0f - dist_act) * y;
    }
    return y;
  }
};

// pass B's step: the release steps composed over the chunk
template <int S>
struct ReleaseMap {
  scancore::BiquadCascade<S> eq;
  scancore::Compressor comp;
  scancore::MinAffine f;

  __device__ __forceinline__ float step(float xin) {
    f.then(comp.det.ar, comp.computer(eq.step(xin)));
    return 0.0f;
  }
};

// pass C's step: the detector without the gain
template <int S>
struct Detector {
  scancore::BiquadCascade<S> eq;
  scancore::Compressor comp;

  __device__ __forceinline__ float step(float xin) {
    comp.det.step(comp.computer(eq.step(xin)));
    return 0.0f;
  }
};

template <int S>
__global__ void __launch_bounds__(kTile) pass_b_kernel(
    const float* __restrict__ x, int shared_channels,
    const float* __restrict__ vec, float* __restrict__ table, int lanes,
    long long T, long long Lc) {
  const scancore::ChunkSpan sp(lanes, T, Lc);
  ReleaseMap<S> op{scancore::BiquadCascade<S>(vec, lanes, sp.li, 1),
                   scancore::Compressor(vec, lanes, sp.li, 5 * S + 1), {}};
  op.eq.load_state(table + Table<S>::at(sp.k, 0, lanes, sp.li), lanes);
  sp.walk<false>(op, x, shared_channels, nullptr, lanes, T);
  if (sp.stores(lanes)) {
    float* p = table + Table<S>::at(sp.k, Table<S>::kY1, lanes, sp.li);
    p[0] = op.f.k;
    p[lanes] = op.f.b;
    p[2 * lanes] = op.f.m;
  }
}

template <int S>
__global__ void __launch_bounds__(kTile) pass_c_kernel(
    const float* __restrict__ x, int shared_channels,
    const float* __restrict__ vec, float* __restrict__ table, int lanes,
    long long T, long long Lc) {
  const scancore::ChunkSpan sp(lanes, T, Lc);
  Detector<S> op{scancore::BiquadCascade<S>(vec, lanes, sp.li, 1),
                 scancore::Compressor(vec, lanes, sp.li, 5 * S + 1)};
  op.eq.load_state(table + Table<S>::at(sp.k, 0, lanes, sp.li), lanes);
  op.comp.det.y1 = table[Table<S>::at(sp.k, Table<S>::kY1, lanes, sp.li)];
  sp.walk<false>(op, x, shared_channels, nullptr, lanes, T);
  if (sp.stores(lanes))
    table[Table<S>::at(sp.k, Table<S>::kG, lanes, sp.li)] = op.comp.det.g;
}

template <int S>
__global__ void __launch_bounds__(kTile) pass_d_kernel(
    const float* __restrict__ x, int shared_channels,
    const float* __restrict__ vec, const float* __restrict__ table,
    float* __restrict__ out, int lanes, long long T, long long Lc,
    int with_dist) {
  const scancore::ChunkSpan sp(lanes, T, Lc);
  EqComp<S> op(vec, lanes, sp.li, with_dist);
  op.eq.load_state(table + Table<S>::at(sp.k, 0, lanes, sp.li), lanes);
  op.comp.det.y1 = table[Table<S>::at(sp.k, Table<S>::kY1, lanes, sp.li)];
  op.comp.det.g = table[Table<S>::at(sp.k, Table<S>::kG, lanes, sp.li)];
  sp.walk<true>(op, x, shared_channels, out, lanes, T);
}

template <int S>
__global__ void __launch_bounds__(kTile) release_carry_kernel(
    float* __restrict__ table, int lanes, int nchunks) {
  scancore::minaffine_chunk_carry(table, Table<S>::kRows, Table<S>::kY1,
                                  lanes, blockIdx.x * kTile, nchunks);
}

template <int S>
__global__ void __launch_bounds__(kTile) attack_carry_kernel(
    const float* __restrict__ vec, float* __restrict__ table, int lanes,
    long long Lc, int nchunks) {
  const int li = scancore::lane_index(lanes, blockIdx.x * kTile);
  scancore::onepole_chunk_carry(table, Table<S>::kRows, Table<S>::kG, lanes,
                                blockIdx.x * kTile, vec[(5 * S + 4) * lanes + li],
                                Lc, nchunks);
}

template <int S>
int run(const float* x, int shared_channels, const float* vec, float* out,
        float* table, int lanes, long long T, long long Lc, int with_dist,
        cudaStream_t stream) {
  const int nchunks = (int)((T + Lc - 1) / Lc);
  const int lane_blocks = scancore::blocks_for(lanes);
  const dim3 spans(nchunks - 1, lane_blocks);
  // pass A and carry 1 are the chunked linear scan's (scan_core.cuh), on
  // the first 2S rows of this table, in float
  using Cascade = scancore::BiquadCascade<S>;
  if (nchunks > 1)
    scancore::linear_state_pass<Cascade><<<spans, kTile, 0, stream>>>(
        x, shared_channels, vec, table, Table<S>::kRows, lanes, T, Lc);
  scancore::linear_state_carry<Cascade>
      <<<lane_blocks, kTile * Cascade::kStateRows, 0, stream>>>(
          vec, table, Table<S>::kRows, lanes, Lc, nchunks);
  if (nchunks > 1)
    pass_b_kernel<S><<<spans, kTile, 0, stream>>>(x, shared_channels, vec,
                                                  table, lanes, T, Lc);
  release_carry_kernel<S><<<lane_blocks, kTile, 0, stream>>>(table, lanes,
                                                             nchunks);
  if (nchunks > 1)
    pass_c_kernel<S><<<spans, kTile, 0, stream>>>(x, shared_channels, vec,
                                                  table, lanes, T, Lc);
  attack_carry_kernel<S><<<lane_blocks, kTile, 0, stream>>>(vec, table, lanes,
                                                            Lc, nchunks);
  pass_d_kernel<S><<<dim3(nchunks, lane_blocks), kTile, 0, stream>>>(
      x, shared_channels, vec, table, out, lanes, T, Lc, with_dist);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: nchunks * (2S + 4) * lanes floats, nchunks = ceil(T / chunk_len);
// chunk_len a positive multiple of 32.
extern "C" int eqcomp_launch(const float* x, int shared_channels,
                             const float* vec, float* out, float* table,
                             int lanes, long long T, int num_sections,
                             int with_dist, long long chunk_len,
                             void* stream) {
  // The basic parametric EQ, the only EQ planned into this head, has 6
  // sections; other counts are instantiated when a chain needs them.
  if (shared_channels < 0 || num_sections != 6 ||
      !scancore::chunked_args_ok(lanes, T, chunk_len))
    return cudaErrorInvalidValue;
  return run<6>(x, shared_channels, vec, out, table, lanes, T, chunk_len,
                with_dist, static_cast<cudaStream_t>(stream));
}
