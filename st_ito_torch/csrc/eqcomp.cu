// K1 on Hopper: the fused EQ -> compressor -> distortion scan.
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
// The cascade, the compressor (gain computer, ballistics and gain) and the
// tile loop are scan_core.cuh's, which K6, K7 and K8 (scan.cu) run too. The
// plain PyTorch version (st_ito_torch/ops/kernels/eqcomp.py) does the same
// operations in the same order.
//
// Bound: the (lanes, T) float32 output write, 1.07 GB at the headline
// 1024 lanes x 262144 samples, about 0.32 ms at the H100 SXM's 3.35 TB/s;
// the shared (C, T) input is 2 MB and stays in L2. This first version is
// latency-bound on the serial recurrence: one thread carries one lane over
// all of T with every state in registers, so the headline shape has only
// 1024 threads (32 warps) in flight. The redesign as a chunked parallel
// scan (the biquad is linear, the ballistics are min-affine) is queued in
// ROADMAP.md.
//
// C entry point: eqcomp_launch(...) returns cudaGetLastError().

#include <cuda_runtime.h>

#include "scan_core.cuh"

namespace {

using scancore::kTile;

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

template <int S>
__global__ void __launch_bounds__(kTile) eqcomp_kernel(
    const float* __restrict__ x, int shared_channels,
    const float* __restrict__ vec, float* __restrict__ out, int lanes,
    long long T, int with_dist) {
  const int lane0 = blockIdx.x * kTile;
  EqComp<S> op(vec, lanes, scancore::lane_index(lanes, lane0), with_dist);
  scancore::run_tiles(op, x, shared_channels, out, lanes, T, lane0);
}

}  // namespace

extern "C" int eqcomp_launch(const float* x, int shared_channels,
                             const float* vec, float* out, int lanes,
                             long long T, int num_sections, int with_dist,
                             void* stream) {
  // The basic parametric EQ, the only EQ planned into this head, has 6
  // sections; other counts are instantiated when a chain needs them.
  if (lanes <= 0 || T <= 0 || shared_channels < 0 || num_sections != 6)
    return cudaErrorInvalidValue;
  eqcomp_kernel<6><<<scancore::blocks_for(lanes), kTile, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x, shared_channels, vec, out, lanes, T, with_dist);
  return static_cast<int>(cudaGetLastError());
}
