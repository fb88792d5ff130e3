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
// The plain PyTorch version (st_ito_torch/ops/kernels/eqcomp.py) does the
// same operations in the same order.
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
// Layout: one warp per block. The warp walks T in 32-sample tiles; the
// input tile (32 lanes x 32 samples) is loaded coalesced into shared
// memory, each thread runs its lane's samples serially, and the output tile
// goes back through the same buffer so that every row is stored as one
// 128-byte segment. A population-shared (C, T) input is never broadcast:
// lane b*C + c loads its tile row from x[c], which stays in L2. State
// carries across the whole of T in one launch, at any length.
//
// C entry point: eqcomp_launch(...) returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr float kDbPerLog = (float)(20.0 / 2.302585092994046);      // 20/ln10
constexpr float kLn10Over20 = (float)(2.302585092994046 / 20.0);

// vec rows, each (lanes,): 5 per section (b0, b1, b2, a1, a2), then
// eq_act, th, slope, knee, aa, ar, mk, comp_act, drive, outg, dist_act.
template <int S>
__global__ void __launch_bounds__(kTile) eqcomp_kernel(
    const float* __restrict__ x, int shared_channels,
    const float* __restrict__ vec, float* __restrict__ out, int lanes,
    long long T, int with_dist) {
  __shared__ float tile[kTile][kTile + 1];
  const int l = threadIdx.x;
  const int lane0 = blockIdx.x * kTile;
  // threads past the last lane compute lane 0's values and store nothing
  const int li = (lane0 + l < lanes) ? lane0 + l : 0;
  const long long L = lanes;

  float b0[S], b1[S], b2[S], a1[S], a2[S], s1[S], s2[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    b0[s] = vec[(5 * s + 0) * L + li];
    b1[s] = vec[(5 * s + 1) * L + li];
    b2[s] = vec[(5 * s + 2) * L + li];
    a1[s] = vec[(5 * s + 3) * L + li];
    a2[s] = vec[(5 * s + 4) * L + li];
    s1[s] = 0.0f;
    s2[s] = 0.0f;
  }
  const float* p = vec + 5 * S * L + li;
  const float eq_act = p[0 * L], th = p[1 * L], slope = p[2 * L];
  const float knee = p[3 * L], aa = p[4 * L], ar = p[5 * L], mk = p[6 * L];
  const float comp_act = p[7 * L], drive = p[8 * L], outg = p[9 * L];
  const float dist_act = p[10 * L];

  float y1 = 0.0f, g = 0.0f;

  for (long long t0 = 0; t0 < T; t0 += kTile) {
    const int n = (int)((T - t0) < kTile ? (T - t0) : kTile);
    for (int r = 0; r < kTile; ++r) {
      const int ln = lane0 + r;
      const long long row = shared_channels > 0 ? ln % shared_channels : ln;
      if (ln < lanes && l < n) tile[r][l] = x[row * T + t0 + l];
    }
    __syncwarp();
    for (int j = 0; j < n; ++j) {
      const float xin = tile[l][j];
      float v = xin;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float y = b0[s] * v + s1[s];
        s1[s] = b1[s] * v - a1[s] * y + s2[s];
        s2[s] = b2[s] * v - a2[s] * y;
        v = y;
      }
      v = eq_act * v + (1.0f - eq_act) * xin;

      const float env_db = logf(fmaxf(fabsf(v), 1e-8f)) * kDbPerLog;
      const float over = env_db - th;
      const float h = over + knee / 2.0f;
      const float knee_region = slope * (h * h) / (2.0f * knee);
      const float c = (2.0f * over < -knee)
                          ? 0.0f
                          : ((2.0f * over > knee) ? slope * over : knee_region);
      y1 = fminf(c, ar * y1 + (1.0f - ar) * c);
      g = aa * g + (1.0f - aa) * y1;

      float y = v * expf(g * kLn10Over20) * mk;
      y = comp_act * y + (1.0f - comp_act) * v;
      if (with_dist) {
        const float yd = tanhf(y * drive) * outg;
        y = dist_act * yd + (1.0f - dist_act) * y;
      }
      tile[l][j] = y;
    }
    __syncwarp();
    for (int r = 0; r < kTile; ++r) {
      const int ln = lane0 + r;
      if (ln < lanes && l < n) out[(long long)ln * T + t0 + l] = tile[r][l];
    }
    __syncwarp();
  }
}

template <int S>
void launch(const float* x, int shared_channels, const float* vec, float* out,
            int lanes, long long T, int with_dist, cudaStream_t stream) {
  const int blocks = (lanes + kTile - 1) / kTile;
  eqcomp_kernel<S><<<blocks, kTile, 0, stream>>>(x, shared_channels, vec, out,
                                                 lanes, T, with_dist);
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
  launch<6>(x, shared_channels, vec, out, lanes, T, with_dist,
            static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
