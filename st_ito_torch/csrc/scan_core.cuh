// The serial scans along time shared by K1 (eqcomp.cu), K6, K7, K8 and K11
// (scan.cu): one copy of each recurrence and of the tile loop that drives
// them, so that the kernels agree op for op with their plain versions.
//
// Layout: one warp per block, 32 lanes per block; the warp walks T in
// 32-sample tiles staged through shared memory, so that every row is loaded
// and stored as one 128-byte segment. The next tile's loads are issued into
// registers before the current tile is computed, so their latency overlaps
// the serial work. Threads past the last lane compute lane 0's values and
// store nothing. A population-shared (C, T) input is read in place: lane
// b*C + c loads its row from x[c], which stays in L2, so the (B, C, T)
// broadcast is never written. State carries across the whole of T in one
// launch, at any length.
//
// An Op holds one lane's coefficients and state in registers and maps one
// input sample (or, with two input sequences, one pair) to one output
// sample with step().

#pragma once

#include <cuda_runtime.h>

namespace scancore {

constexpr int kTile = 32;

// The S-section TDF-II cascade of st_ito_tpu/ops/pallas/scan.py:109-123,
// per sample y = b0*v + s1; s1' = b1*v - a1*y + s2; s2' = b2*v - a2*y;
// v = y, then with a bypass mask act*v + (1-act)*x.
// vec rows, each (lanes,): 5 per section (b0, b1, b2, a1, a2), then act
// when with_active.
template <int S>
struct BiquadCascade {
  float b0[S], b1[S], b2[S], a1[S], a2[S], s1[S], s2[S];
  float act;
  int with_active;

  __device__ __forceinline__ BiquadCascade(const float* __restrict__ vec,
                                           long long L, int li,
                                           int with_active_)
      : with_active(with_active_) {
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
    act = with_active ? vec[5 * S * L + li] : 1.0f;
  }

  __device__ __forceinline__ float step(float xin) {
    float v = xin;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float y = b0[s] * v + s1[s];
      s1[s] = b1[s] * v - a1[s] * y + s2[s];
      s2[s] = b2[s] * v - a2[s] * y;
      v = y;
    }
    if (with_active) v = act * v + (1.0f - act) * xin;
    return v;
  }
};

// The decoupled detector of scan.py:71-77 on the gain computer's output c
// (dB): y1 = min(c, ar*y1 + (1-ar)*c); g = aa*g + (1-aa)*y1, from 0.
struct Ballistics {
  float aa, ar, y1, g;

  __device__ __forceinline__ Ballistics(float aa_, float ar_)
      : aa(aa_), ar(ar_), y1(0.0f), g(0.0f) {}

  __device__ __forceinline__ float step(float c) {
    y1 = fminf(c, ar * y1 + (1.0f - ar) * c);
    g = aa * g + (1.0f - aa) * y1;
    return g;
  }
};

constexpr float kDbPerLog = (float)(20.0 / 2.302585092994046);      // 20/ln10
constexpr float kLn10Over20 = (float)(2.302585092994046 / 20.0);

// The unlinked feed-forward compressor of scan.py:400-431 (K7) and
// scan.py:238-265 (inside K1), per sample: the soft-knee gain computer on
// log(max(|v|, 1e-8)) * 20/ln10, the decoupled ballistics, then
// v * exp(g*ln10/20) * makeup. The bypass blend is the caller's.
// vec rows from row0, each (lanes,): th, slope = 1/ratio - 1,
// knee = max(knee_db, 1e-3), aa, ar, mk (linear makeup).
struct Compressor {
  float th, slope, knee, mk;
  Ballistics det;

  __device__ __forceinline__ Compressor(const float* __restrict__ vec,
                                        long long L, int li, int row0)
      : th(vec[row0 * L + li]),
        slope(vec[(row0 + 1) * L + li]),
        knee(vec[(row0 + 2) * L + li]),
        mk(vec[(row0 + 5) * L + li]),
        det(vec[(row0 + 3) * L + li], vec[(row0 + 4) * L + li]) {}

  __device__ __forceinline__ float step(float v) {
    const float env_db = logf(fmaxf(fabsf(v), 1e-8f)) * kDbPerLog;
    const float over = env_db - th;
    const float h = over + knee / 2.0f;
    const float knee_region = slope * (h * h) / (2.0f * knee);
    const float c = (2.0f * over < -knee)
                        ? 0.0f
                        : ((2.0f * over > knee) ? slope * over : knee_region);
    const float g = det.step(c);
    return v * expf(g * kLn10Over20) * mk;
  }
};

// y = a*y + b from y = 0 (K11, scan.py:478): two input sequences.
struct LinearRecurrence {
  float y = 0.0f;

  __device__ __forceinline__ float step(float a, float b) {
    y = a * y + b;
    return y;
  }
};

// The lane thread threadIdx.x computes in the block at lane0: its own, or
// lane 0 past the last lane.
__device__ __forceinline__ int lane_index(int lanes, int lane0) {
  const int ln = lane0 + (int)threadIdx.x;
  return ln < lanes ? ln : 0;
}

inline int blocks_for(int lanes) { return (lanes + kTile - 1) / kTile; }

// Thread l's column of the tile at t0: next[r] = x[lane0 + r][t0 + l], 0
// past the last lane or the end of T.
__device__ __forceinline__ void load_tile(float (&next)[kTile],
                                          const float* __restrict__ x,
                                          int shared_channels, int lanes,
                                          long long T, int lane0,
                                          long long t0) {
  const int l = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    const int ln = lane0 + r;
    const long long row = shared_channels > 0 ? ln % shared_channels : ln;
    next[r] = (ln < lanes && t0 + l < T) ? x[row * T + t0 + l] : 0.0f;
  }
}

// One warp walks its 32 lanes over all of T. Row r of a tile is lane
// lane0 + r; thread l loads and stores column l of every row (coalesced)
// and computes row l (its own lane) from the shared tiles, one per input
// sequence (NIn = 1: op.step(x); NIn = 2: op.step(a, b)). Only a single
// input may be the shared (C, T) one.
template <int NIn, class Op>
__device__ __forceinline__ void run_tiles_n(Op& op,
                                            const float* const (&x)[NIn],
                                            int shared_channels,
                                            float* __restrict__ out,
                                            int lanes, long long T,
                                            int lane0) {
  static_assert(NIn == 1 || NIn == 2, "one or two input sequences");
  __shared__ float tile[NIn][kTile][kTile + 1];
  const int l = threadIdx.x;
  float next[NIn][kTile];

#pragma unroll
  for (int i = 0; i < NIn; ++i) {
    load_tile(next[i], x[i], shared_channels, lanes, T, lane0, 0);
  }
  for (long long t0 = 0; t0 < T; t0 += kTile) {
    const int n = (int)((T - t0) < kTile ? (T - t0) : kTile);
#pragma unroll
    for (int i = 0; i < NIn; ++i) {
#pragma unroll
      for (int r = 0; r < kTile; ++r) tile[i][r][l] = next[i][r];
    }
    __syncwarp();
    if (t0 + kTile < T) {  // in flight during the steps below
#pragma unroll
      for (int i = 0; i < NIn; ++i)
        load_tile(next[i], x[i], shared_channels, lanes, T, lane0,
                  t0 + kTile);
    }
    for (int j = 0; j < n; ++j) {
      if constexpr (NIn == 1)
        tile[0][l][j] = op.step(tile[0][l][j]);
      else
        tile[0][l][j] = op.step(tile[0][l][j], tile[1][l][j]);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      const int ln = lane0 + r;
      if (ln < lanes && l < n) out[(long long)ln * T + t0 + l] = tile[0][r][l];
    }
    __syncwarp();
  }
}

template <class Op>
__device__ __forceinline__ void run_tiles(Op& op, const float* __restrict__ x,
                                          int shared_channels,
                                          float* __restrict__ out, int lanes,
                                          long long T, int lane0) {
  const float* const xs[1] = {x};
  run_tiles_n<1>(op, xs, shared_channels, out, lanes, T, lane0);
}

}  // namespace scancore
