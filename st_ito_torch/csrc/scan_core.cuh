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
// broadcast is never written. A warp walks one span of samples (a chunk)
// from the state its op holds.
//
// An Op holds one lane's coefficients and state in registers and maps one
// input sample (or, with two input sequences, one pair) to one output
// sample with step().
//
// The chunked scans (K1, eqcomp.cu; K6, K7, K8 and K11, scan.cu) split T
// into chunks of Lc samples, each walked by its own warp with
// run_tiles_span from a given state, and pass the state between chunks
// with small serial carries per lane: linear_chunk_carry (a linear state,
// e.g. the cascade's 2S values, through Phi = A^Lc), minaffine_chunk_carry
// (the release stage of the ballistics, through the chunk's composed
// min-affine map, MinAffine) and onepole_chunk_carry (the attack stage,
// through aa^Lc).
// K6 runs a linear state's passes and carry as written once at the end of
// this file (run_chunked_linear), K7 and K8 the detector's
// (run_chunked_detector), K11 its own passes and carry (scan.cu
// run_chunked_recurrence); K1 runs the linear scan's pass A and
// carry, then passes of its own, with its cascade.

#pragma once

#include <cuda_runtime.h>

namespace scancore {

constexpr int kTile = 32;

// The S-section TDF-II cascade of st_ito_tpu/ops/pallas/scan.py:109-123,
// per sample y = b0*v + s1; s1' = b1*v - a1*y + s2; s2' = b2*v - a2*y;
// v = y, then with a bypass mask act*v + (1-act)*x.
// vec rows, each (lanes,): 5 per section (b0, b1, b2, a1, a2), then act
// when with_active. F is the type of the arithmetic: float in every pass;
// double only where K6's chunk carry forms Phi (linear_chunk_carry).
template <int S, class F = float>
struct BiquadCascade {
  using Value = F;
  // the state as rows of a carry table: row 2s is s1 of section s, row
  // 2s + 1 its s2
  static constexpr int kStateRows = 2 * S;
  F b0[S], b1[S], b2[S], a1[S], a2[S], s1[S], s2[S];
  F act;
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
      s1[s] = F(0);
      s2[s] = F(0);
    }
    act = with_active ? F(vec[5 * S * L + li]) : F(1);
  }

  __device__ __forceinline__ F step(F xin) {
    F v = xin;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const F y = b0[s] * v + s1[s];
      s1[s] = b1[s] * v - a1[s] * y + s2[s];
      s2[s] = b2[s] * v - a2[s] * y;
      v = y;
    }
    if (with_active) v = act * v + (F(1) - act) * xin;
    return v;
  }

  __device__ __forceinline__ void load_state(const float* __restrict__ st,
                                             long long stride) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      s1[s] = st[(2 * s) * stride];
      s2[s] = st[(2 * s + 1) * stride];
    }
  }

  __device__ __forceinline__ void store_state(float* __restrict__ st,
                                              long long stride) const {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      st[(2 * s) * stride] = s1[s];
      st[(2 * s + 1) * stride] = s2[s];
    }
  }

  // the unit state e_i, and state row r
  __device__ __forceinline__ void set_unit_state(int i) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      s1[s] = (2 * s == i) ? F(1) : F(0);
      s2[s] = (2 * s + 1 == i) ? F(1) : F(0);
    }
  }

  __device__ __forceinline__ F state(int r) const {
    F v = F(0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (2 * s == r) v = s1[s];
      if (2 * s + 1 == r) v = s2[s];
    }
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

  // the gain computer: the gain reduction c (dB) for the sample v
  __device__ __forceinline__ float computer(float v) const {
    const float env_db = logf(fmaxf(fabsf(v), 1e-8f)) * kDbPerLog;
    const float over = env_db - th;
    const float h = over + knee / 2.0f;
    const float knee_region = slope * (h * h) / (2.0f * knee);
    return (2.0f * over < -knee)
               ? 0.0f
               : ((2.0f * over > knee) ? slope * over : knee_region);
  }

  __device__ __forceinline__ float step(float v) {
    const float g = det.step(computer(v));
    return v * expf(g * kLn10Over20) * mk;
  }
};

// The release stage's steps y -> min(c, ar*y + (1-ar)*c) composed over a
// span of samples into one map y -> min(m, k*y + b) (st_ito_tpu/ops/
// dynamics.py:55-93): appending a step takes (k, b, m) to
// (ar*k, ar*b + (1-ar)*c, min(c, ar*m + (1-ar)*c)), the b and m updates in
// Ballistics::step's order of operations. Starts as the identity.
struct MinAffine {
  float k = 1.0f, b = 0.0f, m = INFINITY;

  __device__ __forceinline__ void then(float ar, float c) {
    const float bc = (1.0f - ar) * c;
    k = ar * k;
    b = ar * b + bc;
    m = fminf(c, ar * m + bc);
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
// past the last lane or at t_end and after (rows of T samples).
__device__ __forceinline__ void load_tile(float (&next)[kTile],
                                          const float* __restrict__ x,
                                          int shared_channels, int lanes,
                                          long long T, int lane0,
                                          long long t0, long long t_end) {
  const int l = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    const int ln = lane0 + r;
    const long long row = shared_channels > 0 ? ln % shared_channels : ln;
    next[r] = (ln < lanes && t0 + l < t_end) ? x[row * T + t0 + l] : 0.0f;
  }
}

// One warp walks its 32 lanes over the samples [t_begin, t_end) of rows of
// T samples, from the state op holds. Row r of a tile is lane lane0 + r;
// thread l loads and stores column l of every row (coalesced) and computes
// row l (its own lane) from the shared tiles, one per input sequence
// (NIn = 1: op.step(x); NIn = 2: op.step(a, b)). Only a single input may be
// the shared (C, T) one. Without kStore the outputs are dropped and out is
// not read (a pass that only carries state).
template <int NIn, bool kStore, class Op>
__device__ __forceinline__ void run_tiles_span(
    Op& op, const float* const (&x)[NIn], int shared_channels,
    float* __restrict__ out, int lanes, long long T, int lane0,
    long long t_begin, long long t_end) {
  static_assert(NIn == 1 || NIn == 2, "one or two input sequences");
  __shared__ float tile[NIn][kTile][kTile + 1];
  const int l = threadIdx.x;
  float next[NIn][kTile];

#pragma unroll
  for (int i = 0; i < NIn; ++i) {
    load_tile(next[i], x[i], shared_channels, lanes, T, lane0, t_begin,
              t_end);
  }
  for (long long t0 = t_begin; t0 < t_end; t0 += kTile) {
    const int n = (int)((t_end - t0) < kTile ? (t_end - t0) : kTile);
#pragma unroll
    for (int i = 0; i < NIn; ++i) {
#pragma unroll
      for (int r = 0; r < kTile; ++r) tile[i][r][l] = next[i][r];
    }
    __syncwarp();
    if (t0 + kTile < t_end) {  // in flight during the steps below
#pragma unroll
      for (int i = 0; i < NIn; ++i)
        load_tile(next[i], x[i], shared_channels, lanes, T, lane0,
                  t0 + kTile, t_end);
    }
    for (int j = 0; j < n; ++j) {
      float y;
      if constexpr (NIn == 1)
        y = op.step(tile[0][l][j]);
      else
        y = op.step(tile[0][l][j], tile[1][l][j]);
      if constexpr (kStore) tile[0][l][j] = y;
    }
    __syncwarp();
    if constexpr (kStore) {
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const int ln = lane0 + r;
        if (ln < lanes && l < n)
          out[(long long)ln * T + t0 + l] = tile[0][r][l];
      }
      __syncwarp();
    }
  }
}

// x^n rounded once to float: the product formed in double by squaring
// (relative error about 2 log2(n) x 2^-53 before the rounding). Formed by
// n float products instead, as MinAffine::then forms k = ar^Lc and
// onepole_chunk_carry aa^Lc, the power drifts by up to n/2 ulp, which at
// release or attack times of seconds (ar, aa > 0.99999 at 48 kHz) moved
// the chunks' starting state farther from the float64 chain than the
// float32 serial chain lies (the CPU model of the passes, PERF.md). The
// chunked detector takes both powers from here.
__device__ __forceinline__ float pow_n(float x, long long n) {
  double r = 1.0, b = x;
  for (; n > 0; n >>= 1) {
    if (n & 1) r *= b;
    b *= b;
  }
  return (float)r;
}

// ---------------------------------------------------------------- carries
//
// A carry table holds, for chunk k of nchunks and each of its rows, one
// float per lane at table[(k * rows + row) * lanes + lane]. The carries run
// serially over the chunks of each lane; a chunk's entry on exit is the
// state the chunk starts from. The last chunk's own end value is never
// needed, so the passes before a carry write rows for chunks 0 .. n-2 only.

// The linear state s (R = Op::kStateRows rows) of an op whose step with
// input 0 is s -> A s: s_0 = 0, s_{k+1} = Phi s_k + f_k with Phi = A^Lc and
// f_k the chunk's end state from rest (rows row0 .. row0 + R - 1 of the
// table on entry). A block is 32 lanes x R threads (thread i*32 + l: row i,
// lane lane0 + l). Column i of Phi is the unit state e_i stepped Lc times
// with input 0 by the op's own step(), so it rounds as the op does, and
// the products and sums of the chain are taken in the op's type
// (Op::Value): float for K1, double for K6 (run_chunked_linear). Each
// chunk's starting state is stored rounded to float.
template <class Op>
__device__ __forceinline__ void linear_chunk_carry(
    Op& op, float* __restrict__ table, int rows, int row0, int lanes,
    int lane0, long long Lc, int nchunks) {
  using F = typename Op::Value;
  constexpr int R = Op::kStateRows;
  static_assert(R <= 32, "at most 32 state rows");
  __shared__ F phi[R][R][kTile + 1];
  __shared__ F sv[R][kTile];
  const int i = threadIdx.x / kTile;
  const int l = threadIdx.x % kTile;
  if (nchunks > 1) {
    op.set_unit_state(i);
    for (long long t = 0; t < Lc; ++t) op.step(F(0));
#pragma unroll
    for (int r = 0; r < R; ++r) phi[r][i][l] = op.state(r);
  }
  __syncthreads();
  F row[R];
#pragma unroll
  for (int j = 0; j < R; ++j) row[j] = nchunks > 1 ? phi[i][j][l] : F(0);
  F s = F(0);
  sv[i][l] = F(0);
  __syncthreads();

  const bool ok = lane0 + l < lanes;
  const long long stride = (long long)rows * lanes;
  float* p = table + (long long)(row0 + i) * lanes + lane0 + l;
  constexpr int kBatch = 8;  // f_k loads in flight ahead of the chain
  for (int k0 = 0; k0 < nchunks; k0 += kBatch) {
    float f[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u;
      f[u] = (ok && k < nchunks - 1) ? p[k * stride] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u;
      if (k >= nchunks) break;
      if (ok) p[k * stride] = (float)s;
      if (k == nchunks - 1) break;
      F acc = F(0);
#pragma unroll
      for (int j = 0; j < R; ++j) acc = acc + row[j] * sv[j][l];
      acc = acc + F(f[u]);
      __syncthreads();
      sv[i][l] = s = acc;
      __syncthreads();
    }
  }
}

// The release stage y1 over the chunks of one lane (thread l of the block,
// lane lane0 + l): rows row0 .. row0 + 2 of chunk k < n-1 hold the chunk's
// MinAffine (k, b, m) on entry; on exit row row0 holds y1 at the chunk's
// start: y1_0 = 0, y1_{k+1} = min(m_k, k_k*y1_k + b_k).
__device__ __forceinline__ void minaffine_chunk_carry(
    float* __restrict__ table, int rows, int row0, int lanes, int lane0,
    int nchunks) {
  const int ln = lane0 + (int)threadIdx.x;
  if (ln >= lanes) return;
  const long long stride = (long long)rows * lanes;
  float* p = table + (long long)row0 * lanes + ln;
  float y = 0.0f;
  constexpr int kBatch = 8;
  for (int k0 = 0; k0 < nchunks; k0 += kBatch) {
    float fk[kBatch], fb[kBatch], fm[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool in = k0 + u < nchunks - 1;
      const float* q = p + (k0 + u) * stride;
      fk[u] = in ? q[0] : 0.0f;
      fb[u] = in ? q[lanes] : 0.0f;
      fm[u] = in ? q[2 * lanes] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u;
      if (k >= nchunks) break;
      p[k * stride] = y;
      y = fminf(fm[u], fk[u] * y + fb[u]);
    }
  }
}

// The attack stage g = aa*g + (1-aa)*y1 over the chunks of one lane: row
// row0 of chunk k < n-1 holds the chunk's end value from g = 0 on entry,
// and g at the chunk's start on exit: g_0 = 0, g_{k+1} = pw*g_k + gz_k,
// with pw = aa^Lc, the homogeneous part of the steps.
__device__ __forceinline__ void onepole_chunk_carry_pw(
    float* __restrict__ table, int rows, int row0, int lanes, int lane0,
    float pw, int nchunks) {
  const int ln = lane0 + (int)threadIdx.x;
  if (ln >= lanes) return;
  const long long stride = (long long)rows * lanes;
  float* p = table + (long long)row0 * lanes + ln;
  float g = 0.0f;
  constexpr int kBatch = 8;
  for (int k0 = 0; k0 < nchunks; k0 += kBatch) {
    float gz[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      gz[u] = k0 + u < nchunks - 1 ? p[(k0 + u) * stride] : 0.0f;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u;
      if (k >= nchunks) break;
      p[k * stride] = g;
      g = pw * g + gz[u];
    }
  }
}

// The same with aa^Lc formed by Lc float products (K1).
__device__ __forceinline__ void onepole_chunk_carry(
    float* __restrict__ table, int rows, int row0, int lanes, int lane0,
    float aa, long long Lc, int nchunks) {
  if (lane0 + (int)threadIdx.x >= lanes) return;
  float pw = 1.0f;
  for (long long t = 0; t < Lc; ++t) pw = aa * pw;
  onepole_chunk_carry_pw(table, rows, row0, lanes, lane0, pw, nchunks);
}

// ------------------------------------------------- the chunked detector
//
// The decoupled detector between a front and a tail, as a chunked scan in
// the shape of K1's passes B-D without a cascade (K7 and K8). A policy D
// holds one lane's coefficients: D(vec, lanes, li, flags) reads lane li's
// column of vec; its members aa and ar are the detector's, front(x) is the
// gain computer's c (dB) for the input sample x, and tail(x, g) the output
// for x and the detector's g. Every (32-lane block, chunk k) pair is a warp
// of its own (grid (chunks, lane blocks)). The five stages, in order:
//   B. chunk k < n-1 from rest: the release steps composed into one
//      MinAffine (k, b, m), k = ar^Lc formed in double (pow_n);
//   1. y1 at each chunk's start (minaffine_chunk_carry);
//   C. chunk k < n-1 from y1_k and g = 0: its end value gz_k;
//   2. g at each chunk's start, g_{k+1} = aa^Lc g_k + gz_k, aa^Lc formed
//      in double (onepole_chunk_carry_pw);
//   D. every chunk from (y1_k, g_k) with the whole step, the only pass
//      that writes.
// Each pass reads the input once (three reads and one write in all); the
// carries run one thread a lane, serially over the chunks.
// Chunk 0 starts from (0, 0), as the serial chain does, and matches it
// bitwise; the others are exact in real arithmetic and round otherwise.

// The carry table: kRows floats per chunk and lane, at
// table[(k * kRows + row) * lanes + lane].
struct DetectorTable {
  static constexpr int kY1 = 0;  // MinAffine k, then y1 at the start
  static constexpr int kG = 3;   // gz_k, then g at the start
  static constexpr int kRows = 4;

  __device__ static long long at(int k, int row, int lanes, int lane) {
    return ((long long)k * kRows + row) * lanes + lane;
  }
};

// The block's 32 lanes (blockIdx.y) and chunk (blockIdx.x).
struct ChunkSpan {
  int lane0, li, k;
  long long t0, t1;

  __device__ __forceinline__ ChunkSpan(int lanes, long long T, long long Lc)
      : lane0(blockIdx.y * kTile),
        li(lane_index(lanes, blockIdx.y * kTile)),
        k(blockIdx.x),
        t0((long long)blockIdx.x * Lc),
        t1(t0 + Lc < T ? t0 + Lc : T) {}

  __device__ __forceinline__ bool stores(int lanes) const {
    return lane0 + (int)threadIdx.x < lanes;
  }

  // the chunk's samples of rows of T, or of the shared (C, T) input when
  // shared_channels = C > 0
  template <bool kStore, class Op>
  __device__ __forceinline__ void walk(Op& op, const float* __restrict__ x,
                                       int shared_channels,
                                       float* __restrict__ out, int lanes,
                                       long long T) const {
    const float* const xs[1] = {x};
    walk_n<kStore>(op, xs, shared_channels, out, lanes, T);
  }

  // the same with NIn input sequences (op.step(a, b) for two)
  template <bool kStore, int NIn, class Op>
  __device__ __forceinline__ void walk_n(Op& op,
                                         const float* const (&x)[NIn],
                                         int shared_channels,
                                         float* __restrict__ out, int lanes,
                                         long long T) const {
    run_tiles_span<NIn, kStore>(op, x, shared_channels, out, lanes, T,
                                lane0, t0, t1);
  }
};

// pass B's step: the release steps composed over the chunk (its k is
// replaced by pow_n(ar, Lc) after the walk)
template <class D>
struct ReleaseCompose {
  D d;
  MinAffine f;

  __device__ __forceinline__ float step(float x) {
    f.then(d.ar, d.front(x));
    return 0.0f;
  }
};

// pass C's step (D's tail false) and pass D's (true)
template <class D, bool kTail>
struct DetectorStep {
  D d;
  Ballistics det;

  __device__ __forceinline__ DetectorStep(const D& d_)
      : d(d_), det(d_.aa, d_.ar) {}

  __device__ __forceinline__ float step(float x) {
    const float g = det.step(d.front(x));
    return kTail ? d.tail(x, g) : 0.0f;
  }
};

template <class D>
__global__ void __launch_bounds__(kTile) detector_release_pass(
    const float* __restrict__ x, const float* __restrict__ vec,
    float* __restrict__ table, int lanes, long long T, long long Lc,
    int flags) {
  const ChunkSpan sp(lanes, T, Lc);
  ReleaseCompose<D> op{D(vec, lanes, sp.li, flags), {}};
  sp.walk<false>(op, x, 0, nullptr, lanes, T);
  if (sp.stores(lanes)) {
    float* p = table + DetectorTable::at(sp.k, DetectorTable::kY1, lanes,
                                         sp.li);
    p[0] = pow_n(op.d.ar, sp.t1 - sp.t0);
    p[lanes] = op.f.b;
    p[2 * lanes] = op.f.m;
  }
}

template <class D>
__global__ void __launch_bounds__(kTile) detector_release_carry(
    float* __restrict__ table, int lanes, int nchunks) {
  minaffine_chunk_carry(table, DetectorTable::kRows, DetectorTable::kY1,
                        lanes, blockIdx.x * kTile, nchunks);
}

template <class D>
__global__ void __launch_bounds__(kTile) detector_attack_pass(
    const float* __restrict__ x, const float* __restrict__ vec,
    float* __restrict__ table, int lanes, long long T, long long Lc,
    int flags) {
  const ChunkSpan sp(lanes, T, Lc);
  DetectorStep<D, false> op(D(vec, lanes, sp.li, flags));
  op.det.y1 = table[DetectorTable::at(sp.k, DetectorTable::kY1, lanes, sp.li)];
  sp.walk<false>(op, x, 0, nullptr, lanes, T);
  if (sp.stores(lanes))
    table[DetectorTable::at(sp.k, DetectorTable::kG, lanes, sp.li)] =
        op.det.g;
}

template <class D>
__global__ void __launch_bounds__(kTile) detector_attack_carry(
    const float* __restrict__ vec, float* __restrict__ table, int lanes,
    long long Lc, int nchunks, int flags) {
  const int lane0 = blockIdx.x * kTile;
  const D d(vec, lanes, lane_index(lanes, lane0), flags);
  onepole_chunk_carry_pw(table, DetectorTable::kRows, DetectorTable::kG,
                         lanes, lane0, pow_n(d.aa, Lc), nchunks);
}

template <class D>
__global__ void __launch_bounds__(kTile) detector_out_pass(
    const float* __restrict__ x, const float* __restrict__ vec,
    const float* __restrict__ table, float* __restrict__ out, int lanes,
    long long T, long long Lc, int flags) {
  const ChunkSpan sp(lanes, T, Lc);
  DetectorStep<D, true> op(D(vec, lanes, sp.li, flags));
  op.det.y1 = table[DetectorTable::at(sp.k, DetectorTable::kY1, lanes, sp.li)];
  op.det.g = table[DetectorTable::at(sp.k, DetectorTable::kG, lanes, sp.li)];
  sp.walk<true>(op, x, 0, out, lanes, T);
}

// Whether the launch arguments are ones the chunked scans take (K1, K6, K7,
// K8, K11): chunks a positive multiple of the tile, both grid dimensions in
// range.
inline bool chunked_args_ok(int lanes, long long T, long long Lc) {
  return lanes > 0 && T > 0 && Lc > 0 && Lc % kTile == 0 &&
         blocks_for(lanes) <= 65535 && (T + Lc - 1) / Lc <= 0x7fffffffLL;
}

// Launch the five stages in order on the stream, or only stage `stage`
// (0 B, 1 carry 1, 2 C, 3 carry 2, 4 D) when it is not negative, so that
// a tool can time them apart. table: nchunks x kRows x
// lanes floats. Returns cudaGetLastError().
template <class D>
int run_chunked_detector(const float* x, const float* vec, float* out,
                         float* table, int lanes, long long T, long long Lc,
                         int flags, int stage, cudaStream_t stream) {
  const int nchunks = (int)((T + Lc - 1) / Lc);
  const int lane_blocks = blocks_for(lanes);
  const dim3 spans(nchunks - 1, lane_blocks);
  const bool all = stage < 0;
  if ((all || stage == 0) && nchunks > 1)
    detector_release_pass<D><<<spans, kTile, 0, stream>>>(x, vec, table,
                                                          lanes, T, Lc, flags);
  if (all || stage == 1)
    detector_release_carry<D><<<lane_blocks, kTile, 0, stream>>>(table, lanes,
                                                                 nchunks);
  if ((all || stage == 2) && nchunks > 1)
    detector_attack_pass<D><<<spans, kTile, 0, stream>>>(x, vec, table, lanes,
                                                         T, Lc, flags);
  if (all || stage == 3)
    detector_attack_carry<D><<<lane_blocks, kTile, 0, stream>>>(
        vec, table, lanes, Lc, nchunks, flags);
  if (all || stage == 4)
    detector_out_pass<D><<<dim3(nchunks, lane_blocks), kTile, 0, stream>>>(
        x, vec, table, out, lanes, T, Lc, flags);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------- the chunked linear scan
//
// An op whose state is linear (its step with input 0 is s -> A s; K6: the
// cascade's 2S values) as a chunked scan in the shape of K1's pass A, first
// carry and pass D. Op(vec, lanes, li, flags) reads lane li's column of
// vec; Op::kStateRows rows of state go through a carry table of `rows`
// floats per chunk and lane (the state in rows 0 .. kStateRows - 1, at
// table[(k * rows + row) * lanes + lane]). Every (32-lane block, chunk)
// pair of a pass is a warp of its own (grid (chunks, lane blocks)). The
// three stages, in order:
//   A. chunk k < n-1 from rest: its end state f_k (the op with flags 0);
//   1. s_{k+1} = Phi s_k + f_k, Phi = A^Lc, in CarryOp's type
//      (linear_chunk_carry; K1 float, K6 double);
//   D. every chunk from s_k with the op's whole step (flags as given), the
//      only pass that writes.
// A population-shared (C, T) input (shared_channels = C > 0) is read in
// place by both passes. Chunk 0 starts from rest, as the serial chain
// does, and matches it bitwise.

template <class Op>
__global__ void __launch_bounds__(kTile) linear_state_pass(
    const float* __restrict__ x, int shared_channels,
    const float* __restrict__ vec, float* __restrict__ table, int rows,
    int lanes, long long T, long long Lc) {
  const ChunkSpan sp(lanes, T, Lc);
  Op op(vec, lanes, sp.li, 0);
  sp.walk<false>(op, x, shared_channels, nullptr, lanes, T);
  if (sp.stores(lanes))
    op.store_state(table + ((long long)sp.k * rows) * lanes + sp.li, lanes);
}

template <class CarryOp>
__global__ void __launch_bounds__(kTile * CarryOp::kStateRows)
    linear_state_carry(const float* __restrict__ vec,
                       float* __restrict__ table, int rows, int lanes,
                       long long Lc, int nchunks) {
  // thread i*32 + l builds column i of lane lane0 + l's Phi (lane 0's past
  // the last lane)
  const int lane0 = blockIdx.x * kTile;
  const int l = threadIdx.x % kTile;
  CarryOp op(vec, lanes, lane0 + l < lanes ? lane0 + l : 0, 0);
  linear_chunk_carry(op, table, rows, 0, lanes, lane0, Lc, nchunks);
}

template <class Op>
__global__ void __launch_bounds__(kTile) linear_state_out_pass(
    const float* __restrict__ x, int shared_channels,
    const float* __restrict__ vec, const float* __restrict__ table,
    float* __restrict__ out, int rows, int lanes, long long T, long long Lc,
    int flags) {
  const ChunkSpan sp(lanes, T, Lc);
  Op op(vec, lanes, sp.li, flags);
  op.load_state(table + ((long long)sp.k * rows) * lanes + sp.li, lanes);
  sp.walk<true>(op, x, shared_channels, out, lanes, T);
}

// Launch the three stages in order on the stream, or only stage `stage`
// (0 A, 1 the carry, 2 D) when it is not negative, so that a tool can time
// them apart. table: nchunks x Op::kStateRows x lanes floats. The
// arguments as chunked_args_ok() takes them. Returns
// cudaGetLastError().
template <class Op, class CarryOp>
int run_chunked_linear(const float* x, int shared_channels, const float* vec,
                       float* out, float* table, int lanes, long long T,
                       long long Lc, int flags, int stage,
                       cudaStream_t stream) {
  static_assert(Op::kStateRows == CarryOp::kStateRows, "one state");
  constexpr int rows = Op::kStateRows;
  const int nchunks = (int)((T + Lc - 1) / Lc);
  const int lane_blocks = blocks_for(lanes);
  const bool all = stage < 0;
  if ((all || stage == 0) && nchunks > 1)
    linear_state_pass<Op><<<dim3(nchunks - 1, lane_blocks), kTile, 0,
                            stream>>>(x, shared_channels, vec, table, rows,
                                      lanes, T, Lc);
  if (all || stage == 1)
    linear_state_carry<CarryOp><<<lane_blocks, kTile * rows, 0, stream>>>(
        vec, table, rows, lanes, Lc, nchunks);
  if (all || stage == 2)
    linear_state_out_pass<Op><<<dim3(nchunks, lane_blocks), kTile, 0,
                                stream>>>(x, shared_channels, vec, table,
                                          out, rows, lanes, T, Lc, flags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace scancore
