// K5, K3 and K4 on Hopper: the packed stereo FFT pair of the fused LTI group,
// written for the half-grid layout of the response kernels.
//
//   K5 fwd_pack_fft           replaces st_ito_tpu/ops/pallas/mega_fft.py:395
//   K3 fwd_pack_fft_response  replaces st_ito_tpu/ops/pallas/mega_fft.py:431
//   K4 inv_unpack_fft         replaces st_ito_tpu/ops/pallas/mega_fft.py:489
//
// K5 packs z = L + iR, takes Z = FFT_n(z) and writes Zlo[k] = Z[k] and
// Zrev[k] = Z[(n-k) mod n] for the bins k in [0, n/2]. K3 is K5 with the
// response math of rp_response.cuh (what K2 computes) as its epilogue, so
// that Z never reaches device memory: it writes Ylo and Yhig. K4 rebuilds Y
// from (Ylo, Yhig), takes the inverse FFT and writes L = re/n, R = im/n for
// the first T samples. Every half-grid array is a row of pitch Fp = Rp*n1
// per candidate with bin k at index k; only the bins k <= n/2 are written by
// K5/K3 and only the valid ones are read by K4 (Ylo for k <= n/2, Yhig for
// 1 <= k <= n/2 - 1), chosen by index, so junk in the rest never enters a
// sum.
//
// Design. A candidate's n complex samples (4 MB at n = 2^19) do not fit in
// an SM's shared memory, so each transform is a four-step FFT in two
// passes, with n = n1*n2, sample t = j1*n2 + j2 and bin k = k2*n1 + k1:
//
//   forward, pass 1: a tile of adjacent j2 columns of one candidate for all
//     j1, transformed over j1 (length n1), times the twiddle W_n^(k1*j2),
//     M[k1][j2] to scratch (K10's pass 1, fft_persist.cuh cols_tile, on the
//     planar rows L and R of x);
//   forward, pass 2 (mirror_rows_tile): a tile of R rows k1 together with
//     their mirror rows n1-k1, transformed over j2 (length n2), so that it
//     holds Z[k] and Z[(n-k) mod n] for every bin of its columns: the
//     mirror of (k2, k1) is (n2-1-k2, n1-k1) for k1 >= 1 and
//     ((n2-k2) mod n2, 0) for k1 = 0; rows 0 and n1/2 mirror themselves and
//     share the first tile. It emits (Zlo, Zrev), or applies the response
//     to them and emits (Ylo, Yhig);
//   inverse, pass 1 (inv_cols_tile): the same split with
//     the spectrum as input, bin u = j1*n2 + j2: a tile of adjacent j2
//     columns gathers Y[u] over j1 from Ylo (u <= n/2) and from Yhig at the
//     mirror bin (above), transforms over j1 (length n1), multiplies by
//     W_n^-(k1*j2) and writes M[k1][j2] to scratch (K10's inverse pass 1
//     but for the gather);
//   inverse, pass 2 (inv_rows_tile): a tile of rows k1 transformed over j2
//     (length n2) writes sample v = k2*n1 + k1 of the first T, (L, R) =
//     (re, im)/n, in runs of the tile's rows.
//
// Each transform is one persistent launch over the whole population
// (fft_persist.cuh, as K10): ticket-ordered pass-1 and pass-2 items, pass 1
// of later candidates overlapping pass 2 of earlier ones, through a ring of
// scratch slots that stays in L2; the twiddle from two root tables; up to
// five butterfly layers in registers a trip through shared memory. K3's
// epilogue needs 38 Freeverb floats per bin; read from a 40 MB table for
// every (candidate, bin) they are 20 GB a call at n 2^19, and on the card
// the gather cost more than the transform (PERF.md). Here only the four
// allpass floats come from the table, read by bin from its rows (4 MB that
// stay in L2; a copy laid out in pass 2's walk order took no less time);
// the 17 phasors of the other 34 are formed per bin as
// products of a row and a column factor of the four-step grid
// (FactoredTab), 210 KB that stay in cache. Tiles of several candidates,
// which would share a bin's values, lost more to their shorter output runs
// or to a block an SM than they saved. K4 reads each valid bin once with
// the streaming hint, and where T <= n/2 (the headline) its pass 2 forms
// only the samples below n/2 in its last layer and writes the T samples
// with streaming stores; it replaced two launches a chunk of 64 candidates
// through a 256 MB scratch in device memory. Split the other way (pass 1
// over k2 for tiles of bins k1, rows j2 out), it took longer than the
// chunked kernel it replaced (PERF.md).
//
// Tiles make the strided sides of each pass 32- or 64-byte runs and the
// other side whole rows. The natural-order side of each transform is the
// one whose global accesses must be contiguous, the bit-reversed side is
// walked in shared-memory order. The twiddle's integer product k1*j2 < n
// is exact.
//
// Bounds at the headline (B 512, n 2^19, T 2^18): K5 and K4 move 3.2 GB
// (0.96 ms at 3.35 TB/s) against 25.5 G float32 operations (0.38 ms): bytes.
// K3 moves 3.3 GB (the table once) against 61.7 G operations (0.92 ms):
// bytes, barely.
//
// Built with nvcc's contraction of a*b + c into fused multiply-adds (unlike
// packed_response.cu): K3's epilogue is K2's math but for the phasors, each
// a product of two factors where K2 reads one table value, the approximate
// divide (rp_response.cuh FastMath), and the fused operations; the delay's
// phase and denominator, which a resonance magnifies a thousandfold, round
// as the plain version's (delay_build's unfused operations).
//
// C entry points return cudaGetLastError(), or cudaErrorInvalidValue for a
// shape they do not take.

#include <cuda_runtime.h>

#include <algorithm>

#include "fft_core.cuh"
#include "fft_persist.cuh"
#include "rp_response.cuh"

namespace {

using fftcore::allow_smem;
using fftcore::bitrev;
using fftcore::cmul;
using fftcore::ilog2;
using fftcore::kMaxLogN;
using fftcore::kThreads;
using fftcore::row_pitch;
using fftcore::Split;
using fftcore::sw;
using fftcore::tile_log;
using fftpersist::Plan;

// ---------------------------------------------------------------- forward

// What pass 2 emits: Z itself (K5), Z plus the sum of the bin's Freeverb
// table column (a stage timer's probe of the table loads alone), or the
// response applied to Z (K3).
enum Epilogue : int { kZ = 0, kTableOnly = 1, kResponse = 2 };

// The four half-grid outputs, rows of pitch Fp.
struct Outputs {
  float *lo_r, *lo_i, *hi_r, *hi_i;
  long long Fp;
};

// K3's factors of the Freeverb table's phasors (rp_response.cuh ArrayTab's
// cos1/sin1 and combs): phasor d of bin k = k2*n1 + k1 is
// e^(i 2 pi k D_d / n) = u[k2][d] * v[k1][d], (cos, sin) pairs, d = 0 the
// z^-1 term and 1 + 8*ch + j comb j of channel ch; a row holds kPhasors
// pairs and a pad (kFactorPitch float2, 16-byte rows), so that phasors d
// and d+1 come in one 16-byte load. ap: the table's allpass rows (apL_r,
// apL_i, apR_r, apR_i), indexed by bin, pitch the half grid's n/2 + 1.
constexpr int kPhasors = 17;
constexpr int kFactorPitch = 18;

struct Factors {
  const float4* u;
  const float4* v;
  const float* ap;
};

// A bin's Freeverb values for rp_response.cuh reverb_build, from the
// factors: 17 complex products in place of 34 of the 38 floats a bin of
// the table holds (40 MB at n 2^19 against 210 KB of factors).
struct FactoredTab {
  const float4* u;  // the bin's row k2 of u
  const float4* v;  // its row k1 of v
  float2 apL, apR;

  __device__ __forceinline__ float2 phasor(int d) const {
    const float4 a4 = __ldg(u + (d >> 1));
    const float4 b4 = __ldg(v + (d >> 1));
    const float2 a = (d & 1) ? make_float2(a4.z, a4.w)
                             : make_float2(a4.x, a4.y);
    const float2 b = (d & 1) ? make_float2(b4.z, b4.w)
                             : make_float2(b4.x, b4.y);
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
  }
  __device__ __forceinline__ float2 z1() const { return phasor(0); }
  __device__ __forceinline__ float2 comb(int ch, int j) const {
    return phasor(1 + 8 * ch + j);
  }
  __device__ __forceinline__ float2 allpass(int ch) const {
    return ch ? apR : apL;
  }
};

// Row of slot sl in the tile whose primary rows start at a: slots [0, R)
// are rows a..a+R-1, slots [R, 2R) their mirrors n1-k1; row 0 mirrors
// itself, so its mirror slot carries row n1/2 (which mirrors itself too).
__device__ __forceinline__ int slot_row(int sl, int a, int R, int n1) {
  if (sl < R) return a + sl;
  const int k1 = a + sl - R;
  return k1 == 0 ? (n1 >> 1) : n1 - k1;
}

// Pass 2 on row tile `tile` of candidate b, whose intermediate is at
// slot: its R = 2^(log_rows - 1) rows from tile*R and their mirrors, 2R
// rows in shared memory. The epilogue walks the tile's half-grid bins
// (k2 < n2/2, the even positions q of each row) with neighbouring threads
// on neighbouring slots, a thread on the same slot throughout (kThreads is
// a multiple of 2R), so that the row's factors and the candidate's stage
// scalars stay put. The Nyquist bin, at q = 1 of row 0, is thread 0's
// last item.
template <int kEpi>
__device__ __forceinline__ void mirror_rows_tile(
    const Plan& p, const float2* __restrict__ slot, const Outputs& o,
    const rp::Stages& st, const Factors& fac, float2* s, const float2* tw2,
    int b, int tile) {
  const Split& sp = p.sp;
  const int slots = 1 << p.log_rows;
  const int R = slots >> 1;
  const int pitch = row_pitch(sp.n2);
  const int a = tile * R;
  const bool first = a == 0;
  // the candidate's stage scalars, (n_stages, 4) and then n_stages masks,
  // read once into shared memory (a view with B = 1)
  __shared__ float scalars[rp::kMaxStages * (rp::kParamsPerStage + 1)];
  const int n_prm = st.n_stages * rp::kParamsPerStage;
  if (kEpi == kResponse && threadIdx.x < n_prm + st.n_stages) {
    const int i = threadIdx.x;
    scalars[i] = i < n_prm ? st.params[(long long)i * st.B + b]
                 : (st.active != nullptr
                        ? st.active[(long long)(i - n_prm) * st.B + b]
                        : 1.0f);
  }
  rp::Stages one = st;
  one.params = scalars;
  one.active = st.active != nullptr ? scalars + n_prm : nullptr;
  one.B = 1;

#pragma unroll 8
  for (int it = threadIdx.x; it < (slots << sp.log_n2); it += kThreads) {
    const int j = it & (sp.n2 - 1);
    const int sl = it >> sp.log_n2;
    const int k1 = slot_row(sl, a, R, sp.n1);
    s[sl * pitch + sw(j)] = __ldcg(slot + ((long long)k1 << sp.log_n2) + j);
  }
  fftcore::fft_rows_dif_wide<false, false, 5>(s, slots, pitch, sp.log_n2,
                                              tw2);

  // one bin: slot sl at position q, its mirror at (msl, mq)
  auto emit = [&](int sl, int q, int msl, int mq, int k1) {
    const int k2 = bitrev(q, sp.log_n2);
    const int k = k2 * sp.n1 + k1;
    const float2 zlo = s[sl * pitch + sw(q)];
    const float2 zrev = s[msl * pitch + sw(mq)];
    float lo_r = zlo.x, lo_i = zlo.y, hi_r = zrev.x, hi_i = zrev.y;
    if (kEpi != kZ && fac.ap != nullptr) {
      const long long pitch_ap = (sp.n >> 1) + 1;
      const FactoredTab tab{
          fac.u + k2 * (kFactorPitch / 2), fac.v + k1 * (kFactorPitch / 2),
          make_float2(fac.ap[k], fac.ap[pitch_ap + k]),
          make_float2(fac.ap[2 * pitch_ap + k], fac.ap[3 * pitch_ap + k])};
      if (kEpi == kTableOnly) {
        float sum = tab.apL.x + tab.apR.x;
#pragma unroll
        for (int d = 0; d < kPhasors; ++d) sum = sum + tab.phasor(d).x;
        lo_r = lo_r + sum;
      } else {
        const rp::Coeffs cf = rp::rp_coeffs<rp::FastMath>(one, tab, 0, k);
        rp::rp_apply(cf, k == 0 || k == (sp.n >> 1), zlo.x, zlo.y, zrev.x,
                     zrev.y, lo_r, lo_i, hi_r, hi_i);
      }
    } else if (kEpi == kResponse) {
      const rp::Coeffs cf = rp::rp_coeffs<rp::FastMath>(
          one, FactoredTab{nullptr, nullptr, {}, {}}, 0, k);
      rp::rp_apply(cf, k == 0 || k == (sp.n >> 1), zlo.x, zlo.y, zrev.x,
                   zrev.y, lo_r, lo_i, hi_r, hi_i);
    }
    const long long idx = (long long)b * o.Fp + k;
    __stcs(o.lo_r + idx, lo_r);
    __stcs(o.lo_i + idx, lo_i);
    __stcs(o.hi_r + idx, hi_r);
    __stcs(o.hi_i + idx, hi_i);
  };

  const int sl = threadIdx.x & (slots - 1);
  const int k1 = slot_row(sl, a, R, sp.n1);
  const int msl = (first && (sl == 0 || sl == R)) ? sl : (sl ^ R);
  const int main_items = R << sp.log_n2;  // 2R rows x n2/2 bins
  for (int it = threadIdx.x; it < main_items; it += kThreads) {
    const int q = (it >> p.log_rows) << 1;
    const int mq = (first && sl == 0)
                       ? bitrev((sp.n2 - bitrev(q, sp.log_n2)) & (sp.n2 - 1),
                                sp.log_n2)
                       : sp.n2 - 1 - q;
    emit(sl, q, msl, mq, k1);
  }
  if (first && threadIdx.x == 0)  // the Nyquist bin (n2/2, 0), its own mirror
    emit(0, 1, 0, 1, 0);
}

// Blocks an SM the forward is compiled for: two, at most 128 registers a
// thread, as K10.
constexpr int kForwardMinBlocks = 2;

template <int kEpi>
__global__ void __launch_bounds__(kThreads, kForwardMinBlocks) forward_kernel(
    const float* __restrict__ x, Outputs o, float2* __restrict__ scratch,
    const float2* __restrict__ tw, const float2* __restrict__ roots,
    rp::Stages st, Factors fac, int* __restrict__ counters, Plan p) {
  extern __shared__ float2 smem[];
  const Split& sp = p.sp;
  float2* tw1 = smem;                 // W_n1^j, j < n1/2
  float2* tw2 = tw1 + (sp.n1 >> 1);   // W_n2^j, j < n2/2
  float2* s = tw2 + (sp.n2 >> 1);
  fftcore::load_twiddles(tw1, tw, sp.n1 >> 1, 1);
  fftcore::load_twiddles(tw2, tw, sp.n2 >> 1, sp.n1 >> sp.log_n2);
  // x is (B, 2, T): candidate b's L and R rows at b*2T and b*2T + T
  fftpersist::run(
      p, scratch, counters,
      [&](int c, int r, float2* slot) {
        fftpersist::cols_tile<false, 5>(p, x, x + (p.in_stride >> 1), slot,
                                        roots, s, tw1, c, r);
      },
      [&](int c, int r, const float2* slot) {
        mirror_rows_tile<kEpi>(p, slot, o, st, fac, s, tw2, c, r);
      });
}

// ---------------------------------------------------------------- inverse

// K4's inputs, (B, Fp) half grids, and its output y (B, 2, T).
struct Inverse {
  const float *lo_r, *lo_i, *hi_r, *hi_i;
  long long Fp;
  float* y;
  int T;
};

// Butterfly layers a step in K4's two passes (five spilled registers and
// took longer, PERF.md), and its blocks an SM (two: at most 128 registers a
// thread, as K10).
constexpr int kInverseLayers = 4;
constexpr int kInverseMinBlocks = 2;

// Pass 1 on column tile `tile` of candidate b into its slot m: the tile's
// columns j2 gather bin u = j1*n2 + j2 of Y over all j1, from Ylo where
// u <= n/2 and from Yhig at the mirror bin n - u above (Yhig[m] =
// Y[n - m]), so that only the valid bins are read (with the streaming
// hint); then fft_persist.cuh cols_finish, inverse.
__device__ __forceinline__ void inv_cols_tile(
    const Plan& p, const Inverse& io, float2* __restrict__ m,
    const float2* __restrict__ roots, float2* s, const float2* tw1, int b,
    int tile) {
  const Split& sp = p.sp;
  const int pitch = row_pitch(sp.n1);
  const int cw = 1 << p.log_cw;
  const int j2_0 = tile << p.log_cw;
  const long long base = (long long)b * io.Fp;
  const int half = sp.n >> 1;
  const int items = sp.n1 << p.log_cw;
#pragma unroll 8
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int c = it & (cw - 1);
    const int j1 = it >> p.log_cw;
    const int u = (j1 << sp.log_n2) + j2_0 + c;
    const bool lo = u <= half;
    const long long i = base + (lo ? u : sp.n - u);
    s[c * pitch + sw(j1)] = make_float2(__ldcs((lo ? io.lo_r : io.hi_r) + i),
                                        __ldcs((lo ? io.lo_i : io.hi_i) + i));
  }
  fftpersist::cols_finish<true, kInverseLayers>(p, m, roots, s, tw1, tile);
}

// Pass 2 on row tile `tile` of candidate b from its slot m: the tile's
// 2^log_rows rows k1 transform over j2 (length n2) and write sample
// v = k2*n1 + k1 for v < T only, (L, R) = (re, im)/n. With kHalf
// (T <= n/2) the last layer forms only the samples below n/2.
template <bool kHalf>
__device__ __forceinline__ void inv_rows_tile(const Plan& p,
                                              const float2* __restrict__ m,
                                              const Inverse& io, float2* s,
                                              const float2* tw2, int b,
                                              int tile) {
  const Split& sp = p.sp;
  const int pitch = row_pitch(sp.n2);
  const int rows = 1 << p.log_rows;
  const int a = tile << p.log_rows;
  const int items = rows << sp.log_n2;
#pragma unroll 8
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int j = it & (sp.n2 - 1);
    const int r = it >> sp.log_n2;
    s[r * pitch + sw(j)] = __ldcg(m + ((long long)(a + r) << sp.log_n2) + j);
  }
  fftcore::fft_rows_dif_wide<true, kHalf, kInverseLayers>(s, rows, pitch,
                                                          sp.log_n2, tw2);

  // sample (k2, a + r) sits at position q = bitrev(k2) of row r;
  // neighbouring threads take neighbouring rows, so each k2 is one run of
  // `rows` floats in L and in R
  const float scale = 1.0f / (float)sp.n;
  float* yl = io.y + (long long)b * 2 * io.T;
  float* yr = yl + io.T;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int r = it & (rows - 1);
    const int q = it >> p.log_rows;
    if (kHalf && (q & 1)) continue;  // samples from n/2 on: not formed
    const int v = bitrev(q, sp.log_n2) * sp.n1 + a + r;
    if (v < io.T) {
      const float2 val = s[r * pitch + sw(q)];
      __stcs(yl + v, val.x * scale);
      __stcs(yr + v, val.y * scale);
    }
  }
}

template <bool kHalf>
__global__ void __launch_bounds__(kThreads, kInverseMinBlocks)
    inverse_kernel(Inverse io, float2* __restrict__ scratch,
                   const float2* __restrict__ tw,
                   const float2* __restrict__ roots,
                   int* __restrict__ counters, Plan p) {
  extern __shared__ float2 smem[];
  const Split& sp = p.sp;
  float2* tw1 = smem;                 // W_n1^j, j < n1/2
  float2* tw2 = tw1 + (sp.n1 >> 1);   // W_n2^j, j < n2/2
  float2* s = tw2 + (sp.n2 >> 1);
  fftcore::load_twiddles(tw1, tw, sp.n1 >> 1, 1);
  fftcore::load_twiddles(tw2, tw, sp.n2 >> 1, sp.n1 >> sp.log_n2);
  fftpersist::run(
      p, scratch, counters,
      [&](int c, int r, float2* slot) {
        inv_cols_tile(p, io, slot, roots, s, tw1, c, r);
      },
      [&](int c, int r, const float2* slot) {
        inv_rows_tile<kHalf>(p, slot, io, s, tw2, c, r);
      });
}

// ------------------------------------------------------------------- host

// 0 and the split, or cudaErrorInvalidValue
int make_split(int n1, int n2, int T, int B, long long Fp, Split* sp) {
  if (n1 < 2 || n2 < 2 || (n1 & (n1 - 1)) != 0 || (n2 & (n2 - 1)) != 0 ||
      n2 > n1)
    return cudaErrorInvalidValue;
  const int log_n1 = ilog2(n1), log_n2 = ilog2(n2);
  if (log_n1 + log_n2 > kMaxLogN || B < 1 || T < 1 ||
      T > (n1 << log_n2) || (T & (n2 - 1)) != 0 ||
      Fp < ((long long)n1 << log_n2) / 2 + 1)
    return cudaErrorInvalidValue;
  *sp = Split{n1 << log_n2, n1, n2, log_n1, log_n2};
  return 0;
}

// The plan of a persistent launch over B candidates, K10's: pass-1 tiles
// of 2^log_cw columns (transforms of length n1), pass-2 tiles of
// 2^log_rows rows (length n2); the planar-input fields are left 0.
Plan plan_for(const Split& sp, int B, bool pass1_only) {
  Plan p{};
  p.sp = sp;
  p.log_cw = std::min(tile_log(sp.n1), sp.log_n2);
  p.log_rows = std::min(tile_log(sp.n2), sp.log_n1);
  p.B = B;
  p.n_p1 = sp.n2 >> p.log_cw;
  p.n_p2 = sp.n1 >> p.log_rows;
  p.pass1_only = pass1_only ? 1 : 0;
  return p;
}

// the dynamic shared memory of a persistent block: the n1/2 and n2/2
// twiddles and the larger of the two passes' tiles
size_t plan_smem(const Plan& p) {
  const Split& sp = p.sp;
  return ((size_t)(sp.n1 >> 1) + (size_t)(sp.n2 >> 1) +
          std::max((size_t)row_pitch(sp.n1) << p.log_cw,
                   (size_t)row_pitch(sp.n2) << p.log_rows)) *
         sizeof(float2);
}

// One persistent launch of `kernel` over plan p: as many blocks as fit the
// card at once (at most one a ticket), plan_smem(p) bytes of shared memory
// each, its 1 + 2B counters zeroed first.
template <class Kernel, class... Args>
int launch_persistent(Kernel kernel, const Plan& p, int* counters,
                      cudaStream_t stream, Args... args) {
  if ((long long)p.B * (p.n_p1 + p.n_p2) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = plan_smem(p);
  int err = allow_smem(kernel, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == 0) err = cudaGetDevice(&dev);
  if (err == 0)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != 0) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  err = cudaMemsetAsync(counters, 0, sizeof(int) * (1 + 2 * p.B), stream);
  if (err != 0) return err;
  const int grid = std::min(fftpersist::tickets(p), per_sm * sms);
  kernel<<<grid, kThreads, smem, stream>>>(args..., counters, p);
  return static_cast<int>(cudaGetLastError());
}

template <int kEpi>
int forward(const float* x, const Outputs& o, float2* scratch,
            const float2* tw, const float2* roots, int* counters, int B,
            int T, int n1, int n2, const rp::Stages& st, const Factors& fac,
            bool pass1_only, cudaStream_t stream) {
  Split sp;
  if (make_split(n1, n2, T, B, o.Fp, &sp) != 0) return cudaErrorInvalidValue;
  Plan p = plan_for(sp, B, pass1_only);
  // a row and its mirror at least, and whole row pairs a thread's slot
  if (p.log_rows < 1 || kThreads % (1 << p.log_rows) != 0)
    return cudaErrorInvalidValue;
  p.in_rows = T >> sp.log_n2;
  p.in_stride = 2LL * T;
  return launch_persistent(forward_kernel<kEpi>, p, counters, stream, x, o,
                           scratch, tw, roots, st, fac);
}

}  // namespace

// The scratch slots the forward kernels need (candidates of n float2 each).
extern "C" int mega_fft_scratch_slots() { return fftpersist::kRing; }

// The forward kernels' common arguments: x (B, 2, T); the four outputs
// (B, Fp); scratch mega_fft_scratch_slots()*n float2; tw the n1/2
// twiddles W_n1^j as float2; roots the n2 coarse roots W_n^(h*n1), h < n2,
// then the n1 fine ones W_n^l, l < n1; counters 1 + 2B ints (zeroed here).

// K5.
extern "C" int fwd_pack_fft_launch(const float* x, float* zlo_r, float* zlo_i,
                                   float* zrev_r, float* zrev_i,
                                   void* scratch, const void* tw,
                                   const void* roots, int* counters, int B,
                                   int T, int n1, int n2, long long Fp,
                                   void* stream) {
  return forward<kZ>(x, Outputs{zlo_r, zlo_i, zrev_r, zrev_i, Fp},
                     static_cast<float2*>(scratch),
                     static_cast<const float2*>(tw),
                     static_cast<const float2*>(roots), counters, B, T, n1,
                     n2, rp::Stages{}, Factors{}, false,
                     static_cast<cudaStream_t>(stream));
}

// K3. As K5, with the stages of packed_response_launch. For a reverb
// stage: ap the table's four allpass rows (bin k at column k, pitch
// n/2 + 1), u and v the factors of its phasors (Factors: n2 and n1 rows of
// kFactorPitch float2); null otherwise. stage < 0 runs the kernel; 0 to 3 are a stage timer's probes:
// pass 1 alone, then pass 1 with pass 2 emitting Z, Z plus the Freeverb
// values' loads and products alone, and the whole epilogue.
extern "C" int fwd_pack_fft_response_launch(
    const float* x, float* ylo_r, float* ylo_i, float* yhi_r, float* yhi_i,
    void* scratch, const void* tw, const void* roots, int* counters, int B,
    int T, int n1, int n2, long long Fp, unsigned int codes, int n_stages,
    const float* params, const float* active, const float* ap, const void* u,
    const void* v, float w0, float sr, int stage, void* stream) {
  if (stage > 3) return cudaErrorInvalidValue;
  // check_stages asks a reverb stage for a table: the allpass rows stand in
  const rp::Stages st{codes, n_stages,    params, active, ap,
                      (long long)n1 * n2 / 2 + 1, B, n1 * n2, w0, sr};
  if (rp::check_stages(st) != 0 ||
      (ap != nullptr && (u == nullptr || v == nullptr)))
    return cudaErrorInvalidValue;
  const Factors fac{static_cast<const float4*>(u),
                    static_cast<const float4*>(v), ap};
  const Outputs o{ylo_r, ylo_i, yhi_r, yhi_i, Fp};
  float2* s = static_cast<float2*>(scratch);
  const float2* w = static_cast<const float2*>(tw);
  const float2* rt = static_cast<const float2*>(roots);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (stage == 1)
    return forward<kZ>(x, o, s, w, rt, counters, B, T, n1, n2, st, fac, false,
                       strm);
  if (stage == 2)
    return forward<kTableOnly>(x, o, s, w, rt, counters, B, T, n1, n2, st,
                               fac, false, strm);
  return forward<kResponse>(x, o, s, w, rt, counters, B, T, n1, n2, st, fac,
                            stage == 0, strm);
}

// K4. The four inputs (B, Fp); y (B, 2, T); scratch, tw, roots and
// counters as the forward kernels'. stage < 0 runs the kernel; 0 is a
// stage timer's probe: pass 1 of every candidate alone.
extern "C" int inv_unpack_fft_launch(const float* ylo_r, const float* ylo_i,
                                     const float* yhi_r, const float* yhi_i,
                                     float* y, void* scratch, const void* tw,
                                     const void* roots, int* counters, int B,
                                     int T, int n1, int n2, long long Fp,
                                     int stage, void* stream) {
  Split sp;
  if (stage > 0 || make_split(n1, n2, T, B, Fp, &sp) != 0)
    return cudaErrorInvalidValue;
  // the half grids and y are K4's own (Inverse), not planar rows
  const Plan p = plan_for(sp, B, stage == 0);
  const Inverse io{ylo_r, ylo_i, yhi_r, yhi_i, Fp, y, T};
  float2* s = static_cast<float2*>(scratch);
  const float2* w = static_cast<const float2*>(tw);
  const float2* rt = static_cast<const float2*>(roots);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (2LL * T <= sp.n)
    return launch_persistent(inverse_kernel<true>, p, counters, strm, io, s,
                             w, rt);
  return launch_persistent(inverse_kernel<false>, p, counters, strm, io, s,
                           w, rt);
}
