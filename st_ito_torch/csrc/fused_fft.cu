// K10 on Hopper: a batched complex DFT of size n on planar float32 input.
//
// Replaces st_ito_tpu/ops/pallas/fused_fft.py:167 fft_fused (kernel
// _make_kernel, fused_fft.py:120): for each of B rows, (zr, zi) of in_len
// samples, zero-padded to n, goes to X[k] = sum_t z[t] W^(k*t) with
// W = exp(-2 pi i / n) for sign -1 (forward) and exp(+2 pi i / n) for
// sign +1 (inverse, unscaled); only the first out_len bins are written.
// The TPU kernel runs the two stages of a four-step split as MXU matrix
// products in VMEM, one candidate per grid step. Here a candidate's n
// complex samples (4 MB at n = 2^19) do not fit in an SM's shared memory,
// so the same split runs as two passes through a scratch, on the
// shared-memory butterflies of fft_core.cuh, with n = n1*n2, sample
// t = j1*n2 + j2 and bin k = k2*n1 + k1:
//
//   pass 1 (a column tile): a tile of adjacent j2 columns for all j1; reads
//     the rows j1 < in_len/n2 (the rest is the implicit zero pad, never
//     read), transforms each column over j1 (length n1), multiplies by the
//     twiddle W^(k1*j2) and writes M[k1][j2] to the scratch;
//   pass 2 (a row tile): a tile of whole rows k1; transforms each over j2
//     (length n2) and writes X[k2*n1 + k1] for the bins below out_len only.
//
// Bound at the headline (B 512, n 2^19): the forward reads 2 x 512 x 2^18
// floats and writes 2 x 512 x 2^19 (3.2 GB, 0.96 ms at 3.35 TB/s) against
// 5 n log2(n) B = 25.5 G float32 operations (0.38 ms): bytes; the inverse
// moves the same bytes the other way. What this design does about it:
//
//   - One persistent launch walks the whole population, one candidate a
//     chunk (fft_persist.cuh: the ticket scheduler and pass 1, shared with
//     K5 and K3), pass 1 of later chunks overlapping pass 2 of earlier
//     ones, through a ring of scratch slots that stays in L2: its round
//     trip does not reach device memory, and no launch ends between
//     chunks. Outputs are written with the streaming cache hint, so that
//     they do not push the scratch out of L2.
//   - The twiddle W_n^(k1*j2) between the passes comes from two small
//     tables of n-th roots, one complex product, instead of a sincospif
//     per element.
//   - The transforms take up to five (the forward) or four (the inverse)
//     butterfly layers in registers between the trips through shared
//     memory (fft_rows_dif_wide): two or three trips for each length-1024
//     or length-512 transform instead of four or three.
//   - Where out_len <= n/2, pass 2 forms only the bins below n/2 in its
//     last layer (the inverse at the headline): compute, not bytes, since
//     every row k1 feeds bins below n/2.
//
// C entry point: fft_fused_launch(...) returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take.

#include <cuda_runtime.h>

#include <algorithm>

#include "fft_core.cuh"
#include "fft_persist.cuh"

namespace {

using fftcore::bitrev;
using fftcore::ilog2;
using fftcore::kMaxLogN;
using fftcore::kThreads;
using fftcore::row_pitch;
using fftcore::Split;
using fftcore::sw;
using fftcore::tile_log;
using fftpersist::Plan;

// butterfly layers a step: the forward is fastest with 5, the inverse
// (which reads twice the input in pass 1) with 4 (PERF.md, PR 5)
template <bool kInverse>
constexpr int kMaxLayers = kInverse ? 4 : 5;

// Pass 2 on row tile `tile` of candidate b from its scratch slot m.
template <bool kInverse, bool kHalf>
__device__ __forceinline__ void rows_tile(
    const Plan& p, const float2* __restrict__ m, float* __restrict__ yr,
    float* __restrict__ yi, float2* s, const float2* tw2, int b, int tile) {
  const Split& sp = p.sp;
  const int pitch = row_pitch(sp.n2);
  const int rows = 1 << p.log_rows;
  const int a = tile << p.log_rows;
  const long long base = (long long)b * p.out_len;
  const int items = rows << sp.log_n2;
#pragma unroll 8
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int j = it & (sp.n2 - 1);
    const int r = it >> sp.log_n2;
    s[r * pitch + sw(j)] = __ldcg(m + ((long long)(a + r) << sp.log_n2) + j);
  }
  fftcore::fft_rows_dif_wide<kInverse, kHalf, kMaxLayers<kInverse>>(
      s, rows, pitch, sp.log_n2, tw2);

  // bin (k2, a + r) sits at position q = bitrev(k2) of row r; neighbouring
  // threads take neighbouring rows, so each k2 is one run of `rows` floats
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int r = it & (rows - 1);
    const int q = it >> p.log_rows;
    if (kHalf && (q & 1)) continue;  // bins from n/2 on: not formed
    const long long k = (long long)bitrev(q, sp.log_n2) * sp.n1 + a + r;
    if (k < p.out_len) {
      const float2 v = s[r * pitch + sw(q)];
      __stcs(yr + base + k, v.x);
      __stcs(yi + base + k, v.y);
    }
  }
}

// Two blocks an SM: at most 128 registers a thread (unbounded, the
// five-layer steps took 211, one block an SM).
template <bool kInverse, bool kHalf>
__global__ void __launch_bounds__(kThreads, 2) fft_fused_kernel(
    const float* __restrict__ zr, const float* __restrict__ zi,
    float* __restrict__ yr, float* __restrict__ yi,
    float2* __restrict__ scratch, const float2* __restrict__ tw,
    const float2* __restrict__ roots, int* __restrict__ counters, Plan p) {
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
        fftpersist::cols_tile<kInverse, kMaxLayers<kInverse>>(
            p, zr, zi, slot, roots, s, tw1, c, r);
      },
      [&](int c, int r, const float2* slot) {
        rows_tile<kInverse, kHalf>(p, slot, yr, yi, s, tw2, c, r);
      });
}

template <bool kInverse, bool kHalf>
int run(const float* zr, const float* zi, float* yr, float* yi,
        float2* scratch, const float2* tw, const float2* roots,
        int* counters, const Plan& p, cudaStream_t stream) {
  auto kernel = fft_fused_kernel<kInverse, kHalf>;
  const size_t smem =
      ((size_t)(p.sp.n1 >> 1) + (size_t)(p.sp.n2 >> 1) +
       std::max((size_t)row_pitch(p.sp.n1) << p.log_cw,
                (size_t)row_pitch(p.sp.n2) << p.log_rows)) *
      sizeof(float2);
  int err = fftcore::allow_smem(kernel, smem);
  if (err != 0) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
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
  kernel<<<grid, kThreads, smem, stream>>>(zr, zi, yr, yi, scratch, tw,
                                           roots, counters, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The scratch slots the kernel needs (candidates of n float2 each).
extern "C" int fft_fused_scratch_slots() { return fftpersist::kRing; }

// K10. zr, zi: B rows of in_len floats, row r at r*in_stride; yr, yi
// (B, out_len) contiguous; scratch kRing*n float2 (fft_persist.cuh); tw
// the n1/2 twiddles
// W_n1^j = exp(-2 pi i j / n1) as float2; roots the n2 coarse roots
// W_n^(h*n1), h < n2, then the n1 fine ones W_n^l, l < n1; counters
// 1 + 2B ints (zeroed here); sign -1 or +1.
extern "C" int fft_fused_launch(const float* zr, const float* zi,
                                long long in_stride, float* yr, float* yi,
                                void* scratch, const void* tw,
                                const void* roots, int* counters, int B,
                                int in_len, int n1, int n2, int out_len,
                                int sign, void* stream_) {
  if (n1 < 2 || n2 < 2 || (n1 & (n1 - 1)) != 0 || (n2 & (n2 - 1)) != 0 ||
      n2 > n1)
    return cudaErrorInvalidValue;
  const int log_n1 = ilog2(n1), log_n2 = ilog2(n2);
  const int n = n1 << log_n2;
  if (log_n1 + log_n2 > kMaxLogN || B < 1 || in_len < n2 || in_len > n ||
      (in_len & (n2 - 1)) != 0 || in_stride < in_len || out_len < 1 ||
      out_len > n || (sign != 1 && sign != -1))
    return cudaErrorInvalidValue;
  Plan p;
  p.sp = Split{n, n1, n2, log_n1, log_n2};
  p.log_cw = std::min(tile_log(n1), log_n2);
  p.log_rows = std::min(tile_log(n2), log_n1);
  p.B = B;
  p.in_rows = in_len >> log_n2;
  p.out_len = out_len;
  p.in_stride = in_stride;
  p.n_p1 = n2 >> p.log_cw;
  p.n_p2 = n1 >> p.log_rows;
  p.pass1_only = 0;
  if ((long long)B * (p.n_p1 + p.n_p2) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  float2* s = static_cast<float2*>(scratch);
  const float2* w = static_cast<const float2*>(tw);
  const float2* rt = static_cast<const float2*>(roots);
  cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const bool half = 2LL * out_len <= n;
  if (sign < 0)
    return half ? run<false, true>(zr, zi, yr, yi, s, w, rt, counters, p, st)
                : run<false, false>(zr, zi, yr, yi, s, w, rt, counters, p,
                                    st);
  return half ? run<true, true>(zr, zi, yr, yi, s, w, rt, counters, p, st)
              : run<true, false>(zr, zi, yr, yi, s, w, rt, counters, p, st);
}
