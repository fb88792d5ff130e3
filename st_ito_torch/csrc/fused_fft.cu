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
//     chunk. Its blocks take work items in ticket order from a counter:
//     pass 1 of chunk c, then pass 2 of chunk c - kLag, and so on, so pass
//     1 of later chunks overlaps pass 2 of earlier ones. A pass-2 item
//     waits (on a counter in device memory) until all of its chunk's
//     pass-1 items are written; a pass-1 item whose scratch slot was used
//     kRing chunks earlier waits until that chunk's pass 2 has read it. A
//     wait is only ever on an earlier ticket, held by a running block, so
//     every wait ends. The scratch is a ring of kRing candidates (36 MB at
//     n 2^19; with 5 the pass-1 items waited on their slots and the
//     kernel ran 40% slower), small enough to stay in the 50 MB L2: its round trip does
//     not reach device memory, and no launch ends between chunks. Inputs
//     are read and outputs written with the streaming cache hints, so that
//     they do not push the scratch out of L2; the scratch is read past L1
//     (a slot is reused, and L1 is not coherent).
//   - The twiddle W_n^(k1*j2) between the passes comes from two small
//     tables of n-th roots (W_n^(h*n1) and W_n^l, k1*j2 = h*n1 + l), one
//     complex product, instead of a sincospif per element.
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

namespace {

using fftcore::bitrev;
using fftcore::cmul;
using fftcore::ilog2;
using fftcore::kMaxLogN;
using fftcore::kThreads;
using fftcore::row_pitch;
using fftcore::Split;
using fftcore::sw;
using fftcore::tile_log;

constexpr int kLag = 3;   // chunks between a chunk's pass 1 and its pass 2
constexpr int kRing = 9;  // scratch slots, one candidate each
// butterfly layers a step: the forward is fastest with 5, the inverse
// (which reads twice the input in pass 1) with 4 (PERF.md, PR 5)
template <bool kInverse>
constexpr int kMaxLayers = kInverse ? 4 : 5;

struct Plan {
  Split sp;
  int log_cw, log_rows;  // the tiles: 2^log_cw columns, 2^log_rows rows
  int B, in_rows, out_len;
  long long in_stride;
  int n_p1, n_p2;        // items of a chunk (one candidate) in each pass
};

// the counters: [0] the next ticket, then per chunk the pass-1 items
// written and the pass-2 items done
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void wait_for(const int* p, int want) {
  if (threadIdx.x == 0) {
    while (ld_acquire(p) < want) __nanosleep(64);
  }
  __syncthreads();
}

__device__ __forceinline__ void signal(int* p) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(p, 1);
}

// The item of ticket t: (pass 1?, chunk, index within the chunk's pass).
// Stages s = 0, 1, ...: pass 1 of chunk s (s < B), then pass 2 of chunk
// s - kLag (s >= kLag).
__device__ __forceinline__ void decode(const Plan& p, int t, bool& first,
                                      int& c, int& r) {
  const int lead = min(kLag, p.B);  // stages of pass 1 alone
  const int both = (p.B - lead) * (p.n_p1 + p.n_p2);
  if (t < lead * p.n_p1) {
    first = true;
    c = t / p.n_p1;
    r = t % p.n_p1;
  } else if (t < lead * p.n_p1 + both) {
    const int u = t - lead * p.n_p1;
    const int s = lead + u / (p.n_p1 + p.n_p2);
    r = u % (p.n_p1 + p.n_p2);
    first = r < p.n_p1;
    c = first ? s : s - kLag;
    if (!first) r -= p.n_p1;
  } else {
    const int v = t - lead * p.n_p1 - both;
    first = false;
    c = p.B - lead + v / p.n_p2;
    r = v % p.n_p2;
  }
}

// Pass 1 on column tile `tile` of candidate b into its scratch slot m.
template <bool kInverse>
__device__ __forceinline__ void cols_tile(
    const Plan& p, const float* __restrict__ zr, const float* __restrict__ zi,
    float2* __restrict__ m, const float2* __restrict__ roots, float2* s,
    const float2* tw1, int b, int tile) {
  const Split& sp = p.sp;
  const int pitch = row_pitch(sp.n1);
  const int cw = 1 << p.log_cw;
  const int j2_0 = tile << p.log_cw;
  const long long base = (long long)b * p.in_stride;
  const int items = sp.n1 << p.log_cw;
#pragma unroll 8
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int c = it & (cw - 1);
    const int j1 = it >> p.log_cw;
    float2 v = make_float2(0.0f, 0.0f);
    if (j1 < p.in_rows) {
      const long long t = base + ((long long)j1 << sp.log_n2) + j2_0 + c;
      v = make_float2(__ldcs(zr + t), __ldcs(zi + t));
    }
    s[c * pitch + sw(j1)] = v;
  }
  fftcore::fft_rows_dif_wide<kInverse, false, kMaxLayers<kInverse>>(
      s, cw, pitch, sp.log_n1, tw1);

  // W_n^(k1*j2) = W_n^(h*n1) * W_n^l with k1*j2 = h*n1 + l: roots holds
  // the n2 coarse roots, then the n1 fine ones
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int c = it & (cw - 1);
    const int q = it >> p.log_cw;
    const int k1 = bitrev(q, sp.log_n1);
    const int j2 = j2_0 + c;
    const int e = k1 * j2;
    float2 w = cmul(__ldg(roots + (e >> sp.log_n1)),
                    __ldg(roots + sp.n2 + (e & (sp.n1 - 1))));
    if (kInverse) w.y = -w.y;
    m[((long long)k1 << sp.log_n2) + j2] = cmul(s[c * pitch + sw(q)], w);
  }
}

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
  __shared__ int ticket;
  fftcore::load_twiddles(tw1, tw, sp.n1 >> 1, 1);
  fftcore::load_twiddles(tw2, tw, sp.n2 >> 1, sp.n1 >> sp.log_n2);

  int* next = counters;
  int* p1_done = counters + 1;
  int* p2_done = p1_done + p.B;
  const int total = p.B * (p.n_p1 + p.n_p2);
  // thread 0 takes the following ticket while the block works on one, so
  // the atomic's round trip overlaps the work; the smallest unfinished
  // ticket is always some block's current item, whose waits are on smaller
  // ones, so every wait still ends
  int following = threadIdx.x == 0 ? atomicAdd(next, 1) : 0;
  for (;;) {
    __syncthreads();  // the last item's reads of s and ticket are done
    if (threadIdx.x == 0) {
      ticket = following;
      if (following < total) following = atomicAdd(next, 1);
    }
    __syncthreads();
    const int t = ticket;
    if (t >= total) break;
    bool first;
    int c, r;
    decode(p, t, first, c, r);
    float2* slot = scratch + (long long)(c % kRing) * sp.n;
    if (first) {
      if (c >= kRing) wait_for(p2_done + c - kRing, p.n_p2);
      cols_tile<kInverse>(p, zr, zi, slot, roots, s, tw1, c, r);
      signal(p1_done + c);
    } else {
      wait_for(p1_done + c, p.n_p1);
      rows_tile<kInverse, kHalf>(p, slot, yr, yi, s, tw2, c, r);
      signal(p2_done + c);
    }
  }
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
  const int total = p.B * (p.n_p1 + p.n_p2);
  const int grid = std::min(total, per_sm * sms);
  kernel<<<grid, kThreads, smem, stream>>>(zr, zi, yr, yi, scratch, tw,
                                           roots, counters, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The scratch slots the kernel needs (candidates of n float2 each).
extern "C" int fft_fused_scratch_slots() { return kRing; }

// K10. zr, zi: B rows of in_len floats, row r at r*in_stride; yr, yi
// (B, out_len) contiguous; scratch kRing*n float2; tw the n1/2 twiddles
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
