// The persistent four-step FFT launch shared by K10 (fused_fft.cu) and
// K5, K3 and K4 (mega_fft.cu): a ticket scheduler over the two passes of
// the split n = n1*n2 (fft_core.cuh), a ring of scratch slots between
// them, and pass 1, the same in all four but for where its input comes
// from (K10, K5 and K3 read planar rows, cols_tile; K4 gathers the half
// grids and then runs cols_finish).
//
// One launch walks the whole population, one candidate a chunk. Its blocks
// take work items in ticket order from a counter: the pass-1 items of
// chunk c (its column tiles), then the pass-2 items of chunk c - kLag (its
// row tiles, the caller's), and so on, so pass 1 of later chunks overlaps
// pass 2 of earlier ones. A pass-2 item waits (on a counter in device
// memory) until all of its chunk's pass-1 items are written; a pass-1 item
// whose scratch slot was used kRing chunks earlier waits until that
// chunk's pass 2 has read it. A wait is only ever on an earlier ticket
// (kRing > kLag), held by a running block, so every wait ends. The
// scratch is a ring of kRing candidates (36 MB at n 2^19; with 5 the
// pass-1 items waited on their slots and K10 ran 40% slower), small enough
// to stay in the 50 MB L2. Inputs are read with the streaming cache hint
// and the scratch past L1 (a slot is reused, and L1 is not coherent).
//
// The twiddle W_n^(k1*j2) between the passes comes from two small tables
// of n-th roots (W_n^(h*n1) and W_n^l, k1*j2 = h*n1 + l), one complex
// product, instead of a sincospif per element; the transforms take up to
// kMaxL butterfly layers in registers between trips through shared memory
// (fft_rows_dif_wide).

#pragma once

#include <cuda_runtime.h>

#include "fft_core.cuh"

namespace fftpersist {

using fftcore::bitrev;
using fftcore::cmul;
using fftcore::kThreads;
using fftcore::row_pitch;
using fftcore::Split;
using fftcore::sw;

constexpr int kLag = 3;   // chunks between a chunk's pass 1 and its pass 2
constexpr int kRing = 9;  // scratch slots, one candidate each

struct Plan {
  Split sp;
  int log_cw, log_rows;  // the tiles: 2^log_cw columns, 2^log_rows rows
  int B, in_rows, out_len;
  long long in_stride;
  int n_p1, n_p2;  // items of a chunk in each pass
  int pass1_only;  // a stage timer's probe: the pass-1 items alone
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

// The tickets of a launch; it needs 1 + 2*B counters.
__host__ __device__ __forceinline__ int tickets(const Plan& p) {
  return p.B * (p.n_p1 + (p.pass1_only ? 0 : p.n_p2));
}

// The item of ticket t: (pass 1?, chunk, index within the chunk's pass).
// Stages s = 0, 1, ...: pass 1 of chunk s (s < B), then pass 2 of chunk
// s - kLag (s >= kLag).
__device__ __forceinline__ void decode(const Plan& p, int t, bool& first,
                                      int& c, int& r) {
  if (p.pass1_only) {
    first = true;
    c = t / p.n_p1;
    r = t % p.n_p1;
    return;
  }
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

// The rest of pass 1 on column tile `tile` once its columns are in shared
// memory (j1 at position sw(j1) of row c): the column transforms over j1
// (length n1), the twiddle, M[k1][j2] out to the slot m.
template <bool kInverse, int kMaxL>
__device__ __forceinline__ void cols_finish(const Plan& p,
                                            float2* __restrict__ m,
                                            const float2* __restrict__ roots,
                                            float2* s, const float2* tw1,
                                            int tile) {
  const Split& sp = p.sp;
  const int pitch = row_pitch(sp.n1);
  const int cw = 1 << p.log_cw;
  const int j2_0 = tile << p.log_cw;
  const int items = sp.n1 << p.log_cw;
  fftcore::fft_rows_dif_wide<kInverse, false, kMaxL>(s, cw, pitch,
                                                    sp.log_n1, tw1);

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

// Pass 1 on column tile `tile` of candidate b (rows zr, zi at b*in_stride)
// into its scratch slot m: the tile's columns j2 over all j1 (the rows
// j1 >= in_rows are the zero pad), then cols_finish.
template <bool kInverse, int kMaxL>
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
  cols_finish<kInverse, kMaxL>(p, m, roots, s, tw1, tile);
}

// The persistent loop of one block: tickets in order until none is left.
// A pass-1 item r of chunk (candidate) c is cols(c, r, slot), which writes
// the chunk's slot (cols_tile); a pass-2 item is rows(c, r, slot), which
// reads it. Waits are skipped for pass1_only.
template <class Cols, class Rows>
__device__ __forceinline__ void run(const Plan& p,
                                    float2* __restrict__ scratch,
                                    int* __restrict__ counters, Cols cols,
                                    Rows rows) {
  __shared__ int ticket;
  int* next = counters;
  int* p1_done = counters + 1;
  int* p2_done = p1_done + p.B;
  const int total = tickets(p);
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
    float2* slot = scratch + (long long)(c % kRing) * p.sp.n;
    if (first) {
      if (c >= kRing && !p.pass1_only) wait_for(p2_done + c - kRing, p.n_p2);
      cols(c, r, slot);
      signal(p1_done + c);
    } else {
      wait_for(p1_done + c, p.n_p1);
      rows(c, r, slot);
      signal(p2_done + c);
    }
  }
}

}  // namespace fftpersist
