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
// __global__ passes behind one C entry point, with n = n1*n2, sample
// t = j1*n2 + j2 and bin k = k2*n1 + k1:
//
//   forward, pass 1 (fwd_cols): a block takes a tile of adjacent j2 columns
//     for all j1, transforms each over j1 (length n1), multiplies by the
//     twiddle W_n^(k1*j2) and writes M[k1][j2] to scratch;
//   forward, pass 2 (fwd_rows): a block takes a tile of rows k1 together
//     with their mirror rows n1-k1, transforms each over j2 (length n2) and
//     so holds Z[k] and Z[(n-k) mod n] for every bin of its columns: the
//     mirror of (k2, k1) is (n2-1-k2, n1-k1) for k1 >= 1 and
//     ((n2-k2) mod n2, 0) for k1 = 0; rows 0 and n1/2 mirror themselves and
//     share the first block. It emits (Zlo, Zrev), or applies the response
//     to them and emits (Ylo, Yhig);
//   inverse, pass A (inv_rows): a block takes a tile of columns k1, gathers
//     Y[k2*n1 + k1] over k2 from Ylo (lower half) and from Yhig at the
//     mirror bin (upper half), transforms over k2 (length n2), multiplies
//     by W_n^-(k1*j2) and writes A[k1][j2] to scratch;
//   inverse, pass B (inv_cols): a block takes a tile of columns j2 for all
//     k1, transforms over k1 (length n1) and writes the first T samples.
//
// Tiles make the strided sides of each pass 32- or 64-byte runs and the
// other side whole rows. The transforms are the shared-memory butterflies
// of fft_core.cuh (radix 2, up to three layers per trip through shared
// memory); the natural-order side of each is the one whose global accesses
// must be contiguous, the bit-reversed side is walked in shared-memory order
// (global runs at a stride do not care in which order they come). The
// twiddle's integer product k1*j2 < n is exact, and
// sincospif() takes it as the exact fraction 2*k1*j2/n.
//
// The scratch holds `chunk` candidates (n float2 each); the entry points
// walk the population chunk by chunk on the caller's stream. The chunk only
// bounds the scratch: measured on the card, keeping a chunk's intermediate
// inside the 50 MB L2 (8 candidates at n = 2^19) gains less than the short
// launches lose to their last, partly filled wave of blocks (PERF.md).
//
// Bounds at the headline (B 512, n 2^19, T 2^18): K5 and K4 move 3.2 GB
// (0.96 ms at 3.35 TB/s) against 25.5 G float32 operations (0.38 ms): bytes.
// K3 moves 3.3 GB against 61.7 G operations (0.92 ms): bytes, barely. The
// kernels' own cost is the shared-memory traffic of the butterflies and the
// scratch round trip, not either bound.
//
// Built with -fmad=false like packed_response.cu: K3's epilogue is then K2's
// arithmetic op for op on the same Z, so K3 equals K5 -> K2 bitwise, and the
// butterflies' cost is in their shared-memory exchanges, not their flops.
//
// C entry points return cudaGetLastError(), or cudaErrorInvalidValue for a
// shape they do not take.

#include <cuda_runtime.h>

#include "fft_core.cuh"
#include "rp_response.cuh"

namespace {

using fftcore::allow_smem;
using fftcore::bitrev;
using fftcore::cmul;
using fftcore::ilog2;
using fftcore::kMaxLogN;
using fftcore::kThreads;
using fftcore::row_pitch;
using fftcore::smem_bytes;
using fftcore::Split;
using fftcore::sw;
using fftcore::tile_log;

// ---------------------------------------------------------------- forward

__global__ void __launch_bounds__(kThreads) fwd_cols_kernel(
    const float* __restrict__ x, float2* __restrict__ scratch,
    const float2* __restrict__ tw, Split sp, int b0, int T, int log_cw) {
  extern __shared__ float2 smem[];
  float2* tw_s = smem;
  float2* s = smem + (sp.n1 >> 1);
  const int pitch = row_pitch(sp.n1);
  const int cw = 1 << log_cw;
  const int j2_0 = blockIdx.x << log_cw;
  const int in_rows = T >> sp.log_n2;
  const float* xl = x + (long long)(b0 + blockIdx.y) * 2 * T;
  const float* xr = xl + T;

  fftcore::load_twiddles(tw_s, tw, sp.n1 >> 1, 1);
  const int items = sp.n1 << log_cw;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int c = it & (cw - 1);
    const int j1 = it >> log_cw;
    float2 v = make_float2(0.0f, 0.0f);
    if (j1 < in_rows) {
      const long long t = ((long long)j1 << sp.log_n2) + j2_0 + c;
      v = make_float2(xl[t], xr[t]);
    }
    s[c * pitch + sw(j1)] = v;
  }
  fftcore::fft_rows_dif<false>(s, cw, pitch, sp.log_n1, tw_s);

  float2* m = scratch + (long long)blockIdx.y * sp.n;
  const float step = -2.0f / (float)sp.n;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int c = it & (cw - 1);
    const int q = it >> log_cw;
    const int k1 = bitrev(q, sp.log_n1);
    const int j2 = j2_0 + c;
    float sn, cs;
    sincospif(step * (float)(k1 * j2), &sn, &cs);
    m[((long long)k1 << sp.log_n2) + j2] =
        cmul(s[c * pitch + sw(q)], make_float2(cs, sn));
  }
}

// Row of slot sl in the block whose primary rows start at a: slots [0, R)
// are rows a..a+R-1, slots [R, 2R) their mirrors n1-k1; row 0 mirrors
// itself, so its mirror slot carries row n1/2 (which mirrors itself too).
__device__ __forceinline__ int slot_row(int sl, int a, int R, int n1) {
  if (sl < R) return a + sl;
  const int k1 = a + sl - R;
  return k1 == 0 ? (n1 >> 1) : n1 - k1;
}

template <bool kResp>
__global__ void __launch_bounds__(kThreads) fwd_rows_kernel(
    const float2* __restrict__ scratch, float* __restrict__ o_lo_r,
    float* __restrict__ o_lo_i, float* __restrict__ o_hi_r,
    float* __restrict__ o_hi_i, const float2* __restrict__ tw, Split sp,
    int b0, long long Fp, int log_rows, rp::Stages st) {
  extern __shared__ float2 smem[];
  float2* tw_s = smem;
  float2* s = smem + (sp.n2 >> 1);
  const int pitch = row_pitch(sp.n2);
  const int rows = 1 << log_rows;
  const int R = rows >> 1;
  const int a = blockIdx.y * R;
  const bool first = (a == 0);
  const int b = b0 + blockIdx.x;
  const float2* m = scratch + (long long)blockIdx.x * sp.n;

  fftcore::load_twiddles(tw_s, tw, sp.n2 >> 1, sp.n1 >> sp.log_n2);
  for (int it = threadIdx.x; it < (rows << sp.log_n2); it += blockDim.x) {
    const int j = it & (sp.n2 - 1);
    const int sl = it >> sp.log_n2;
    const int k1 = slot_row(sl, a, R, sp.n1);
    s[sl * pitch + sw(j)] = m[((long long)k1 << sp.log_n2) + j];
  }
  fftcore::fft_rows_dif<false>(s, rows, pitch, sp.log_n2, tw_s);

  // Bin (k2, k1) of slot sl sits at position q = bitrev(k2) of its row; the
  // bins of the half grid, k2 < n2/2, are the even q. One more bin, the
  // Nyquist (n2/2, 0) at q = 1 of row 0, goes to the first block's thread 0.
  const int main_items = rows << (sp.log_n2 - 1);
  const int items = main_items + ((first && threadIdx.x == 0) ? blockDim.x : 0);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    int sl, q;
    if (it < main_items) {
      sl = it & (rows - 1);
      q = (it >> log_rows) << 1;
    } else {
      sl = 0;
      q = 1;
    }
    const int k2 = bitrev(q, sp.log_n2);
    const int k1 = slot_row(sl, a, R, sp.n1);
    const bool self = first && (sl == 0 || sl == R);
    const int msl = self ? sl : (sl ^ R);
    const int mq = (first && sl == 0)
                       ? bitrev((sp.n2 - k2) & (sp.n2 - 1), sp.log_n2)
                       : sp.n2 - 1 - q;
    const int k = k2 * sp.n1 + k1;
    const long long idx = (long long)b * Fp + k;
    if (kResp) {
      float tab[rp::kFreeverbRows];
      rp::load_table(st, k, tab);
      const rp::Coeffs c = rp::rp_coeffs(st, tab, b, k);
      const float2 zlo = s[sl * pitch + sw(q)];
      const float2 zrev = s[msl * pitch + sw(mq)];
      float lo_r, lo_i, hi_r, hi_i;
      rp::rp_apply(c, k == 0 || k == (sp.n >> 1), zlo.x, zlo.y, zrev.x,
                   zrev.y, lo_r, lo_i, hi_r, hi_i);
      o_lo_r[idx] = lo_r;
      o_lo_i[idx] = lo_i;
      o_hi_r[idx] = hi_r;
      o_hi_i[idx] = hi_i;
    } else {
      const float2 zlo = s[sl * pitch + sw(q)];
      const float2 zrev = s[msl * pitch + sw(mq)];
      o_lo_r[idx] = zlo.x;
      o_lo_i[idx] = zlo.y;
      o_hi_r[idx] = zrev.x;
      o_hi_i[idx] = zrev.y;
    }
  }
}

// ---------------------------------------------------------------- inverse

__global__ void __launch_bounds__(kThreads) inv_rows_kernel(
    const float* __restrict__ ylo_r, const float* __restrict__ ylo_i,
    const float* __restrict__ yhi_r, const float* __restrict__ yhi_i,
    float2* __restrict__ scratch, const float2* __restrict__ tw, Split sp,
    int b0, long long Fp, int log_cw) {
  extern __shared__ float2 smem[];
  float2* tw_s = smem;
  float2* s = smem + (sp.n2 >> 1);
  const int pitch = row_pitch(sp.n2);
  const int cw = 1 << log_cw;
  const int a = blockIdx.y << log_cw;
  const long long base = (long long)(b0 + blockIdx.x) * Fp;
  const int half = sp.n2 >> 1;

  fftcore::load_twiddles(tw_s, tw, half, sp.n1 >> sp.log_n2);
  // Y[k2*n1 + k1] into position q = bitrev(k2) of column k1's row: from Ylo
  // in the lower half, from Yhig at the mirror bin in the upper half
  for (int it = threadIdx.x; it < (sp.n2 << log_cw); it += blockDim.x) {
    const int i = it & (cw - 1);
    const int q = it >> log_cw;
    const int k2 = bitrev(q, sp.log_n2);
    const int k1 = a + i;
    bool lo;
    int k;
    if (k1 != 0) {
      lo = k2 < half;
      k = lo ? k2 * sp.n1 + k1 : (sp.n2 - 1 - k2) * sp.n1 + (sp.n1 - k1);
    } else {
      lo = k2 <= half;
      k = lo ? k2 * sp.n1 : (sp.n2 - k2) * sp.n1;
    }
    s[i * pitch + sw(q)] = lo ? make_float2(ylo_r[base + k], ylo_i[base + k])
                          : make_float2(yhi_r[base + k], yhi_i[base + k]);
  }
  fftcore::fft_rows_dit<true>(s, cw, pitch, sp.log_n2, tw_s);

  float2* m = scratch + (long long)blockIdx.x * sp.n;
  const float step = 2.0f / (float)sp.n;
  for (int it = threadIdx.x; it < (cw << sp.log_n2); it += blockDim.x) {
    const int j2 = it & (sp.n2 - 1);
    const int i = it >> sp.log_n2;
    const int k1 = a + i;
    float sn, cs;
    sincospif(step * (float)(k1 * j2), &sn, &cs);
    m[((long long)k1 << sp.log_n2) + j2] =
        cmul(s[i * pitch + sw(j2)], make_float2(cs, sn));
  }
}

__global__ void __launch_bounds__(kThreads) inv_cols_kernel(
    const float2* __restrict__ scratch, float* __restrict__ y,
    const float2* __restrict__ tw, Split sp, int b0, int T, int log_cw) {
  extern __shared__ float2 smem[];
  float2* tw_s = smem;
  float2* s = smem + (sp.n1 >> 1);
  const int pitch = row_pitch(sp.n1);
  const int cw = 1 << log_cw;
  const int j2_0 = blockIdx.x << log_cw;
  const int out_rows = T >> sp.log_n2;
  const float2* m = scratch + (long long)blockIdx.y * sp.n;
  float* yl = y + (long long)(b0 + blockIdx.y) * 2 * T;
  float* yr = yl + T;

  fftcore::load_twiddles(tw_s, tw, sp.n1 >> 1, 1);
  const int items = sp.n1 << log_cw;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int c = it & (cw - 1);
    const int k1 = it >> log_cw;
    s[c * pitch + sw(k1)] = m[((long long)k1 << sp.log_n2) + j2_0 + c];
  }
  fftcore::fft_rows_dif<true>(s, cw, pitch, sp.log_n1, tw_s);

  const float scale = 1.0f / (float)sp.n;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int c = it & (cw - 1);
    const int q = it >> log_cw;
    const int j1 = bitrev(q, sp.log_n1);
    if (j1 < out_rows) {
      const float2 v = s[c * pitch + sw(q)];
      const long long t = ((long long)j1 << sp.log_n2) + j2_0 + c;
      yl[t] = v.x * scale;
      yr[t] = v.y * scale;
    }
  }
}

// ------------------------------------------------------------------- host

// 0 and the split, or cudaErrorInvalidValue
int make_split(int n1, int n2, int T, int B, int chunk, long long Fp,
               Split* sp) {
  if (n1 < 2 || n2 < 2 || (n1 & (n1 - 1)) != 0 || (n2 & (n2 - 1)) != 0 ||
      n2 > n1)
    return cudaErrorInvalidValue;
  const int log_n1 = ilog2(n1), log_n2 = ilog2(n2);
  if (log_n1 + log_n2 > kMaxLogN || B < 1 || chunk < 1 || T < 1 ||
      T > (n1 << log_n2) || (T & (n2 - 1)) != 0 ||
      Fp < ((long long)n1 << log_n2) / 2 + 1)
    return cudaErrorInvalidValue;
  *sp = Split{n1 << log_n2, n1, n2, log_n1, log_n2};
  return 0;
}

template <bool kResp>
int forward(const float* x, float* o0, float* o1, float* o2, float* o3,
            float2* scratch, const float2* tw, int B, int T, int n1, int n2,
            long long Fp, int chunk, const rp::Stages& st, void* stream_) {
  Split sp;
  if (make_split(n1, n2, T, B, chunk, Fp, &sp) != 0)
    return cudaErrorInvalidValue;
  const int log_cw = min(tile_log(n1), sp.log_n2);
  const int log_rows = min(tile_log(n2), sp.log_n1);
  if (log_rows < 1) return cudaErrorInvalidValue;  // a row and its mirror
  const size_t smem1 = smem_bytes(n1, log_cw);
  const size_t smem2 = smem_bytes(n2, log_rows);
  int err = allow_smem(fwd_cols_kernel, smem1);
  if (err == 0) err = allow_smem(fwd_rows_kernel<kResp>, smem2);
  if (err != 0) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  for (int b0 = 0; b0 < B; b0 += chunk) {
    const int nb = min(chunk, B - b0);
    fwd_cols_kernel<<<dim3(n2 >> log_cw, nb), kThreads, smem1, stream>>>(
        x, scratch, tw, sp, b0, T, log_cw);
    fwd_rows_kernel<kResp>
        <<<dim3(nb, n1 >> log_rows), kThreads, smem2, stream>>>(
            scratch, o0, o1, o2, o3, tw, sp, b0, Fp, log_rows, st);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// K5. x (B, 2, T); the four outputs (B, Fp); scratch chunk*n float2; tw the
// n1/2 twiddles W_n1^j as float2.
extern "C" int fwd_pack_fft_launch(const float* x, float* zlo_r, float* zlo_i,
                                   float* zrev_r, float* zrev_i,
                                   void* scratch, const void* tw, int B,
                                   int T, int n1, int n2, long long Fp,
                                   int chunk, void* stream) {
  if (chunk > 65535) return cudaErrorInvalidValue;
  return forward<false>(x, zlo_r, zlo_i, zrev_r, zrev_i,
                        static_cast<float2*>(scratch),
                        static_cast<const float2*>(tw), B, T, n1, n2, Fp,
                        chunk, rp::Stages{}, stream);
}

// K3. As K5, with the stages of packed_response_launch; table is the
// (38, table_pitch) Freeverb rows indexed by bin, or null.
extern "C" int fwd_pack_fft_response_launch(
    const float* x, float* ylo_r, float* ylo_i, float* yhi_r, float* yhi_i,
    void* scratch, const void* tw, int B, int T, int n1, int n2, long long Fp,
    int chunk, unsigned int codes, int n_stages, const float* params,
    const float* active, const float* table, long long table_pitch, float w0,
    float sr, void* stream) {
  if (chunk > 65535) return cudaErrorInvalidValue;
  const rp::Stages st{codes, n_stages,    params, active, table,
                      table_pitch, B,     n1 * n2, w0,    sr};
  if (rp::check_stages(st) != 0) return cudaErrorInvalidValue;
  return forward<true>(x, ylo_r, ylo_i, yhi_r, yhi_i,
                       static_cast<float2*>(scratch),
                       static_cast<const float2*>(tw), B, T, n1, n2, Fp,
                       chunk, st, stream);
}

// K4. The four inputs (B, Fp); y (B, 2, T).
extern "C" int inv_unpack_fft_launch(const float* ylo_r, const float* ylo_i,
                                     const float* yhi_r, const float* yhi_i,
                                     float* y, void* scratch_, const void* tw_,
                                     int B, int T, int n1, int n2,
                                     long long Fp, int chunk, void* stream_) {
  Split sp;
  if (chunk > 65535 || make_split(n1, n2, T, B, chunk, Fp, &sp) != 0)
    return cudaErrorInvalidValue;
  float2* scratch = static_cast<float2*>(scratch_);
  const float2* tw = static_cast<const float2*>(tw_);
  const int log_cols = min(tile_log(n2), sp.log_n1);
  const int log_cw = min(tile_log(n1), sp.log_n2);
  const size_t smem_a = smem_bytes(n2, log_cols);
  const size_t smem_b = smem_bytes(n1, log_cw);
  int err = allow_smem(inv_rows_kernel, smem_a);
  if (err == 0) err = allow_smem(inv_cols_kernel, smem_b);
  if (err != 0) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  for (int b0 = 0; b0 < B; b0 += chunk) {
    const int nb = min(chunk, B - b0);
    inv_rows_kernel<<<dim3(nb, n1 >> log_cols), kThreads, smem_a, stream>>>(
        ylo_r, ylo_i, yhi_r, yhi_i, scratch, tw, sp, b0, Fp, log_cols);
    inv_cols_kernel<<<dim3(n2 >> log_cw, nb), kThreads, smem_b, stream>>>(
        scratch, y, tw, sp, b0, T, log_cw);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}
