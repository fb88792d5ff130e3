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
// so the same split runs as two __global__ passes through a scratch in
// device memory, on the shared-memory butterflies of fft_core.cuh, with
// n = n1*n2, sample t = j1*n2 + j2 and bin k = k2*n1 + k1:
//
//   pass 1 (cols_kernel): a block takes a tile of adjacent j2 columns for
//     all j1, reads the rows j1 < in_len/n2 (the rest is the implicit zero
//     pad, never read), transforms each column over j1 (length n1),
//     multiplies by the twiddle W^(k1*j2) and writes M[k1][j2] to scratch;
//   pass 2 (rows_kernel): a block takes a tile of whole rows k1, transforms
//     each over j2 (length n2) and writes X[k2*n1 + k1] for the bins below
//     out_len only.
//
// This is K5's forward split (mega_fft.cu) on planar rows instead of the
// packed stereo pair, without the mirror rows, and with the sign as a
// template parameter. Tiles make the strided side of each pass 32- or
// 64-byte runs and the other side whole rows; the input takes a row stride,
// so the two channels of a (B, 2, T) signal are read in place. The twiddle's
// integer product k1*j2 < n is exact, and sincospif() takes it as the exact
// fraction 2*k1*j2/n.
//
// The scratch holds `chunk` candidates (n float2 each); the entry point
// walks the population chunk by chunk on the caller's stream.
//
// Bound at the headline (B 512, n 2^19): the forward reads 2 x 512 x 2^18
// floats and writes 2 x 512 x 2^19 (3.2 GB, 0.96 ms at 3.35 TB/s) against
// 5 n log2(n) B = 25.5 G float32 operations (0.38 ms): bytes; the inverse
// moves the same bytes the other way. As for K5, the kernel's own cost is
// the shared-memory traffic of the butterflies and the scratch round trip.
//
// C entry point: fft_fused_launch(...) returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take.

#include <cuda_runtime.h>

#include "fft_core.cuh"

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

template <bool kInverse>
__global__ void __launch_bounds__(kThreads) cols_kernel(
    const float* __restrict__ zr, const float* __restrict__ zi,
    long long in_stride, float2* __restrict__ scratch,
    const float2* __restrict__ tw, Split sp, int b0, int in_rows,
    int log_cw) {
  extern __shared__ float2 smem[];
  float2* tw_s = smem;
  float2* s = smem + (sp.n1 >> 1);
  const int pitch = row_pitch(sp.n1);
  const int cw = 1 << log_cw;
  const int j2_0 = blockIdx.x << log_cw;
  const long long base = (long long)(b0 + blockIdx.y) * in_stride;

  fftcore::load_twiddles(tw_s, tw, sp.n1 >> 1, 1);
  const int items = sp.n1 << log_cw;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int c = it & (cw - 1);
    const int j1 = it >> log_cw;
    float2 v = make_float2(0.0f, 0.0f);
    if (j1 < in_rows) {
      const long long t = base + ((long long)j1 << sp.log_n2) + j2_0 + c;
      v = make_float2(zr[t], zi[t]);
    }
    s[c * pitch + sw(j1)] = v;
  }
  fftcore::fft_rows_dif<kInverse>(s, cw, pitch, sp.log_n1, tw_s);

  float2* m = scratch + (long long)blockIdx.y * sp.n;
  const float step = (kInverse ? 2.0f : -2.0f) / (float)sp.n;
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

template <bool kInverse>
__global__ void __launch_bounds__(kThreads) rows_kernel(
    const float2* __restrict__ scratch, float* __restrict__ yr,
    float* __restrict__ yi, const float2* __restrict__ tw, Split sp, int b0,
    int out_len, int log_rows) {
  extern __shared__ float2 smem[];
  float2* tw_s = smem;
  float2* s = smem + (sp.n2 >> 1);
  const int pitch = row_pitch(sp.n2);
  const int rows = 1 << log_rows;
  const int a = blockIdx.y << log_rows;
  const float2* m = scratch + (long long)blockIdx.x * sp.n;
  const long long base = (long long)(b0 + blockIdx.x) * out_len;

  fftcore::load_twiddles(tw_s, tw, sp.n2 >> 1, sp.n1 >> sp.log_n2);
  const int items = rows << sp.log_n2;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int j = it & (sp.n2 - 1);
    const int r = it >> sp.log_n2;
    s[r * pitch + sw(j)] = m[((long long)(a + r) << sp.log_n2) + j];
  }
  fftcore::fft_rows_dif<kInverse>(s, rows, pitch, sp.log_n2, tw_s);

  // bin (k2, a + r) sits at position q = bitrev(k2) of row r; neighbouring
  // threads take neighbouring rows, so each k2 is one run of `rows` floats
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int r = it & (rows - 1);
    const int q = it >> log_rows;
    const long long k =
        (long long)bitrev(q, sp.log_n2) * sp.n1 + a + r;
    if (k < out_len) {
      const float2 v = s[r * pitch + sw(q)];
      yr[base + k] = v.x;
      yi[base + k] = v.y;
    }
  }
}

template <bool kInverse>
int run(const float* zr, const float* zi, long long in_stride, float* yr,
        float* yi, float2* scratch, const float2* tw, int B, int in_len,
        const Split& sp, int out_len, int chunk, cudaStream_t stream) {
  const int log_cw = min(tile_log(sp.n1), sp.log_n2);
  const int log_rows = min(tile_log(sp.n2), sp.log_n1);
  const size_t smem1 = smem_bytes(sp.n1, log_cw);
  const size_t smem2 = smem_bytes(sp.n2, log_rows);
  int err = allow_smem(cols_kernel<kInverse>, smem1);
  if (err == 0) err = allow_smem(rows_kernel<kInverse>, smem2);
  if (err != 0) return err;
  const int in_rows = in_len >> sp.log_n2;
  for (int b0 = 0; b0 < B; b0 += chunk) {
    const int nb = min(chunk, B - b0);
    cols_kernel<kInverse>
        <<<dim3(sp.n2 >> log_cw, nb), kThreads, smem1, stream>>>(
            zr, zi, in_stride, scratch, tw, sp, b0, in_rows, log_cw);
    rows_kernel<kInverse>
        <<<dim3(nb, sp.n1 >> log_rows), kThreads, smem2, stream>>>(
            scratch, yr, yi, tw, sp, b0, out_len, log_rows);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// K10. zr, zi: B rows of in_len floats, row r at r*in_stride; yr, yi
// (B, out_len) contiguous; scratch chunk*n float2; tw the n1/2 twiddles
// W_n1^j = exp(-2 pi i j / n1) as float2; sign -1 or +1.
extern "C" int fft_fused_launch(const float* zr, const float* zi,
                                long long in_stride, float* yr, float* yi,
                                void* scratch, const void* tw, int B,
                                int in_len, int n1, int n2, int out_len,
                                int chunk, int sign, void* stream_) {
  if (n1 < 2 || n2 < 2 || (n1 & (n1 - 1)) != 0 || (n2 & (n2 - 1)) != 0 ||
      n2 > n1)
    return cudaErrorInvalidValue;
  const int log_n1 = ilog2(n1), log_n2 = ilog2(n2);
  const int n = n1 << log_n2;
  if (log_n1 + log_n2 > kMaxLogN || B < 1 || chunk < 1 || chunk > 65535 ||
      in_len < n2 || in_len > n || (in_len & (n2 - 1)) != 0 ||
      in_stride < in_len || out_len < 1 || out_len > n ||
      (sign != 1 && sign != -1))
    return cudaErrorInvalidValue;
  const Split sp{n, n1, n2, log_n1, log_n2};
  float2* s = static_cast<float2*>(scratch);
  const float2* w = static_cast<const float2*>(tw);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  return sign < 0 ? run<false>(zr, zi, in_stride, yr, yi, s, w, B, in_len,
                               sp, out_len, chunk, stream)
                  : run<true>(zr, zi, in_stride, yr, yi, s, w, B, in_len,
                              sp, out_len, chunk, stream);
}
