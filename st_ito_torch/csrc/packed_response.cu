// K9 and K2 on Hopper: the fused LTI response construction + packed
// hermitian apply, on the flat half grid (K9) and on the pitched one (K2).
//
// K9 replaces st_ito_tpu/ops/pallas/packed_response.py:133
// packed_response_apply_rp (kernel _make_kernel, packed_response.py:68);
// K2 replaces packed_response.py:267 packed_response_apply_rp_padded (kernel
// _make_kernel_3d, :210). Both are one __global__ function: every array is
// a row per candidate with bin k at index k, F = n/2 + 1 valid bins and a
// row pitch that is F for K9 and Fp = Rp*n1 >= F for K2 (the half grid the
// FFT kernels of mega_fft.cu write and read; bins past F are never touched,
// in or out). The per-bin math is rp_coeffs() and rp_apply() of
// rp_response.cuh; the plain
// PyTorch version (st_ito_torch/ops/kernels/packed_response.py) runs the
// same operations in the same order on the full (B, F) grid.
//
// Bound: memory. It reads 4 and writes 4 (B, F) float32 arrays: 4.3 GB at
// the headline B = 512, F = 262145, about 1.3 ms at 3.35 TB/s. The design
// keeps everything else out of device memory: one thread owns one bin,
// loads that bin's 38 Freeverb table values (candidate-independent, built
// once per (sample rate, n) and cached on the device by the caller) into
// registers once, then walks a chunk of candidates. Consecutive blocks
// share a frequency tile (the candidate chunk is the fastest grid axis),
// so the table tile is read from device memory once and from L2 after.
// The ragged frequency edge is masked in the kernel; nothing is padded.
//
// C entry points: packed_response_launch(...) (K9) and
// packed_response_padded_launch(...) (K2) return cudaGetLastError(), or
// cudaErrorInvalidValue for a stage code they do not know.

#include <cuda_runtime.h>

#include "rp_response.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCandPerBlock = 64;

__global__ void __launch_bounds__(kThreads) packed_response_kernel(
    const float* __restrict__ zr, const float* __restrict__ zi,
    const float* __restrict__ zrr, const float* __restrict__ zri,
    float* __restrict__ ylo_r, float* __restrict__ ylo_i,
    float* __restrict__ yhi_r, float* __restrict__ yhi_i, rp::Stages st,
    int F, long long pitch) {
  const int k = blockIdx.y * kThreads + threadIdx.x;
  if (k >= F) return;
  const int b_begin = blockIdx.x * kCandPerBlock;
  const int b_end = min(st.B, b_begin + kCandPerBlock);

  float tab[rp::kFreeverbRows];
  rp::load_table(st, k, tab);
  const bool edge = (k == 0) || (k == F - 1);

  for (int b = b_begin; b < b_end; ++b) {
    const rp::Coeffs c = rp::rp_coeffs(st, rp::ArrayTab{tab}, b, k);
    const long long idx = (long long)b * pitch + k;
    float lo_r, lo_i, hi_r, hi_i;
    rp::rp_apply(c, edge, zr[idx], zi[idx], zrr[idx], zri[idx], lo_r, lo_i,
                 hi_r, hi_i);
    ylo_r[idx] = lo_r;
    ylo_i[idx] = lo_i;
    yhi_r[idx] = hi_r;
    yhi_i[idx] = hi_i;
  }
}

int launch(const float* zr, const float* zi, const float* zrr,
           const float* zri, float* ylo_r, float* ylo_i, float* yhi_r,
           float* yhi_i, unsigned int codes, int n_stages,
           const float* params, const float* active, const float* table,
           int B, int F, long long pitch, int n, float w0, float sr,
           void* stream) {
  if (F < 2 || n != 2 * (F - 1) || pitch < F) return cudaErrorInvalidValue;
  const rp::Stages st{codes, n_stages, params, active, table, F,
                      B,     n,        w0,     sr};
  if (rp::check_stages(st) != 0) return cudaErrorInvalidValue;
  const dim3 grid((B + kCandPerBlock - 1) / kCandPerBlock,
                  (F + kThreads - 1) / kThreads);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  packed_response_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      zr, zi, zrr, zri, ylo_r, ylo_i, yhi_r, yhi_i, st, F, pitch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K9: rows of F bins, nothing between them.
extern "C" int packed_response_launch(
    const float* zr, const float* zi, const float* zrr, const float* zri,
    float* ylo_r, float* ylo_i, float* yhi_r, float* yhi_i,
    unsigned int codes, int n_stages, const float* params,
    const float* active, const float* table, int B, int F, int n, float w0,
    float sr, void* stream) {
  return launch(zr, zi, zrr, zri, ylo_r, ylo_i, yhi_r, yhi_i, codes,
                n_stages, params, active, table, B, F, F, n, w0, sr, stream);
}

// K2: rows of pitch Fp holding F valid bins each.
extern "C" int packed_response_padded_launch(
    const float* zr, const float* zi, const float* zrr, const float* zri,
    float* ylo_r, float* ylo_i, float* yhi_r, float* yhi_i,
    unsigned int codes, int n_stages, const float* params,
    const float* active, const float* table, int B, int F, int Fp, int n,
    float w0, float sr, void* stream) {
  return launch(zr, zi, zrr, zri, ylo_r, ylo_i, yhi_r, yhi_i, codes,
                n_stages, params, active, table, B, F, Fp, n, w0, sr, stream);
}
