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
// in or out). The math is rp_response.cuh's: each stage's Terms
// (stage_terms) and the per-bin response (rp_coeffs_staged, rp_apply), the
// operations of the plain PyTorch version
// (st_ito_torch/ops/kernels/packed_response.py) in its order, but for the
// approximate divide and one sincosf (FastMath, as K3 takes them) and the
// fused multiply-adds of nvcc's contraction: within 1.3e-6 x max|Y| of it
// on the card, also on the delay's comb resonances (PERF.md).
//
// Bound: memory. It reads 4 and writes 4 (B, F) float32 arrays: 4.3 GB at
// the headline B = 512, F = 262145, about 1.3 ms at 3.35 TB/s; its ~290
// float32 operations a (candidate, bin) take 0.58 ms at 67 TFLOP/s. On the
// card the instructions issued are the limit: with IEEE division (18 a
// (candidate, bin), each with its slow-path check), a cosf and a sinf,
// and each stage's candidate-only terms formed for every bin, the kernel
// took 3.9 ms against 1.6 for its loads and stores alone (PERF.md). The
// design:
//
//   - one thread owns one bin, loads that bin's 38 Freeverb table values
//     (candidate-independent, built once per (sample rate, n) and cached on
//     the device by the caller) into registers once, then walks a chunk of
//     candidates. Consecutive blocks share a frequency tile (the candidate
//     chunk is the fastest grid axis), so the table tile is read from
//     device memory once and from L2 after. The ragged frequency edge is
//     masked in the kernel; nothing is padded;
//   - each block computes the Terms of its candidates once into shared
//     memory (the delay's Di, Df, fb and mix, the reverb's g, d, wet and
//     width, a gain's powf, a widener's a - b and b, every bypass weight),
//     which the per-bin math then reads;
//   - the approximate divide and one sincosf of the same rounded phase;
//     the delay's phase and denominator stay unfused (__fmul_rn,
//     __fadd_rn), since a resonance magnifies their last bit a
//     thousandfold.
//
// C entry points: packed_response_launch(...) (K9) and
// packed_response_padded_launch(...) (K2) return cudaGetLastError(), or
// cudaErrorInvalidValue for a stage code they do not know. Their `stage`
// is -1 for the kernel, or a stage timer's probe: 0 the loads and stores
// alone (Y = Z), 1 the response with IeeeMath, 2 with FastMath (the
// kernel's arithmetic).

#include <cuda_runtime.h>

#include <type_traits>

#include "rp_response.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCandPerBlock = 64;

// kMode: what the kernel computes, a stage timer's probes beside it: kCopy
// the loads and stores alone (Y = Z), kIeee the response with IeeeMath,
// kFast with FastMath (the kernel).
enum Mode : int { kCopy = 0, kIeee = 1, kFast = 2 };

template <int kMode>
__global__ void __launch_bounds__(kThreads) packed_response_kernel(
    const float* __restrict__ zr, const float* __restrict__ zi,
    const float* __restrict__ zrr, const float* __restrict__ zri,
    float* __restrict__ ylo_r, float* __restrict__ ylo_i,
    float* __restrict__ yhi_r, float* __restrict__ yhi_i, rp::Stages st,
    int F, long long pitch) {
  using M = typename std::conditional<kMode == kIeee, rp::IeeeMath,
                                      rp::FastMath>::type;
  // the Terms and bypass weights of the block's candidates,
  // [candidate][stage], computed once
  __shared__ rp::Terms terms[kCandPerBlock * rp::kMaxStages];
  __shared__ float active[kCandPerBlock * rp::kMaxStages];
  const int b_begin = blockIdx.x * kCandPerBlock;
  const int nb = min(st.B - b_begin, kCandPerBlock);
  if (kMode != kCopy) {
    for (int i = threadIdx.x; i < nb * st.n_stages; i += kThreads) {
      const int b = b_begin + i / st.n_stages, s = i % st.n_stages;
      terms[i] = rp::stage_terms(st, s, b);
      if (st.active != nullptr)
        active[i] = st.active[(long long)s * st.B + b];
    }
    __syncthreads();
  }
  const int k = blockIdx.y * kThreads + threadIdx.x;
  if (k >= F) return;

  float tab[rp::kFreeverbRows];
  if (kMode != kCopy) rp::load_table(st, k, tab);
  const bool edge = (k == 0) || (k == F - 1);

  for (int c = 0; c < nb; ++c) {
    const long long idx = (long long)(b_begin + c) * pitch + k;
    if (kMode == kCopy) {
      ylo_r[idx] = zr[idx];
      ylo_i[idx] = zi[idx];
      yhi_r[idx] = zrr[idx];
      yhi_i[idx] = zri[idx];
      continue;
    }
    const rp::Coeffs cf = rp::rp_coeffs_staged<M>(
        st, terms + c * st.n_stages, active + c * st.n_stages,
        rp::ArrayTab{tab}, k);
    float lo_r, lo_i, hi_r, hi_i;
    rp::rp_apply(cf, edge, zr[idx], zi[idx], zrr[idx], zri[idx], lo_r, lo_i,
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
           int stage, void* stream) {
  if (F < 2 || n != 2 * (F - 1) || pitch < F || stage > kFast)
    return cudaErrorInvalidValue;
  const rp::Stages st{codes, n_stages, params, active, table, F,
                      B,     n,        w0,     sr};
  if (rp::check_stages(st) != 0) return cudaErrorInvalidValue;
  const dim3 grid((B + kCandPerBlock - 1) / kCandPerBlock,
                  (F + kThreads - 1) / kThreads);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  auto kernel = stage == kCopy   ? packed_response_kernel<kCopy>
                : stage == kIeee ? packed_response_kernel<kIeee>
                                 : packed_response_kernel<kFast>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
    float sr, int stage, void* stream) {
  return launch(zr, zi, zrr, zri, ylo_r, ylo_i, yhi_r, yhi_i, codes,
                n_stages, params, active, table, B, F, F, n, w0, sr, stage,
                stream);
}

// K2: rows of pitch Fp holding F valid bins each.
extern "C" int packed_response_padded_launch(
    const float* zr, const float* zi, const float* zrr, const float* zri,
    float* ylo_r, float* ylo_i, float* yhi_r, float* yhi_i,
    unsigned int codes, int n_stages, const float* params,
    const float* active, const float* table, int B, int F, int Fp, int n,
    float w0, float sr, int stage, void* stream) {
  return launch(zr, zi, zrr, zri, ylo_r, ylo_i, yhi_r, yhi_i, codes,
                n_stages, params, active, table, B, F, Fp, n, w0, sr, stage,
                stream);
}
