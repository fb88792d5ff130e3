// K9 on Hopper: the fused LTI response construction + packed hermitian apply.
//
// Replaces st_ito_tpu/ops/pallas/packed_response.py:133
// packed_response_apply_rp (kernel _make_kernel, packed_response.py:68).
// For each (candidate b, bin k) of the half grid k in [0, n/2] it evaluates
// every stage's response from the candidate's scalars and the bin's
// frequency terms (delay, gain, stereo widener, Freeverb: the real-pair math
// of st_ito_torch/chain/rp_responses.py), blends it toward identity where
// the stage is bypassed, composes the stages, and applies
//   Ylo[k]  = P Z[k] + Q conj(Zrev[k])
//   Yhig[k] = conj(Pc) Zrev[k] + conj(Qc) conj(Z[k])
// with the DC/Nyquist correction Ylo = (Ylo + Yhig)/2 at k = 0 and k = F-1.
// The plain PyTorch version (st_ito_torch/ops/kernels/packed_response.py)
// runs the same operations in the same order on the full (B, F) grid.
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
// The delay's phase index k*Di is formed in 64-bit integers before the mask
// to log2(n) bits: at k ~ 2^18 and Di ~ 48000 it leaves int32.
//
// C entry point: packed_response_launch(...) returns cudaGetLastError(), or
// cudaErrorInvalidValue for a stage code it does not know.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCandPerBlock = 64;
constexpr int kMaxStages = 8;
constexpr int kParamsPerStage = 4;
constexpr int kFreeverbRows = 38;
enum StageCode : int { kDelay = 0, kGain = 1, kWidener = 2, kReverb = 3 };

// A response: scalar kind uses v[0], v[1] = (Hr, Hi); monomix kind uses
// v[0..5] = (Dr, Di, GLr, GLi, GRr, GRi).
struct Resp {
  bool mono;
  float v[6];
};

__device__ __forceinline__ void cmul(float ar, float ai, float br, float bi,
                                     float& cr, float& ci) {
  cr = ar * br - ai * bi;
  ci = ar * bi + ai * br;
}

__device__ __forceinline__ Resp delay_build(const float* p, int B, float w,
                                            float w0, int k, int n, float sr) {
  const float D = p[0] * sr;
  const float fb = p[B] * 0.999f;
  const float mix = p[2 * B];
  const float Di = floorf(D);
  const float Df = D - Di;
  const long long m = ((long long)k * (long long)Di) & (long long)(n - 1);
  const float th = w0 * (float)m + w * Df;
  const float c = cosf(th);
  const float s = sinf(th);
  const float dr = 1.0f - fb * c;
  const float di = fb * s;
  const float idd = 1.0f / (dr * dr + di * di);
  const float hwr = (c * dr - s * di) * idd;
  const float hwi = -(c * di + s * dr) * idd;
  Resp r;
  r.mono = false;
  r.v[0] = (1.0f - mix) + mix * hwr;
  r.v[1] = mix * hwi;
  return r;
}

__device__ __forceinline__ Resp gain_build(const float* p) {
  Resp r;
  r.mono = false;
  r.v[0] = powf(10.0f, p[0] / 20.0f);
  r.v[1] = 0.0f;
  return r;
}

__device__ __forceinline__ Resp widener_build(const float* p) {
  const float width = p[0];
  const float sqrt2 = 1.4142135623730951f;
  const float mg = sqrtf(fminf(fmaxf(1.0f - width, 0.0f), 1.0f)) * sqrt2;
  const float sg = sqrtf(fminf(fmaxf(width, 0.0f), 1.0f)) * sqrt2;
  const float a = (mg + sg) / 2.0f;
  const float b = (mg - sg) / 2.0f;
  Resp r;
  r.mono = true;
  r.v[0] = a - b;
  r.v[1] = 0.0f;
  r.v[2] = b;
  r.v[3] = 0.0f;
  r.v[4] = b;
  r.v[5] = 0.0f;
  return r;
}

// sum of the 8 damped combs 1 / (conj(zD) - g/A), times the allpass product
__device__ __forceinline__ void freeverb_channel(const float* cc,
                                                 const float* ss, float apr,
                                                 float api, float gAr,
                                                 float gAi, float& hr,
                                                 float& hi) {
  float sr_ = 0.0f, si_ = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float wr = cc[j] - gAr;
    const float wi = ss[j] - gAi;
    const float idd = 1.0f / (wr * wr + wi * wi);
    const float r = wr * idd;
    const float i = -wi * idd;
    if (j == 0) {
      sr_ = r;
      si_ = i;
    } else {
      sr_ = sr_ + r;
      si_ = si_ + i;
    }
  }
  cmul(sr_, si_, apr, api, hr, hi);
}

// tab rows: cos1, sin1, combL_c[8], combL_s[8], combR_c[8], combR_s[8],
// apL_r, apL_i, apR_r, apR_i (chain/rp_responses.py FREEVERB_ROWS)
__device__ __forceinline__ Resp reverb_build(const float* p, int B,
                                             const float* tab) {
  const float fb = p[0] * 0.28f + 0.7f;
  const float d = p[B] * 0.4f;
  const float g = fb * (1.0f - d);
  const float wet = p[2 * B];
  const float width = p[3 * B];

  const float Ar = 1.0f - d * tab[0];
  const float Ai = d * tab[1];
  const float q = g / (Ar * Ar + Ai * Ai);
  const float gAr = q * Ar;
  const float gAi = -q * Ai;

  float HLr, HLi, HRr, HRi;
  freeverb_channel(tab + 2, tab + 10, tab[34], tab[35], gAr, gAi, HLr, HLi);
  freeverb_channel(tab + 18, tab + 26, tab[36], tab[37], gAr, gAi, HRr, HRi);

  const float gain_in = 0.015f;
  const float wet1 = 0.5f * wet * 3.0f * (1.0f + width) * gain_in;
  const float wet2 = 0.5f * wet * 3.0f * (1.0f - width) * gain_in;
  Resp r;
  r.mono = true;
  r.v[0] = (1.0f - wet) * 2.0f;
  r.v[1] = 0.0f;
  r.v[2] = wet1 * HLr + wet2 * HRr;
  r.v[3] = wet1 * HLi + wet2 * HRi;
  r.v[4] = wet1 * HRr + wet2 * HLr;
  r.v[5] = wet1 * HRi + wet2 * HLi;
  return r;
}

__device__ __forceinline__ void bypass(Resp& h, float a) {
  const float na = 1.0f - a;
  if (!h.mono) {
    h.v[0] = a * h.v[0] + na;
    h.v[1] = a * h.v[1];
  } else {
    h.v[0] = a * h.v[0] + na;
#pragma unroll
    for (int i = 1; i < 6; ++i) h.v[i] = a * h.v[i];
  }
}

// total response h_new . h_old (rp_responses.rp_compose)
__device__ __forceinline__ Resp compose(const Resp& o, const Resp& nw) {
  Resp r;
  if (!o.mono && !nw.mono) {
    r.mono = false;
    cmul(o.v[0], o.v[1], nw.v[0], nw.v[1], r.v[0], r.v[1]);
  } else if (!o.mono) {
    r.mono = true;
    cmul(o.v[0], o.v[1], nw.v[0], nw.v[1], r.v[0], r.v[1]);
    cmul(o.v[0], o.v[1], nw.v[2], nw.v[3], r.v[2], r.v[3]);
    cmul(o.v[0], o.v[1], nw.v[4], nw.v[5], r.v[4], r.v[5]);
  } else if (!nw.mono) {
    r.mono = true;
    cmul(o.v[0], o.v[1], nw.v[0], nw.v[1], r.v[0], r.v[1]);
    cmul(o.v[2], o.v[3], nw.v[0], nw.v[1], r.v[2], r.v[3]);
    cmul(o.v[4], o.v[5], nw.v[0], nw.v[1], r.v[4], r.v[5]);
  } else {
    r.mono = true;
    const float s1r = o.v[0] + o.v[2] + o.v[4];
    const float s1i = o.v[1] + o.v[3] + o.v[5];
    cmul(o.v[0], o.v[1], nw.v[0], nw.v[1], r.v[0], r.v[1]);
    float ar, ai, br, bi;
    cmul(nw.v[0], nw.v[1], o.v[2], o.v[3], ar, ai);
    cmul(s1r, s1i, nw.v[2], nw.v[3], br, bi);
    r.v[2] = ar + br;
    r.v[3] = ai + bi;
    cmul(nw.v[0], nw.v[1], o.v[4], o.v[5], ar, ai);
    cmul(s1r, s1i, nw.v[4], nw.v[5], br, bi);
    r.v[4] = ar + br;
    r.v[5] = ai + bi;
  }
  return r;
}

__global__ void __launch_bounds__(kThreads) packed_response_kernel(
    const float* __restrict__ zr, const float* __restrict__ zi,
    const float* __restrict__ zrr, const float* __restrict__ zri,
    float* __restrict__ ylo_r, float* __restrict__ ylo_i,
    float* __restrict__ yhi_r, float* __restrict__ yhi_i,
    unsigned int codes, int n_stages, const float* __restrict__ params,
    const float* __restrict__ active, const float* __restrict__ table,
    int B, int F, int n, float w0, float sr) {
  const int k = blockIdx.y * kThreads + threadIdx.x;
  if (k >= F) return;
  const int b_begin = blockIdx.x * kCandPerBlock;
  const int b_end = min(B, b_begin + kCandPerBlock);

  float tab[kFreeverbRows];
  if (table != nullptr) {
#pragma unroll
    for (int r = 0; r < kFreeverbRows; ++r) tab[r] = table[(long long)r * F + k];
  }
  const float w = w0 * (float)k;
  const bool edge = (k == 0) || (k == F - 1);

  for (int b = b_begin; b < b_end; ++b) {
    Resp h;
    for (int s = 0; s < n_stages; ++s) {
      const int code = (codes >> (4 * s)) & 0xF;
      const float* p = params + (long long)s * kParamsPerStage * B + b;
      Resp h2;
      if (code == kDelay) {
        h2 = delay_build(p, B, w, w0, k, n, sr);
      } else if (code == kGain) {
        h2 = gain_build(p);
      } else if (code == kWidener) {
        h2 = widener_build(p);
      } else {
        h2 = reverb_build(p, B, tab);
      }
      if (active != nullptr) bypass(h2, active[(long long)s * B + b]);
      h = (s == 0) ? h2 : compose(h, h2);
    }

    // packed coefficients (rp_responses.rp_packed_coeffs)
    float Pr, Pi, Qr, Qi, Pcr, Pci, Qcr, Qci;
    if (!h.mono) {
      Pr = h.v[0];
      Pi = h.v[1];
      Qr = 0.0f;
      Qi = 0.0f;
      Pcr = h.v[0];
      Pci = h.v[1];
      Qcr = 0.0f;
      Qci = 0.0f;
    } else {
      const float Dr = h.v[0], Di = h.v[1];
      const float GLr = h.v[2], GLi = h.v[3], GRr = h.v[4], GRi = h.v[5];
      const float A1r = GLr - GRi, A1i = GLi + GRr;
      const float A2r = GLr + GRi, A2i = GLi - GRr;
      Pr = Dr + 0.5f * (A1r + A1i);
      Pi = Di + 0.5f * (A1i - A1r);
      Qr = 0.5f * (A1r - A1i);
      Qi = 0.5f * (A1r + A1i);
      Pcr = Dr + 0.5f * (A2r - A2i);
      Pci = Di + 0.5f * (A2i + A2r);
      Qcr = 0.5f * (A2r + A2i);
      Qci = 0.5f * (A2i - A2r);
    }

    const long long idx = (long long)b * F + k;
    const float a_r = zr[idx], a_i = zi[idx], c_r = zrr[idx], c_i = zri[idx];
    float lo_r = Pr * a_r - Pi * a_i + Qr * c_r + Qi * c_i;
    float lo_i = Pr * a_i + Pi * a_r + Qi * c_r - Qr * c_i;
    const float hi_r = Pcr * c_r + Pci * c_i + Qcr * a_r - Qci * a_i;
    const float hi_i = Pcr * c_i - Pci * c_r - Qcr * a_i - Qci * a_r;
    if (edge) {
      lo_r = 0.5f * (lo_r + hi_r);
      lo_i = 0.5f * (lo_i + hi_i);
    }
    ylo_r[idx] = lo_r;
    ylo_i[idx] = lo_i;
    yhi_r[idx] = hi_r;
    yhi_i[idx] = hi_i;
  }
}

}  // namespace

extern "C" int packed_response_launch(
    const float* zr, const float* zi, const float* zrr, const float* zri,
    float* ylo_r, float* ylo_i, float* yhi_r, float* yhi_i,
    unsigned int codes, int n_stages, const float* params,
    const float* active, const float* table, int B, int F, int n, float w0,
    float sr, void* stream) {
  if (n_stages < 1 || n_stages > kMaxStages || B < 1 || F < 2 ||
      n != 2 * (F - 1) || (n & (n - 1)) != 0)
    return cudaErrorInvalidValue;
  for (int s = 0; s < n_stages; ++s) {
    const int code = (codes >> (4 * s)) & 0xF;
    if (code > kReverb) return cudaErrorInvalidValue;
    if (code == kReverb && table == nullptr) return cudaErrorInvalidValue;
  }
  const dim3 grid((B + kCandPerBlock - 1) / kCandPerBlock,
                  (F + kThreads - 1) / kThreads);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  packed_response_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      zr, zi, zrr, zri, ylo_r, ylo_i, yhi_r, yhi_i, codes, n_stages, params,
      active, table, B, F, n, w0, sr);
  return static_cast<int>(cudaGetLastError());
}
