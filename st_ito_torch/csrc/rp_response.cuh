// The per-bin response math of the fused LTI stages, shared by the three
// kernels that apply it: K9 and K2 (packed_response.cu) and K3's epilogue
// (mega_fft.cu). One copy, so the three compute the same operations in the
// same order (K3 takes the Freeverb phasors from another source).
//
// For one (candidate b, bin k) of the half grid k in [0, n/2] rp_coeffs()
// evaluates every stage's response from the candidate's Terms (what the
// stage takes from its scalars alone, stage_terms()) and the bin's
// frequency terms (delay, gain, stereo widener, Freeverb: the
// real-pair math of st_ito_torch/chain/rp_responses.py), blends it toward
// identity where the stage is bypassed and composes the stages; rp_apply()
// then applies
//   Ylo[k]  = P Z[k] + Q conj(Zrev[k])
//   Yhig[k] = conj(Pc) Zrev[k] + conj(Qc) conj(Z[k])
// with the DC/Nyquist correction Ylo = (Ylo + Yhig)/2 at k = 0 and k = n/2.
//
// The delay's phase index k*Di is formed in 64-bit integers before the mask
// to log2(n) bits: at k ~ 2^18 and Di ~ 48000 it leaves int32.

#pragma once

#include <cuda_runtime.h>

namespace rp {

constexpr int kMaxStages = 8;
constexpr int kParamsPerStage = 4;
constexpr int kFreeverbRows = 38;
enum StageCode : int { kDelay = 0, kGain = 1, kWidener = 2, kReverb = 3 };

// What every candidate and bin of one launch shares. params is
// (n_stages, kParamsPerStage, B) float32, active (n_stages, B) or null,
// table the (kFreeverbRows, table_pitch) Freeverb rows indexed by bin, or
// null when no stage is a reverb.
struct Stages {
  unsigned int codes;
  int n_stages;
  const float* params;
  const float* active;
  const float* table;
  long long table_pitch;
  int B;
  int n;
  float w0;  // 2 pi / n
  float sr;
};

// 0 when the stage list is one the kernels take, else cudaErrorInvalidValue
inline int check_stages(const Stages& st) {
  if (st.n_stages < 1 || st.n_stages > kMaxStages || st.B < 1 || st.n < 2 ||
      (st.n & (st.n - 1)) != 0)
    return cudaErrorInvalidValue;
  for (int s = 0; s < st.n_stages; ++s) {
    const int code = (st.codes >> (4 * s)) & 0xF;
    if (code > kReverb) return cudaErrorInvalidValue;
    if (code == kReverb &&
        (st.table == nullptr || st.table_pitch < st.n / 2 + 1))
      return cudaErrorInvalidValue;
  }
  return 0;
}

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

// How the response math divides and takes the delay's phasor. IeeeMath:
// IEEE division and cosf/sinf of the rounded phase, as the plain version
// computes them (a stage timer's probe of K9 and K2). FastMath (K3, K9,
// K2): the approximate divide (2 ulp, no call to a slow path) and one
// sincosf of the same rounded phase (near a comb's resonance the response
// magnifies a change of the phase's last bit a thousandfold, so the phase
// rounds as the plain version's does); inside K3's forward, which holds its
// registers to 128 around five-layer butterflies, IEEE division's
// slow-path call made the response math 2.5 times K2's cost on the card,
// and in K2 it took 0.6 ms of 3.7 (PERF.md).
struct IeeeMath {
  __device__ __forceinline__ static float div(float a, float b) {
    return a / b;
  }
  // (cos, sin) of the delay's phase w0*m + w*Df (w = w0*k, w0 = 2 pi / n)
  __device__ __forceinline__ static void cis(float w0, float w, long long m,
                                             int k, float Df, int n,
                                             float& c, float& s) {
    const float th = __fadd_rn(__fmul_rn(w0, (float)m), __fmul_rn(w, Df));
    c = cosf(th);
    s = sinf(th);
  }
};

struct FastMath {
  __device__ __forceinline__ static float div(float a, float b) {
    return __fdividef(a, b);
  }
  __device__ __forceinline__ static void cis(float w0, float w, long long m,
                                             int, float Df, int, float& c,
                                             float& s) {
    sincosf(__fadd_rn(__fmul_rn(w0, (float)m), __fmul_rn(w, Df)), &s, &c);
  }
};

// What a stage's response takes from its candidate and no bin changes
// (stage_terms): the delay's Di = floor(D), Df = D - Di, fb and mix (D =
// delay_seconds * sr); the reverb's g, d, wet and width; the gain's linear
// gain; the widener's a - b and b.
struct Terms {
  float v[4];
};

__device__ __forceinline__ Terms delay_terms(const float* p, int B,
                                             float sr) {
  const float D = __fmul_rn(p[0], sr);
  const float fb = __fmul_rn(p[B], 0.999f);
  const float mix = p[2 * B];
  const float Di = floorf(D);
  const float Df = D - Di;
  return Terms{{Di, Df, fb, mix}};
}

// The delay's response. Its phase and 1 - fb*e^(i th) are taken with
// rounded products and sums that no build contracts into a fused
// multiply-add (__fmul_rn, __fadd_rn): near a resonance (fb up to 0.999)
// the response magnifies their last bit a thousandfold, so they round as
// the plain version's do in every kernel, whatever its build's flags.
template <class M>
__device__ __forceinline__ Resp delay_build(const Terms& t, float w,
                                            float w0, int k, int n) {
  const float Di = t.v[0], Df = t.v[1], fb = t.v[2], mix = t.v[3];
  const long long m = ((long long)k * (long long)Di) & (long long)(n - 1);
  float c, s;
  M::cis(w0, w, m, k, Df, n, c, s);
  const float dr = 1.0f - __fmul_rn(fb, c);
  const float di = fb * s;
  const float idd =
      M::div(1.0f, __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di)));
  const float hwr = __fmul_rn(__fsub_rn(__fmul_rn(c, dr), __fmul_rn(s, di)),
                              idd);
  const float hwi =
      -__fmul_rn(__fadd_rn(__fmul_rn(c, di), __fmul_rn(s, dr)), idd);
  Resp r;
  r.mono = false;
  r.v[0] = (1.0f - mix) + mix * hwr;
  r.v[1] = mix * hwi;
  return r;
}

__device__ __forceinline__ Terms gain_terms(const float* p) {
  return Terms{{powf(10.0f, p[0] / 20.0f)}};
}

__device__ __forceinline__ Resp gain_build(const Terms& t) {
  Resp r;
  r.mono = false;
  r.v[0] = t.v[0];
  r.v[1] = 0.0f;
  return r;
}

__device__ __forceinline__ Terms widener_terms(const float* p) {
  const float width = p[0];
  const float sqrt2 = 1.4142135623730951f;
  const float mg = sqrtf(fminf(fmaxf(1.0f - width, 0.0f), 1.0f)) * sqrt2;
  const float sg = sqrtf(fminf(fmaxf(width, 0.0f), 1.0f)) * sqrt2;
  const float a = (mg + sg) / 2.0f;
  const float b = (mg - sg) / 2.0f;
  return Terms{{a - b, b}};
}

__device__ __forceinline__ Resp widener_build(const Terms& t) {
  Resp r;
  r.mono = true;
  r.v[0] = t.v[0];
  r.v[1] = 0.0f;
  r.v[2] = t.v[1];
  r.v[3] = 0.0f;
  r.v[4] = t.v[1];
  r.v[5] = 0.0f;
  return r;
}

// The Freeverb values of one bin, from the (kFreeverbRows, table_pitch)
// table of chain/rp_responses.py FREEVERB_ROWS held in registers: cos1,
// sin1, combL_c[8], combL_s[8], combR_c[8], combR_s[8], apL_r, apL_i,
// apR_r, apR_i. (K3 gives reverb_build another source of the same values,
// mega_fft.cu FactoredTab.)
struct ArrayTab {
  const float* t;

  __device__ __forceinline__ float2 z1() const {
    return make_float2(t[0], t[1]);
  }
  // conj(zD) of comb j of channel ch (0 L, 1 R) as (cos, sin)
  __device__ __forceinline__ float2 comb(int ch, int j) const {
    return make_float2(t[2 + 16 * ch + j], t[10 + 16 * ch + j]);
  }
  __device__ __forceinline__ float2 allpass(int ch) const {
    return make_float2(t[34 + 2 * ch], t[35 + 2 * ch]);
  }
};

// sum of the 8 damped combs 1 / (conj(zD) - g/A), times the allpass product
template <class M, class Tab>
__device__ __forceinline__ void freeverb_channel(const Tab& tab, int ch,
                                                 float gAr, float gAi,
                                                 float& hr, float& hi) {
  float sr_ = 0.0f, si_ = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 cs = tab.comb(ch, j);
    const float wr = cs.x - gAr;
    const float wi = cs.y - gAi;
    const float idd = M::div(1.0f, wr * wr + wi * wi);
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
  const float2 ap = tab.allpass(ch);
  cmul(sr_, si_, ap.x, ap.y, hr, hi);
}

__device__ __forceinline__ Terms reverb_terms(const float* p, int B) {
  const float fb = p[0] * 0.28f + 0.7f;
  const float d = p[B] * 0.4f;
  const float g = fb * (1.0f - d);
  const float wet = p[2 * B];
  const float width = p[3 * B];
  return Terms{{g, d, wet, width}};
}

// (wet1 and wet2 are formed after the combs, as the plain version forms
// them: formed before, they stay live across the combs' registers)
template <class M, class Tab>
__device__ __forceinline__ Resp reverb_build(const Terms& t,
                                             const Tab& tab) {
  const float g = t.v[0], d = t.v[1], wet = t.v[2], width = t.v[3];

  const float2 z1 = tab.z1();
  const float Ar = 1.0f - d * z1.x;
  const float Ai = d * z1.y;
  const float q = M::div(g, Ar * Ar + Ai * Ai);
  const float gAr = q * Ar;
  const float gAi = -q * Ai;

  float HLr, HLi, HRr, HRi;
  freeverb_channel<M>(tab, 0, gAr, gAi, HLr, HLi);
  freeverb_channel<M>(tab, 1, gAr, gAi, HRr, HRi);

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

// The bin's Freeverb table column into registers (the caller keeps it while
// it walks candidates).
__device__ __forceinline__ void load_table(const Stages& st, int k,
                                           float* tab) {
  if (st.table != nullptr) {
#pragma unroll
    for (int r = 0; r < kFreeverbRows; ++r)
      tab[r] = st.table[(long long)r * st.table_pitch + k];
  }
}

// The packed coefficients of one (candidate, bin): P, Q, Pc, Qc as real
// pairs (rp_responses.rp_packed_coeffs).
struct Coeffs {
  float Pr, Pi, Qr, Qi, Pcr, Pci, Qcr, Qci;
};

// The code of stage s.
__device__ __forceinline__ int stage_code(const Stages& st, int s) {
  return (st.codes >> (4 * s)) & 0xF;
}

// The Terms of stage s of candidate b.
__device__ __forceinline__ Terms stage_terms(const Stages& st, int s, int b) {
  const int code = stage_code(st, s);
  const float* p = st.params + (long long)s * kParamsPerStage * st.B + b;
  if (code == kDelay) return delay_terms(p, st.B, st.sr);
  if (code == kGain) return gain_terms(p);
  if (code == kWidener) return widener_terms(p);
  return reverb_terms(p, st.B);
}

// Stage `code`'s response at bin k (w = w0*k) from its Terms.
template <class M, class Tab>
__device__ __forceinline__ Resp stage_build(const Stages& st, int code,
                                            const Terms& t, const Tab& tab,
                                            float w, int k) {
  if (code == kDelay) return delay_build<M>(t, w, st.w0, k, st.n);
  if (code == kGain) return gain_build(t);
  if (code == kWidener) return widener_build(t);
  return reverb_build<M>(t, tab);
}

// The packed coefficients of a composed response
// (rp_responses.rp_packed_coeffs).
__device__ __forceinline__ Coeffs packed(const Resp& h) {
  Coeffs c;
  if (!h.mono) {
    c.Pr = h.v[0];
    c.Pi = h.v[1];
    c.Qr = 0.0f;
    c.Qi = 0.0f;
    c.Pcr = h.v[0];
    c.Pci = h.v[1];
    c.Qcr = 0.0f;
    c.Qci = 0.0f;
  } else {
    const float Dr = h.v[0], Di = h.v[1];
    const float GLr = h.v[2], GLi = h.v[3], GRr = h.v[4], GRi = h.v[5];
    const float A1r = GLr - GRi, A1i = GLi + GRr;
    const float A2r = GLr + GRi, A2i = GLi - GRr;
    c.Pr = Dr + 0.5f * (A1r + A1i);
    c.Pi = Di + 0.5f * (A1i - A1r);
    c.Qr = 0.5f * (A1r - A1i);
    c.Qi = 0.5f * (A1r + A1i);
    c.Pcr = Dr + 0.5f * (A2r - A2i);
    c.Pci = Di + 0.5f * (A2i + A2r);
    c.Qcr = 0.5f * (A2r + A2i);
    c.Qci = 0.5f * (A2i - A2r);
  }
  return c;
}

// Candidate b, bin k: every stage's response, bypass-blended and composed,
// as packed coefficients, the reverb's bin values from tab (ArrayTab or
// another source of them), divisions and the delay's phasor as M takes
// them. Each stage's Terms are formed in place, right before its response
// (K3, which takes a candidate's scalars from shared memory for each of its
// bins). Kept apart from rp_apply() so that a kernel loads the spectra only
// after this, the long part, is done with its registers.
template <class M, class Tab>
__device__ __forceinline__ Coeffs rp_coeffs(const Stages& st, const Tab& tab,
                                            int b, int k) {
  const float w = st.w0 * (float)k;
  Resp h;
  for (int s = 0; s < st.n_stages; ++s) {
    const int code = stage_code(st, s);
    const float* p = st.params + (long long)s * kParamsPerStage * st.B + b;
    Resp h2;
    if (code == kDelay) {
      h2 = delay_build<M>(delay_terms(p, st.B, st.sr), w, st.w0, k, st.n);
    } else if (code == kGain) {
      h2 = gain_build(gain_terms(p));
    } else if (code == kWidener) {
      h2 = widener_build(widener_terms(p));
    } else {
      h2 = reverb_build<M>(reverb_terms(p, st.B), tab);
    }
    if (st.active != nullptr) bypass(h2, st.active[(long long)s * st.B + b]);
    h = (s == 0) ? h2 : compose(h, h2);
  }
  return packed(h);
}

// rp_coeffs with each stage's Terms and bypass weight computed beforehand
// (K9 and K2, which compute a candidate's once for all of a block's bins):
// stage s's are terms[s] and active[s].
template <class M, class Tab>
__device__ __forceinline__ Coeffs rp_coeffs_staged(const Stages& st,
                                                   const Terms* terms,
                                                   const float* active,
                                                   const Tab& tab, int k) {
  const float w = st.w0 * (float)k;
  Resp h;
  for (int s = 0; s < st.n_stages; ++s) {
    Resp h2 = stage_build<M>(st, stage_code(st, s), terms[s], tab, w, k);
    if (st.active != nullptr) bypass(h2, active[s]);
    h = (s == 0) ? h2 : compose(h, h2);
  }
  return packed(h);
}

// Z[k] = (a_r, a_i), Zrev[k] = (c_r, c_i) in; Ylo[k] and Yhig[k] out. edge:
// k is the DC or the Nyquist bin.
__device__ __forceinline__ void rp_apply(const Coeffs& c, bool edge,
                                         float a_r, float a_i, float c_r,
                                         float c_i, float& lo_r, float& lo_i,
                                         float& hi_r, float& hi_i) {
  lo_r = c.Pr * a_r - c.Pi * a_i + c.Qr * c_r + c.Qi * c_i;
  lo_i = c.Pr * a_i + c.Pi * a_r + c.Qi * c_r - c.Qr * c_i;
  hi_r = c.Pcr * c_r + c.Pci * c_i + c.Qcr * a_r - c.Qci * a_i;
  hi_i = c.Pcr * c_i - c.Pci * c_r - c.Qcr * a_i - c.Qci * a_r;
  if (edge) {
    lo_r = 0.5f * (lo_r + hi_r);
    lo_i = 0.5f * (lo_i + hi_i);
  }
}

}  // namespace rp
