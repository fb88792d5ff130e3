"""Real-pair (r, i) frequency responses of the rp-capable LTI stages — port
of ``st_ito_tpu/chain/rp_responses.py``.

The fused LTI kernel K9 (``ops/kernels/packed_response.py``) evaluates each
stage's response from a few per-candidate scalars and candidate-independent
frequency tables, composes the stages, and applies the packed hermitian
formula. Its plain PyTorch version is exactly these functions on the full
``(B, F)`` grid, and the CUDA kernel repeats them op for op per bin.

Each supported stage contributes a bundle:

    tables(sr, n, F, device) -> dict[str, Tensor | float]
        frequency-dependent constants, each tensor shaped (rows, F),
        evaluated at omega_k = 2*pi*k/n. Float entries are static scalars.
    build(params, tables) -> ("scalar", (Hr, Hi))
                           | ("monomix", (Dr, Di, GLr, GLi, GRr, GRi))
        params: dict name -> (B, 1) tensor of denormalized values.

The damped comb is evaluated division-free per comb via

    comb = zD*A / (A - g*zD) = 1 / (conj(zD) - g/A)      (|zD| = 1)
"""

from __future__ import annotations

import math

import torch

from st_ito_torch.ops.reverb import (
    _ALLPASS_TUNINGS,
    _COMB_TUNINGS,
    _STEREO_SPREAD,
)

# ---------------------------------------------------------------- helpers


def cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _omega(n: int, F: int, device) -> torch.Tensor:
    return (2.0 * math.pi / n) * torch.arange(F, dtype=torch.float32,
                                              device=device)


# ---------------------------------------------------------------- delay


def delay_tables(sr: float, n: int, F: int, device=None) -> dict:
    return {"omega": _omega(n, F, device)[None, :],
            "kidx": torch.arange(F, dtype=torch.int64, device=device)[None, :],
            "_sr": float(sr), "_n": int(n)}


def delay_build(p: dict, tables: dict):
    """(reference semantics: st_ito_tpu chain/responses.py delay_response,
    including its exact integer phase reduction for the z^-D term). The
    phase index k*Di is formed in int64: at k ~ 2^18 and Di ~ 48000 the
    product leaves int32, and only its low log2(n) bits are kept."""
    w = tables["omega"]
    k = tables["kidx"]
    n = tables["_n"]
    D = p["delay_seconds"] * tables["_sr"]
    fb = p["feedback"] * 0.999
    mix = p["mix"]
    Di = torch.floor(D)
    Df = D - Di
    m = (k * Di.to(torch.int64)) & (n - 1)
    th = (2.0 * math.pi / n) * m.to(torch.float32) + w * Df
    c = torch.cos(th)
    s = torch.sin(th)  # zD = (c, -s)
    dr = 1.0 - fb * c
    di = fb * s
    idd = 1.0 / (dr * dr + di * di)
    Hwr = (c * dr - s * di) * idd
    Hwi = -(c * di + s * dr) * idd
    return ("scalar", ((1.0 - mix) + mix * Hwr, mix * Hwi))


# ---------------------------------------------------------------- gain


def gain_tables(sr: float, n: int, F: int, device=None) -> dict:
    return {}


def gain_build(p: dict, tables: dict):
    g = torch.pow(10.0, p["gain_db"] / 20.0)
    return ("scalar", (g, torch.zeros_like(g)))


# ---------------------------------------------------------------- widener


def widener_tables(sr: float, n: int, F: int, device=None) -> dict:
    return {}


def widener_build(p: dict, tables: dict):
    width = p["width"]
    sqrt2 = math.sqrt(2.0)
    mg = torch.sqrt(torch.clamp(1.0 - width, 0.0, 1.0)) * sqrt2
    sg = torch.sqrt(torch.clamp(width, 0.0, 1.0)) * sqrt2
    a = (mg + sg) / 2.0
    b = (mg - sg) / 2.0
    z = torch.zeros_like(a)
    return ("monomix", (a - b, z, b, z, b, z))


# ---------------------------------------------------------------- freeverb

# Row order of the packed (38, F) Freeverb table the CUDA kernel reads:
# cos1, sin1, combL_c[8], combL_s[8], combR_c[8], combR_s[8], apL_r, apL_i,
# apR_r, apR_i. The dict entries are row views into that one tensor.
FREEVERB_ROWS = (("cos1", 1), ("sin1", 1), ("combL_c", 8), ("combL_s", 8),
                 ("combR_c", 8), ("combR_s", 8), ("apL_r", 1), ("apL_i", 1),
                 ("apR_r", 1), ("apR_i", 1))


def freeverb_tables(sr: float, n: int, F: int, device=None) -> dict:
    """conj(zD) tables per comb (8 per channel), one-pole z^-1 cos/sin,
    and the candidate-independent allpass cascade product per channel.
    ``"_packed"`` holds all 38 rows as one contiguous (38, F) tensor;
    ``"_phasor_delays"`` the delays D of its 17 phasor rows (z^-1, then the
    combs of L and of R), from which the K3 kernel forms them
    (``ops/kernels/mega_fft.py freeverb_factors``)."""
    w = _omega(n, F, device)
    kk = torch.arange(F, dtype=torch.int64, device=device)

    def lag_cs(D: int):
        # exact integer phase reduction of omega*D
        m = (kk * D) & (n - 1)
        th = (2.0 * math.pi / n) * m.to(torch.float32)
        return torch.cos(th), torch.sin(th)

    rows = {"cos1": [torch.cos(w)], "sin1": [torch.sin(w)]}
    delays = [1]
    for ch, spread in (("L", 0), ("R", _STEREO_SPREAD)):
        cc, ss = [], []
        for tune in _COMB_TUNINGS:
            delays.append(int(sr * (tune + spread) / 44100.0))
            c, s = lag_cs(delays[-1])
            cc.append(c)
            ss.append(s)
        rows[f"comb{ch}_c"] = cc
        rows[f"comb{ch}_s"] = ss
        apr = torch.ones_like(w)
        api = torch.zeros_like(w)
        for tune in _ALLPASS_TUNINGS:
            c, s = lag_cs(int(sr * (tune + spread) / 44100.0))  # zD = (c, -s)
            # (1.5 zD - 1) / (1 - 0.5 zD)
            nr, ni = 1.5 * c - 1.0, -1.5 * s
            dr, di = 1.0 - 0.5 * c, 0.5 * s
            idd = 1.0 / (dr * dr + di * di)
            tr, ti = (nr * dr + ni * di) * idd, (ni * dr - nr * di) * idd
            apr, api = cmul(apr, api, tr, ti)
        rows[f"ap{ch}_r"] = [apr]
        rows[f"ap{ch}_i"] = [api]
    packed = torch.stack([r for name, _ in FREEVERB_ROWS for r in rows[name]])
    out = {"_packed": packed, "_phasor_delays": tuple(delays)}
    i = 0
    for name, count in FREEVERB_ROWS:
        out[name] = packed[i:i + count]
        i += count
    return out


def _freeverb_channel(tables: dict, ch: str, gAr, gAi):
    """Sum of 8 damped combs times the channel's allpass product."""
    cc = tables[f"comb{ch}_c"]
    ss = tables[f"comb{ch}_s"]
    sr_ = si_ = None
    for k in range(cc.shape[0]):
        wr = cc[k][None, :] - gAr
        wi = ss[k][None, :] - gAi
        idd = 1.0 / (wr * wr + wi * wi)
        r, i = wr * idd, -wi * idd
        sr_ = r if sr_ is None else sr_ + r
        si_ = i if si_ is None else si_ + i
    return cmul(sr_, si_, tables[f"ap{ch}_r"], tables[f"ap{ch}_i"])


def freeverb_build_stereo(p: dict, tables: dict):
    """(reference semantics: st_ito_tpu chain/responses.py
    freeverb_response, C=2)."""
    fb = p["room_size"] * 0.28 + 0.7
    d = p["damping"] * 0.4
    g = fb * (1.0 - d)
    wet = p["wet_dry"]
    width = p["width"]

    # g / A with A = 1 - d z^-1
    Ar = 1.0 - d * tables["cos1"]
    Ai = d * tables["sin1"]
    q = g / (Ar * Ar + Ai * Ai)
    gAr = q * Ar
    gAi = -q * Ai

    HLr, HLi = _freeverb_channel(tables, "L", gAr, gAi)
    HRr, HRi = _freeverb_channel(tables, "R", gAr, gAi)

    gain_in = 0.015
    wet1 = 0.5 * wet * 3.0 * (1.0 + width) * gain_in
    wet2 = 0.5 * wet * 3.0 * (1.0 - width) * gain_in
    MLr = wet1 * HLr + wet2 * HRr
    MLi = wet1 * HLi + wet2 * HRi
    MRr = wet1 * HRr + wet2 * HLr
    MRi = wet1 * HRi + wet2 * HLi
    dry = (1.0 - wet) * 2.0  # (B, 1); broadcasts in the apply
    return ("monomix", (dry, torch.zeros_like(dry), MLr, MLi, MRr, MRi))


# -------------------------------------------------------- rp algebra


def rp_bypass(kind, H, active):
    """active: (B, 1) float mask (1 = effect on). Blends toward identity."""
    if kind == "scalar":
        Hr, Hi = H
        return ("scalar", (active * Hr + (1.0 - active), active * Hi))
    Dr, Di, GLr, GLi, GRr, GRi = H
    return ("monomix", (active * Dr + (1.0 - active), active * Di,
                        active * GLr, active * GLi,
                        active * GRr, active * GRi))


def rp_compose(kind_old, H_old, kind_new, H_new):
    """Total response H_new . H_old over the scalar/monomix closure."""
    if H_old is None:
        return kind_new, H_new
    if kind_old == "scalar" and kind_new == "scalar":
        return "scalar", cmul(*H_old, *H_new)
    if kind_old == "scalar":
        Hr, Hi = H_old
        D2r, D2i, GL2r, GL2i, GR2r, GR2i = H_new
        return "monomix", (*cmul(Hr, Hi, D2r, D2i),
                           *cmul(Hr, Hi, GL2r, GL2i),
                           *cmul(Hr, Hi, GR2r, GR2i))
    if kind_new == "scalar":
        D1r, D1i, GL1r, GL1i, GR1r, GR1i = H_old
        Hr, Hi = H_new
        return "monomix", (*cmul(D1r, D1i, Hr, Hi),
                           *cmul(GL1r, GL1i, Hr, Hi),
                           *cmul(GR1r, GR1i, Hr, Hi))
    D1r, D1i, GL1r, GL1i, GR1r, GR1i = H_old
    D2r, D2i, GL2r, GL2i, GR2r, GR2i = H_new
    s1r = D1r + GL1r + GR1r
    s1i = D1i + GL1i + GR1i
    Dr, Di = cmul(D1r, D1i, D2r, D2i)
    GLr, GLi = (a + b for a, b in zip(cmul(D2r, D2i, GL1r, GL1i),
                                      cmul(s1r, s1i, GL2r, GL2i)))
    GRr, GRi = (a + b for a, b in zip(cmul(D2r, D2i, GR1r, GR1i),
                                      cmul(s1r, s1i, GR2r, GR2i)))
    return "monomix", (Dr, Di, GLr, GLi, GRr, GRi)


def rp_packed_coeffs(kind, H):
    """(P, Q, Pc, Qc) real pairs from the composed response (lower half
    grid). Packed-complex identities:
      P  = D + (GL + iGR)(1-i)/2     Q  = (GL + iGR)(1+i)/2
      Pc = D + (GL - iGR)(1+i)/2     Qc = (GL - iGR)(1-i)/2
    with the scalar kind degenerating to P = Pc = H, Q = Qc = 0."""
    if kind == "scalar":
        Hr, Hi = H
        z = torch.zeros_like(Hr)
        return (Hr, Hi), (z, z), (Hr, Hi), (z, z)
    Dr, Di, GLr, GLi, GRr, GRi = H
    A1r, A1i = GLr - GRi, GLi + GRr  # GL + i GR
    A2r, A2i = GLr + GRi, GLi - GRr  # GL - i GR
    P = (Dr + 0.5 * (A1r + A1i), Di + 0.5 * (A1i - A1r))
    Q = (0.5 * (A1r - A1i), 0.5 * (A1r + A1i))
    Pc = (Dr + 0.5 * (A2r - A2i), Di + 0.5 * (A2i + A2r))
    Qc = (0.5 * (A2r + A2i), 0.5 * (A2i - A2r))
    return P, Q, Pc, Qc


def rp_packed_apply(P, Q, Pc, Qc, zr, zi, zrr, zri):
    """Lower-half outputs and upper-half generators.

      Ylo[k]  = P[k] Z[k] + Q[k] conj(Zrev[k])
      Yhig[k] = Y[(n-k) mod n] = conj(Pc[k]) Zrev[k] + conj(Qc[k]) conj(Z[k])

    z = (zr, zi) is Z on [0, n/2]; zrev = (zrr, zri) is Z[(n-k) mod n].
    Returns (YloR, YloI, YhigR, YhigI)."""
    Pr, Pi = P
    Qr, Qi = Q
    Pcr, Pci = Pc
    Qcr, Qci = Qc
    ylo_r = Pr * zr - Pi * zi + Qr * zrr + Qi * zri
    ylo_i = Pr * zi + Pi * zr + Qi * zrr - Qr * zri
    yhi_r = Pcr * zrr + Pci * zri + Qcr * zr - Qci * zi
    yhi_i = Pcr * zri - Pci * zrr - Qcr * zi - Qci * zr
    return ylo_r, ylo_i, yhi_r, yhi_i


# ------------------------------------------------------------- bundles

RP_BUNDLES = {
    "delay": (delay_tables, delay_build),
    "gain": (gain_tables, gain_build),
    "stereo_widener": (widener_tables, widener_build),
    "reverb": (freeverb_tables, freeverb_build_stereo),
}
