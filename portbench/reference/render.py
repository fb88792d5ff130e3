"""Plain renderer of the effect chains the ITO cells run, in float64.

A straightforward reading of the effects' equations in plain PyTorch, with
no kernel and nothing of the program under test: every stage's parameter
ranges, the RBJ biquads, the decoupled compressor detector (Giannoulis,
Massberg & Reiss 2012), the tanh drive, the feedback delay's and JUCE
Freeverb's exact frequency responses. Two ways of joining the stages, as
the two renderers of ST-ITO join them:

- ``render_population`` follows the population renderer that scores the
  candidates: the delay and the reverb applied together as one linear
  response over an FFT grid with a guard of the whole signal (the delay's
  tail feeds the reverb), no output normalisation (the embed normalises);
- ``render_candidate`` follows the per-candidate renderer that makes a
  job's output audio: every stage on its own, truncated to the buffer,
  then peak-normalised.

``quantize`` rounds each stage's output (the control runs the chain one
precision step below the configuration's float32: bfloat16).

Effects are found by the name a chain file gives them: the built-ins in
``EFFECTS``, any other as the ``EFFECT`` of ``effects/<name>.py`` beside
this file.

A stage is active where its bypass slot is <= 0.5; parameters are
``raw * (max - min) + min``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
from typing import Callable

import torch

F64 = torch.float64

# (name, min, max) of each built-in effect's parameters, in vector order
PARAMS = {
    "parametric_eq": (
        [("low_shelf_gain_db", -24.0, 24.0),
         ("low_shelf_cutoff_freq", 20.0, 4000.0),
         ("low_shelf_q_factor", 0.1, 4.0)]
        + [(f"band{i}_{k}", lo, hi) for i in range(4)
           for k, lo, hi in (("gain_db", -24.0, 24.0),
                             ("cutoff_freq", 20.0, 10000.0),
                             ("q_factor", 0.1, 4.0))]
        + [("high_shelf_gain_db", -24.0, 24.0),
           ("high_shelf_cutoff_freq", 200.0, 18000.0),
           ("high_shelf_q_factor", 0.1, 4.0)]),
    "compressor": [("threshold_db", -80.0, 0.0), ("ratio", 1.0, 20.0),
                   ("attack_ms", 0.1, 100.0), ("release_ms", 10.0, 1000.0)],
    "distortion": [("drive_db", -48.0, 48.0), ("output_gain_db", -24.0, 24.0)],
    "delay": [("delay_seconds", 0.01, 1.0), ("feedback", 0.05, 1.0),
              ("mix", 0.0, 1.0)],
    "reverb": [("room_size", 0.0, 1.0), ("damping", 0.0, 1.0),
               ("wet_dry", 0.0, 1.0), ("width", 0.0, 1.0)],
    "limiter": [("threshold_db", -40.0, 0.0), ("release_ms", 10.0, 1000.0)],
    "multiband_compressor": [
        ("xover_low_hz", 40.0, 1000.0), ("xover_high_hz", 1000.0, 12000.0)]
    + [(f"{b}_{k}", lo, hi) for b in ("low", "mid", "high")
       for k, lo, hi in (("threshold_db", -60.0, 0.0), ("ratio", 1.0, 20.0),
                         ("makeup_db", -12.0, 12.0))]
    + [("attack_ms", 0.1, 100.0), ("release_ms", 10.0, 1000.0)],
}

EQ_PAD = 8192  # the EQ's and crossovers' guard for the response's tail
COMBS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)  # at 44.1 kHz
ALLPASSES = (556, 441, 341, 225)
SPREAD = 23  # the right channel's extra samples of lag
REVERB_IN_GAIN = 0.015


@dataclasses.dataclass(frozen=True)
class Effect:
    """One effect: its parameters [(name, min, max)], and either
    ``process(x (B, C, T), p, sr) -> y`` or, for a linear stage that joins
    the population renderer's response group, ``spectrum(X (B, 2, F), p,
    w, sr) -> Y`` on the rfft grid ``w``."""

    params: list
    process: Callable | None = None
    spectrum: Callable | None = None


def effect(name: str) -> Effect:
    """A built-in effect, else the ``EFFECT`` of ``effects/<name>.py``
    beside this file."""
    if name in EFFECTS:
        return EFFECTS[name]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "effects", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_effect_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.EFFECT


def load_chain(path: str) -> list[str]:
    """The effects of a chain file ({stage: {"effect": ...}}), in order."""
    with open(path) as f:
        spec = json.load(f)
    return [entry["effect"] for entry in spec.values()]


def num_params(effects) -> int:
    return sum(len(effect(e).params) + 1 for e in effects)


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def identity(x):
    return x


def stage_slices(effects):
    """[(effect, bypass index, {param: index})] over the flat vector."""
    out, i = [], 0
    for e in effects:
        names = {name: i + 1 + j for j, (name, _, _) in
                 enumerate(effect(e).params)}
        out.append((e, i, names))
        i += 1 + len(effect(e).params)
    return out


def physical(name_of, W, index) -> dict:
    """name -> (B,) physical values of one stage of W (B, P), formed in
    float32 as the configuration states its parameters (a delay of D
    samples is float32(seconds x rate): at 48000 samples its ulp is 1/256
    of a sample, which a comb near feedback 1 turns into percents)."""
    W = W.to(torch.float32)
    return {name: ((W[:, index[name]] * (hi - lo) + lo).to(F64)
                   if name != "delay_seconds" else
                   W[:, index[name]] * (hi - lo) + lo)
            for name, lo, hi in effect(name_of).params}


# ------------------------------------------------------------ filters


def biquad(gain_db, freq, q, sr, kind):
    """RBJ cookbook biquad, a0-normalised: (b, a), each (..., 3), designed
    in float32 as the configuration states its filters (a 20 Hz band's
    poles sit within 3e-3 of the unit circle, where the float32 design's
    own rounding moves a 60-s render by up to 4e-4 of its peak) and
    returned in float64."""
    gain_db, freq, q = (torch.as_tensor(v).to(torch.float32)
                        for v in (gain_db, freq, q))
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * math.pi * freq / sr
    alpha = torch.sin(w0) / (2.0 * q)
    c = torch.cos(w0)
    sA = torch.sqrt(A)
    if kind == "low_shelf":
        b = (A * ((A + 1) - (A - 1) * c + 2 * sA * alpha),
             2 * A * ((A - 1) - (A + 1) * c),
             A * ((A + 1) - (A - 1) * c - 2 * sA * alpha))
        a = ((A + 1) + (A - 1) * c + 2 * sA * alpha,
             -2 * ((A - 1) + (A + 1) * c),
             (A + 1) + (A - 1) * c - 2 * sA * alpha)
    elif kind == "high_shelf":
        b = (A * ((A + 1) + (A - 1) * c + 2 * sA * alpha),
             -2 * A * ((A - 1) + (A + 1) * c),
             A * ((A + 1) + (A - 1) * c - 2 * sA * alpha))
        a = ((A + 1) - (A - 1) * c + 2 * sA * alpha,
             2 * ((A - 1) - (A + 1) * c),
             (A + 1) - (A - 1) * c - 2 * sA * alpha)
    elif kind == "peaking":
        b = (1 + alpha * A, -2 * c, 1 - alpha * A)
        a = (1 + alpha / A, -2 * c, 1 - alpha / A)
    elif kind == "lowpass":
        b = ((1 - c) / 2, 1 - c, (1 - c) / 2)
        a = (1 + alpha, -2 * c, 1 - alpha)
    elif kind == "highpass":
        b = ((1 + c) / 2, -(1 + c), (1 + c) / 2)
        a = (1 + alpha, -2 * c, 1 - alpha)
    else:
        raise ValueError(kind)
    b = torch.stack(b, dim=-1)
    a = torch.stack(a, dim=-1)
    return (b / a[..., :1]).to(F64), (a / a[..., :1]).to(F64)


def omega(n: int, device):
    return torch.linspace(0.0, math.pi, n // 2 + 1, dtype=F64, device=device)


def biquad_response(b, a, w):
    """Product over the sections (..., S, 3) of b(z)/a(z) at z = e^{jw}:
    (..., F) complex."""
    z1 = torch.exp(-1j * w)
    z2 = z1 * z1
    num = b[..., 0:1] + b[..., 1:2] * z1 + b[..., 2:3] * z2
    den = a[..., 0:1] + a[..., 1:2] * z1 + a[..., 2:3] * z2
    return torch.prod(num / den, dim=-2)


def filt(x, H, n):
    """x (..., T) through H (on the size-n rfft grid), truncated to T."""
    T = x.shape[-1]
    X = torch.fft.rfft(x, n=n, dim=-1)
    return torch.fft.irfft(X * H, n=n, dim=-1)[..., :T]


def eq(x, p, sr):
    """The six-section parametric EQ on x (B, C, T)."""
    secs = [biquad(p["low_shelf_gain_db"], p["low_shelf_cutoff_freq"],
                   p["low_shelf_q_factor"], sr, "low_shelf")]
    for i in range(4):
        secs.append(biquad(p[f"band{i}_gain_db"], p[f"band{i}_cutoff_freq"],
                           p[f"band{i}_q_factor"], sr, "peaking"))
    secs.append(biquad(p["high_shelf_gain_db"], p["high_shelf_cutoff_freq"],
                       p["high_shelf_q_factor"], sr, "high_shelf"))
    b = torch.stack([s[0] for s in secs], dim=-2)
    a = torch.stack([s[1] for s in secs], dim=-2)
    n = next_pow2(x.shape[-1] + EQ_PAD)
    H = biquad_response(b, a, omega(n, x.device))  # (B, F)
    return filt(x, H[:, None, :], n)


# ------------------------------------------------------------ dynamics


def _prefix(combine, elems):
    """Inclusive prefix composition along the last axis by doubling: each
    step composes every element with the one 2^k places before it."""
    T = elems[0][0].shape[-1]
    s = 1
    while s < T:
        prev = [torch.cat([torch.full_like(e[..., :s], ident), e[..., :-s]],
                          dim=-1) for e, ident in elems]
        cur = combine(prev, [e for e, _ in elems])
        elems = [(c, ident) for c, (_, ident) in zip(cur, elems)]
        s *= 2
    return [e for e, _ in elems]


def release_stage(c, ar):
    """y[n] = min(c[n], ar y[n-1] + (1 - ar) c[n]), y[-1] = 0. Each step is
    the map y -> min(m, k y + b); two compose as (k1 k2, k2 b1 + b2,
    min(m2, k2 m1 + b2))."""
    k = ar.expand(c.shape)
    b = (1.0 - k) * c

    def combine(e1, e2):
        (k1, b1, m1), (k2, b2, m2) = e1, e2
        # an unbounded m1 stays unbounded, also where k2 has underflowed
        m = torch.where(torch.isinf(m1), m1, k2 * m1 + b2)
        return k1 * k2, k2 * b1 + b2, torch.minimum(m2, m)

    _, B, M = _prefix(combine, [(k, 1.0), (b, 0.0), (c, math.inf)])
    return torch.minimum(M, B)


def one_pole(u, aa):
    """y[n] = aa y[n-1] + (1 - aa) u[n], y[-1] = 0."""
    k = aa.expand(u.shape)

    def combine(e1, e2):
        (k1, b1), (k2, b2) = e1, e2
        return k1 * k2, k2 * b1 + b2

    _, B = _prefix(combine, [(k, 1.0), ((1.0 - k) * u, 0.0)])
    return B


def time_alpha(ms, sr):
    return torch.exp(-1.0 / (torch.clamp_min(ms, 1e-3) * 1e-3 * sr))


def compressor(x, sr, threshold, ratio, attack_ms, release_ms, knee,
               makeup_db, linked):
    """Feed-forward compressor on x (B, C, T); parameters (B,) or floats.
    The detector: the gain computer's reduction in dB through the release
    stage, then the attack one-pole."""
    def col(v):
        return torch.as_tensor(v, dtype=F64, device=x.device).reshape(-1, 1, 1)

    env = x.abs().amax(dim=1, keepdim=True) if linked else x.abs()
    level = 20.0 * torch.log10(torch.clamp_min(env, 1e-8))
    over = level - col(threshold)
    slope = 1.0 / col(ratio) - 1.0
    knee = col(knee)
    gr = torch.where(2.0 * over < -knee, torch.zeros_like(over),
                     torch.where(2.0 * over > knee, slope * over,
                                 slope * (over + knee / 2.0) ** 2
                                 / (2.0 * knee)))
    smooth = one_pole(release_stage(gr, time_alpha(col(release_ms), sr)),
                      time_alpha(col(attack_ms), sr))
    return x * 10.0 ** (smooth / 20.0) * 10.0 ** (col(makeup_db) / 20.0)


def basic_compressor(x, p, sr):
    return compressor(x, sr, p["threshold_db"], p["ratio"], p["attack_ms"],
                      p["release_ms"], 0.5, 0.0, linked=False)


def limiter(x, p, sr):
    return compressor(x, sr, p["threshold_db"], 1000.0, 0.05,
                      p["release_ms"], 0.1, 0.0, linked=True)


def multiband(x, p, sr):
    """Three bands split by Linkwitz-Riley crossovers (two Butterworth
    sections each edge, by frequency sampling), a linked compressor each,
    summed."""
    n = next_pow2(x.shape[-1] + EQ_PAD)
    w = omega(n, x.device)

    def lr4(sig, freq, kind):
        b, a = biquad(torch.zeros_like(freq), freq,
                      torch.full_like(freq, 0.7071), sr, kind)
        b2 = torch.stack([b, b], dim=-2)
        a2 = torch.stack([a, a], dim=-2)
        return filt(sig, biquad_response(b2, a2, w)[:, None, :], n)

    fl, fh = p["xover_low_hz"], p["xover_high_hz"]
    rest = lr4(x, fl, "highpass")
    bands = (lr4(x, fl, "lowpass"), lr4(rest, fh, "lowpass"),
             lr4(rest, fh, "highpass"))
    out = 0.0
    for band, name in zip(bands, ("low", "mid", "high")):
        out = out + compressor(band, sr, p[f"{name}_threshold_db"],
                               p[f"{name}_ratio"], p["attack_ms"],
                               p["release_ms"], 3.0, p[f"{name}_makeup_db"],
                               linked=True)
    return out


def distortion(x, p, sr):
    def col(v):
        return v.reshape(-1, 1, 1)

    return (torch.tanh(x * 10.0 ** (col(p["drive_db"]) / 20.0))
            * 10.0 ** (col(p["output_gain_db"]) / 20.0))


# ------------------------------------------------------------ delay, reverb


def delay_spectrum(X, p, w, sr):
    """(1 - mix) + mix z^-D / (1 - 0.999 fb z^-D), D in samples."""
    D = (p["delay_seconds"] * sr).to(F64)[:, None]
    zD = torch.exp(-1j * w * D)
    fb = (p["feedback"] * 0.999)[:, None]
    mix = p["mix"][:, None]
    return X * ((1.0 - mix) + mix * zD / (1.0 - fb * zD))[:, None, :]


def _reverb_channel(w, sr, feedback, damp, spread):
    """8 damped combs summed, then 4 allpasses in series: (B, F)."""
    z1 = torch.exp(-1j * w)
    comb = 0.0
    for tune in COMBS:
        zD = torch.exp(-1j * w * int(sr * (tune + spread) / 44100.0))
        lp = 1.0 - damp * z1
        comb = comb + zD * lp / (lp - feedback * (1.0 - damp) * zD)
    ap = 1.0
    for tune in ALLPASSES:
        zD = torch.exp(-1j * w * int(sr * (tune + spread) / 44100.0))
        ap = ap * (1.5 * zD - 1.0) / (1.0 - 0.5 * zD)
    return comb * ap


def reverb_spectrum(X, p, w, sr):
    """out_c = dry x_c + wet_c (x_L + x_R) with JUCE's scales (wet 3, dry
    2, input 0.015, width)."""
    col = {k: v[:, None] for k, v in p.items()}
    feedback = col["room_size"] * 0.28 + 0.7
    damp = col["damping"] * 0.4
    HL = _reverb_channel(w, sr, feedback, damp, 0)
    HR = _reverb_channel(w, sr, feedback, damp, SPREAD)
    wet1 = 0.5 * col["wet_dry"] * 3.0 * (1.0 + col["width"])
    wet2 = 0.5 * col["wet_dry"] * 3.0 * (1.0 - col["width"])
    dry = (1.0 - col["wet_dry"]) * 2.0
    mono = X[:, 0] + X[:, 1]
    return torch.stack(
        [dry * X[:, 0] + (wet1 * HL + wet2 * HR) * REVERB_IN_GAIN * mono,
         dry * X[:, 1] + (wet1 * HR + wet2 * HL) * REVERB_IN_GAIN * mono],
        dim=1)


EFFECTS = {
    "parametric_eq": Effect(PARAMS["parametric_eq"], process=eq),
    "compressor": Effect(PARAMS["compressor"], process=basic_compressor),
    "distortion": Effect(PARAMS["distortion"], process=distortion),
    "limiter": Effect(PARAMS["limiter"], process=limiter),
    "multiband_compressor": Effect(PARAMS["multiband_compressor"],
                                   process=multiband),
    "delay": Effect(PARAMS["delay"], spectrum=delay_spectrum),
    "reverb": Effect(PARAMS["reverb"], spectrum=reverb_spectrum),
}


# ------------------------------------------------------------ the chains


def _stereo(x):
    return torch.cat([x, x], dim=1) if x.shape[1] == 1 else x


def _linear(name):
    return effect(name).spectrum is not None


def render_population(effects, W, x, sr, guard=None, quantize=identity):
    """W (B, P), x (C, T) shared -> (B, C, T), as the population renderer
    joins the stages: consecutive linear stages (delay, reverb) as one
    response over next_pow2(T + guard) points (guard: the whole T, or
    ``guard`` where it is shorter), the others one by one."""
    W = W.to(F64)
    B = W.shape[0]
    x = x.to(F64)[None].expand(B, *x.shape)
    T = x.shape[-1]
    slices = stage_slices(effects)
    i = 0
    while i < len(slices):
        name, byp, idx = slices[i]
        if _linear(name):
            x = _stereo(x)
            n = next_pow2(T + (T if guard is None else min(guard, T)))
            w = omega(n, x.device)
            X = torch.fft.rfft(x, n=n, dim=-1)
            while i < len(slices) and _linear(slices[i][0]):
                g_name, g_byp, g_idx = slices[i]
                Y = effect(g_name).spectrum(X, physical(g_name, W, g_idx), w,
                                            sr)
                X = torch.where((W[:, g_byp] <= 0.5)[:, None, None], Y, X)
                i += 1
            x = quantize(torch.fft.irfft(X, n=n, dim=-1)[..., :T])
            continue
        y = effect(name).process(x, physical(name, W, idx), sr)
        x = quantize(torch.where((W[:, byp] <= 0.5)[:, None, None], y, x))
        i += 1
    return x


def render_candidate(effects, w, x, sr, quantize=identity):
    """w (P,), x (C, T) -> (C, T), every stage on its own and truncated to
    the buffer (a linear stage over next_pow2(2T) points), then
    peak-normalised."""
    W = w.to(F64)[None]
    x = x.to(F64)[None]
    T = x.shape[-1]
    for name, byp, idx in stage_slices(effects):
        p = physical(name, W, idx)
        if _linear(name):
            x = _stereo(x)
            n = next_pow2(2 * T)
            Y = effect(name).spectrum(torch.fft.rfft(x, n=n, dim=-1), p,
                                      omega(n, x.device), sr)
            y = torch.fft.irfft(Y, n=n, dim=-1)[..., :T]
        else:
            y = effect(name).process(x, p, sr)
        x = quantize(torch.where(W[0, byp] <= 0.5, y, x))
    x = x[0]
    return x / torch.clamp_min(x.abs().max(), 1e-8)
