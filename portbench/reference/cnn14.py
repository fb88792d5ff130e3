"""Plain AFx-Rep Cnn14 (mid/side), the reference for every cell.

PANNs' Cnn14 as AFx-Rep uses it (Kong et al. 2020; the reference's
``param-panns-concat-l2.yaml``): stereo in, mid = (L + R) / 2 and side =
(L - R) / 2 each through the log-mel front end (periodic Hann, centred
frames with reflect padding, power spectrum, Slaney mel filterbank,
10 log10 with a floor of 1e-10), min-max input scaling from [-80, 40] dB to
[-1, 1], six blocks of two 3x3 convolutions with BatchNorm and ReLU (2x2
average pooling after the first five), the mean over mel bins, the maximum
plus the mean over time, and a linear head for mid and one for side.

Weights live in a plain dict under the names ``param_specs`` lists, which
are also the names the program's module takes, so one draw from the seed
(``core/weights.py``) serves both. ``embed`` runs the eval-mode forward in
the dtype of its input; ``conv_quant`` rounds every convolution's input and
weight first (the control's lower precision).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def channels(enc: dict) -> list[int]:
    b = enc["base_channels"]
    return [b, 2 * b, 4 * b, 8 * b, 16 * b, 32 * b]


def param_specs(enc: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor, in draw order. kind: "conv",
    "linear" (Xavier-uniform), "bias", "bn_weight", "bn_bias", "bn_mean",
    "bn_var", "count"."""
    specs = []

    def bn(prefix, c):
        specs.extend([(f"{prefix}.weight", (c,), "bn_weight"),
                      (f"{prefix}.bias", (c,), "bn_bias"),
                      (f"{prefix}.running_mean", (c,), "bn_mean"),
                      (f"{prefix}.running_var", (c,), "bn_var"),
                      (f"{prefix}.num_batches_tracked", (), "count")])

    bn("bn0", enc["mel_bins"])
    cin = 1
    for i, c in enumerate(channels(enc)):
        blk = f"conv_block{i + 1}"
        specs.append((f"{blk}.conv1.weight", (c, cin, 3, 3), "conv"))
        specs.append((f"{blk}.conv2.weight", (c, c, 3, 3), "conv"))
        if enc["use_batchnorm"]:
            bn(f"{blk}.bn1", c)
            bn(f"{blk}.bn2", c)
        cin = c
    for head in ("fc_mid", "fc_side"):
        specs.append((f"{head}.weight", (enc["embed_dim"], cin), "linear"))
        specs.append((f"{head}.bias", (enc["embed_dim"],), "bias"))
    return specs


def mel_matrix(enc: dict) -> np.ndarray:
    """(n_fft // 2 + 1, mel_bins) Slaney mel filterbank with Slaney area
    normalisation (librosa.filters.mel's defaults), float64."""
    sr, n_fft, n_mels = enc["sample_rate"], enc["window_size"], enc["mel_bins"]
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-12) / min_log_hz)
                        / logstep, f / f_sp)

    def mel_to_hz(m):
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        m * f_sp)

    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(enc["fmin"]), hz_to_mel(enc["fmax"]),
                                  n_mels + 2))
    fdiff = np.diff(f_pts)
    ramps = f_pts[None, :] - fft_freqs[:, None]
    lower = -ramps[:, :-2] / fdiff[None, :-1]
    upper = ramps[:, 2:] / fdiff[None, 1:]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights * (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None]


def logmel(x: torch.Tensor, enc: dict) -> torch.Tensor:
    """(N, T) -> (N, 1, frames, mel_bins) in x's dtype."""
    n_fft, hop = enc["window_size"], enc["hop_size"]
    xp = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop)
    k = torch.arange(n_fft, dtype=x.dtype, device=x.device)
    window = 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n_fft)
    power = torch.fft.rfft(frames * window, dim=-1).abs() ** 2
    mel = power @ torch.as_tensor(mel_matrix(enc), dtype=x.dtype,
                                  device=x.device)
    return (10.0 * torch.log10(torch.clamp_min(mel, 1e-10)))[:, None]


def no_quant(t):
    return t


def conv_stack(h, params, enc, bn_fn, conv_quant=no_quant, block_hook=None):
    """The six blocks on h (N, 1, frames, mel) -> (N, C, frames', mel').
    ``bn_fn(h, prefix)`` normalises; ``block_hook(h)`` follows each block
    (train mode's dropout)."""
    for i in range(6):
        blk = f"conv_block{i + 1}"
        for j in (1, 2):
            w = params[f"{blk}.conv{j}.weight"].to(h.dtype)
            h = F.conv2d(conv_quant(h), conv_quant(w), padding=1)
            if enc["use_batchnorm"]:
                h = bn_fn(h, f"{blk}.bn{j}")
            h = torch.relu(h)
        if i < 5:
            h = F.avg_pool2d(h, 2)
        if block_hook is not None:
            h = block_hook(h)
    return h


def eval_bn(params):
    def bn(h, prefix):
        def p(name):
            return params[f"{prefix}.{name}"].to(h.dtype)[None, :, None, None]

        return ((h - p("running_mean")) / torch.sqrt(p("running_var") + BN_EPS)
                * p("weight") + p("bias"))

    return bn


def minmax(h):
    return (torch.clamp(h, -80.0, 40.0) + 80.0) / 120.0 * 2.0 - 1.0


def heads(h, params, batch):
    """Pooled features (batch * 2, C, frames, mel) -> (mid, side)."""
    h = h.mean(dim=3)
    h = h.amax(dim=2) + h.mean(dim=2)
    h = h.reshape(batch, 2, -1)

    def fc(name, v):
        return v @ params[f"{name}.weight"].to(v.dtype).T + params[
            f"{name}.bias"].to(v.dtype)

    return fc("fc_mid", h[:, 0]), fc("fc_side", h[:, 1])


def mid_side(x):
    return torch.stack([(x[:, 0] + x[:, 1]) / 2.0, (x[:, 0] - x[:, 1]) / 2.0],
                       dim=1)


def forward(params: dict, x: torch.Tensor, enc: dict,
            conv_quant=no_quant) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode forward of x (batch, 2, T) in x's dtype -> (mid, side)."""
    if enc["input_norm"] != "minmax":
        raise ValueError("the reference covers input_norm minmax")
    batch, _, T = x.shape
    h = minmax(logmel(mid_side(x).reshape(batch * 2, T), enc))
    h = conv_stack(h, params, enc, eval_bn(params), conv_quant)
    return heads(h, params, batch)


def calibrate_bn(params: dict, clips: torch.Tensor, enc: dict) -> dict:
    """Running means and variances for every BatchNorm of the conv stack:
    each one's batch statistics over ``clips`` (n, 2, T), each
    peak-normalised, block by block as the clips pass the stack, in the
    clips' dtype (as training leaves them). With drawn statistics instead,
    a random-weight Cnn14 carries a large part common to every input
    through its blocks, its embeddings all point one way, and bfloat16's
    rounding moves a fitness further than the audio does."""
    stats = {}

    def bn(h, prefix):
        stats[f"{prefix}.running_mean"] = h.mean(dim=(0, 2, 3))
        stats[f"{prefix}.running_var"] = h.var(dim=(0, 2, 3))
        return eval_bn({**params, **stats})(h, prefix)

    x = clips / torch.clamp_min(clips.abs().amax(dim=(1, 2), keepdim=True),
                                1e-8)
    h = minmax(logmel(mid_side(x).reshape(2 * x.shape[0], -1), enc))
    conv_stack(h, params, enc, bn)
    return stats


def l2(e):
    return e / torch.clamp_min(torch.linalg.vector_norm(e, dim=-1,
                                                         keepdim=True), 1e-12)


def embed(params, x, enc, conv_quant=no_quant, chunk=None, block=8):
    """{"mid", "side"}: L2-normalised embeddings of x (batch, 2, T), each
    item peak-normalised first; with ``chunk`` the mean of its back-to-back
    chunks' embeddings (a shorter tail left out), normalised again. Runs
    ``block`` items at a time."""
    outs = {"mid": [], "side": []}
    for i in range(0, x.shape[0], block):
        xb = x[i:i + block]
        if chunk is not None and xb.shape[-1] > chunk:
            n = (xb.shape[-1] - chunk) // chunk + 1
            parts = xb[..., :n * chunk].unfold(-1, chunk, chunk)  # (b, 2, n, L)
            parts = parts.permute(0, 2, 1, 3).reshape(-1, 2, chunk)
            e = embed(params, parts, enc, conv_quant, block=block)
            for k in outs:
                outs[k].append(l2(e[k].reshape(xb.shape[0], n, -1).mean(1)))
            continue
        peak = xb.abs().amax(dim=(1, 2), keepdim=True)
        mid, side = forward(params, xb / torch.clamp_min(peak, 1e-8), enc,
                            conv_quant)
        outs["mid"].append(l2(mid))
        outs["side"].append(l2(side))
    return {k: torch.cat(v) for k, v in outs.items()}

