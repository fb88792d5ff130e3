"""The LAION-CLAP audio tower (HTSAT-unfused) as an ``nn.Module`` — port
of ``st_ito_tpu/models/clap_laion.py``, the ``--metric clap`` backend and
the frozen "-pt" pretext encoder:

  log-mel input features -> per-mel-bin BatchNorm (its running statistics)
  -> ``reshape_mel2img`` (the 1024-frame spectrogram stacked into a
  256 x 256 image, bicubic align-corners interpolation when shorter, as a
  matrix) -> 4 x 4 patch conv -> 4 Swin stages (windowed attention with a
  relative position bias, the odd blocks' windows cyclically shifted under
  the Swin attention mask, patch merging) -> LayerNorm -> mean pool -> a
  two-layer ReLU projection to the 512-d CLAP space.

The module's ``state_dict`` takes transformers' names for
``ClapAudioModelWithProjection``: ``audio_model.audio_encoder.*`` and
``audio_projection.*`` (``hf_state_dict`` also reads the bare
``audio_encoder.`` prefix and a whole ``ClapModel``'s ``state_dict``). The
attention is written as plain products and a softmax, as the JAX tower
has it. It runs in float32 with TF32 off (``no_tf32``).

The mel front end is ``ClapFeatureExtractor``'s for the unfused model:
48 kHz, n_fft 1024, hop 480, 64 Slaney-scale, Slaney-normed mel bins,
``power_to_db`` with amin 1e-10.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from st_ito_torch.models.cnn14 import no_tf32
from st_ito_torch.models.encoders import frozen
from st_ito_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class ClapLaionConfig:
    # the published laion/clap-htsat-unfused configuration
    spec_size: int = 256
    patch: int = 4
    n_mels: int = 64
    window: int = 8
    depths: tuple = (2, 2, 6, 2)
    heads: tuple = (4, 8, 16, 32)
    patch_dim: int = 96
    hidden: int = 768  # patch_dim * 2**(len(depths)-1)
    proj_dim: int = 512
    mlp_ratio: float = 4.0
    eps: float = 1e-5
    # front end
    sample_rate: int = 48000
    n_fft: int = 1024
    hop: int = 480
    fmin: float = 50.0
    fmax: float = 14000.0
    max_samples: int = 480000  # the 10 s context
    # a converted checkpoint for the "-pt" pretext role
    ckpt_path: str | None = None

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.n_mels

    @property
    def embed_dim(self) -> int:  # the pretext head's width
        return self.proj_dim


# ------------------------------------------------------------- attention


def _rel_index(win: int, full_window: int) -> np.ndarray:
    """Relative-position index of a win x win window into the
    (2*full_window-1)^2 bias table (Swin's construction; sub-centred when
    the layer's window is clamped below the table's)."""
    coords = np.stack(np.meshgrid(np.arange(win), np.arange(win),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (full_window - 1)
    return (rel[..., 0] * (2 * full_window - 1) + rel[..., 1]).astype(
        np.int64)


def _swin_attn_mask(Hp: int, Wp: int, win: int, shift: int) -> np.ndarray:
    """(num_windows, N, N) additive mask of shifted windows (0 / -100),
    transformers' get_attn_mask."""
    img = np.zeros((Hp, Wp))
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(Hp // win, win, Wp // win, win)
    img = img.transpose(0, 2, 1, 3).reshape(-1, win * win)
    mask = img[:, None, :] - img[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class _Dense(nn.Module):
    """A linear layer under transformers' ``<name>.dense`` nesting."""

    def __init__(self, i: int, o: int):
        super().__init__()
        self.dense = nn.Linear(i, o)


class ClapSelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_rel_index(window, window)))


class ClapAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.self = ClapSelfAttention(dim, heads, window)
        self.output = _Dense(dim, dim)


class ClapSwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, cfg: ClapLaionConfig):
        super().__init__()
        hidden = int(dim * cfg.mlp_ratio)
        self.layernorm_before = nn.LayerNorm(dim, eps=cfg.eps)
        self.attention = ClapAttention(dim, heads, cfg.window)
        self.layernorm_after = nn.LayerNorm(dim, eps=cfg.eps)
        self.intermediate = _Dense(dim, hidden)
        self.output = _Dense(hidden, dim)


class ClapPatchMerging(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=eps)


class ClapStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, downsample: bool,
                 cfg: ClapLaionConfig):
        super().__init__()
        self.blocks = nn.ModuleList(ClapSwinBlock(dim, heads, cfg)
                                    for _ in range(depth))
        if downsample:
            self.downsample = ClapPatchMerging(dim, cfg.eps)


class ClapPatchEmbed(nn.Module):
    def __init__(self, cfg: ClapLaionConfig):
        super().__init__()
        self.proj = nn.Conv2d(1, cfg.patch_dim, cfg.patch, stride=cfg.patch)
        self.norm = nn.LayerNorm(cfg.patch_dim, eps=cfg.eps)


class ClapAudioEncoder(nn.Module):
    def __init__(self, cfg: ClapLaionConfig):
        super().__init__()
        self.batch_norm = nn.BatchNorm2d(cfg.n_mels)
        self.patch_embed = ClapPatchEmbed(cfg)
        dims = [cfg.patch_dim * 2 ** i for i in range(len(cfg.depths))]
        self.layers = nn.ModuleList(
            ClapStage(dims[i], d, cfg.heads[i], i < len(cfg.depths) - 1, cfg)
            for i, d in enumerate(cfg.depths))
        self.norm = nn.LayerNorm(dims[-1], eps=cfg.eps)


class ClapAudioModel(nn.Module):
    def __init__(self, cfg: ClapLaionConfig):
        super().__init__()
        self.audio_encoder = ClapAudioEncoder(cfg)


class ClapProjection(nn.Module):
    def __init__(self, cfg: ClapLaionConfig):
        super().__init__()
        dim = cfg.patch_dim * 2 ** (len(cfg.depths) - 1)
        self.linear1 = nn.Linear(dim, cfg.proj_dim)
        self.linear2 = nn.Linear(cfg.proj_dim, cfg.proj_dim)


def _stage_window(H: int, W: int, window: int) -> tuple[int, int]:
    """(win, the odd blocks' shift) of a stage on an H x W grid: the
    window clamped to the grid; transformers zeroes the shift whenever
    min(H, W) <= window."""
    win = min(window, H, W)
    return win, (win // 2 if win < min(H, W) else 0)


def _window_attention(block: ClapSwinBlock, x: torch.Tensor, H: int, W: int,
                      heads: int, win: int, shift: int, idx: torch.Tensor,
                      mask: torch.Tensor | None):
    """One Swin block's attention half: x (B, H*W, C) -> (B, H*W, C), on
    win x win windows rolled by ``shift`` under ``mask`` (None unrolled),
    the bias table read at ``idx``."""
    B, N, C = x.shape

    h = block.layernorm_before(x).reshape(B, H, W, C)
    pad_b, pad_r = (-H) % win, (-W) % win
    if pad_b or pad_r:
        h = F.pad(h, (0, 0, 0, pad_r, 0, pad_b))
    Hp, Wp = H + pad_b, W + pad_r
    if shift:
        h = torch.roll(h, (-shift, -shift), dims=(1, 2))
    nW, n = (Hp // win) * (Wp // win), win * win
    h = h.reshape(B, Hp // win, win, Wp // win, win, C)
    h = h.permute(0, 1, 3, 2, 4, 5).reshape(B * nW, n, C)

    sa = block.attention.self
    d = C // heads

    def split(t):
        return t.reshape(-1, n, heads, d).transpose(1, 2)

    q, k, v = split(sa.query(h)), split(sa.key(h)), split(sa.value(h))
    attn = (q @ k.transpose(-1, -2)) / math.sqrt(d)
    bias = sa.relative_position_bias_table[idx.reshape(-1)].reshape(
        n, n, heads).permute(2, 0, 1)
    attn = attn + bias[None]
    if shift:
        attn = (attn.reshape(B, nW, heads, n, n)
                + mask[None, :, None]).reshape(B * nW, heads, n, n)
    out = torch.softmax(attn, dim=-1) @ v
    out = block.attention.output.dense(out.transpose(1, 2).reshape(-1, n, C))

    out = out.reshape(B, Hp // win, Wp // win, win, win, C)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    if shift:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    if pad_b or pad_r:
        out = out[:, :H, :W]
    return out.reshape(B, N, C)


class ClapAudioTower(nn.Module):
    """forward(input_features (B, 1, frames, n_mels)) -> (pooled (B,
    hidden), projected (B, proj_dim)): transformers'
    ``ClapAudioModelWithProjection`` for the unfused model."""

    def __init__(self, config: ClapLaionConfig = ClapLaionConfig()):
        super().__init__()
        self.config = config
        self.audio_model = ClapAudioModel(config)
        self.audio_projection = ClapProjection(config)
        # the constants of the config's fixed grid, built once as
        # non-persistent buffers (the state_dict keeps transformers' names):
        # each stage's shifted-window mask and clamped bias index, the
        # bicubic resize of the 10 s context's frames, the mel front end's
        # window and filterbank
        H = W = config.spec_size // config.patch
        self.grids = []
        for si, stage in enumerate(self.audio_model.audio_encoder.layers):
            win, shift = _stage_window(H, W, config.window)
            self.grids.append((H, W, win, shift))
            if win != config.window:
                stage.register_buffer("rel_index", torch.from_numpy(
                    _rel_index(win, config.window)), persistent=False)
            if shift:
                Hp, Wp = H + (-H) % win, W + (-W) % win
                stage.register_buffer("attn_mask", torch.from_numpy(
                    _swin_attn_mask(Hp, Wp, win, shift)), persistent=False)
            H, W = (H + 1) // 2, (W + 1) // 2
        frames = config.max_samples // config.hop + 1
        spec_w = config.spec_size * config.freq_ratio
        for name, src, dst in (
                ("time_resize", frames, spec_w),
                ("freq_resize", config.n_mels,
                 config.spec_size // config.freq_ratio)):
            M = _cubic_resize_matrix(src, dst) if src < dst else None
            self.register_buffer(
                name, None if M is None else torch.from_numpy(M),
                persistent=False)
        from st_ito_torch.ops.stft import hann_window, mel_filterbank

        self.register_buffer("mel_window", hann_window(config.n_fft),
                             persistent=False)
        self.register_buffer("mel_fb", mel_filterbank(
            config.sample_rate, config.n_fft, config.n_mels, config.fmin,
            config.fmax, htk=False, norm="slaney"), persistent=False)
        frozen(self)

    def forward(self, input_features: torch.Tensor):
        cfg = self.config
        enc = self.audio_model.audio_encoder
        with no_tf32():
            bn = enc.batch_norm
            scale = bn.weight * torch.rsqrt(bn.running_var + 1e-5)
            shift = bn.bias - bn.running_mean * scale
            feats = input_features.to(torch.float32) * scale + shift

            img = reshape_mel2img(feats, cfg, self.time_resize,
                                  self.freq_resize)  # (B, 1, S, S)
            h = enc.patch_embed.proj(img)
            B, C, H, W = h.shape
            h = enc.patch_embed.norm(h.reshape(B, C, H * W).transpose(1, 2))

            for si, layer in enumerate(enc.layers):
                _, _, win, shift = self.grids[si]
                for bi, block in enumerate(layer.blocks):
                    sa = block.attention.self
                    idx = getattr(layer, "rel_index",
                                  sa.relative_position_index)
                    rolled = bi % 2 == 1 and shift > 0
                    h = h + _window_attention(
                        block, h, H, W, cfg.heads[si], win,
                        shift if rolled else 0, idx,
                        layer.attn_mask if rolled else None)
                    m = block.layernorm_after(h)
                    m = F.gelu(block.intermediate.dense(m))  # exact
                    h = h + block.output.dense(m)
                if hasattr(layer, "downsample"):
                    hh = h.reshape(B, H, W, -1)
                    if H % 2 or W % 2:
                        hh = F.pad(hh, (0, 0, 0, W % 2, 0, H % 2))
                    hh = torch.cat([hh[:, 0::2, 0::2], hh[:, 1::2, 0::2],
                                    hh[:, 0::2, 1::2], hh[:, 1::2, 1::2]],
                                   dim=-1)
                    H, W = (H + 1) // 2, (W + 1) // 2
                    hh = layer.downsample.norm(hh.reshape(B, H * W, -1))
                    h = layer.downsample.reduction(hh)

            pooled = enc.norm(h).mean(dim=1)  # transformers' avgpool
            proj = self.audio_projection
            out = proj.linear2(F.relu(proj.linear1(pooled)))
        return pooled, out


# ------------------------------------------------------------- front end


def _cubic_resize_matrix(src: int, dst: int) -> np.ndarray | None:
    """(dst, src) matrix of 1-D bicubic interpolation with
    align_corners=True and A=-0.75 (F.interpolate's convention)."""
    if src == dst:
        return None

    def kern(t):
        at = np.abs(t)
        A = -0.75
        return np.where(
            at <= 1.0, ((A + 2) * at - (A + 3)) * at * at + 1,
            np.where(at < 2.0, (((at - 5) * at + 8) * at - 4) * A, 0.0))

    x = np.arange(dst) * (src - 1) / (dst - 1)
    i0 = np.floor(x).astype(int)
    t = x - i0
    W = np.zeros((dst, src))
    for tap in (-1, 0, 1, 2):
        idx = np.clip(i0 + tap, 0, src - 1)
        W[np.arange(dst), idx] += kern(tap - t)
    return W.astype(np.float32)


def reshape_mel2img(feats: torch.Tensor, cfg: ClapLaionConfig,
                    time_resize: torch.Tensor | None = None,
                    freq_resize: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """(B, 1, frames, n_mels) -> (B, 1, spec_size, spec_size):
    transformers' ClapAudioEncoder.reshape_mel2img, its interpolation as a
    matrix product (``time_resize`` / ``freq_resize``, where given and of
    the input's size, else built here)."""
    B, C, T, Fq = feats.shape
    spec_w = cfg.spec_size * cfg.freq_ratio
    spec_h = cfg.spec_size // cfg.freq_ratio
    if T > spec_w or Fq > spec_h:
        raise ValueError("input longer than the swin input size")

    def resize(M, src, dst):
        if M is None or M.shape[1] != src:
            M = torch.from_numpy(_cubic_resize_matrix(src, dst)).to(
                feats.device)
        return M

    if T < spec_w:
        feats = torch.einsum("wt,bctf->bcwf",
                             resize(time_resize, T, spec_w), feats)
    if Fq < spec_h:
        feats = torch.einsum("hf,bctf->bcth",
                             resize(freq_resize, Fq, spec_h), feats)
    B, C, T, Fq = feats.shape
    r = cfg.freq_ratio
    feats = feats.reshape(B, C * r, T // r, Fq).transpose(2, 3)
    return feats.reshape(B, C, Fq * r, T // r)


def clap_mel(x: torch.Tensor, cfg: ClapLaionConfig,
             net: ClapAudioTower | None = None) -> torch.Tensor:
    """Waveform (B, T) at cfg.sample_rate -> (B, frames, n_mels) log-mel
    dB: ClapFeatureExtractor's rand_trunc path (Slaney mel filters, the
    power spectrogram, 10 log10 with amin 1e-10); the window and the
    filterbank are ``net``'s buffers where a tower is given."""
    from st_ito_torch.ops.stft import (hann_window, mel_filterbank,
                                       power_to_db, stft)

    if net is not None:
        w, mel_w = net.mel_window, net.mel_fb
    else:
        w = hann_window(cfg.n_fft, x.device)
        mel_w = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                               cfg.fmin, cfg.fmax, htk=False,
                               norm="slaney").to(x.device)
    S = torch.abs(stft(x, cfg.n_fft, cfg.hop, center=True, window=w)) ** 2
    with no_tf32():
        return power_to_db(S @ mel_w, ref=1.0, amin=1e-10)


# ------------------------------------------------------------- weights


def hf_state_dict(sd: dict) -> dict:
    """A transformers ``ClapModel`` or ``ClapAudioModelWithProjection``
    state_dict (or one whose encoder keys carry the bare
    ``audio_encoder.`` prefix) -> the tower's entries under the tower's
    names; the text tower's and the logit scales' are left out."""
    out = {}
    for k, v in sd.items():
        if k.startswith(("audio_model.audio_encoder.", "audio_projection.")):
            out[k] = v
        elif k.startswith("audio_encoder."):
            out["audio_model." + k] = v
    return out


def init_clap_laion_(net: ClapAudioTower, generator: torch.Generator
                     ) -> ClapAudioTower:
    """The JAX init scheme: truncated normals (std 0.02, clipped at two
    standard deviations) for the patch conv, every linear and the bias
    tables, zero biases, unit norms, the BatchNorm at its defaults."""
    def tn_(t, std=0.02):
        t.copy_(torch.clamp(torch.randn(t.shape, generator=generator) * std,
                            -2 * std, 2 * std))

    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                tn_(m.weight)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                m.reset_parameters()
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
            elif isinstance(m, ClapSelfAttention):
                tn_(m.relative_position_bias_table)
    return net


# ------------------------------------------------------------- model API


@dataclasses.dataclass
class ClapLaionModel:
    net: ClapAudioTower
    config: ClapLaionConfig = ClapLaionConfig()
    embed_dim: int = 512


def load_clap_laion_model(ckpt_path: str | None = (
        "checkpoints/clap-htsat-unfused.pt"), allow_random: bool = False,
        seed: int = 0, config: ClapLaionConfig | None = None,
        device="cuda") -> ClapLaionModel:
    """The tower on ``device`` (default the card), from a transformers
    ``ClapModel`` (or audio-tower) state_dict saved at ``ckpt_path`` (a
    ``.pt``/``.bin`` of the dict, or of a module), or with
    ``allow_random`` and no file random weights at ``config`` (default
    the published one) from a ``torch.Generator`` seeded with ``seed``."""
    cfg = config or ClapLaionConfig()
    if ckpt_path and os.path.isfile(ckpt_path):
        sd = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        net = ClapAudioTower(cfg)
        sd = hf_state_dict(sd)
        missing, _ = net.load_state_dict(sd, strict=False)
        # the index buffers and the step counter are derived, not learned
        missing = [k for k in missing if not k.endswith(
            ("relative_position_index", "num_batches_tracked"))]
        if missing:
            raise KeyError(f"{ckpt_path}: CLAP weights missing {missing}")
        return ClapLaionModel(net=frozen(net.to(resolve_device(device))),
                              config=cfg, embed_dim=cfg.proj_dim)
    if allow_random:
        net = init_clap_laion_(ClapAudioTower(cfg),
                               torch.Generator().manual_seed(seed))
        return ClapLaionModel(net=frozen(net.to(resolve_device(device))),
                              config=cfg, embed_dim=cfg.proj_dim)
    raise FileNotFoundError(
        "LAION-CLAP checkpoint unavailable offline; pass a local HF "
        "ClapModel state_dict or allow_random=True")


def _embed_mono(net: ClapAudioTower, mono: torch.Tensor, in_sr: int,
                cfg: ClapLaionConfig) -> torch.Tensor:
    """mono (B, T) at in_sr -> (B, proj_dim) L2-normalised: resampled to
    48 kHz, the 10 s context centre-cropped or repeat-padded (the
    extractor's default), the mel front end, the tower."""
    from st_ito_torch.ops.resample import resample

    mono = resample(mono, in_sr, cfg.sample_rate)
    T = mono.shape[-1]
    if T > cfg.max_samples:
        s = (T - cfg.max_samples) // 2
        mono = mono[:, s:s + cfg.max_samples]
    elif T < cfg.max_samples:
        reps = -(-cfg.max_samples // T)
        mono = mono.repeat(1, reps)[:, :cfg.max_samples]
    _, proj = net(clap_mel(mono, cfg, net)[:, None])
    norm = torch.linalg.norm(proj, dim=-1, keepdim=True)
    return proj / torch.clamp_min(norm, 1e-12)


def get_clap_laion_embeds(x: torch.Tensor, model: ClapLaionModel,
                          sample_rate, midside: bool = False, **kwargs
                          ) -> dict[str, torch.Tensor]:
    """CLAP embeddings of x (B, C, T), L2-normalised: {"mono": ...} of the
    channel mean, or with ``midside`` on stereo {"mid", "side"} of x0 + x1
    and x0 - x1 (not halved), both in one batch of the tower."""
    x = x.to(torch.float32)
    with torch.no_grad():
        if midside and x.shape[1] == 2:
            B = x.shape[0]
            both = torch.cat([x[:, 0] + x[:, 1], x[:, 0] - x[:, 1]])
            e = _embed_mono(model.net, both, int(sample_rate), model.config)
            return {"mid": e[:B], "side": e[B:]}
        return {"mono": _embed_mono(model.net, x.mean(dim=1),
                                    int(sample_rate), model.config)}


def get_clap_laion_embeds_midside(x, model, sample_rate, **kwargs) -> dict:
    """The mid/side CLAP metric (``run_optim --metric clap`` with the
    native tower), on x's device."""
    return get_clap_laion_embeds(x, model, sample_rate, midside=True,
                                 **kwargs)


def clap_laion_pretext_apply(net: ClapAudioTower, x: torch.Tensor,
                             cfg: ClapLaionConfig, training: bool = False,
                             rng=None):
    """The pretext-encoder interface: x (B, C, T) at cfg.sample_rate ->
    (mid_embed, side_embed) through the tower, unnormalised; mid and side
    are (x0 +- x1) / 2, truncated from the head to the 10 s context. The
    input BatchNorm keeps its running statistics in both modes and the
    tower holds no dropout, so ``training`` and ``rng`` change nothing."""
    B = x.shape[0]
    x = x.to(torch.float32)
    if x.shape[1] == 2:
        both = torch.cat([(x[:, 0] + x[:, 1]) / 2.0,
                          (x[:, 0] - x[:, 1]) / 2.0])
    else:
        both = x[:, 0]
    both = both[..., :cfg.max_samples]
    _, proj = net(clap_mel(both, cfg, net)[:, None])
    if x.shape[1] == 2:
        return proj[:B], proj[B:]
    return proj, proj
