"""HTS-AT, the hierarchical (Swin-style) audio transformer, as an
``nn.Module`` — port of ``st_ito_tpu/models/htsat.py``, a pretext-encoder
alternative (``cfg/pretext-htsat.yaml``) and the CLAP-ft tower
(``clap.py``): a log-mel front end normalised per item, a patch
embedding, four stages of windowed multi-head self-attention blocks with
shifted windows and a relative position bias, patch merging between
stages, a final norm, mean pool and linear head.

As in the JAX module: no attention mask on the shifted windows; the
forward roll is by (-win) // 2 and the one back by win // 2, which differ
for an odd (clamped) window; a clamped window sub-indexes the bias table;
GELU is the tanh approximation (``jax.nn.gelu``'s default); the
standardisation's deviation is the biased one. No dropout, so train and
eval mode compute the same. The parameter names are the JAX pytree's
(``stages.{i}.blocks.{j}.{norm1,qkv,proj,rel_bias,norm2,mlp1,mlp2}``,
``stages.{i}.merge``, ``patch_embed``, ``norm``, ``head``). It runs in
float32 with TF32 off (``no_tf32``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from st_ito_torch.models.cnn14 import no_tf32
from st_ito_torch.ops.stft import mel_filterbank


@dataclasses.dataclass(frozen=True)
class HTSATConfig:
    embed_dim: int = 512
    dim: int = 96
    depths: tuple = (2, 2, 6, 2)
    heads: tuple = (4, 8, 16, 32)
    window: int = 8
    patch: int = 4
    mlp_ratio: float = 4.0
    sample_rate: float = 48000.0
    window_size: int = 2048
    hop_size: int = 1024
    mel_bins: int = 128
    fmin: float = 20.0
    fmax: float = 20000.0
    num_frames: int = 256  # spectrogram frames (crop/pad)


def _rel_bias_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int64)


def _clamped_bias_index(win: int, window: int) -> np.ndarray:
    """The (2*window-1)^2 table's index of a clamped win x win window: the
    relative offsets of the smaller window re-centred in the table."""
    offset = window - win
    idx_small = _rel_bias_index(win)
    d = 2 * win - 1
    r0 = idx_small // d + offset
    r1 = idx_small % d + offset
    return r0 * (2 * window - 1) + r1


class HTSATBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_bias = nn.Parameter(torch.zeros((2 * window - 1) ** 2,
                                                 heads))
        self.norm2 = nn.LayerNorm(dim)
        self.mlp1 = nn.Linear(dim, 4 * dim)
        self.mlp2 = nn.Linear(4 * dim, dim)


class HTSATMerge(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim)
        self.norm = nn.LayerNorm(4 * dim)


class HTSATStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int,
                 merge: bool):
        super().__init__()
        self.blocks = nn.ModuleList(HTSATBlock(dim, heads, window)
                                    for _ in range(depth))
        if merge:
            self.merge = HTSATMerge(dim)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim, 1, patch, patch))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.norm = nn.LayerNorm(dim)


def _window_attention(block: HTSATBlock, x: torch.Tensor, H: int, W: int,
                      heads: int, win: int, shift: bool, idx: torch.Tensor):
    """x (B, H*W, C) -> (B, H*W, C) on win x win windows: the window
    shrinks to min(window, H, W) on small late-stage grids, the bias table
    read at ``idx`` (``_clamped_bias_index``); a shift on a grid the window
    covers is dropped."""
    B, N, C = x.shape
    shift = shift and win < min(H, W)
    h = block.norm1(x).reshape(B, H, W, C)
    if shift:
        h = torch.roll(h, ((-win) // 2, (-win) // 2), dims=(1, 2))
    pad_h, pad_w = (-H) % win, (-W) % win
    if pad_h or pad_w:
        h = F.pad(h, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    nH, nW, n = Hp // win, Wp // win, win * win
    h = h.reshape(B, nH, win, nW, win, C)
    h = h.permute(0, 1, 3, 2, 4, 5).reshape(B * nH * nW, n, C)

    qkv = block.qkv(h).reshape(-1, n, 3, heads, C // heads)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    scale = (C // heads) ** -0.5
    attn = (q * scale) @ k.transpose(-1, -2)
    bias = block.rel_bias[idx.reshape(-1)].reshape(n, n, heads).permute(
        2, 0, 1)
    out = torch.softmax(attn + bias[None], dim=-1) @ v
    out = block.proj(out.transpose(1, 2).reshape(-1, n, C))

    out = out.reshape(B, nH, nW, win, win, C)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    if pad_h or pad_w:
        out = out[:, :H, :W]
    if shift:
        out = torch.roll(out, (win // 2, win // 2), dims=(1, 2))
    return out.reshape(B, N, C)


def standardized_logmel(x: torch.Tensor, window_size: int, hop_size: int,
                        num_frames: int, mel_matrix: torch.Tensor
                        ) -> torch.Tensor:
    """The mono mix of x (B, C, T) -> (B, num_frames, mel bins): log-mel
    of Hann-windowed centred frames by ``mel_matrix`` (the caller's Slaney
    filterbank on x's device), standardised per item by its mean and
    biased deviation (floored at 1e-5), cropped or zero-padded to
    num_frames. HTS-AT's and DeepGCN's front end."""
    from st_ito_torch.ops.stft import frame_signal, hann_window, power_to_db

    mono = x.to(torch.float32).mean(dim=1)
    frames = frame_signal(mono, window_size, hop_size) * hann_window(
        window_size, x.device)
    S = torch.abs(torch.fft.rfft(frames, dim=-1)) ** 2
    with no_tf32():
        mel_db = power_to_db(S @ mel_matrix)
    mu = mel_db.mean(dim=(-1, -2), keepdim=True)
    std = mel_db.std(dim=(-1, -2), keepdim=True, correction=0)
    mel_db = (mel_db - mu) / torch.clamp_min(std, 1e-5)
    have = mel_db.shape[1]
    if have >= num_frames:
        return mel_db[:, :num_frames]
    return F.pad(mel_db, (0, 0, 0, num_frames - have))


class HTSAT(nn.Module):
    """forward(x (B, C, T)) -> (embed, embed), (B, embed_dim) each."""

    def __init__(self, config: HTSATConfig = HTSATConfig()):
        super().__init__()
        cfg = self.config = config
        self.patch_embed = PatchEmbed(cfg.dim, cfg.patch)
        dims = [cfg.dim * 2 ** i for i in range(len(cfg.depths))]
        self.stages = nn.ModuleList(
            HTSATStage(dims[i], d, cfg.heads[i], cfg.window,
                       i < len(cfg.depths) - 1)
            for i, d in enumerate(cfg.depths))
        self.norm = nn.LayerNorm(dims[-1])
        self.head = nn.Linear(dims[-1], cfg.embed_dim)
        # the constants of the config's fixed grid, built once as
        # non-persistent buffers (the state_dict keeps the JAX names):
        # each stage's window and bias index, the mel filterbank
        H, W = cfg.num_frames // cfg.patch, cfg.mel_bins // cfg.patch
        self.wins = []
        for stage in self.stages:
            win = min(cfg.window, H, W)
            self.wins.append(win)
            stage.register_buffer("bias_index", torch.from_numpy(
                _clamped_bias_index(win, cfg.window)), persistent=False)
            H, W = H // 2, W // 2
        self.register_buffer("mel_fb", mel_filterbank(
            cfg.sample_rate, cfg.window_size, cfg.mel_bins, cfg.fmin,
            cfg.fmax), persistent=False)

    def forward(self, x: torch.Tensor):
        cfg = self.config
        mel_db = standardized_logmel(x, cfg.window_size, cfg.hop_size,
                                     cfg.num_frames, self.mel_fb)
        with no_tf32():
            pe = self.patch_embed
            h = F.conv2d(mel_db[:, None], pe.weight, pe.bias,
                         stride=cfg.patch)
            B, C, H, W = h.shape
            h = pe.norm(h.permute(0, 2, 3, 1).reshape(B, H * W, C))
            for si, stage in enumerate(self.stages):
                for bi, block in enumerate(stage.blocks):
                    h = h + _window_attention(
                        block, h, H, W, cfg.heads[si], self.wins[si],
                        bi % 2 == 1, stage.bias_index)
                    m = F.gelu(block.mlp1(block.norm2(h)), approximate="tanh")
                    h = h + block.mlp2(m)
                if hasattr(stage, "merge"):
                    hh = h.reshape(B, H, W, -1)
                    hh = torch.cat([hh[:, 0::2, 0::2], hh[:, 1::2, 0::2],
                                    hh[:, 0::2, 1::2], hh[:, 1::2, 1::2]],
                                   dim=-1)
                    H, W = H // 2, W // 2
                    hh = stage.merge.norm(hh.reshape(B, H * W, -1))
                    h = stage.merge.reduction(hh)
            e = self.head(self.norm(h).mean(dim=1))
        return e, e


def init_htsat_(net: HTSAT, generator: torch.Generator) -> HTSAT:
    """The JAX init scheme: truncated normals (std 0.02, clipped at two
    standard deviations) for the patch embedding, every linear and the bias
    tables, zero biases, unit norms."""
    def tn_(t, std=0.02):
        t.copy_(torch.clamp(torch.randn(t.shape, generator=generator) * std,
                            -2 * std, 2 * std))

    with torch.no_grad():
        tn_(net.patch_embed.weight)
        net.patch_embed.bias.zero_()
        for m in net.modules():
            if isinstance(m, nn.Linear):
                tn_(m.weight)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, HTSATBlock):
                tn_(m.rel_bias)
    return net
