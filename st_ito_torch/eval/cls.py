"""Style classification: a linear probe and zero-shot nearest reference
on frozen embeddings — port of ``st_ito_tpu/eval/cls.py``.

The five production styles (neutral, warm, bright, broadcast, telephone)
are parameter settings of the port's own ops, so the benchmark needs no
rendered dataset. ``render_style`` runs the EQ and filters by frequency
sampling and the compressor op by op: it launches no CUDA kernel of the
port."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from st_ito_torch.ops.dynamics import compressor
from st_ito_torch.ops.eq import parametric_eq
from st_ito_torch.ops.iir import apply_iir_fsm, biquad_coeffs
from st_ito_torch.utils import resolve_device

STYLES = ("neutral", "warm", "bright", "broadcast", "telephone")


def render_style(x: torch.Tensor, style: str, sample_rate: int
                 ) -> torch.Tensor:
    """One of the five styles applied to (C, T) audio on its device."""
    if style == "neutral":
        return x
    if style == "bright":
        return parametric_eq(x, sample_rate, high_shelf_gain_db=12.0,
                             high_shelf_cutoff_freq=4000.0,
                             low_shelf_gain_db=-4.0)
    if style == "warm":
        return parametric_eq(x, sample_rate, low_shelf_gain_db=8.0,
                             low_shelf_cutoff_freq=200.0,
                             high_shelf_gain_db=-8.0,
                             high_shelf_cutoff_freq=4000.0)
    if style == "broadcast":
        y = compressor(x, sample_rate, threshold_db=-30.0, ratio=8.0,
                       attack_ms=5.0, release_ms=100.0, knee_db=3.0,
                       makeup_gain_db=12.0)
        return torch.tanh(y)
    if style == "telephone":
        b_hp, a_hp = biquad_coeffs(0.0, 300.0, 0.707, sample_rate, "highpass")
        b_lp, a_lp = biquad_coeffs(0.0, 3400.0, 0.707, sample_rate, "lowpass")
        b = torch.stack([b_hp, b_lp]).to(x.device)
        a = torch.stack([a_hp, a_lp]).to(x.device)
        return apply_iir_fsm(x, b, a)
    raise ValueError(f"unknown style: {style}")


def make_style_dataset(audio_sources, sample_rate=48000, per_style=8,
                       length=65536, seed=0, device="cuda"):
    """``per_style`` crops of the sources (numpy's ``default_rng(seed)``
    picks each source and offset, as in the JAX package) rendered to every
    style on ``device`` and peak-normalised. Returns (clips (N, 2, T),
    labels (N,)) as numpy arrays."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    clips, labels = [], []
    for si, style in enumerate(STYLES):
        for _ in range(per_style):
            src = audio_sources[int(rng.integers(0, len(audio_sources)))]
            _, T = src.shape
            s = int(rng.integers(0, max(T - length, 1)))
            x = src[:, s:s + length]
            if x.shape[-1] < length:
                x = np.pad(x, ((0, 0), (0, length - x.shape[-1])))
            if x.shape[0] == 1:
                x = np.repeat(x, 2, axis=0)
            y = render_style(torch.as_tensor(x, dtype=torch.float32,
                                             device=dev), style, sample_rate)
            y = y.cpu().numpy()
            clips.append(y / max(np.abs(y).max(), 1e-8))
            labels.append(si)
    return np.stack(clips), np.asarray(labels)


def _embed_all(clips, model, embed_func, sample_rate, batch=8,
               device="cuda") -> torch.Tensor:
    """Every clip's heads concatenated, (N, D), on ``device``."""
    dev = resolve_device(device)
    embeds = []
    for s in range(0, len(clips), batch):
        e = embed_func(torch.as_tensor(clips[s:s + batch],
                                       dtype=torch.float32, device=dev),
                       model, sample_rate)
        embeds.append(torch.cat(list(e.values()), dim=-1))
    return torch.cat(embeds).to(torch.float32)


def run_zero_shot_task(clips, labels, model, embed_func, sample_rate=48000,
                       num_refs: int = 1, seed: int = 0,
                       device="cuda") -> float:
    """Nearest-reference classification: ``num_refs`` clips of each style
    (numpy's ``default_rng(seed)``) average into its reference, and every
    other clip takes the style of the reference it is most similar to."""
    rng = np.random.default_rng(seed)
    E = _embed_all(clips, model, embed_func, sample_rate,
                   device=device).cpu().numpy()
    E = E / np.maximum(np.linalg.norm(E, axis=-1, keepdims=True), 1e-12)

    n_styles = labels.max() + 1
    ref_idx = []
    for s in range(n_styles):
        members = np.where(labels == s)[0]
        ref_idx.extend(rng.choice(members, num_refs, replace=False))
    ref_idx = np.asarray(ref_idx)
    refs = E[ref_idx].reshape(n_styles, num_refs, -1).mean(axis=1)

    query = np.setdiff1d(np.arange(len(labels)), ref_idx)
    preds = np.argmax(E[query] @ refs.T, axis=-1)
    return float((preds == labels[query]).mean())


def train_probe(X: torch.Tensor, y: torch.Tensor, n_classes: int,
                steps: int = 300, lr: float = 1e-2):
    """A linear classifier (W (D, n_classes), b (n_classes,)) from zeros,
    ``steps`` full-batch Adam steps on the mean cross-entropy, in float32
    on X's device: optax.adam's update (b1 0.9, b2 0.999, eps 1e-8)."""
    W = torch.zeros(X.shape[-1], n_classes, device=X.device,
                    requires_grad=True)
    b = torch.zeros(n_classes, device=X.device, requires_grad=True)
    opt = torch.optim.Adam([W, b], lr=lr, eps=1e-8)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        F.cross_entropy(X @ W + b, y).backward()
        opt.step()
    return W.detach(), b.detach()


def run_probe_task(clips, labels, model, embed_func, sample_rate=48000,
                   train_frac: float = 0.7, steps: int = 300,
                   lr: float = 1e-2, seed: int = 0, device="cuda") -> float:
    """Linear-probe accuracy on frozen embeddings: a split drawn by numpy's
    ``default_rng(seed)``, ``train_probe`` on the first ``train_frac``,
    accuracy on the rest."""
    rng = np.random.default_rng(seed)
    E = _embed_all(clips, model, embed_func, sample_rate, device=device)
    n = len(labels)
    perm = rng.permutation(n)
    n_train = int(n * train_frac)
    tr, te = perm[:n_train], perm[n_train:]
    y = torch.as_tensor(labels, device=E.device)
    with torch.enable_grad():
        W, b = train_probe(E[tr], y[tr], int(labels.max() + 1), steps, lr)
    preds = torch.argmax(E[te] @ W + b, dim=-1).cpu().numpy()
    return float((preds == labels[te]).mean())
