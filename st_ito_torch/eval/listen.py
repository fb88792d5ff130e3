"""Human-correlation analysis for listening-test stimuli — port of
``st_ito_tpu/eval/listen.py``: each metric's similarity over stimulus
pairs, and its Spearman and Pearson correlation with the human ratings,
the evidence that a style metric tracks perception."""

from __future__ import annotations

import json

import numpy as np
import torch

from st_ito_torch.eval.metrics import style_similarity
from st_ito_torch.utils import resolve_device


def _rankdata(a: np.ndarray) -> np.ndarray:
    """Ranks from 0, ties given their average rank."""
    _, inv, counts = np.unique(a, return_inverse=True, return_counts=True)
    cum = np.cumsum(counts) - counts
    avg = cum + (counts - 1) / 2.0
    return avg[inv.reshape(-1)]


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    ra, rb = _rankdata(np.asarray(a)), _rankdata(np.asarray(b))
    ra -= ra.mean()
    rb -= rb.mean()
    d = np.sqrt((ra**2).sum() * (rb**2).sum())
    return float((ra * rb).sum() / d) if d > 0 else 0.0


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64) - np.mean(a)
    b = np.asarray(b, np.float64) - np.mean(b)
    d = np.sqrt((a**2).sum() * (b**2).sum())
    return float((a * b).sum() / d) if d > 0 else 0.0


def evaluate_listening_correlation(stimuli: list[dict], metrics: dict,
                                   sample_rate: int = 48000,
                                   device="cuda") -> dict:
    """stimuli: [{"a": (C, T) array, "b": (C, T) array, "rating": float}];
    metrics: name -> (model, embed_func), the models on ``device``. Returns
    each metric's correlations and similarities."""
    dev = resolve_device(device)
    ratings = np.asarray([s["rating"] for s in stimuli], np.float64)
    results = {}
    for name, (model, embed_func) in metrics.items():
        sims = []
        for s in stimuli:
            batch = torch.as_tensor(np.stack([s["a"], s["b"]]),
                                    dtype=torch.float32, device=dev)
            e = embed_func(batch, model, sample_rate)
            ea = {k: v[0:1] for k, v in e.items()}
            eb = {k: v[1:2] for k, v in e.items()}
            sims.append(float(style_similarity(ea, eb)[0]))
        sims = np.asarray(sims)
        results[name] = {
            "spearman": spearman(sims, ratings),
            "pearson": pearson(sims, ratings),
            "similarities": sims.tolist(),
        }
    return results


def load_ratings_json(path: str) -> list[dict]:
    """[{"a_path", "b_path", "rating"}] with the WAVs on disk -> stimuli."""
    from st_ito_torch.utils import load_audio

    with open(path) as f:
        entries = json.load(f)
    stimuli = []
    for e in entries:
        a, _ = load_audio(e["a_path"])
        b, _ = load_audio(e["b_path"])
        stimuli.append({"a": a, "b": b, "rating": float(e["rating"])})
    return stimuli
