"""Embedding-space visualisation — port of ``st_ito_tpu/eval/visualize.py``:
a 2-D projection of style embeddings (UMAP where ``umap`` is installed,
else PCA by SVD) and a scatter plot coloured by style label. It works on
numpy arrays on the host; matplotlib is imported when a figure is drawn."""

from __future__ import annotations

import os

import numpy as np


def project_embeddings(E: np.ndarray, method: str = "auto", dim: int = 2):
    """E (N, D) -> (N, dim). ``"auto"`` takes UMAP if it imports, else PCA;
    ``"umap"`` insists on UMAP. The signs of PCA's axes are arbitrary."""
    if method in ("auto", "umap"):
        try:
            import umap

            return umap.UMAP(n_components=dim).fit_transform(E)
        except ImportError:
            if method == "umap":
                raise
    E = E - E.mean(axis=0, keepdims=True)
    _, _, Vt = np.linalg.svd(E, full_matrices=False)
    return E @ Vt[:dim].T


def plot_embeddings(E: np.ndarray, labels: np.ndarray,
                    label_names: list[str] | None = None,
                    out_path: str = "embeddings.png", method: str = "auto",
                    title: str = "style embeddings") -> np.ndarray:
    """Project and scatter; returns the 2-D projection."""
    P = project_embeddings(E, method)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 5))
    for lab in np.unique(labels):
        mask = labels == lab
        name = label_names[int(lab)] if label_names else str(lab)
        ax.scatter(P[mask, 0], P[mask, 1], s=14, label=name, alpha=0.75)
    ax.set_title(title)
    ax.legend(fontsize=8)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return P
