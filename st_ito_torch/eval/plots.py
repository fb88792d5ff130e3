"""Figures from the evaluation results' JSON — port of
``st_ito_tpu/eval/plots.py``: PSM accuracy against the number of
distractors, style-transfer similarity and time per method, and sweep
curves. matplotlib is imported when a figure is drawn, not with the
module."""

from __future__ import annotations

import json
import os

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_psm_results(results: dict | str, out_path: str = "psm.png"):
    """Accuracy vs #distractors per metric/condition."""
    if isinstance(results, str):
        with open(results) as f:
            results = json.load(f)
    plt = _mpl()
    conditions = list(results)
    fig, axs = plt.subplots(1, len(conditions), figsize=(5 * len(conditions), 4),
                            squeeze=False)
    for ci, cond in enumerate(conditions):
        ax = axs[0][ci]
        for metric, res in results[cond].items():
            acc = res["accuracy_by_distractors"]
            ds = sorted(int(d) for d in acc)
            ax.plot(ds, [acc[str(d)] if str(d) in acc else acc[d] for d in ds],
                    marker="o", label=metric)
        ax.plot(ds, [1.0 / (d + 1) for d in ds], "k--", alpha=0.5,
                label="chance")
        ax.set_title(cond)
        ax.set_xlabel("# distractors")
        ax.set_ylabel("accuracy")
        ax.set_ylim(0, 1.05)
        ax.legend(fontsize=8)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_pst_results(results: dict | str, out_path: str = "pst.png",
                     metric_key: str | None = None):
    """Grouped bars: style similarity per method, averaged over examples."""
    if isinstance(results, str):
        with open(results) as f:
            results = json.load(f)
    plt = _mpl()
    methods: dict[str, list[float]] = {}
    times: dict[str, list[float]] = {}
    for ex in results.values():
        for method, entry in ex.items():
            keys = [k for k in entry if k.endswith("_sim")]
            if metric_key:
                keys = [k for k in keys if k.startswith(metric_key)]
            for k in keys:
                methods.setdefault(method, []).append(entry[k])
            times.setdefault(method, []).append(entry.get("time_elapsed", 0.0))
    names = list(methods)
    fig, axs = plt.subplots(1, 2, figsize=(11, 4))
    axs[0].bar(names, [np.mean(methods[m]) for m in names],
               yerr=[np.std(methods[m]) for m in names], capsize=4)
    axs[0].set_ylabel("style similarity")
    axs[0].tick_params(axis="x", rotation=30)
    axs[1].bar(names, [np.mean(times[m]) for m in names])
    axs[1].set_ylabel("wall-clock (s)")
    axs[1].tick_params(axis="x", rotation=30)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_sweep_results(sweeps: dict, out_path: str = "sweep.png"):
    """{label: result of sweep_parameter} -> similarity-vs-value curves."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 4))
    for label, res in sweeps.items():
        ax.plot(res["values"], res["similarities"], marker=".",
                label=f"{label} (rho={res['monotonicity']:.2f})")
    ax.set_xlabel("parameter value")
    ax.set_ylabel("similarity to value 0")
    ax.legend(fontsize=8)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
