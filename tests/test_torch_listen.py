"""The listening-test correlation (``eval/listen.py``) and the embedding
projection (``eval/visualize.py``) against st_ito_tpu's on the CPU.

Tolerances: ranks and correlations on the same numbers exactly; the MFCC
metric's similarities within 1e-5 and its correlations within 1e-5 (the
Spearman of the similarities is held to equal ranks); PCA projections
within 1e-5 x max|want| up to the sign of each axis (a singular vector's
sign is arbitrary)."""

import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from st_ito_tpu.eval import listen as jlisten
from st_ito_tpu.eval import visualize as jviz
from st_ito_tpu.models.registry import (
    get_mfcc_feature_embeds as jax_mfcc_embeds,
    load_mfcc_feature_extractor as jax_load_mfcc,
)
from st_ito_tpu.ops import distortion as jax_distortion

from st_ito_torch.eval import listen, visualize
from st_ito_torch.models import (get_mfcc_feature_embeds,
                                 load_mfcc_feature_extractor)
from st_ito_torch.utils import save_audio
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000


@pytest.mark.parametrize("seed", range(4))
def test_ranks_and_correlations_match_jax(seed):
    """Ties (values drawn from a few levels), reversed and constant
    inputs, whose correlation is 0."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 5, 12).astype(np.float64)
    b = a * 0.5 + rng.standard_normal(12)
    np.testing.assert_array_equal(listen._rankdata(a), jlisten._rankdata(a))
    for u, v in ((a, b), (a, -a), (b, np.ones(12))):
        assert listen.spearman(u, v) == jlisten.spearman(u, v)
        assert listen.pearson(u, v) == jlisten.pearson(u, v)


def stimuli():
    """Five pairs of a decaying tone and its distortion (more drive, a
    lower synthetic rating), as ``tests/test_listen_plots.py`` makes
    them; the JAX op renders both packages' b."""
    t = np.arange(SR // 2) / SR
    base = (np.sin(2 * np.pi * 220 * t) * np.exp(-((t % 0.25) / 0.1))
            ).astype(np.float32)
    x = np.stack([base, base * 0.9]) * 0.6
    return [{"a": x, "b": np.asarray(jax_distortion(jnp.asarray(x), d)),
             "rating": 1.0 - d / 40.0} for d in (0.0, 6.0, 12.0, 24.0, 36.0)]


def test_listening_correlation_matches_jax(tmp_path):
    """evaluate_listening_correlation with the MFCC metric, and the same
    stimuli through load_ratings_json (16-bit WAVs on disk)."""
    st = stimuli()
    got = listen.evaluate_listening_correlation(
        st, {"mfcc": (load_mfcc_feature_extractor(),
                      get_mfcc_feature_embeds)}, SR, device="cpu")["mfcc"]
    want = jlisten.evaluate_listening_correlation(
        st, {"mfcc": (jax_load_mfcc(), jax_mfcc_embeds)}, SR)["mfcc"]
    np.testing.assert_allclose(got["similarities"], want["similarities"],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(listen._rankdata(got["similarities"]),
                                  jlisten._rankdata(want["similarities"]))
    assert got["spearman"] == pytest.approx(want["spearman"], abs=1e-5)
    assert got["pearson"] == pytest.approx(want["pearson"], abs=1e-5)
    assert got["spearman"] > 0.8

    entries = []
    for i, s in enumerate(st):
        for tag in ("a", "b"):
            save_audio(os.path.join(tmp_path, f"{i}{tag}.wav"), s[tag], SR)
        entries.append({"a_path": str(tmp_path / f"{i}a.wav"),
                         "b_path": str(tmp_path / f"{i}b.wav"),
                         "rating": s["rating"]})
    path = tmp_path / "ratings.json"
    path.write_text(json.dumps(entries))
    got = listen.load_ratings_json(str(path))
    want = jlisten.load_ratings_json(str(path))
    for g, w in zip(got, want, strict=True):
        assert g["rating"] == w["rating"]
        np.testing.assert_array_equal(g["a"], np.asarray(w["a"]))
        np.testing.assert_array_equal(g["b"], np.asarray(w["b"]))


def test_projection_matches_jax(tmp_path):
    """"auto" falls through to PCA where umap is not installed, as in the
    JAX module; the plot is written."""
    rng = np.random.default_rng(5)
    E = np.concatenate([rng.standard_normal((20, 32)) + 4.0,
                        rng.standard_normal((20, 32)) - 4.0])
    labels = np.asarray([0] * 20 + [1] * 20)
    want = jviz.project_embeddings(E, "pca")
    for method in ("auto", "pca"):
        got = visualize.project_embeddings(E, method)
        assert got.shape == (40, 2)
        sign = np.sign((got * want).sum(axis=0))
        np.testing.assert_allclose(got * sign, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    out = str(tmp_path / "viz.png")
    P = visualize.plot_embeddings(E, labels, ["a", "b"], out_path=out,
                                  method="pca")
    assert os.path.isfile(out) and P.shape == (40, 2)
    assert abs(P[:20, 0].mean() - P[20:, 0].mean()) > 1.0
