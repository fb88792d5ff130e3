"""Features and metrics against st_ito_tpu: ``ops/stft.py`` (``stft``,
``spectrogram``, ``logmel``, ``mfcc``, ``spectral_centroid``), the MIR
features of ``features.py``, the multi-resolution STFT loss of
``ops/losses.py``, the MFCC feature embed of ``models/registry.py`` and the
metric registry of ``eval/metrics.py``. The JAX side runs op by op on the
CPU; inputs are numpy noise under an envelope from a seed.

Tolerances: rtol 1e-4 for the transforms, each MIR feature and the loss
(with an atol of 1e-4 x the array's peak where values cross zero: the MFCC
coefficients, the STFT bins); the MFCC embed cosine > 1 - 1e-5."""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from st_ito_tpu import features as jfeat
from st_ito_tpu.eval import metrics as jmetrics
from st_ito_tpu.models import registry as jreg
from st_ito_tpu.ops import losses as jloss

from st_ito_torch import features as tfeat
from st_ito_torch.eval import metrics as tmetrics
from st_ito_torch.models import registry as treg
from st_ito_torch.ops import losses as tloss
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the modules (each package's ``ops`` exports a function of their name)
jstft = importlib.import_module("st_ito_tpu.ops.stft")
tstft = importlib.import_module("st_ito_torch.ops.stft")

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000


def _audio(seed, shape):
    """Noise under a slow envelope with a few partials, peak 0.9."""
    rng = np.random.default_rng(seed)
    T = shape[-1]
    t = np.arange(T) / SR
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 3.0 * t * SR / T)
    x = 0.3 * rng.standard_normal(shape) * env
    for f in rng.uniform(100, 6000, 3):
        x = x + 0.3 * np.sin(2 * np.pi * f * t)
    return (0.9 * x / np.abs(x).max()).astype(np.float32)


def _close(got, want, rtol=1e-4, atol_rel=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


# ------------------------------------------------------------- transforms


@pytest.mark.parametrize("center", [True, False])
def test_stft_and_spectrogram_match_jax(center):
    """The complex STFT (Hann, hop a quarter) and the power spectrogram of
    (2, 2, 8192), centred (reflect pad) and not."""
    x = _audio(0, (2, 2, 8192))
    got = tstft.stft(torch.from_numpy(x), 2048, 512, center=center)
    want = np.asarray(jstft.stft(jnp.asarray(x), 2048, 512, center=center))
    _close(torch.view_as_real(got), np.stack([want.real, want.imag], -1),
           atol_rel=1e-4)
    _close(tstft.spectrogram(torch.from_numpy(x), 2048, 512, center=center),
           jstft.spectrogram(jnp.asarray(x), 2048, 512, center=center),
           atol_rel=1e-6)


def test_logmel_matches_jax():
    x = _audio(1, (3, 8192))
    _close(tstft.logmel(torch.from_numpy(x), SR),
           jstft.logmel(jnp.asarray(x), SR), atol_rel=1e-5)


def test_mfcc_matches_jax():
    """torchaudio's MFCC semantics: HTK mel without norm, the 80 dB floor
    under the whole batch's maximum, the ortho DCT-II; (3, 1, 16384)."""
    x = _audio(2, (3, 1, 16384))
    x[1] *= 1e-3  # a quiet item: the floor comes from the others
    _close(tstft.mfcc(torch.from_numpy(x), SR),
           jstft.mfcc(jnp.asarray(x), SR), atol_rel=1e-4)
    np.testing.assert_allclose(tstft._dct_matrix(25, 128).numpy(),
                               np.asarray(jstft._dct_matrix(25, 128)))


def test_spectral_centroid_matches_jax():
    x = _audio(3, (2, 2, 8192))
    _close(tstft.spectral_centroid(torch.from_numpy(x), SR),
           jstft.spectral_centroid(jnp.asarray(x), SR))


# ----------------------------------------------------------- MIR features


MIR = ("lufs", "rms", "crest", "barkspectrum", "spectral_centroid")


@pytest.mark.parametrize("name", MIR)
def test_mir_feature_matches_jax(name):
    """Each MIR feature of (3, 2, 24000): LUFS needs 400 ms, the Bark
    spectrum's 32768-point reflect pad more than 16384 samples; one item
    mono-like, one quiet."""
    x = _audio(4, (3, 2, 24000))
    x[1, 1] = x[1, 0]
    x[2] *= 0.01
    got = tfeat.get_mir_feature_embeds(torch.from_numpy(x), None, SR)
    want = jfeat.get_mir_feature_embeds(jnp.asarray(x), None, SR)
    assert sorted(got) == sorted(want) == sorted(MIR)
    _close(got[name], want[name])
    assert (tfeat.load_mir_feature_extractor().embed_dim
            == jfeat.load_mir_feature_extractor().embed_dim == 49)


@pytest.mark.parametrize("mode", ["mono", "stereo", "mid-side"])
def test_barkspectrum_modes_match_jax(mode):
    x = _audio(5, (2, 2, 20000))
    _close(tfeat.compute_barkspectrum(torch.from_numpy(x), sample_rate=SR,
                                      mode=mode),
           jfeat.compute_barkspectrum(jnp.asarray(x), sample_rate=SR,
                                      mode=mode))


# ------------------------------------------------------------------ loss


def test_stft_loss_matches_jax():
    x, y = _audio(6, (2, 8192)), _audio(7, (2, 8192))
    _close(tloss.stft_loss(torch.from_numpy(x), torch.from_numpy(y), 1024,
                           256, 600),
           jloss.stft_loss(jnp.asarray(x), jnp.asarray(y), 1024, 256, 600))


def test_multi_resolution_stft_loss_matches_jax():
    """auraloss's three resolutions on (2, 2, 8192), and zero on equal
    inputs."""
    x, y = _audio(8, (2, 2, 8192)), _audio(9, (2, 2, 8192))
    _close(tloss.multi_resolution_stft_loss(torch.from_numpy(x),
                                            torch.from_numpy(y)),
           jloss.multi_resolution_stft_loss(jnp.asarray(x), jnp.asarray(y)))
    assert float(tloss.multi_resolution_stft_loss(
        torch.from_numpy(x), torch.from_numpy(x))) == 0.0


# ---------------------------------------------------------- MFCC metric


@pytest.mark.parametrize("midside,sr", [(False, SR), (True, SR),
                                        (False, 44100)])
def test_mfcc_embed_matches_jax(midside, sr):
    """The MFCC feature embed of (3, 2, 16384): each coefficient's mean,
    population standard deviation and maximum over the frames, of the
    channel mean or of mid and side, at 48 kHz or resampled from 44.1:
    cosine > 1 - 1e-5 per item."""
    x = _audio(10, (3, 2, 16384))
    model = treg.load_mfcc_feature_extractor()
    got = treg.get_mfcc_feature_embeds(torch.from_numpy(x), model, sr,
                                       midside=midside)["mono"].numpy()
    want = np.asarray(jreg.get_mfcc_feature_embeds(
        jnp.asarray(x), jreg.load_mfcc_feature_extractor(), sr,
        midside=midside)["mono"])
    assert got.shape == want.shape == (3, 75 * (2 if midside else 1))
    cos = np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1)
                                    * np.linalg.norm(want, axis=-1))
    assert np.all(cos > 1 - 1e-5), cos


# -------------------------------------------------------- metric registry


def test_metric_registry_matches_jax():
    """The same metric names; "mfcc" and "mir" load, embed and score
    (``style_similarity``: the mean cosine over heads) as JAX's do
    (rtol 1e-4)."""
    assert sorted(tmetrics.METRICS) == sorted(jmetrics.METRICS)
    x, y = _audio(11, (2, 2, 24000)), _audio(12, (2, 2, 24000))
    for name in ("mfcc", "mir"):
        model, embed = tmetrics.load_metric(name)
        jmodel, jembed = jmetrics.load_metric(name)
        got = tmetrics.style_similarity(
            embed(torch.from_numpy(x), model, SR),
            embed(torch.from_numpy(y), model, SR))
        want = jmetrics.style_similarity(jembed(jnp.asarray(x), jmodel, SR),
                                         jembed(jnp.asarray(y), jmodel, SR))
        _close(got, want)
    a, b = np.random.default_rng(13).standard_normal((2, 4, 8)).astype(
        np.float32)
    _close(tmetrics.cosine(torch.from_numpy(a), torch.from_numpy(b)),
           jmetrics.cosine(jnp.asarray(a), jnp.asarray(b)))


def test_param_metric_loads_on_the_cpu():
    model, embed = tmetrics.load_metric("param", allow_random=True,
                                        device="cpu")
    assert embed is treg.get_param_embeds and model.embed_dim == 512


@pytest.mark.parametrize("name", ["clap", "fx-encoder", "beats", "wav2vec2",
                                  "wav2clip", "vggish"])
def test_checkpoint_gated_metrics_raise(name, tmp_path, monkeypatch):
    """Without their weights the baselines' loaders raise
    FileNotFoundError, as the JAX package's do (wav2vec2 and CLAP: no
    local Hugging Face cache, which the loaders alone read)."""
    monkeypatch.chdir(tmp_path)  # no checkpoints/ directory
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    with pytest.raises(FileNotFoundError):
        tmetrics.load_metric(name)
