"""The port's LAION-CLAP tower (``st_ito_torch.models.clap_laion``) against
st_ito_tpu's on the CPU, at the small config of
``tests/test_pretrained_towers.py`` (spec 64, 16 mels, window 4, depths
(1, 2, 1)), the JAX weights carried across by
``convert.clap_laion_state_dict_from_jax``; and against transformers'
``ClapAudioModelWithProjection`` twin, which loads the port's
``state_dict`` by its own names, and whose ``state_dict`` the port loads.

Tolerances: the tower's outputs within 1e-4 x max|want| of JAX's and of
the twin's; ``reshape_mel2img`` within 1e-5 x max|want| of JAX's (the
same matrix) and 1e-4 absolute of ``F.interpolate(bicubic,
align_corners=True)``; ``clap_mel`` within 1e-4 x max|want| dB of JAX's;
the metric's and the pretext's embeddings within 1e-4 x max|want| and at
cosine > 1 - 1e-5 per item."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from st_ito_tpu.models import clap_laion as jcl

from st_ito_torch.models import clap_laion, convert
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401
from tests.torch_train_draws import reference_jit

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SMALL = dict(spec_size=64, n_mels=16, patch=4, window=4, depths=(1, 2, 1),
             heads=(2, 4, 2), patch_dim=16, hidden=64, proj_dim=32,
             max_samples=48000)
JCFG = jcl.ClapLaionConfig(**SMALL)
CFG = clap_laion.ClapLaionConfig(**SMALL)


def audio(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.3


def assert_close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), err


def assert_cosine(got, want, limit=1e-5):
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert (cos > 1.0 - limit).all(), cos


def small_clap():
    """(JAX params, the port's tower with them) at the small config, the
    BatchNorm's statistics and affine moved off their init."""
    params = reference_jit(lambda k: jcl.init_clap_laion_params(k, JCFG))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    bn = params["batch_norm"]
    bn["running_mean"] = jnp.asarray(rng.uniform(-1, 1, 16), jnp.float32)
    bn["running_var"] = jnp.asarray(rng.uniform(0.5, 2, 16), jnp.float32)
    bn["weight"] = jnp.asarray(rng.uniform(0.5, 1.5, 16), jnp.float32)
    bn["bias"] = jnp.asarray(rng.uniform(-0.5, 0.5, 16), jnp.float32)
    net = clap_laion.ClapAudioTower(CFG)
    net.load_state_dict(convert.clap_laion_state_dict_from_jax(params))
    return params, net


@pytest.fixture(scope="module")
def towers():
    return small_clap()


def models(towers):
    params, net = towers
    return (jcl.ClapLaionModel(params=params, config=JCFG, embed_dim=32),
            clap_laion.ClapLaionModel(net=net, config=CFG, embed_dim=32))


@pytest.mark.parametrize("frames", [101, 256])
def test_tower_matches_jax(towers, frames):
    """Input features shorter than the 256 frames (the bicubic resize) and
    exactly 256; the shifted windows' mask, the padded merge-free grid."""
    params, net = towers
    feats = audio((2, 1, frames, 16), 2) * 10.0
    want_pooled, want = jax.jit(lambda p, f: jcl.clap_audio_tower(
        p, f, JCFG))(params, jnp.asarray(feats))
    pooled, got = net(torch.from_numpy(feats))
    assert_close(pooled, want_pooled)
    assert_close(got, want)


def test_tower_state_dict_is_transformers(towers, monkeypatch):
    """transformers' twin loads the port's state_dict (strictly) and
    computes the port's outputs; the port loads the twin's."""
    monkeypatch.setenv("USE_TF", "0")  # its TensorFlow half is not needed
    pytest.importorskip("transformers")
    from transformers import ClapAudioConfig
    from transformers.models.clap.modeling_clap import (
        ClapAudioModelWithProjection)

    _, net = towers
    hf_cfg = ClapAudioConfig(
        spec_size=64, num_mel_bins=16, patch_size=4, patch_stride=[4, 4],
        window_size=4, depths=[1, 2, 1], num_attention_heads=[2, 4, 2],
        patch_embeds_hidden_size=16, hidden_size=64, projection_dim=32,
        enable_fusion=False)
    twin = ClapAudioModelWithProjection(hf_cfg).eval()
    twin.load_state_dict(net.state_dict())
    feats = torch.from_numpy(audio((2, 1, 256, 16), 3) * 10.0)
    with torch.no_grad():
        want = twin(input_features=feats).audio_embeds
    assert_close(net(feats)[1], want)

    torch.manual_seed(4)
    other = ClapAudioModelWithProjection(hf_cfg).eval()
    back = clap_laion.ClapAudioTower(CFG)
    back.load_state_dict(clap_laion.hf_state_dict(other.state_dict()))
    with torch.no_grad():
        want = other(input_features=feats).audio_embeds
    assert_close(back(feats)[1], want)


@pytest.mark.parametrize("frames", [101, 256])
def test_reshape_mel2img_matches_jax(frames):
    feats = audio((2, 1, frames, 12), 5)
    want = np.asarray(jcl.reshape_mel2img(jnp.asarray(feats), JCFG))
    got = clap_laion.reshape_mel2img(torch.from_numpy(feats), CFG)
    assert_close(got, want, 1e-5)
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(feats), (256, 16), mode="bicubic",
        align_corners=True)
    r = CFG.freq_ratio
    ref = ref.reshape(2, r, 64, 16).permute(0, 1, 3, 2).reshape(2, 1, 64, 64)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)


def test_clap_mel_matches_jax():
    x = audio((2, 30000), 6)
    want = np.asarray(jcl.clap_mel(jnp.asarray(x), JCFG))
    got = clap_laion.clap_mel(torch.from_numpy(x), CFG)
    assert got.shape == want.shape == (2, 30000 // 480 + 1, 16)
    assert_close(got, want)


# (case, T, sample rate): the mono mix, mid/side, a signal shorter than the
# 1 s context (repeat-padded), one longer (centre-cropped), and 44.1 kHz
EMBED_CASES = [("mono", 48000, 48000), ("midside", 48000, 48000),
               ("repeat_pad", 20011, 48000), ("centre_crop", 60000, 48000),
               ("resampled", 44100, 44100)]


@pytest.mark.parametrize("case,T,sr", EMBED_CASES,
                         ids=[c[0] for c in EMBED_CASES])
def test_embeds_match_jax(towers, case, T, sr):
    jmodel, model = models(towers)
    x = audio((2, 2, T), 7)
    midside = case == "midside"
    want = jcl.get_clap_laion_embeds(jnp.asarray(x), jmodel, sr,
                                     midside=midside)
    got = clap_laion.get_clap_laion_embeds(torch.from_numpy(x), model, sr,
                                           midside=midside)
    assert sorted(got) == sorted(want) == (
        ["mid", "side"] if midside else ["mono"])
    for k in want:
        assert_close(got[k], want[k])
        assert_cosine(got[k], want[k])
        np.testing.assert_allclose(np.linalg.norm(got[k].numpy(), axis=-1),
                                   1.0, atol=1e-5)
    if midside:
        ms = clap_laion.get_clap_laion_embeds_midside(torch.from_numpy(x),
                                                      model, sr)
        for k in want:
            np.testing.assert_array_equal(ms[k].numpy(), got[k].numpy())


@pytest.mark.parametrize("channels", [2, 1])
def test_pretext_apply_matches_jax(towers, channels):
    """Halved mid/side (or mono as both), truncated from the head to the
    context, unnormalised."""
    params, net = towers
    x = audio((2, channels, 50000), 8)
    want = jax.jit(lambda p, a: jcl.clap_laion_pretext_apply(p, a, JCFG))(
        params, jnp.asarray(x))
    got = clap_laion.clap_laion_pretext_apply(net, torch.from_numpy(x), CFG)
    for g, w in zip(got, want):
        assert_close(g.detach(), w)
        assert_cosine(g.detach(), w)
    if channels == 1:
        assert got[0] is got[1]
