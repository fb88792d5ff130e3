"""The port's BEATs against st_ito_tpu's on the CPU, at a small config (D
64, depth 2, 4 heads, as ``tests/test_convert_parity.py`` builds the
reference's encoder): the Kaldi fbank, the relative position buckets, the
token features from a normalised fbank, the whole embed from audio, with
the JAX weights carried across (``beats_state_dict_from_jax``: the folded
positional-conv weight as its own direction and norm) and the port's
release-named ``state_dict`` through the JAX converter
(``convert_beats_state_dict``, which folds the weight norm).

Tolerances: the fbank within 1e-4 x max|want| (its log floor and the 2^15
scale make it the front end's own scale); token features within 1e-4 x
max|want| and at cosine > 1 - 1e-5 per token; embeddings at cosine
> 1 - 1e-5."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from st_ito_tpu.models import beats as jbeats

from st_ito_torch.models import beats, convert
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401
from tests.torch_train_draws import reference_jit

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SMALL = dict(embed_dim=32, encoder_embed_dim=64, depth=2, heads=4,
             ffn_dim=128, patch=4, conv_pos=16, conv_pos_groups=4,
             num_buckets=16, max_distance=64)
SR = 48000


@pytest.fixture(scope="module")
def params():
    """Small JAX BEATs weights with their gates and LayerNorms moved off
    init, so that every term of the gated bias is exercised."""
    p = reference_jit(jbeats.init_beats_params, static_argnums=1)(
        jax.random.PRNGKey(0), jbeats.BEATsConfig(**SMALL))
    rng = np.random.default_rng(1)
    for layer in p["encoder"]["layers"]:
        layer["self_attn"]["grep_a"] = jnp.asarray(
            rng.uniform(0.5, 1.5, (1, 4, 1, 1)), jnp.float32)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            layer[ln]["weight"] = jnp.asarray(rng.uniform(0.8, 1.2, 64),
                                              jnp.float32)
            layer[ln]["bias"] = jnp.asarray(rng.uniform(-0.1, 0.1, 64),
                                            jnp.float32)
    p["encoder"]["pos_conv"][0]["bias"] = jnp.asarray(
        rng.uniform(-0.1, 0.1, 64), jnp.float32)
    return p


def port_net(params):
    net = beats.BEATs(beats.BEATsConfig(**SMALL))
    net.load_state_dict(convert.beats_state_dict_from_jax(params))
    return net


def assert_cosine(got, want, limit=1e-5):
    got = np.asarray(got, np.float64).reshape(-1, np.shape(want)[-1])
    want = np.asarray(want, np.float64).reshape(got.shape)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert np.isfinite(got).all() and (cos > 1.0 - limit).all(), cos.min()


def test_kaldi_fbank_matches_jax():
    cfg = jbeats.BEATsConfig()
    mono = np.random.default_rng(2).standard_normal((2, 16000)).astype(
        np.float32) * 3000.0
    want = np.asarray(jbeats.kaldi_fbank(jnp.asarray(mono), cfg))
    got = beats.kaldi_fbank(torch.from_numpy(mono), beats.BEATsConfig())
    assert got.shape == want.shape == (2, 98, 128)
    assert np.abs(np.asarray(got) - want).max() <= 1e-4 * np.abs(want).max()


def test_relative_position_buckets_match_jax():
    rel = np.arange(300)[None, :] - np.arange(300)[:, None]
    np.testing.assert_array_equal(
        beats._relative_position_bucket(rel, 320, 800),
        jbeats._relative_position_bucket(rel, 320, 800))


def test_token_features_match_jax(params):
    """beats_encode_fbank from a normalised fbank: patches, LayerNorm,
    projection, the positional conv, DeepNorm layers, the gated bias and
    the alpha = 32 logits; both directions of the weights."""
    jcfg = jbeats.BEATsConfig(**SMALL)
    fbank = np.random.default_rng(3).standard_normal((2, 18, 16)).astype(
        np.float32)
    want = np.asarray(jbeats.beats_encode_fbank(params, jnp.asarray(fbank),
                                                jcfg))
    net = port_net(params)
    got = beats.beats_encode_fbank(net, torch.from_numpy(fbank), net.config)
    assert got.shape == want.shape == (2, 16, 64)
    assert np.abs(np.asarray(got) - want).max() <= 1e-4 * np.abs(want).max()
    assert_cosine(got, want)

    back = jbeats.convert_beats_state_dict(net.state_dict(), jcfg)
    again = np.asarray(jbeats.beats_encode_fbank(back, jnp.asarray(fbank),
                                                 jcfg))
    assert_cosine(again, want)
    assert np.abs(again - want).max() <= 1e-5 * np.abs(want).max()


def test_beats_embeds_match_jax(params):
    """get_beats_embeds on stereo audio at 48 kHz: the 16 kHz resample,
    the mono mix times 2^15, the fbank's normalisation, the token mean,
    L2."""
    jcfg = jbeats.BEATsConfig(**SMALL)
    x = np.random.default_rng(4).standard_normal((2, 2, 24000)).astype(
        np.float32) * 0.3
    want = jbeats.get_beats_embeds(
        jnp.asarray(x), jbeats.BEATsModel(params=params, config=jcfg), SR)
    model = beats.BEATsModel(net=port_net(params), config=beats.BEATsConfig(
        **SMALL), embed_dim=64)
    got = beats.get_beats_embeds(torch.from_numpy(x), model, SR)
    assert set(got) == set(want) == {"mono"}
    assert_cosine(got["mono"], want["mono"])


def test_load_beats_checkpoint(params, tmp_path):
    """The released layout ({"cfg", "model"}, with a predictor head the
    loader drops) loads by name; allow_random draws repeatably; without a
    file the loader raises FileNotFoundError."""
    net = port_net(params)
    sd = dict(net.state_dict())
    sd["predictor.weight"] = torch.zeros(527, 64)
    cfg = {"encoder_embed_dim": 64, "encoder_layers": 2,
           "encoder_attention_heads": 4, "encoder_ffn_embed_dim": 128,
           "input_patch_size": 4, "conv_pos": 16, "conv_pos_groups": 4,
           "num_buckets": 16, "max_distance": 64, "embed_dim": 32}
    torch.save({"cfg": cfg, "model": sd}, tmp_path / "beats.pt")
    model = beats.load_beats_model(str(tmp_path / "beats.pt"), device="cpu")
    assert model.config == beats.BEATsConfig(**SMALL) and model.embed_dim == 64
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 2, 8000)).astype(np.float32))
    torch.testing.assert_close(model(x), beats.beats_apply(net, x), rtol=0,
                               atol=0)
    with pytest.raises(FileNotFoundError):
        beats.load_beats_model(None)
    a, b = (beats.load_beats_model(allow_random=True, seed=7,
                                   config=model.config, device="cpu")
            for _ in range(2))
    torch.testing.assert_close(a(x), b(x), rtol=0, atol=0)
    assert dataclasses.asdict(a.config) == dataclasses.asdict(model.config)
