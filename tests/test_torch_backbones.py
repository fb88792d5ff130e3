"""The port's transformer backbones against st_ito_tpu's on the CPU, at
the small configs of ``tests/test_encoders.py``, the JAX weights carried
across by ``convert.*_state_dict_from_jax``: HTS-AT (``models/htsat.py``)
and the CLAP-ft encoder (``models/clap.py``), in eval and in train mode
(the JAX apply's ``training``; neither holds dropout or a BatchNorm, so
one JAX run serves both). DeepGCN, the BatchNorm buffers and the dropout
are ``tests/test_torch_gcn.py``.

Tolerances: embeddings within 1e-4 x max|want| and at cosine > 1 - 1e-5
per item."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from st_ito_tpu.models import clap as jclap
from st_ito_tpu.models import htsat as jhtsat

from st_ito_torch.models import clap, convert, htsat

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)


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


def set_mode(net, training):
    return net.train() if training else net.eval()


# ----------------------------------------------------------------- HTS-AT

# the JAX test's config (one block a stage), and one whose first stage
# shifts an odd window: window 5 on the 16 x 32 grid, rolled by -3 and
# back by 2, its grid padded to 20 x 35, the later windows clamped
HTSAT = {
    "w8": dict(embed_dim=16, dim=16, depths=(1, 1, 1, 1), heads=(2, 2, 4, 4),
               num_frames=64),
    "w5_shifted": dict(embed_dim=16, dim=16, depths=(2, 2, 1, 1),
                       heads=(2, 2, 4, 4), window=5, num_frames=64),
}


@functools.lru_cache(maxsize=None)
def htsat_case(name):
    """(params, input, the JAX embedding): HTS-AT holds no dropout and no
    BatchNorm, so the JAX apply's ``training`` changes nothing and one
    JAX run serves both of the port's modes."""
    jcfg = jhtsat.HTSATConfig(**HTSAT[name])
    params = jax.jit(lambda k: jhtsat.init_htsat_params(k, jcfg))(
        jax.random.PRNGKey(1))
    x = audio((2, 2, 65536), 2)
    want, _ = jax.jit(lambda p, a: jhtsat.htsat_apply(p, a, jcfg))(
        params, jnp.asarray(x))
    return params, x, want


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(HTSAT))
def test_htsat_matches_jax(name, training):
    params, x, want = htsat_case(name)
    net = set_mode(htsat.HTSAT(htsat.HTSATConfig(**HTSAT[name])), training)
    net.load_state_dict(convert.htsat_state_dict_from_jax(params))
    got, same = net(torch.from_numpy(x))
    assert same is got
    assert_close(got.detach(), want)
    assert_cosine(got.detach(), want)


def test_htsat_pads_short_input():
    """Fewer frames than num_frames: the standardised log-mel is padded
    with zeros (after standardisation), as in JAX."""
    jcfg = jhtsat.HTSATConfig(**HTSAT["w8"])
    params = htsat_case("w8")[0]
    x = audio((1, 1, 30000), 4)
    want, _ = jax.jit(lambda p, a: jhtsat.htsat_apply(p, a, jcfg))(
        params, jnp.asarray(x))
    net = htsat.HTSAT(htsat.HTSATConfig(**HTSAT["w8"])).eval()
    net.load_state_dict(convert.htsat_state_dict_from_jax(params))
    assert_close(net(torch.from_numpy(x))[0].detach(), want)


# ---------------------------------------------------------------- CLAP-ft

TOWER = dict(embed_dim=24, dim=16, depths=(1, 1, 1, 1), heads=(2, 2, 4, 4),
             num_frames=64)


@functools.lru_cache(maxsize=None)
def clap_audio_case(channels):
    """(params, input, the JAX embeddings), one JAX run for both modes (no
    dropout, no BatchNorm)."""
    jcfg = jclap.CLAPAudioConfig(embed_dim=16,
                                 tower=jhtsat.HTSATConfig(**TOWER))
    params = jax.jit(lambda k: jclap.init_clap_audio_params(k, jcfg))(
        jax.random.PRNGKey(5))
    x = audio((2, channels, 65536), 6)
    want = jax.jit(lambda p, a: jclap.clap_audio_apply(p, a, jcfg))(
        params, jnp.asarray(x))
    return params, x, want


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("channels", [2, 1])
def test_clap_audio_matches_jax(channels, training):
    """Halved mid/side in one batched tower pass, each projected; mono as
    both heads."""
    params, x, want = clap_audio_case(channels)
    cfg = clap.CLAPAudioConfig(embed_dim=16,
                               tower=htsat.HTSATConfig(**TOWER))
    net = set_mode(clap.CLAPAudio(cfg), training)
    net.load_state_dict(convert.clap_audio_state_dict_from_jax(params))
    got = net(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert_close(g.detach(), w)
        assert_cosine(g.detach(), w)
    if channels == 2:
        assert not np.allclose(got[0].detach(), got[1].detach())


