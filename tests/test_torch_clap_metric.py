"""The CLAP metric's path in the port against st_ito_tpu's on the CPU, at
the small tower of ``tests/test_torch_clap.py``: ``load_clap_laion_model``
from a transformers-named ``.pt``; ``load_clap_model`` serving the native
tower from a checkpoint or from the local Hugging Face cache (its one
``from_pretrained`` asked for the local files only), refusing offline with
FileNotFoundError and raising on weights whose names do not fit;
``get_clap_embeds`` against the JAX package's; the engine's fitness of the
CLAP embed, marked ``host_side`` as the JAX CLI marks it or not, against
the JAX package's host-side and on-device fitness of the same tower,
weights and candidates, with a content model and dropout too. The CLIs
with ``--metric clap`` are ``tests/test_torch_clap_cli.py``.

Tolerances: embeddings within 1e-6 of each other where the same module
computes them from the same weights, and within 1e-4 x max|want| of
JAX's; fitness values within 1e-4 of JAX's, and bitwise between the
port's marked and unmarked embeds."""

import sys
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from st_ito_tpu.chain import ChainSpec as JaxChainSpec
from st_ito_tpu.chain import basic_delay as jax_basic_delay
from st_ito_tpu.chain import basic_reverb as jax_basic_reverb
from st_ito_tpu.ito.engine import make_fitness_fn as jax_make_fitness_fn
from st_ito_tpu.models import clap_laion as jcl
from st_ito_tpu.models import registry as jregistry

from st_ito_torch.chain import ChainSpec, basic_delay, basic_reverb
from st_ito_torch.ito import make_fitness_fn
from st_ito_torch.models import clap_laion, registry
from st_ito_torch.models.clap_laion import ClapAudioTower

from tests.test_torch_clap import CFG, JCFG, small_clap

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000


def audio(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.3


@pytest.fixture(scope="module")
def small():
    """(the JAX model, the port's model) sharing the small tower's
    weights."""
    params, net = small_clap()
    return (jcl.ClapLaionModel(params=params, config=JCFG, embed_dim=32),
            clap_laion.ClapLaionModel(net=net, config=CFG, embed_dim=32))


# ------------------------------------------------------------- loading


def test_load_clap_laion_model_from_hf_named_pt(small, tmp_path):
    """A whole ``ClapModel``'s state_dict (the text tower's and the logit
    scales' entries beside the audio tower's) under ``state_dict``, and
    an audio tower's with the bare ``audio_encoder.`` prefix and no
    position index buffers: both load, and embed as the source does; the
    JAX package's converter reads the same file's names."""
    jmodel, model = small
    sd = model.net.state_dict()
    whole = dict(sd, **{"text_model.embeddings.word_embeddings.weight":
                        torch.zeros(4, 2), "logit_scale_a": torch.ones(())})
    torch.save({"state_dict": whole}, tmp_path / "whole.pt")
    bare = {k[len("audio_model."):] if k.startswith("audio_model.") else k: v
            for k, v in sd.items() if not k.endswith("position_index")}
    torch.save(bare, tmp_path / "bare.pt")
    x = torch.from_numpy(audio((2, 2, 48000), 1))
    want = clap_laion.get_clap_laion_embeds(x, model, SR, midside=True)
    for name in ("whole.pt", "bare.pt"):
        loaded = clap_laion.load_clap_laion_model(
            str(tmp_path / name), config=CFG, device="cpu")
        got = clap_laion.get_clap_laion_embeds(x, loaded, SR, midside=True)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6)
    params = jcl.convert_clap_laion_state_dict(
        {k: v.numpy() for k, v in bare.items()}, JCFG)
    jwant = jcl.get_clap_laion_embeds(
        jnp.asarray(x.numpy()), jcl.ClapLaionModel(params=params,
                                                   config=JCFG), SR,
        midside=True)
    for k in want:
        got = want[k].numpy()
        assert np.abs(got - np.asarray(jwant[k])).max() <= 1e-4


def test_load_clap_laion_model_refuses(tmp_path):
    torch.save({"audio_projection.linear1.weight": torch.zeros(32, 64)},
               tmp_path / "partial.pt")
    with pytest.raises(KeyError, match="missing"):
        clap_laion.load_clap_laion_model(str(tmp_path / "partial.pt"),
                                         config=CFG, device="cpu")
    with pytest.raises(FileNotFoundError):
        clap_laion.load_clap_laion_model(str(tmp_path / "none.pt"),
                                         device="cpu")
    model = clap_laion.load_clap_laion_model(None, allow_random=True,
                                             config=CFG, device="cpu")
    assert model.embed_dim == 32 and not model.net.training


class FakeTransformers(types.ModuleType):
    """A stand-in ``transformers`` whose ``ClapModel.from_pretrained``
    records its arguments and serves ``cached`` (a state_dict), or raises
    OSError as an empty local cache does."""

    def __init__(self, cached=None):
        super().__init__("transformers")
        self.calls = []
        calls = self.calls

        class ClapModel:
            @classmethod
            def from_pretrained(cls, model_id, **kwargs):
                calls.append((model_id, kwargs))
                if cached is None:
                    raise OSError(f"{model_id} is not in the local cache")
                return types.SimpleNamespace(state_dict=lambda: cached)

        self.ClapModel = ClapModel


def whole_clap_model(sd):
    """A transformers ``ClapModel`` state_dict around the tower's: the
    text tower's and the logit scales' entries beside it."""
    return dict(sd, **{"text_model.embeddings.word_embeddings.weight":
                       torch.zeros(4, 2), "logit_scale_a": torch.ones(())})


def test_load_clap_model_reads_the_local_cache_only(tmp_path, monkeypatch):
    """No checkpoint and no cached model: FileNotFoundError, the one
    ``from_pretrained`` having asked for the local files only."""
    fake = FakeTransformers()
    monkeypatch.setitem(sys.modules, "transformers", fake)
    monkeypatch.chdir(tmp_path)  # no checkpoints/ directory
    with pytest.raises(FileNotFoundError, match="not available locally"):
        registry.load_clap_model(device="cpu")
    assert fake.calls == [("laion/clap-htsat-unfused",
                           {"local_files_only": True})]


def test_load_clap_model_serves_the_native_checkpoint(small, tmp_path,
                                                      monkeypatch):
    """A state_dict at the checkpoint path comes back as the native tower
    (the published config's shapes: here the small tower's with the
    config patched to match), the cache not asked."""
    _, model = small
    fake = FakeTransformers()
    monkeypatch.setitem(sys.modules, "transformers", fake)
    torch.save(model.net.state_dict(), tmp_path / "clap.pt")
    monkeypatch.setattr(clap_laion, "ClapLaionConfig", lambda: CFG)
    got = registry.load_clap_model(ckpt_path=str(tmp_path / "clap.pt"),
                                   device="cpu")
    assert isinstance(got, clap_laion.ClapLaionModel) and not fake.calls
    x = torch.from_numpy(audio((1, 2, 48000), 2))
    np.testing.assert_allclose(
        registry.get_clap_embeds(x, got, SR)["mono"],
        registry.get_clap_embeds(x, model, SR)["mono"], atol=1e-6)


def test_load_clap_model_serves_the_hf_cache(small, tmp_path, monkeypatch):
    """No checkpoint: a whole ``ClapModel`` from the local cache, asked
    for with ``local_files_only``, comes back as the native tower holding
    its audio weights."""
    _, model = small
    fake = FakeTransformers(whole_clap_model(model.net.state_dict()))
    monkeypatch.setitem(sys.modules, "transformers", fake)
    monkeypatch.setattr(clap_laion, "ClapAudioTower",
                        lambda config=CFG: ClapAudioTower(config))
    monkeypatch.chdir(tmp_path)
    got = registry.load_clap_model(device="cpu")
    assert fake.calls == [("laion/clap-htsat-unfused",
                           {"local_files_only": True})]
    assert isinstance(got, clap_laion.ClapLaionModel)
    for k, v in model.net.state_dict().items():
        torch.testing.assert_close(got.net.state_dict()[k], v, rtol=0,
                                   atol=0)


@pytest.mark.parametrize("source", ["checkpoint", "cache"])
def test_load_clap_model_propagates_a_name_mismatch(small, source, tmp_path,
                                                    monkeypatch):
    """Weights that do not fit the tower raise, wherever they come from:
    a checkpoint short of the tower's names does not fall through to the
    cache, and a cached model short of them fails ``load_state_dict``."""
    _, model = small
    sd = {k: v for k, v in model.net.state_dict().items()
          if not k.startswith("audio_projection.")}
    fake = FakeTransformers(whole_clap_model(sd))
    monkeypatch.setitem(sys.modules, "transformers", fake)
    monkeypatch.setattr(clap_laion, "ClapLaionConfig", lambda: CFG)
    monkeypatch.setattr(clap_laion, "ClapAudioTower",
                        lambda config=CFG: ClapAudioTower(config))
    monkeypatch.chdir(tmp_path)
    if source == "checkpoint":
        torch.save(sd, tmp_path / "clap.pt")
        with pytest.raises(KeyError, match="audio_projection"):
            registry.load_clap_model(ckpt_path=str(tmp_path / "clap.pt"),
                                     device="cpu")
        assert not fake.calls
    else:
        with pytest.raises(RuntimeError, match="audio_projection"):
            registry.load_clap_model(device="cpu")
        assert len(fake.calls) == 1


@pytest.mark.parametrize("midside", [False, True])
def test_get_clap_embeds_matches_jax(small, midside):
    """The metric's embed is the native tower's (``get_clap_laion_embeds``,
    bitwise), at 44.1 kHz resampled to 48 kHz first, against the JAX
    package's ``get_clap_embeds`` on its native tower."""
    jmodel, model = small
    x = torch.from_numpy(audio((2, 2, 44100), 3))
    got = registry.get_clap_embeds(x, model, 44100, midside=midside)
    direct = clap_laion.get_clap_laion_embeds(x, model, 44100,
                                              midside=midside)
    want = jregistry.get_clap_embeds(jnp.asarray(x.numpy()), jmodel, 44100,
                                     midside=midside)
    assert sorted(got) == sorted(want) == (
        ["mid", "side"] if midside else ["mono"])
    for k in want:
        np.testing.assert_array_equal(got[k], direct[k])
        np.testing.assert_allclose(np.linalg.norm(got[k], axis=-1), 1.0,
                                   atol=1e-5)
        assert np.abs(got[k].numpy() - np.asarray(want[k])).max() <= 1e-4


# ------------------------------------------------------------- fitness


def marked(embed):
    """``embed`` marked ``host_side``, as the JAX CLI marks an embed that
    its jitted program cannot trace."""
    def f(x, m, sr, **kw):
        return embed(x, m, sr)

    f.host_side = True
    return f


def fitness_case():
    chain = ChainSpec((basic_delay(), basic_reverb()))
    jchain = JaxChainSpec((jax_basic_delay(), jax_basic_reverb()))
    x, y = audio((2, 48000), 4), audio((1, 2, 48000), 5)
    W = np.random.default_rng(6).random((4, chain.num_params))
    return chain, jchain, x, y, W


def test_marked_clap_fitness_matches_jax(small):
    """delay -> reverb, four candidates on a 1 s stereo input: an embed
    marked ``host_side`` is scored by the port's one fitness path, as
    the unmarked one is (bitwise), and within 1e-4 of both the JAX
    package's host-side fitness of the marked embed and its on-device
    fitness of the unmarked one; ``return_audio`` returns the embeddings
    and the renders."""
    jmodel, model = small
    chain, jchain, x, y, W = fitness_case()
    jy = jcl.get_clap_laion_embeds_midside(jnp.asarray(y), jmodel, SR)
    args = (jnp.asarray(W, jnp.float32), jnp.asarray(x), jy, None, None)
    want_host = np.asarray(jax_make_fitness_fn(
        jchain, jmodel, SR, 2,
        embed_func=marked(jcl.get_clap_laion_embeds_midside))(*args))
    want = np.asarray(jax_make_fitness_fn(
        jchain, jmodel, SR, 2,
        embed_func=jcl.get_clap_laion_embeds_midside)(*args))
    target = clap_laion.get_clap_laion_embeds_midside(torch.from_numpy(y),
                                                      model, SR)
    got = make_fitness_fn(
        chain, model, SR, 2,
        embed_func=marked(clap_laion.get_clap_laion_embeds_midside),
        device="cpu")(W, x, target)
    plain = make_fitness_fn(
        chain, model, SR, 2,
        embed_func=clap_laion.get_clap_laion_embeds_midside,
        device="cpu")(W, x, target)
    assert torch.is_tensor(got) and got.shape == (4,)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    for w in (want_host, want):
        assert np.abs(got.numpy() - w).max() <= 1e-4, (got, w)
    fvals, embeds, Y = make_fitness_fn(
        chain, model, SR, 2,
        embed_func=marked(clap_laion.get_clap_laion_embeds_midside),
        return_audio=True, device="cpu")(W, x, target)
    np.testing.assert_array_equal(fvals.numpy(), got.numpy())
    assert sorted(embeds) == ["mid", "side"] and Y.shape == (4, 2, 48000)


def test_clap_fitness_takes_a_content_model_and_dropout(small):
    """What the JAX package's host-side path refuses or ignores, the
    port's one path scores: the CLAP tower as the content model beside
    itself as the style one, with dropout 0.2 (which the CLAP embed, like
    the JAX one, does not apply), within 1e-4 of the JAX on-device
    fitness of the same configuration."""
    jmodel, model = small
    chain, jchain, x, y, W = fitness_case()
    jy = jcl.get_clap_laion_embeds_midside(jnp.asarray(y), jmodel, SR)
    want = np.asarray(jax_make_fitness_fn(
        jchain, jmodel, SR, 2, embed_func=jcl.get_clap_laion_embeds_midside,
        content_model=jmodel,
        content_embed_func=jcl.get_clap_laion_embeds_midside,
        dropout=0.2)(jnp.asarray(W, jnp.float32), jnp.asarray(x), jy, jy,
                     jax.random.PRNGKey(0)))
    target = clap_laion.get_clap_laion_embeds_midside(torch.from_numpy(y),
                                                      model, SR)
    got = make_fitness_fn(
        chain, model, SR, 2,
        embed_func=marked(clap_laion.get_clap_laion_embeds_midside),
        content_model=model,
        content_embed_func=clap_laion.get_clap_laion_embeds_midside,
        dropout=0.2, device="cpu")(W, x, target, target,
                                   torch.Generator().manual_seed(0))
    assert np.abs(got.numpy() - want).max() <= 1e-4, (got, want)
