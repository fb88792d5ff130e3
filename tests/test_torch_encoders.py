"""The port's dsTCN, FX-encoder, VGGish and Wav2CLIP against st_ito_tpu's
on the CPU, with the JAX weights carried across (``*_state_dict_from_jax``)
and, the other way, the port's ``state_dict`` read by the JAX package's
loader or converter, which takes the release's names: so both the names
and the arithmetic are held.

Tolerances: log-mel front ends within 1e-4 x max|want|; embeddings at
cosine > 1 - 1e-5 per item (and within 1e-4 x max|want| elementwise where
a module's output is compared raw); the PCA postprocessor's quantised
levels exactly, away from the rounding boundaries. The dsTCN and
FX-encoder run at small widths; VGGish and the ResNet-18 have one
architecture, run at their own widths on short inputs (VGGish needs
0.96 s at 16 kHz for one example)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from st_ito_tpu.models import encoders as jenc
from st_ito_tpu.models import vggish as jvgg
from st_ito_tpu.models import wav2clip as jw2c

from st_ito_torch.models import convert, encoders, vggish, wav2clip
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401
from tests.torch_train_draws import reference_jit

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000


def audio(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.3


def assert_cosine(got, want, limit=1e-5):
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    assert got.shape == want.shape and np.isfinite(got).all()
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert (cos > 1.0 - limit).all(), cos


def assert_close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def random_bn(params, rng):
    """Walk a JAX pytree and move every BatchNorm's statistics and affine
    off their init, so that the conversion is exercised."""
    if isinstance(params, list):
        for p in params:
            random_bn(p, rng)
        return
    if "running_var" in params:
        c = params["running_var"].shape[0]
        params["running_mean"] = jnp.asarray(rng.uniform(-0.1, 0.1, c),
                                             jnp.float32)
        params["running_var"] = jnp.asarray(rng.uniform(0.5, 2.0, c),
                                            jnp.float32)
        params["weight"] = jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)
        params["bias"] = jnp.asarray(rng.uniform(-0.1, 0.1, c), jnp.float32)
        return
    for v in params.values():
        if isinstance(v, (dict, list)):
            random_bn(v, rng)


# ------------------------------------------------------------------ dsTCN

DSTCN = dict(embed_dim=16, nblocks=3, kernel_size=5, stride=2,
             dilation_growth=2, channel_width=4, stack_size=2)


@pytest.mark.parametrize("ninputs", [1, 2])
def test_dstcn_matches_jax(ninputs):
    """Stereo input conformed to the encoder's channels (mono mix, and
    duplicated for two), odd paddings cropped, PReLU, max + mean pool."""
    jcfg = jenc.DsTCNConfig(ninputs=ninputs, **DSTCN)
    params = reference_jit(jenc.init_dstcn_params, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg)
    params["blocks"][1]["prelu"] = jnp.linspace(-0.5, 0.5, 8)
    x = audio((2, 2, 4099), 2)
    want, want_side = jenc.dstcn_apply(params, jnp.asarray(x), jcfg)
    net = encoders.DsTCN(encoders.DsTCNConfig(ninputs=ninputs, **DSTCN))
    net.load_state_dict(convert.dstcn_state_dict_from_jax(params))
    got, side = net(torch.from_numpy(x))
    assert side is got
    assert_close(got, want)
    assert_cosine(got, want)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(want_side))


# ------------------------------------------------------------- FX-encoder

FXE = dict(channels=(2, 4, 8), kernels=(5, 4), strides=(2, 2))


def test_fx_encoder_matches_jax(tmp_path):
    """The module at small widths, both directions: the JAX weights
    carried in, and the port's state_dict, saved as the DDP-trained
    release is (``model``, ``module.`` prefixed), read by the JAX loader."""
    jcfg = jenc.FXEncoderConfig(embed_dim=8, **FXE)
    params = reference_jit(jenc.init_fx_encoder_params, static_argnums=1)(
        jax.random.PRNGKey(3), jcfg)
    random_bn(params, np.random.default_rng(4))
    x = audio((2, 2, 301), 5)
    want = jenc.fx_encoder_apply(params, jnp.asarray(x), jcfg)
    net = encoders.FXEncoder(encoders.FXEncoderConfig(embed_dim=8, **FXE))
    net.load_state_dict(convert.fx_encoder_state_dict_from_jax(params))
    got = net(torch.from_numpy(x))
    assert_close(got, want)
    assert_cosine(got, want)

    other = encoders.xavier_init_(
        encoders.FXEncoder(encoders.FXEncoderConfig(embed_dim=8, **FXE)),
        torch.Generator().manual_seed(6))
    path = tmp_path / "FXencoder_ps.pt"
    torch.save({"model": {f"module.{k}": v
                          for k, v in other.state_dict().items()}}, path)
    jparams = jenc.load_fx_encoder_model(str(path)).params
    assert_close(other(torch.from_numpy(x)),
                 jenc.fx_encoder_apply(jparams, jnp.asarray(x), jcfg))
    # and the port's own loader reads the same file
    loaded = encoders.load_fx_encoder_model(
        str(path), config=encoders.FXEncoderConfig(embed_dim=8, **FXE),
        device="cpu").net
    torch.testing.assert_close(loaded(torch.from_numpy(x)),
                               other(torch.from_numpy(x)), rtol=0, atol=0)


def test_fx_encoder_embeds_match_jax(monkeypatch):
    """``get_fx_encoder_embeds``: the resample to 44.1 kHz, the batch's
    peak, mono made stereo, L2. The JAX embed applies the encoder at the
    published config; here at the small one, through its module-level
    ``fx_encoder_apply``."""
    jcfg = jenc.FXEncoderConfig(embed_dim=8, **FXE)
    apply = jenc.fx_encoder_apply
    monkeypatch.setattr(jenc, "fx_encoder_apply",
                        lambda p, x, cfg=None: apply(p, x, jcfg))
    params = reference_jit(jenc.init_fx_encoder_params, static_argnums=1)(
        jax.random.PRNGKey(7), jcfg)
    random_bn(params, np.random.default_rng(7))
    x = audio((2, 2, 8192), 8)
    jmodel = jenc.FXEncoderModel(params=params)
    model = encoders.load_fx_encoder_model(
        allow_random=True, config=encoders.FXEncoderConfig(embed_dim=8, **FXE),
        device="cpu")
    model.net.load_state_dict(convert.fx_encoder_state_dict_from_jax(params))
    for inp in (x, x[:, :1]):
        want = jenc.get_fx_encoder_embeds(jnp.asarray(inp), jmodel, SR)
        got = encoders.get_fx_encoder_embeds(torch.from_numpy(inp), model, SR)
        assert set(got) == set(want) == {"stereo"}
        assert_cosine(got["stereo"], want["stereo"])


# ----------------------------------------------------------------- VGGish


@pytest.fixture(scope="module")
def vggish_params():
    return reference_jit(jvgg.init_vggish_params)(jax.random.PRNGKey(9))


def test_vggish_frontend_matches_jax():
    cfg = jvgg.VGGishConfig()
    np.testing.assert_array_equal(vggish.vggish_mel_matrix(),
                                  jvgg.vggish_mel_matrix(cfg))
    x = audio((2, 16000 * 2 + 1234), 10)
    want = jvgg.vggish_log_mel_examples(jnp.asarray(x), cfg,
                                        jnp.asarray(jvgg.vggish_mel_matrix()))
    got = vggish.vggish_log_mel_examples(
        torch.from_numpy(x), vggish.VGGishConfig(),
        torch.from_numpy(vggish.vggish_mel_matrix()))
    assert got.shape == (2, 2, 96, 64)
    assert np.abs(np.asarray(got) - np.asarray(want)).max() <= (
        1e-4 * np.abs(np.asarray(want)).max())


def test_vggish_matches_jax(vggish_params, tmp_path):
    """The VGG body and MLP with the JAX weights, the JAX converter on the
    port's state_dict, the PCA postprocessor, and get_vggish_embeds
    (mono mix, 16 kHz, examples, their mean) with and without the PCA."""
    params = dict(vggish_params)
    net = vggish.VGGish()
    net.load_state_dict(convert.vggish_state_dict_from_jax(params))
    ex = audio((3, 96, 64), 11)
    want = jvgg.vggish_forward(params, jnp.asarray(ex))
    got = net(torch.from_numpy(ex))
    assert_close(got, want)
    assert_cosine(got, want)
    back = jvgg.convert_vggish_state_dict(net.state_dict())
    np.testing.assert_array_equal(jvgg.vggish_forward(back, jnp.asarray(ex)),
                                  want)

    x = audio((2, 2, SR * 2), 12)
    want = jvgg.get_vggish_embeds(jnp.asarray(x),
                                  jvgg.VGGishModel(params=params), SR)
    got = vggish.get_vggish_embeds(torch.from_numpy(x),
                                   vggish.VGGishModel(net=net), SR)
    assert_cosine(got["mono"], want["mono"])

    # the PCA: one projection of the embeddings, levels exactly
    rng = np.random.default_rng(13)
    e = np.array(want["mono"])
    M = (rng.standard_normal((128, 128)) / (np.abs(e).max() * 16)).astype(
        np.float32)
    mu = rng.standard_normal((128, 1)).astype(np.float32) * 0.1
    params.update(pca_eigen_vectors=jnp.asarray(M), pca_means=jnp.asarray(mu))
    pnet = vggish.VGGish(postprocess=True)
    pnet.load_state_dict(convert.vggish_state_dict_from_jax(params))
    pw = np.asarray(jvgg.vggish_postprocess(params, jnp.asarray(e)))
    pg = vggish.vggish_postprocess(dict(pnet.named_buffers()),
                                   torch.from_numpy(e))
    np.testing.assert_array_equal(np.asarray(pg), pw)
    # the upstream files: the state_dict and the separate PCA file
    torch.save(net.state_dict(), tmp_path / "vggish.pth")
    torch.save({"pca_eigen_vectors": torch.from_numpy(M),
                "pca_means": torch.from_numpy(mu)}, tmp_path / "pca.pth")
    loaded = vggish.load_vggish_model(str(tmp_path / "vggish.pth"),
                                      str(tmp_path / "pca.pth"),
                                      device="cpu")
    assert loaded.net.postprocess
    got = vggish.get_vggish_embeds(torch.from_numpy(x), loaded, SR)["mono"]
    want = jvgg.get_vggish_embeds(jnp.asarray(x),
                                  jvgg.VGGishModel(params=params), SR)["mono"]
    # a level may round the other way where the projection lands on a
    # boundary: at most one step, on a few of the 256 entries
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert diff.max() <= 255.0 / 4.0 * 1e-3 + 0.5 and (diff > 1e-3).mean() < 0.05


# --------------------------------------------------------------- Wav2CLIP


def test_wav2clip_matches_jax():
    """The front end, the ResNet-18 with moved BatchNorm statistics and the
    projection, with the JAX weights carried across; the JAX converter on
    the port's release-named state_dict; get_wav2clip_embeds."""
    params = reference_jit(jw2c.init_wav2clip_params)(jax.random.PRNGKey(14))
    random_bn(params, np.random.default_rng(15))
    jcfg = jw2c.Wav2ClipConfig()
    np.testing.assert_array_equal(wav2clip.wav2clip_mel_matrix(),
                                  jw2c.wav2clip_mel_matrix(jcfg))
    mono = audio((2, 16000), 16)
    mel_w = jw2c.wav2clip_mel_matrix(jcfg)
    want = np.asarray(jw2c.wav2clip_log_mel(jnp.asarray(mono), jcfg,
                                            jnp.asarray(mel_w)))
    got = wav2clip.wav2clip_log_mel(torch.from_numpy(mono),
                                    wav2clip.Wav2ClipConfig(),
                                    torch.from_numpy(mel_w))
    assert got.shape == want.shape == (2, 1, 64, 101)
    assert np.abs(np.asarray(got) - want).max() <= 1e-4 * np.abs(want).max()

    net = wav2clip.Wav2Clip()
    net.load_state_dict(convert.wav2clip_state_dict_from_jax(params))
    spec = audio((2, 1, 64, 96), 17)
    e = jw2c.resnet18_forward(params, jnp.asarray(spec))
    got_e = net.encoder(torch.from_numpy(spec))
    assert_cosine(got_e, e)
    want = jw2c.wav2clip_transform(params, e)
    assert_cosine(net.transform(got_e), want)
    back = jw2c.convert_wav2clip_state_dict(net.state_dict())
    np.testing.assert_array_equal(jw2c.wav2clip_transform(
        back, jw2c.resnet18_forward(back, jnp.asarray(spec))), want)

    x = audio((2, 2, SR), 18)
    want = jw2c.get_wav2clip_embeds(jnp.asarray(x),
                                    jw2c.Wav2ClipModel(params=params), SR)
    got = wav2clip.get_wav2clip_embeds(torch.from_numpy(x),
                                       wav2clip.Wav2ClipModel(net=net), SR)
    assert set(got) == {"mono"}
    assert_cosine(got["mono"], want["mono"])


def test_wav2clip_loads_the_release_layouts(tmp_path):
    """A state_dict entry, bare torchvision keys and a plain MLP's
    ``transform.{i}`` load into the release's names; without a
    ``transform`` the tower stops at fc."""
    src = wav2clip.init_wav2clip_(wav2clip.Wav2Clip(),
                                  torch.Generator().manual_seed(19))
    spec = torch.from_numpy(audio((1, 1, 64, 40), 20))
    bare = {k.replace("encoder.", "", 1).replace("sequential.", ""): v
            for k, v in src.state_dict().items()}
    torch.save({"state_dict": bare}, tmp_path / "w.pt")
    net = wav2clip.load_wav2clip_model(str(tmp_path / "w.pt"),
                                       device="cpu").net
    torch.testing.assert_close(net(spec), src(spec), rtol=0, atol=0)
    torch.save({k: v for k, v in bare.items()
                if not k.startswith("transform")}, tmp_path / "t.pt")
    net = wav2clip.load_wav2clip_model(str(tmp_path / "t.pt"),
                                       device="cpu").net
    assert net.transform is None
    torch.testing.assert_close(net(spec), src.encoder(spec), rtol=0, atol=0)


def test_random_weight_loaders_and_refusals():
    """allow_random draws from the seed, repeatably; without a file and
    without allow_random each loader raises FileNotFoundError."""
    for load in (encoders.load_fx_encoder_model, vggish.load_vggish_model,
                 wav2clip.load_wav2clip_model):
        with pytest.raises(FileNotFoundError):
            load(None)
    a = wav2clip.load_wav2clip_model(allow_random=True, seed=3, device="cpu")
    b = wav2clip.load_wav2clip_model(allow_random=True, seed=3, device="cpu")
    for (k, v), w in zip(a.net.state_dict().items(),
                         b.net.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
    assert not any(p.requires_grad for p in a.net.parameters())
