"""The AFx-Rep ``.ckpt`` converter and ``cli/embed.py`` against
st_ito_tpu's on the CPU: a Lightning-layout checkpoint of a small Cnn14
(with the torchlibrosa front-end buffers and other modules' entries the
converter drops) read by both packages' ``load_torch_checkpoint`` gives
equal parameters and the same config from a ``config.yaml``;
``load_param_model`` searches as the JAX package does and caches the
conversion as ``.npz``; ``cli/embed.py`` prints what ``scripts/embed.py``
prints on the same npz weights, within 1e-5."""

import os
import runpy
import sys

import numpy as np
import pytest
import torch

from st_ito_tpu.models import convert as jconvert
from st_ito_tpu.models.registry import export_encoder_npz as jax_export

from st_ito_torch.cli import embed
from st_ito_torch.models import (Cnn14, Cnn14Config, convert,
                                 export_encoder_npz, load_param_model)
from st_ito_torch.models.cnn14 import init_cnn14_
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SCRIPT = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                      "embed.py")
SMALL = dict(embed_dim=16, window_size=512, hop_size=256, mel_bins=32,
             base_channels=2)
YAML = """model:
  init_args:
    encoder:
      init_args:
        embed_dim: 16
        window_size: 512
        hop_size: 256
        mel_bins: 32
        base_channels: 2
"""


def small_net(seed=0):
    net = init_cnn14_(Cnn14(Cnn14Config(**SMALL)),
                      torch.Generator().manual_seed(seed))
    with torch.no_grad():  # BatchNorm statistics off their init
        for k, v in net.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                v.copy_(torch.rand(v.shape) * 0.5 + (0.75 if "var" in k
                                                     else -0.25))
    return net


def write_ckpt(path, net):
    """What a Lightning AFx-Rep run saves: the encoder under ``encoder.``,
    torchlibrosa's buffers in it, and another module's weights beside."""
    sd = {f"encoder.{k}": v for k, v in net.state_dict().items()}
    sd["encoder.spectrogram_extractor.stft.conv_real.weight"] = torch.ones(3)
    sd["encoder.logmel_extractor.melW"] = torch.ones(2, 2)
    sd["projector.weight"] = torch.ones(4, 4)
    torch.save({"state_dict": sd, "epoch": 3}, path)


def test_ckpt_converter_matches_jax(tmp_path):
    net = small_net()
    path = tmp_path / "afx-rep.ckpt"
    write_ckpt(path, net)
    (tmp_path / "config.yaml").write_text(YAML)
    sd, config = convert.load_torch_checkpoint(str(path))
    params, jconfig = jconvert.load_torch_checkpoint(str(path))
    flat = convert.flatten_params(params)
    assert set(flat) == {k for k in sd if not k.endswith(
        "num_batches_tracked")}
    for k, v in flat.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert config == Cnn14Config(**SMALL)
    assert config.base_channels == jconfig.base_channels == 2
    # the converted weights are the source model's
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 2, 8192)).astype(np.float32))
    back = Cnn14(config)
    back.load_state_dict(sd)
    for a, b in zip(back(x), net(x)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_config_yaml_needs_pyyaml(tmp_path, monkeypatch):
    """A config.yaml beside the checkpoint without PyYAML installed is an
    ImportError naming it, never the default config in silence; without a
    config.yaml the config is the default one."""
    path = tmp_path / "afx-rep.ckpt"
    write_ckpt(path, small_net())
    assert convert.load_torch_checkpoint(str(path))[1] == Cnn14Config()
    (tmp_path / "config.yaml").write_text(YAML)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        convert.load_torch_checkpoint(str(path))


def test_load_param_model_search_order(tmp_path, monkeypatch):
    """$STITO_CKPT_DIR's .ckpt is converted and cached as .npz beside it
    (the cache then serves, config included); ./tmp comes first; an
    explicit path first of all."""
    ckpt_dir = tmp_path / "ckpts"
    ckpt_dir.mkdir()
    net = small_net(1)
    write_ckpt(ckpt_dir / "afx-rep.ckpt", net)
    (ckpt_dir / "config.yaml").write_text(YAML)
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setenv("STITO_CKPT_DIR", str(ckpt_dir))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 2, 8192)).astype(np.float32))

    def embeds(model):
        return model(x)[0]

    model = load_param_model(device="cpu")
    torch.testing.assert_close(embeds(model), net(x)[0], rtol=0, atol=0)
    assert (ckpt_dir / "afx-rep.npz").is_file()
    (ckpt_dir / "afx-rep.ckpt").unlink()
    cached = load_param_model(device="cpu")
    assert cached.config == Cnn14Config(**SMALL)
    torch.testing.assert_close(embeds(cached), net(x)[0], rtol=0, atol=0)

    other = small_net(2)
    (work / "tmp").mkdir()
    export_encoder_npz(other.state_dict(), str(work / "tmp" / "afx-rep.npz"),
                       other.config)
    torch.testing.assert_close(embeds(load_param_model(device="cpu")),
                               other(x)[0], rtol=0, atol=0)
    explicit = tmp_path / "mine.ckpt"
    write_ckpt(explicit, net)
    (tmp_path / "config.yaml").write_text(YAML)
    torch.testing.assert_close(
        embeds(load_param_model(str(explicit), device="cpu")), net(x)[0],
        rtol=0, atol=0)


def printed(text):
    """The numbers of embed's two lines: the shape, then four values."""
    lines = [ln for ln in text.splitlines() if ln.startswith(("mid", "side"))]
    assert [ln[:4] for ln in lines] == ["mid ", "side"]
    return [np.asarray([float(t) for t in ln.split(":", 1)[1].replace(
        "(", " ").replace(")", " ").replace("[", " ").replace("]", " ")
        .replace(",", " ").split()]) for ln in lines]


def test_embed_cli_prints_what_the_script_prints(tmp_path, monkeypatch,
                                                 capsys):
    """Both packages on one npz (``export_encoder_npz``'s layout): the
    printed shapes equal, the values within 1e-5; and the port's CLI on
    the Lightning checkpoint of the same weights."""
    net = small_net(3)
    npz = tmp_path / "enc.npz"
    jax_export({k: v.numpy() for k, v in net.state_dict().items()
                if not k.endswith("num_batches_tracked")}, str(npz),
               Cnn14Config(**SMALL))
    monkeypatch.setattr(sys, "argv", ["embed.py", "--ckpt", str(npz)])
    runpy.run_path(SCRIPT, run_name="__main__")
    want = printed(capsys.readouterr().out)
    embed.main(["--ckpt", str(npz), "--device", "cpu"])
    got = printed(capsys.readouterr().out)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape == (6,)
        np.testing.assert_array_equal(g[:2], w[:2])
        np.testing.assert_allclose(g[2:], w[2:], rtol=0, atol=1e-5)

    ckpt = tmp_path / "afx-rep.ckpt"
    write_ckpt(ckpt, net)
    (tmp_path / "config.yaml").write_text(YAML)
    embed.main(["--ckpt", str(ckpt), "--device", "cpu"])
    for g, w in zip(printed(capsys.readouterr().out), got):
        np.testing.assert_array_equal(g, w)


def test_embed_cli_refuses_without_weights(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("STITO_CKPT_DIR", raising=False)
    with pytest.raises(FileNotFoundError):
        embed.main(["--device", "cpu"])
