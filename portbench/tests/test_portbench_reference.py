"""The plain references against a tiny CPU run of the port, and the
reference's doubling scans against serial loops."""

import math
import os

import numpy as np
import pytest
import torch

from portbench.core import audio, bench, weights
from portbench.reference import cnn14 as ref_cnn14
from portbench.reference import render as ref_render

SR = 48000
ENC = {"embed_dim": 8, "sample_rate": 48000, "window_size": 512,
       "hop_size": 128, "mel_bins": 32, "fmin": 20, "fmax": 20000,
       "use_batchnorm": True, "input_norm": "minmax", "base_channels": 2}


def chain(name):
    return os.path.join(bench.HERE, "chains", f"{name}.json")


@pytest.mark.parametrize("T", [500, 3000])  # 0.5 ** 2048 underflows
def test_release_stage_equals_serial_loop(T):
    gen = torch.Generator().manual_seed(0)
    c = -30 * torch.rand((3, 2, T), generator=gen, dtype=torch.float64)
    ar = torch.tensor([0.9, 0.99, 0.5], dtype=torch.float64)[:, None, None]
    aa = torch.tensor([0.3, 0.8, 0.95], dtype=torch.float64)[:, None, None]
    got = ref_render.one_pole(ref_render.release_stage(c, ar), aa)
    y1 = torch.zeros(c.shape[:-1], dtype=torch.float64)
    y2 = torch.zeros_like(y1)
    want = torch.empty_like(c)
    for n in range(c.shape[-1]):
        y1 = torch.minimum(c[..., n], ar[..., 0] * y1 + (1 - ar[..., 0])
                           * c[..., n])
        y2 = aa[..., 0] * y2 + (1 - aa[..., 0]) * y1
        want[..., n] = y2
    assert torch.allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["basic", "style"])
def test_renders_match_the_port(name):
    from st_ito_torch.chain import (build_batched_render_fn, build_render_fn,
                                    chain_from_json)

    spec = chain_from_json(chain(name))
    effects = ref_render.load_chain(chain(name))
    assert spec.num_params == ref_render.num_params(effects)
    x = audio.program_audio(audio.generator(5, device="cpu"), 2, 8192, SR,
                            "cpu")
    W = torch.from_numpy(np.random.default_rng(3).random(
        (6, spec.num_params)).astype(np.float32))
    got = build_batched_render_fn(spec, SR, 2, peak_normalize_output=False,
                                  device="cpu")(W, x)
    want = ref_render.render_population(effects, W, x, SR)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-3
    for w in W[:2]:
        got = build_render_fn(spec, SR, 2, device="cpu")(w, x)
        want = ref_render.render_candidate(effects, w, x, SR)
        assert float((got - want).abs().max()) < 1e-3


def test_cnn14_matches_the_port():
    from st_ito_torch.models.cnn14 import Cnn14, Cnn14Config
    from st_ito_torch.models.registry import ParamModel, get_param_embeds

    net = Cnn14(Cnn14Config(**ENC))
    net.load_state_dict(weights.draw(9, ref_cnn14.param_specs(ENC), "cpu"))
    model = ParamModel(net=net, config=net.config, embed_dim=8)
    x = 0.3 * torch.randn((3, 2, 8192), generator=torch.Generator()
                          .manual_seed(1))
    got = get_param_embeds(x, model, SR)
    params = weights.draw(9, ref_cnn14.param_specs(ENC), "cpu",
                          dtype=torch.float64)
    want = ref_cnn14.embed(params, x.double(), ENC)
    for k in ("mid", "side"):
        assert float((got[k].double() - want[k]).abs().max()) < 1e-5


def test_chunked_embed_matches_the_port():
    from st_ito_torch.models.cnn14 import Cnn14, Cnn14Config
    from st_ito_torch.models.registry import (ParamModel,
                                              get_param_embeds_chunked)

    net = Cnn14(Cnn14Config(**ENC))
    net.load_state_dict(weights.draw(9, ref_cnn14.param_specs(ENC), "cpu"))
    model = ParamModel(net=net, config=net.config, embed_dim=8)
    x = 0.3 * torch.randn((2, 2, 3 * 4096 + 100))
    got = get_param_embeds_chunked(x, model, SR, chunk_len=4096)
    params = weights.draw(9, ref_cnn14.param_specs(ENC), "cpu",
                          dtype=torch.float64)
    want = ref_cnn14.embed(params, x.double(), ENC, chunk=4096)
    for k in ("mid", "side"):
        assert float((got[k].double() - want[k]).abs().max()) < 1e-5


def test_mel_matrix_matches_the_port():
    from st_ito_torch.ops.stft import mel_filterbank

    want = mel_filterbank(48000, 2048, 128, 20.0, 20000.0).double().numpy()
    got = ref_cnn14.mel_matrix({"sample_rate": 48000, "window_size": 2048,
                                "mel_bins": 128, "fmin": 20, "fmax": 20000})
    assert np.abs(got - want).max() < 1e-6 * np.abs(want).max()


def test_lower_precision_rounds():
    from portbench.drivers import ito

    bf16, fp8 = ito.bf16, ito.fp8
    t = torch.linspace(-1, 1, 1001, dtype=torch.float64)
    assert 0 < float((bf16(t) - t).abs().max()) <= 2 ** -8
    assert 2 ** -8 < float((fp8(t) - t).abs().max()) <= 2 ** -4
    assert math.isclose(float(fp8(t).abs().max()), 1.0)


def test_reference_cmaes_asks_as_the_port_does():
    from st_ito_torch.ito.cmaes import CMAES

    from portbench.reference import cmaes as ref_cmaes

    rng = np.random.default_rng(3)
    x0 = rng.random(36)
    port = CMAES(x0, 0.33, popsize=16, bounds=(0.0, 1.0), seed=2 ** 40 + 9)
    ref = ref_cmaes.CMAES(x0, 0.33, 16, 2 ** 40 + 9)
    for _ in range(4):
        X = port.ask()
        assert np.array_equal(ref.ask(), X)
        f = np.sin(7.0 * X).sum(1)
        port.tell(X, f)
        ref.tell(X, f)


def test_calibrated_batchnorm_takes_the_clips_statistics():
    gen = torch.Generator().manual_seed(5)
    params = weights.draw(7, ref_cnn14.param_specs(ENC), "cpu",
                          dtype=torch.float64)
    clips = torch.stack([audio.program_audio(gen, 2, 8192, SR, "cpu")
                         for _ in range(4)]).double()
    stats = ref_cnn14.calibrate_bn(params, clips, ENC)
    assert len(stats) == 2 * 2 * 6
    x = clips / clips.abs().amax(dim=(1, 2), keepdim=True)
    h = ref_cnn14.minmax(ref_cnn14.logmel(
        ref_cnn14.mid_side(x).reshape(8, -1), ENC))
    h = torch.nn.functional.conv2d(
        h, params["conv_block1.conv1.weight"], padding=1)
    assert torch.allclose(stats["conv_block1.bn1.running_mean"],
                          h.mean(dim=(0, 2, 3)))
    assert torch.allclose(stats["conv_block1.bn1.running_var"],
                          h.var(dim=(0, 2, 3)))
    # the calibrated encoder tells the clips apart
    params.update(stats)
    e = ref_cnn14.embed(params, clips, ENC)["mid"]
    cos = e @ e.T
    assert cos[~torch.eye(4, dtype=torch.bool)].max() < 0.99
