"""``run_optim --metric clap`` and ``eval_pst --metrics clap`` on the
CPU, the small tower of ``tests/test_torch_clap.py`` put in place of the
CLAP loaders of both packages.

Tolerances: the CLI's fitness history within 1e-4 of the JAX CLI's on the
same populations; the ``input`` method's CLAP similarity within 1e-5 of
the JAX tower's cosine of the same faded signals."""

import functools
import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from st_ito_tpu.models import clap_laion as jcl

from st_ito_torch.chain import chain_preset
from st_ito_torch.cli import eval_pst, run_optim
from st_ito_torch.eval import metrics
from st_ito_torch.eval.pst import fade_in
from st_ito_torch.models import Cnn14, Cnn14Config, registry
from st_ito_torch.models.cnn14 import init_cnn14_
from st_ito_torch.utils import load_audio, save_audio

from tests.test_torch_clap_metric import small  # noqa: F401
from tests.test_torch_cnn14 import SMALL
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000


def test_run_optim_metric_clap_matches_jax(small, tmp_path, monkeypatch):
    """``--metric clap`` at popsize 4 for one iteration, each package's
    loader serving its small tower: the same populations asked (one
    seed, bitwise), fitness histories within 1e-4, the WAV and the
    parameters written."""
    from st_ito_tpu.cli import run_optim as jax_cli
    from st_ito_tpu.ito.cmaes import CMAES as JaxCMAES
    from st_ito_tpu.models import registry as jregistry
    from st_ito_torch.ito import CMAES

    from tests.test_torch_ito import _record_asks
    from tests.test_torch_render import force_jax_tpu_plan

    jmodel, model = small
    rng = np.random.default_rng(7)
    t = np.arange(8192) / SR
    x = (0.3 * np.sin(2 * np.pi * 330 * t) * np.ones((2, 1))
         + 0.05 * rng.standard_normal((2, 8192)))
    wav = str(tmp_path / "tune.wav")
    save_audio(wav, x.astype(np.float32), SR)
    monkeypatch.setenv("STITO_COMPILE_CACHE", "0")
    seen = []
    monkeypatch.setattr(registry, "load_clap_model",
                        lambda **kw: (seen.append(kw), model)[1])
    monkeypatch.setattr(jregistry, "load_clap_model", lambda **kw: jmodel)
    asks = {"jax": [], "port": []}
    _record_asks(monkeypatch, JaxCMAES, asks["jax"])
    _record_asks(monkeypatch, CMAES, asks["port"])
    common = [wav, "None", "--metric", "clap", "--popsize", "4",
              "--max-iters", "1", "--max-length", "8192"]
    with pytest.MonkeyPatch.context() as mp:
        force_jax_tpu_plan(mp)  # the JAX renderer's plan that the port's is
        want = jax_cli.main(common + ["--output-dir", str(tmp_path / "j")])
    res = run_optim.main(common + ["--device", "cpu", "--output-dir",
                                   str(tmp_path / "t")])
    assert seen == [{"device": torch.device("cpu")}]
    assert len(asks["port"]) == len(asks["jax"]) == 1
    np.testing.assert_array_equal(asks["port"][0], asks["jax"][0])
    hist = np.asarray(res["fval_history"])
    assert hist.shape == (1,) and np.isfinite(hist).all()
    assert np.abs(hist - np.asarray(want["fval_history"])).max() <= 1e-4
    assert res["total_evals"] == 8
    run_dir = tmp_path / "t" / "tune_to_synthetic_target_es"
    out, sr = load_audio(str(run_dir / "output_audio_sigma=0.33.wav"))
    assert sr == SR and out.shape == (2, 8192) and np.isfinite(out).all()
    with open(run_dir / "parameters_sigma=0.33.json") as f:
        assert list(json.load(f)) == ["ParametricEQ", "Delay", "Reverb"]


def test_eval_pst_metric_clap(small, tmp_path, monkeypatch, capsys):
    """``eval_pst --metrics clap`` on one synthesized pair of 16384
    samples, popsize 4 for one iteration: every method's clap_sim finite,
    and the ``input`` method's the JAX tower's cosine of the faded input
    and target within 1e-5."""
    jmodel, model = small
    # style-es's encoder: a small Cnn14 (hop 128) where load_param_model
    # looks
    cfg = Cnn14Config(**dict(SMALL, hop_size=128))
    registry.export_encoder_npz(
        init_cnn14_(Cnn14(cfg), torch.Generator().manual_seed(8))
        .state_dict(), str(tmp_path / "afx-rep.npz"), cfg)
    monkeypatch.setenv("STITO_CKPT_DIR", str(tmp_path))
    monkeypatch.setitem(metrics.METRICS, "clap",
                        (lambda: model, registry.get_clap_embeds))
    monkeypatch.setattr(eval_pst, "_synth_examples", functools.partial(
        eval_pst._synth_examples, T=16384, n=1))
    out = tmp_path / "pst"
    res = eval_pst.main(["--chain", "guitar", "--popsize", "4",
                         "--max-iters", "1", "--metrics", "clap",
                         "--device", "cpu", "--output-dir", str(out)])
    capsys.readouterr()
    per = res["synthetic0"]
    assert list(per) == ["input", "random", "rule-based", "style-es"]
    assert all(np.isfinite(e["clap_sim"]) for e in per.values())
    ex, = eval_pst._synth_examples(chain_preset("guitar"), device="cpu")
    e = [jcl.get_clap_laion_embeds(
        jnp.asarray(fade_in(torch.as_tensor(ex[k])[None], 32768).numpy()),
        jmodel, SR)["mono"] for k in ("input", "target")]
    cos = float(np.sum(np.asarray(e[0]) * np.asarray(e[1])))
    assert abs(per["input"]["clap_sim"] - cos) <= 1e-5
