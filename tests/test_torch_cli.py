"""The port's style-transfer CLI (``st_ito_torch.cli.run_optim``) against
st_ito_tpu's: the same chains and synthetic target, a whole run on the CPU
that writes its WAVs and parameter JSON, ``--staged``, ``--savepop``,
``--chunked`` and ``--dropout`` passed through as the JAX CLI passes them,
``--metric mfcc`` against the JAX CLI, ``--metric clap`` reaching its
loader, and the flag that is not ported raising with its ROADMAP item. ``--algorithm autodiff`` is held in
``test_torch_autodiff.py``."""

import json
import os

import numpy as np
import pytest
import torch

from st_ito_tpu.cli import run_optim as jax_cli
from st_ito_tpu.models.cnn14 import Cnn14Config as JaxCnn14Config
from st_ito_tpu.models.registry import export_encoder_npz

from st_ito_torch.cli import run_optim
from st_ito_torch.utils import load_audio, save_audio

from tests.test_torch_cnn14 import jax_params

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

# a small encoder (hop 128: 64 frames at T 8192; the deployed one needs
# 31744 samples at least), written in the export_encoder_npz layout that
# load_param_model finds under $STITO_CKPT_DIR
SMALL_CLI = dict(embed_dim=32, window_size=256, hop_size=128, mel_bins=32,
                 base_channels=4)


def _facts(chain):
    return [(s.name, s.effect, s.num_channels,
             [(p.name, p.min_value, p.max_value, p.default) for p in s.params])
            for s in chain.stages] + [chain.with_bypass]


@pytest.mark.parametrize("effect_type", ["vst", "basic"])
@pytest.mark.parametrize("with_bypass", [False, True])
def test_build_chain_and_synthetic_target_match_jax(effect_type, with_bypass):
    got = run_optim.build_chain(effect_type, "es", with_bypass)
    want = jax_cli.build_chain(effect_type, "es", with_bypass)
    assert _facts(got) == _facts(want)
    np.testing.assert_array_equal(run_optim.synthetic_target_params(got),
                                  jax_cli.synthetic_target_params(want))
    assert run_optim.build_chain(effect_type, "autodiff") is None


@pytest.fixture
def cli_inputs(tmp_path, monkeypatch):
    """A stereo WAV at 44.1 kHz (the CLI resamples it to 48 kHz) and the
    small encoder's checkpoint."""
    rng = np.random.default_rng(0)
    T = 12000
    t = np.arange(T) / 44100
    x = (0.3 * np.sin(2 * np.pi * 220 * t) * np.ones((2, 1))
         + 0.05 * rng.standard_normal((2, T)))
    wav = str(tmp_path / "song.wav")
    save_audio(wav, x.astype(np.float32), 44100)
    export_encoder_npz(jax_params(1, random_bn=False),
                       str(tmp_path / "afx-rep.npz"),
                       JaxCnn14Config(**SMALL_CLI))
    monkeypatch.setenv("STITO_CKPT_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    return wav, str(tmp_path / "out")


def test_cli_runs_on_the_cpu(cli_inputs, capsys):
    wav, out = cli_inputs
    res = run_optim.main([wav, "None", "--device", "cpu", "--popsize", "8",
                          "--max-iters", "2", "--max-length", "8192",
                          "--allow-random-model", "--output-dir", out])
    run_dir = os.path.join(out, "song_to_synthetic_target_es")
    for name in ("input_audio.wav", "target_audio.wav",
                 "output_audio_sigma=0.33.wav"):
        audio, sr = load_audio(os.path.join(run_dir, name))
        assert sr == 48000 and audio.shape == (2, 8192), name
        assert np.isfinite(audio).all() and np.abs(audio).max() > 0, name
    with open(os.path.join(run_dir, "parameters_sigma=0.33.json")) as f:
        params = json.load(f)
    assert list(params) == ["ParametricEQ", "Delay", "Reverb"]
    assert all(np.isfinite(v) for p in params.values() for v in p.values())
    out_text = capsys.readouterr().out
    summary = json.loads(out_text[out_text.index("{\n"):])
    assert summary["run_dir"] == run_dir
    assert summary["total_evals"] == 24 and summary["evals_per_sec"] > 0
    assert res["total_evals"] == 24 and np.isfinite(res["fopt"])
    assert len(res["fval_history"]) == 2


@pytest.mark.parametrize("flags", [
    ["--staged"], ["--savepop"], ["--chunked"], ["--dropout", "0.2"],
], ids=["staged", "savepop", "chunked", "dropout"])
def test_cli_es_modes_on_the_cpu(cli_inputs, flags, monkeypatch):
    """Each mode flag reaches run_es (or run_staged_es for --staged) as the
    JAX CLI passes it (st_ito_tpu/cli/run_optim.py:226-242), and the run
    writes its WAVs and parameters; --staged optimises the vst chain's
    three stages in turn, --savepop writes every generation's renders
    (find_w0's in pop_-1)."""
    import st_ito_torch.ito as ito
    from st_ito_torch.ito import engine

    seen = []

    def spy(fn, **extra):
        return lambda *a, **k: (seen.append(dict(k, **extra)), fn(*a, **k))[1]

    # the CLI's call, and run_staged_es's calls of run_es per stage
    monkeypatch.setattr(ito, "run_es", spy(engine.run_es))
    monkeypatch.setattr(ito, "run_staged_es",
                        spy(engine.run_staged_es, staged=True))
    monkeypatch.setattr(engine, "run_es", spy(engine.run_es))
    wav, out = cli_inputs
    res = run_optim.main([wav, "None", "--device", "cpu", "--popsize", "4",
                          "--max-iters", "1", "--max-length", "8192",
                          "--output-dir", out] + flags)
    run_dir = os.path.join(out, "song_to_synthetic_target_es")
    audio, sr = load_audio(os.path.join(run_dir,
                                        "output_audio_sigma=0.33.wav"))
    assert sr == 48000 and audio.shape == (2, 8192)
    assert np.isfinite(audio).all() and np.isfinite(res["fopt"])
    k = seen[0]
    assert k["savepop"] == (flags == ["--savepop"])
    assert k["chunked"] == (flags == ["--chunked"])
    assert k["dropout"] == (0.2 if flags[0] == "--dropout" else 0.0)
    if flags == ["--staged"]:
        assert k.get("staged") and len(seen) == 4  # the call and 3 stages
        assert [s["opt_slice"] for s in seen[1:]] == [
            (a, b) for _, a, b in
            run_optim.build_chain("vst", "es").stage_slices()]
        assert len(res["fval_history"]) == 3
    else:
        assert len(seen) == 1 and len(res["fval_history"]) == 1
    if flags == ["--savepop"]:
        for gen in ("pop_-1", "pop_0"):
            assert len(os.listdir(os.path.join(run_dir, gen))) == 4


def test_cli_metric_mfcc_matches_jax(tmp_path, monkeypatch):
    """``--metric mfcc`` at popsize 8, 2 iterations, on a 48 kHz WAV, here
    on the CPU and in the JAX CLI on its TPU plan (Pallas interpreted):
    both run the host CMA-ES (the CLI's gens_per_dispatch=1) from one seed,
    so they ask for the same populations, bit for bit, as long as the MFCC
    fitness ranks them alike; the fitness history within 1e-4, and the
    written WAV and parameters."""
    from st_ito_tpu.ito.cmaes import CMAES as JaxCMAES
    from st_ito_torch.ito import CMAES

    from tests.test_torch_ito import _record_asks
    from tests.test_torch_render import force_jax_tpu_plan

    rng = np.random.default_rng(1)
    t = np.arange(8192) / 48000
    x = (0.3 * np.sin(2 * np.pi * 330 * t) * np.ones((2, 1))
         + 0.05 * rng.standard_normal((2, 8192)))
    wav = str(tmp_path / "tune.wav")
    save_audio(wav, x.astype(np.float32), 48000)
    monkeypatch.setenv("STITO_COMPILE_CACHE", "0")
    asks = {"jax": [], "port": []}
    _record_asks(monkeypatch, JaxCMAES, asks["jax"])
    _record_asks(monkeypatch, CMAES, asks["port"])
    common = [wav, "None", "--metric", "mfcc", "--popsize", "8",
              "--max-iters", "2", "--max-length", "8192"]
    with pytest.MonkeyPatch.context() as mp:
        force_jax_tpu_plan(mp)
        want = jax_cli.main(common + ["--output-dir", str(tmp_path / "j")])
    got = run_optim.main(common + ["--device", "cpu", "--output-dir",
                                   str(tmp_path / "t")])
    assert len(asks["port"]) == len(asks["jax"]) == 2
    for a, b in zip(asks["port"], asks["jax"]):
        np.testing.assert_array_equal(a, b)
    hist = np.asarray(got["fval_history"])
    assert hist.shape == (2,) and np.isfinite(hist).all()
    assert np.abs(hist - np.asarray(want["fval_history"])).max() <= 1e-4
    run_dir = str(tmp_path / "t" / "tune_to_synthetic_target_es")
    audio, sr = load_audio(os.path.join(run_dir,
                                        "output_audio_sigma=0.33.wav"))
    assert sr == 48000 and audio.shape == (2, 8192)
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0
    with open(os.path.join(run_dir, "parameters_sigma=0.33.json")) as f:
        assert list(json.load(f)) == ["ParametricEQ", "Delay", "Reverb"]


@pytest.mark.parametrize("flags,item", [
    (["--num-devices", "4"], "13"),
], ids=["flags6-13"])  # as it was
def test_unported_flags_raise(flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP §1 item {item}"):
        run_optim.main(["in.wav", "None", "--device", "cpu"] + flags)


def test_cli_metric_clap_reaches_its_loader(cli_inputs, monkeypatch):
    """``--metric clap`` is ported: with no CLAP checkpoint and no
    transformers the CLI reaches ``load_clap_model``, which raises
    FileNotFoundError, as the JAX CLI's does offline. The path itself runs
    in ``tests/test_torch_clap_cli.py``."""
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)
    wav, out = cli_inputs
    with pytest.raises(FileNotFoundError, match="CLAP weights"):
        run_optim.main([wav, "None", "--metric", "clap", "--device", "cpu",
                        "--max-length", "8192", "--output-dir", out])
