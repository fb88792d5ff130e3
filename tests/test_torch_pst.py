"""The PST benchmark (``eval/pst.py``, ``eval/pst_examples.py``,
``cli/eval_pst.py``) against st_ito_tpu's on the CPU with the MFCC metric.

The JAX renders that a comparison reads run op by op where the JAX module
jits them over a delay or a compressor (its ``_synth_examples`` and
``synthesize_contrived_examples``; the detector scan jitted), for the
reasons ``tests/test_torch_eval.py`` gives (ROADMAP §3); the benchmark's
chain is the "guitar" preset (distortion -> EQ -> reverb), which the JAX
``run_random`` renders jitted to within 5e-5 of the op-by-op render.

Tolerances: renders within 5e-5 x max(1, peak); each method's similarity
within 1e-5 (``input``, ``random``, ``rule-based``); ``style-es`` at
popsize 8 for 2 generations finite with the JAX package's keys (the CLI
test); the JSON's keys, the WAV names and the example sets' names and
paths equal."""

import functools
import glob
import json
import os
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from st_ito_tpu.chain import chain_preset as jax_chain_preset
from st_ito_tpu.cli import eval_pst as jax_eval_pst
from st_ito_tpu.eval import cls as jcls
from st_ito_tpu.eval import pst as jpst
from st_ito_tpu.eval import pst_examples as jex
from st_ito_tpu.models.cnn14 import Cnn14Config as JaxCnn14Config
from st_ito_tpu.models.registry import export_encoder_npz
from st_ito_tpu.models.registry import (
    get_mfcc_feature_embeds as jax_mfcc_embeds,
    load_mfcc_feature_extractor as jax_load_mfcc,
)

from st_ito_torch.chain import chain_preset
from st_ito_torch.cli import eval_pst
from st_ito_torch.eval import pst, pst_examples
from st_ito_torch.models import (get_mfcc_feature_embeds,
                                 load_mfcc_feature_extractor)
from st_ito_torch.utils import save_audio

from tests.test_torch_cnn14 import SMALL, jax_init
from tests.test_torch_eval import sources
from tests.test_torch_fx import jit_jax_scans
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000
T = 16384


def assert_render(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 5e-5 * max(1.0, np.abs(want).max())


@pytest.fixture
def jax_op_by_op(monkeypatch):
    """The JAX render_style as its plain function, the detector and
    allpass scans jitted."""
    jit_jax_scans(monkeypatch)
    monkeypatch.setattr(jcls, "render_style", jcls.render_style.__wrapped__)


# ------------------------------------------------------------ example sets


def test_example_sets_match_jax(tmp_path):
    """The curated pairs, the contrived layout, the mode chains, and
    loading both sets from WAVs on disk (44.1 kHz mono resampled to 48 kHz
    stereo and truncated, by ``_conform``)."""
    assert pst_examples.REAL_EXAMPLES == jex.REAL_EXAMPLES
    assert pst_examples.CONTRIVED_STYLES == jex.CONTRIVED_STYLES
    assert pst_examples.MODE_CHAINS == jex.MODE_CHAINS
    for mode in ("music", "speech"):
        assert (pst_examples.contrived_example_paths(mode, "/d", range(3))
                == jex.contrived_example_paths(mode, "/d", range(3)))
    with pytest.raises(ValueError):
        pst_examples.contrived_example_paths("guitar", "/d")
    for mode in pst_examples.MODE_CHAINS:
        got, want = (pst_examples.benchmark_chain(mode),
                     jex.benchmark_chain(mode))
        assert [s.name for s in got.stages] == [s.name for s in want.stages]
        assert got.num_params == want.num_params

    rng = np.random.default_rng(0)
    pairs, idx = jex.REAL_EXAMPLES["guitar"]
    for rel in {p for i in idx for p in pairs[i]}:
        os.makedirs(tmp_path / os.path.dirname(rel), exist_ok=True)
        save_audio(str(tmp_path / rel),
                   rng.uniform(-0.5, 0.5, (1, 4410)).astype(np.float32), 44100)
    for in_path, tgt_path in jex.contrived_example_paths("speech",
                                                         str(tmp_path),
                                                         range(80, 81)):
        for p in (in_path, tgt_path):
            os.makedirs(os.path.dirname(p), exist_ok=True)
            save_audio(p, rng.uniform(-0.5, 0.5, (2, 2400)).astype(
                np.float32), 24000)
    for got, want in (
            (pst_examples.load_real_examples(str(tmp_path), "guitar",
                                             max_length=4000),
             jex.load_real_examples(str(tmp_path), "guitar",
                                    max_length=4000)),
            (pst_examples.load_contrived_examples(str(tmp_path), "speech",
                                                  index_range=range(80, 81)),
             jex.load_contrived_examples(str(tmp_path), "speech",
                                         index_range=range(80, 81)))):
        assert [e["name"] for e in got] == [e["name"] for e in want]
        for g, w in zip(got, want):
            for k in ("input", "target"):
                assert g[k].dtype == np.float32 and g[k].shape[0] == 2
                assert_render(g[k], w[k])


def test_synthesized_contrived_examples_match_jax(jax_op_by_op):
    src = sources(2, T // 2, seed=30)
    src[1] = src[1][:1]  # mono made stereo
    got = pst_examples.synthesize_contrived_examples(src, SR, device="cpu")
    want = jex.synthesize_contrived_examples(src, SR)
    assert [e["name"] for e in got] == [e["name"] for e in want]
    for g, w in zip(got, want):
        assert_render(g["input"], w["input"])
        assert_render(g["target"], w["target"])


def test_synth_examples_match_jax(jax_op_by_op, monkeypatch):
    """The CLI's two pairs through the general chain (distortion -> EQ ->
    compressor -> delay -> reverb) at a setting with every stage on; the
    JAX CLI's ``jax.jit`` of its renderer as the plain call."""
    monkeypatch.setattr(jax, "jit", lambda f, **k: f)
    got = eval_pst._synth_examples(chain_preset("general"), T=T,
                                   device="cpu")
    want = jax_eval_pst._synth_examples(jax_chain_preset("general"), T=T)
    assert [e["name"] for e in got] == [e["name"] for e in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["input"], w["input"])
        assert_render(g["target"], w["target"])


# -------------------------------------------------------------- benchmark


def examples():
    src = sources(3, T, seed=31)
    return [{"name": "ex0", "input": src[0], "target": src[1]},
            {"name": "ex1", "input": src[1][:1], "target": src[2]}]


def written(out):
    """The results JSON's contents and the WAV names, per example."""
    (path,) = glob.glob(os.path.join(out, "results_*.json"))
    with open(path) as f:
        res = json.load(f)
    wavs = {ex: sorted(os.listdir(os.path.join(out, ex))) for ex in res}
    return res, wavs


def test_pst_benchmark_matches_jax(tmp_path):
    """``default_methods``' input, random and rule-based on two examples
    (one mono input): the similarities within 1e-5, the JSON and the WAVs
    (at -22 LUFS, 16 bits) under the same names."""
    chain, jchain = chain_preset("guitar"), jax_chain_preset("guitar")
    mfcc = {"mfcc": (load_mfcc_feature_extractor(), get_mfcc_feature_embeds)}
    jmfcc = {"mfcc": (jax_load_mfcc(), jax_mfcc_embeds)}
    methods = pst.default_methods(chain, None, get_mfcc_feature_embeds,
                                  seed=3, device="cpu")
    jmethods = jpst.default_methods(jchain, None, jax_mfcc_embeds, seed=3)
    assert list(methods) == list(jmethods)
    keep = ("input", "random", "rule-based")
    got = pst.run_pst_benchmark(
        examples(), {k: methods[k] for k in keep}, mfcc, SR,
        output_dir=str(tmp_path / "t"), device="cpu")
    want = jpst.run_pst_benchmark(
        examples(), {k: jmethods[k] for k in keep}, jmfcc, SR,
        output_dir=str(tmp_path / "j"))
    assert got.keys() == want.keys()
    for ex in got:
        assert list(got[ex]) == list(want[ex]) == list(keep)
        for m in keep:
            assert got[ex][m].keys() == want[ex][m].keys()
            assert abs(got[ex][m]["mfcc_sim"]
                       - want[ex][m]["mfcc_sim"]) <= 1e-5, (ex, m)
    assert got["ex0"]["input"]["mfcc_sim"] == pytest.approx(
        want["ex0"]["input"]["mfcc_sim"], abs=1e-6)
    (res, wavs), (jres, jwavs) = written(str(tmp_path / "t")), written(
        str(tmp_path / "j"))
    assert wavs == jwavs and wavs["ex0"] == [
        "input.wav", "random.wav", "rule-based.wav", "target.wav"]
    assert {ex: {m: set(e) for m, e in d.items()} for ex, d in res.items()} \
        == {ex: {m: set(e) for m, e in d.items()} for ex, d in jres.items()}


def test_learned_systems_raise():
    """The learned baselines are methods now (``run_learned_inference``,
    tests/test_torch_learned.py); a system that is no StyleTransferSystem
    raises when its method runs, not when the methods are built."""
    methods = pst.default_methods(chain_preset("guitar"), None,
                                  get_mfcc_feature_embeds,
                                  style_systems={"deepafx-st": (None, None)},
                                  device="cpu")
    assert list(methods) == ["input", "random", "rule-based", "deepafx-st",
                             "style-es"]
    x = torch.zeros(1, 2, 64)
    with pytest.raises(AttributeError):
        methods["deepafx-st"]["func"](x, x, 48000)


def test_eval_pst_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """Both CLIs on the guitar chain with a small Cnn14 served from
    $STITO_CKPT_DIR and one synthesized pair of T samples: the same
    examples, methods, similarities of input, random and rule-based within
    1e-5, WAV names and figure; ``style-es`` (``run_es`` with a random
    crop, no w0 search) at popsize 8 for 2 generations finite, with the
    JAX entry's keys and parameter names."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    cfg = JaxCnn14Config(**dict(SMALL, hop_size=128))
    export_encoder_npz(jax_init(jax.random.PRNGKey(4), cfg),
                       str(ckpt / "afx-rep.npz"), cfg)
    monkeypatch.setenv("STITO_CKPT_DIR", str(ckpt))
    for mod in (eval_pst, jax_eval_pst):
        monkeypatch.setattr(mod, "_synth_examples", functools.partial(
            mod._synth_examples, T=T, n=1))
    argv = ["--chain", "guitar", "--popsize", "8", "--max-iters", "2",
            "--metrics", "mfcc", "--output-dir"]
    jax_eval_pst.main(argv + [str(tmp_path / "j")])
    got = eval_pst.main(argv + [str(tmp_path / "t"), "--device", "cpu"])
    capsys.readouterr()
    (res, wavs), (jres, jwavs) = written(str(tmp_path / "t")), written(
        str(tmp_path / "j"))
    assert res.keys() == jres.keys() == got.keys() == {"synthetic0"}
    assert wavs == jwavs
    for m in ("input", "random", "rule-based", "style-es"):
        assert res["synthetic0"][m].keys() == jres["synthetic0"][m].keys()
    for m in ("input", "random", "rule-based"):
        assert abs(res["synthetic0"][m]["mfcc_sim"]
                   - jres["synthetic0"][m]["mfcc_sim"]) <= 1e-5, m
    es, jes = res["synthetic0"]["style-es"], jres["synthetic0"]["style-es"]
    assert es.keys() == jes.keys() == {"time_elapsed", "mfcc_sim", "params"}
    assert np.isfinite(es["mfcc_sim"]) and -1 <= es["mfcc_sim"] <= 1
    assert es["params"].keys() == jes["params"].keys()
    for stage in es["params"]:
        assert es["params"][stage].keys() == jes["params"][stage].keys()
    assert (tmp_path / "t" / "pst_plot.png").stat().st_size > 0
