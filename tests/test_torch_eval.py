"""The recovery evaluations against st_ito_tpu's with the MFCC metric:
the synthetic cases, their scoring and the benchmark over methods, the
metric sweep, the case-study recovery curve, the PSM quadruplets (their
numpy draws, renders and ranking, and the on-disk layout), the three CLIs
(``eval_psm``, ``eval_sweep``, ``effect_info``) on the CPU and the
figures.

Tolerances: renders within 5e-5 x max(1, peak), scores and similarities
within 1e-4 (MRSTFT losses 1e-4 relative); parameter draws, accuracies, recovered values and the
effect listing exactly, WAVs to their 16 bits. The JAX modules jit their
renderer, so the chains hold no delay, whose length a jitted render rounds
one ulp away from the op-by-op one for some settings (ROADMAP §3); and the
synthetic module, whose chain holds the compressor, renders op by op with
its scans jitted (``op_by_op_synthetic``): jitted whole, XLA's fusions
move the compressor's output by 3e-3 at 0.1 ms attack and 10 ms release,
where the port lies within 2e-6 of the op-by-op render."""

import types


import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from st_ito_tpu.chain import ChainSpec as JaxChainSpec
from st_ito_tpu.chain import EFFECT_REGISTRY as JAX_REGISTRY
from st_ito_tpu.cli import effect_info as jax_effect_info
from st_ito_tpu.cli import eval_psm as jax_eval_psm
from st_ito_tpu.cli import eval_sweep as jax_eval_sweep
from st_ito_tpu.eval import case_study as jcase
from st_ito_tpu.eval import psm as jpsm
from st_ito_tpu.eval import sweep as jsweep
from st_ito_tpu.eval import synthetic as jsynth
from st_ito_tpu.ito import run_input as jax_run_input
from st_ito_tpu.ito import run_random as jax_run_random
from st_ito_tpu.models.registry import (
    get_mfcc_feature_embeds as jax_mfcc_embeds,
    load_mfcc_feature_extractor as jax_load_mfcc,
)

from st_ito_torch.chain import EFFECT_REGISTRY, ChainSpec
from st_ito_torch.cli import effect_info, eval_psm, eval_sweep
from st_ito_torch.eval import case_study, plots, psm, sweep, synthetic
from st_ito_torch.ito import run_input, run_random
from st_ito_torch.models import (get_mfcc_feature_embeds,
                                 load_mfcc_feature_extractor)

from tests.test_torch_fx import jit_jax_scans
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000
T = 16384
CHAIN = ("parametric_eq", "compressor", "distortion", "reverb")


def sources(n=3, T=T, seed=11):
    """Decaying partials, stereo, as ``tests/test_eval.py`` makes them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = np.arange(T) / SR
        x = sum(np.sin(2 * np.pi * f * (i + 1) * t) * a
                for f, a in [(110, 1), (330, .5), (990, .3), (2970, .2)])
        x *= np.exp(-((t % 0.4) / 0.15))
        x += rng.standard_normal(T) * 0.01
        out.append(np.stack([x, x * 0.9]).astype(np.float32) * 0.6)
    return out


def chains(names=CHAIN):
    return (ChainSpec(tuple(EFFECT_REGISTRY[n]() for n in names),
                      with_bypass=False),
            JaxChainSpec(tuple(JAX_REGISTRY[n]() for n in names),
                         with_bypass=False))


@pytest.fixture(scope="module")
def mfcc():
    return ((load_mfcc_feature_extractor(), get_mfcc_feature_embeds),
            (jax_load_mfcc(), jax_mfcc_embeds))


def assert_renders(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 5e-5 * max(1.0, np.abs(want).max())


def assert_scores(got: dict, want: dict):
    """Nested dicts of numbers within 1e-4 of each other, same keys."""
    assert set(got) == set(want)
    for k in got:
        if isinstance(got[k], dict):
            assert_scores(got[k], want[k])
        else:
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(want[k], np.float64),
                                       atol=1e-4,
                                       rtol=1e-4 if k == "mrstft" else 0)


def op_by_op_synthetic(monkeypatch):
    """The JAX synthetic module's ``jax.jit`` as the plain call, its
    scans jitted (the module docstring says why)."""
    monkeypatch.setattr(jsynth, "jax", types.SimpleNamespace(jit=lambda f: f))
    jit_jax_scans(monkeypatch)


def test_synthetic_cases_match_jax(monkeypatch):
    op_by_op_synthetic(monkeypatch)
    chain, jchain = chains()
    x = sources(1)[0]
    got = synthetic.make_synthetic_cases(chain, x, SR, seed=3, device="cpu")
    want = jsynth.make_synthetic_cases(jchain, jnp.asarray(x), SR, seed=3)
    assert [c["name"] for c in got] == [c["name"] for c in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["w_target"], w["w_target"])
        assert_renders(g["target"], w["target"])


def test_synthetic_benchmark_matches_jax(mfcc, tmp_path, monkeypatch):
    """``run_synthetic_benchmark`` over two methods (the input, and one
    random setting): every case's MRSTFT and style similarity, and the
    written JSON."""
    op_by_op_synthetic(monkeypatch)
    (model, embed), (jmodel, jembed) = mfcc
    chain, jchain = chains(("parametric_eq", "distortion"))
    x = sources(1, seed=4)[0]
    out = str(tmp_path / "synthetic.json")
    got = synthetic.run_synthetic_benchmark(
        chain, x, {"input": {"func": run_input},
                   "random": {"func": run_random,
                              "kwargs": {"chain": chain, "seed": 5,
                                         "device": "cpu"}}},
        model, embed, SR, out_path=out, device="cpu")
    want = jsynth.run_synthetic_benchmark(
        jchain, jnp.asarray(x), {"input": {"func": jax_run_input},
                                 "random": {"func": jax_run_random,
                                            "kwargs": {"chain": jchain,
                                                       "seed": 5}}},
        jmodel, jembed, SR)
    assert_scores(got, want)
    with open(out) as f:
        assert_scores(json.load(f), want)


def test_sweep_matches_jax(mfcc):
    (model, embed), (jmodel, jembed) = mfcc
    x = sources(1, seed=6)[0]
    got = sweep.sweep_parameter(x, "distortion", "drive_db", model, embed,
                                SR, num_steps=5, device="cpu")
    want = jsweep.sweep_parameter(jnp.asarray(x), "distortion", "drive_db",
                                  jmodel, jembed, SR, num_steps=5)
    assert got["values"] == want["values"]
    assert_scores(got, want)
    assert got["monotonicity"] == want["monotonicity"]


def test_case_study_curve_matches_jax(mfcc):
    (model, embed), (jmodel, jembed) = mfcc
    x = sources(1, seed=7)[0]
    got = case_study.parameter_recovery_curve(
        x, "distortion", "drive_db", 0.75, model, embed, SR, num_steps=6,
        device="cpu")
    want = jcase.parameter_recovery_curve(
        jnp.asarray(x), "distortion", "drive_db", 0.75, jmodel, jembed, SR,
        num_steps=6)
    assert_scores(got, want)
    assert got["recovered_value"] == want["recovered_value"]


@pytest.mark.parametrize("condition", ["intra-effect", "inter-effect"])
def test_psm_quadruplets_match_jax(mfcc, condition):
    """The same draws (effects, settings, crops), renders within 5e-5 x
    peak, and the same accuracies."""
    (model, embed), (jmodel, jembed) = mfcc
    src = sources(3, T=2 * T, seed=8)
    kw = dict(effect_names=["distortion", "parametric_eq", "reverb"],
              num_examples=3, num_distractors=2, length=T, seed=9,
              condition=condition)
    got = psm.generate_psm_quadruplets(src, device="cpu", **kw)
    want = jpsm.generate_psm_quadruplets(src, **kw)
    for g, w in zip(got, want, strict=True):
        assert g["effect"] == w["effect"]
        assert_renders(g["ref"], w["ref"])
        for a, b in zip(g["candidates"], w["candidates"], strict=True):
            assert_renders(a, b)
    acc = psm.evaluate_metric_on_quadruplets(got, model, embed, SR,
                                             device="cpu")
    assert acc == jpsm.evaluate_metric_on_quadruplets(want, jmodel, jembed,
                                                      SR)


def test_psm_disk_roundtrip(tmp_path):
    ex = [{"ref": np.full((2, 64), 0.5, np.float32),
           "candidates": [np.full((2, 64), v, np.float32)
                          for v in (0.25, -0.5)], "effect": "distortion"}]
    psm.save_quadruplets_to_disk(ex, str(tmp_path))
    assert sorted(os.listdir(tmp_path / "distortion_0000")) == [
        "a.wav", "b.wav", "ref.wav"]
    back = psm.load_quadruplets_from_disk(str(tmp_path))
    assert back[0]["effect"] == "distortion"
    np.testing.assert_allclose(back[0]["ref"], ex[0]["ref"], atol=1 / 32767)
    np.testing.assert_allclose(back[0]["candidates"][1],
                               ex[0]["candidates"][1], atol=1 / 32767)


# ------------------------------------------------------------------ CLIs


def test_eval_psm_cli_matches_jax(tmp_path, capsys):
    argv = ["--metrics", "mfcc", "--num-examples", "2", "--num-distractors",
            "2"]
    jax_eval_psm.main(argv + ["--out", str(tmp_path / "j.json")])
    got = eval_psm.main(argv + ["--out", str(tmp_path / "t.json"),
                                "--plot", str(tmp_path / "psm.png"),
                                "--device", "cpu"])
    with open(tmp_path / "j.json") as f:
        want = json.load(f)
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == want
    assert set(got) == {"intra-effect", "inter-effect"}
    assert (tmp_path / "psm.png").stat().st_size > 0


def test_eval_sweep_cli_matches_jax(tmp_path):
    argv = ["--metric", "mfcc", "--num-steps", "4", "--length", str(T)]
    jax_eval_sweep.main(argv + ["--out", str(tmp_path / "j.json")])
    eval_sweep.main(argv + ["--out", str(tmp_path / "t.json"), "--plot",
                            str(tmp_path / "sweep.png"), "--device", "cpu"])
    with open(tmp_path / "j.json") as f:
        want = json.load(f)
    with open(tmp_path / "t.json") as f:
        assert_scores(json.load(f), want)
    assert (tmp_path / "sweep.png").stat().st_size > 0


@pytest.mark.parametrize("argv", [[], ["compressor"]],
                         ids=["registry", "effect"])
def test_effect_info_cli_prints_the_jax_listing(argv, capsys):
    jax_effect_info.main(argv)
    want = capsys.readouterr().out
    effect_info.main(argv)
    assert capsys.readouterr().out == want


def test_effect_info_smoke_test_matches_jax(capsys):
    jax_effect_info.main(["phaser", "--test", "--seed", "2"])
    want = capsys.readouterr().out
    stats = effect_info.main(["phaser", "--test", "--seed", "2",
                              "--device", "cpu"])
    got = capsys.readouterr().out
    assert stats["finite"]
    # the statistics print to 4 decimals; one may round the other way
    for g, w in zip(got.split(), want.split(), strict=True):
        try:
            assert abs(float(g) - float(w)) <= 1e-4
        except ValueError:
            assert g == w


def test_plots_write_figures(tmp_path):
    sweep_res = {"values": [0.0, 0.5, 1.0], "similarities": [1.0, 0.8, 0.5],
                 "monotonicity": 1.0}
    plots.plot_sweep_results({"d": sweep_res}, str(tmp_path / "s.png"))
    pst = {"ex0": {"es": {"param_sim": 0.9, "time_elapsed": 2.0},
                   "input": {"param_sim": 0.5, "time_elapsed": 0.0}}}
    plots.plot_pst_results(pst, str(tmp_path / "p.png"))
    for name in ("s.png", "p.png"):
        assert (tmp_path / name).stat().st_size > 0
