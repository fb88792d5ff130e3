"""Style classification (``eval/cls.py``, ``cli/eval_cls.py``) against
st_ito_tpu's on the CPU: the five style renders, the dataset's draws,
zero-shot nearest reference, the linear probe and the CLI.

The JAX ``render_style`` is jitted; it runs here op by op (its plain
function, the compressor's detector scan jitted, as ``tests/
test_torch_eval.py`` runs the synthetic module), since XLA's fusions of
the whole compressor move its slow detector by ulps that the tanh after
it carries (ROADMAP §3). Tolerances: renders within 5e-5 x max(1, peak);
zero-shot accuracies equal; the probe's W and b after 300 Adam steps
within 1e-4 of max|want|, with equal accuracies.

The dataset has 4 clips a style, so that the probe trains on 14: with 10
(3 a style) a style with 2 of them has the exact fraction 1/5 that the
uniform first prediction gives it, its bias's first gradient is exactly
0, and Adam's first step moves that bias by the learning rate in the
direction of the rounding noise. Float32 Adam then lies 1e-3 to 6e-2 of
max|W| from a float64 run of itself in either package (on 14 it lies
within 1e-6)."""

import json
import types

import numpy as np
import pytest
import torch
import jax

from st_ito_tpu.cli import eval_cls as jax_eval_cls
from st_ito_tpu.eval import cls as jcls
from st_ito_tpu.models.registry import (
    get_mfcc_feature_embeds as jax_mfcc_embeds,
    load_mfcc_feature_extractor as jax_load_mfcc,
)

from st_ito_torch.cli import eval_cls
from st_ito_torch.eval import cls
from st_ito_torch.models import (get_mfcc_feature_embeds,
                                 load_mfcc_feature_extractor)

from tests.test_torch_eval import sources
from tests.test_torch_fx import jit_jax_scans
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000
T = 16384


@pytest.fixture
def op_by_op(monkeypatch):
    """The JAX render_style as its plain function, its scans jitted."""
    monkeypatch.setattr(jcls, "render_style", jcls.render_style.__wrapped__)
    jit_jax_scans(monkeypatch)


def assert_render(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 5e-5 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("style", cls.STYLES)
def test_render_style_matches_jax(style, op_by_op):
    x = sources(1, T, seed=20)[0]
    got = cls.render_style(torch.from_numpy(x), style, SR)
    assert_render(got, jcls.render_style(jax.numpy.asarray(x), style, SR))
    if style != "neutral":
        assert np.abs(np.asarray(got) - x).max() > 1e-2


def test_render_style_refuses_unknown():
    with pytest.raises(ValueError, match="unknown style"):
        cls.render_style(torch.zeros(2, 64), "lofi", SR)


@pytest.fixture(scope="module")
def dataset():
    """The JAX dataset (op by op), from mono and short sources too."""
    src = sources(2, 2 * T, seed=21) + [sources(1, T // 2, seed=22)[0][:1]]
    mp = pytest.MonkeyPatch()
    mp.setattr(jcls, "render_style", jcls.render_style.__wrapped__)
    jit_jax_scans(mp)
    try:
        want = jcls.make_style_dataset(src, SR, per_style=4, length=T, seed=4)
    finally:
        mp.undo()
    return src, want


def test_style_dataset_matches_jax(dataset):
    src, (want_clips, want_labels) = dataset
    clips, labels = cls.make_style_dataset(src, SR, per_style=4, length=T,
                                           seed=4, device="cpu")
    np.testing.assert_array_equal(labels, want_labels)
    assert clips.shape == (20, 2, T)
    for g, w in zip(clips, want_clips):
        assert_render(g, w)


@pytest.mark.parametrize("num_refs", [1, 2])
def test_zero_shot_matches_jax(dataset, num_refs):
    _, (clips, labels) = dataset
    got = cls.run_zero_shot_task(clips, labels, load_mfcc_feature_extractor(),
                                 get_mfcc_feature_embeds, SR,
                                 num_refs=num_refs, seed=5, device="cpu")
    want = jcls.run_zero_shot_task(clips, labels, jax_load_mfcc(),
                                   jax_mfcc_embeds, SR, num_refs=num_refs,
                                   seed=5)
    assert got == want


@pytest.mark.parametrize("seed", [6, 7])
def test_probe_matches_jax(dataset, monkeypatch, seed):
    """The MFCC metric's probe: W and b after 300 Adam steps, and the
    accuracies."""
    _, (clips, labels) = dataset
    trained = {}

    def recording_jit(f):
        jitted = jax.jit(f)

        def call(*a):
            out = jitted(*a)
            trained["jax"] = out[0]
            return out

        return call

    monkeypatch.setattr(jcls, "jax", types.SimpleNamespace(
        jit=recording_jit, value_and_grad=jax.value_and_grad))
    train = cls.train_probe

    def recording_train(*a, **k):
        trained["torch"] = train(*a, **k)
        return trained["torch"]

    monkeypatch.setattr(cls, "train_probe", recording_train)
    got = cls.run_probe_task(clips, labels, load_mfcc_feature_extractor(),
                             get_mfcc_feature_embeds, SR, seed=seed,
                             device="cpu")
    want = jcls.run_probe_task(clips, labels, jax_load_mfcc(),
                               jax_mfcc_embeds, SR, seed=seed)
    assert got == want
    for g, w in zip(trained["torch"], trained["jax"], strict=True):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_eval_cls_cli_matches_jax(tmp_path, op_by_op, capsys):
    argv = ["--metrics", "mfcc", "--per-style", "2", "--length", str(T)]
    jax_eval_cls.main(argv + ["--out", str(tmp_path / "j.json")])
    want = capsys.readouterr().out
    got = eval_cls.main(argv + ["--out", str(tmp_path / "t.json"),
                                "--device", "cpu"])
    assert capsys.readouterr().out.replace("t.json", "j.json") == want
    with open(tmp_path / "j.json") as f:
        assert json.load(f) == got
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == got
    assert 0.0 <= got["mfcc"]["zero_shot_acc"] <= 1.0
