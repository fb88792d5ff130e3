"""Gradient ITO against st_ito_tpu's: the first gradient of
``run_autodiff``'s loss (at theta = 0, where it starts), five steps of
``run_autodiff`` through the 51-parameter processor and through a chain,
its determinism with embedding dropout, and the CLI's ``--algorithm
autodiff``; a small Cnn14 carried across from the JAX weights, T 8192.

Tolerances: the loss within 1e-5, the first gradient within 1e-3 x its
largest component, elementwise, and 1e-3 in relative L2. There the JAX
processor's compressor runs op by op around its jitted scan, the rest of
the loss jitted: the detector's release coefficient at theta = 0 (1005 ms)
lies within 2.1e-5 of 1, and the compressor jitted whole, XLA's fusions
move the gradient by 6e-3 of its largest component (the low shelf's gain),
where the port lies within 5e-5 of the op-by-op run.

``run_autodiff`` in the JAX package jits its whole step, so over five
steps the loss histories are held within 1e-4. Adam's first step is
lr x g / (|g| + 1e-8): a parameter whose exact gradient is 0 (a flat
band's frequency or Q) moves by its rounding noise over 1e-8, in either
package, and so does the loss surface of the rest from then on. So the
parameters are held where Adam's first step moved them a full step: after
it within 1e-5, after each step within 5% of their distance from the
start in L2. The chain of those five steps is EQ -> gain -> reverb: with
a delay in it, the jitted JAX render rounds the delay's length one ulp
away from the op-by-op one for some settings (ROADMAP §3), which a
feedback comb turns into 1e-2."""

import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from st_ito_tpu import proc as jproc
from st_ito_tpu.chain import ChainSpec as JaxChainSpec
from st_ito_tpu.chain import basic_delay as jax_basic_delay
from st_ito_tpu.chain import basic_gain as jax_basic_gain
from st_ito_tpu.chain import basic_parametric_eq as jax_basic_eq
from st_ito_tpu.chain import basic_reverb as jax_basic_reverb
from st_ito_tpu.chain import build_render_fn as jax_build_render_fn
from st_ito_tpu.cli import run_optim as jax_cli
from st_ito_tpu.ito import engine as jax_engine
from st_ito_tpu.models.cnn14 import Cnn14Config as JaxCnn14Config
from st_ito_tpu.models.registry import ParamModel as JaxParamModel
from st_ito_tpu.models.registry import export_encoder_npz
from st_ito_tpu.models.registry import get_param_embeds as jax_embeds
from st_ito_tpu.ops import dynamics as jdyn

from st_ito_torch.chain import (ChainSpec, basic_delay, basic_gain,
                                basic_parametric_eq, basic_reverb)
from st_ito_torch.cli import run_optim
from st_ito_torch.ito import engine, run_autodiff
from st_ito_torch.utils import load_audio, save_audio

from tests.test_torch_autodiff import assert_grads, program
from tests.test_torch_cli import SMALL_CLI
from tests.test_torch_cnn14 import SMALL, jax_params, port_model
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000
T = 8192
LR = 1e-2


@pytest.fixture(scope="module")
def models():
    params = jax_params(3, random_bn=False)
    jmodel = JaxParamModel(params=params, config=JaxCnn14Config(**SMALL),
                           embed_dim=32)
    return jmodel, port_model(params)


@pytest.fixture(scope="module")
def io_pair():
    """An input and a target made by the JAX processor at one setting."""
    x = program(5, (1, 2, T))
    y = np.asarray(jax.jit(jproc.apply_complex_autodiff_processor,
                           static_argnums=2)(
        jnp.asarray(program(6, (1, 2, T))),
        jnp.linspace(0.2, 0.8, 51)[None], SR))
    return x, y


def vst_chain(jax=False):
    if jax:
        return JaxChainSpec((jax_basic_eq(), jax_basic_delay(),
                             jax_basic_reverb()))
    return ChainSpec((basic_parametric_eq(), basic_delay(), basic_reverb()))


def eq_gain_reverb(jax=False):
    if jax:
        return JaxChainSpec((jax_basic_eq(), jax_basic_gain(),
                             jax_basic_reverb()))
    return ChainSpec((basic_parametric_eq(), basic_gain(), basic_reverb()))


def _processor_op_by_op(x, w):
    """``proc.apply_complex_autodiff_processor`` with its stages jitted but
    the compressor, which runs op by op around its scan (the module
    docstring says why; the caller jits ``ballistics_parallel``)."""
    stages = (("apply_parametric_eq", 18), ("apply_compressor", 6),
              ("apply_distortion", 1), ("apply_reverb", 25),
              ("apply_gain", 1))
    i = 0
    for name, n in stages:
        fn = getattr(jproc, name)
        if name != "apply_compressor":
            fn = jax.jit(fn, static_argnums=2)
        x = fn(x, w[:, i:i + n], SR)
        i += n
    return x


def jax_loss_fn(x, y, jmodel, chain):
    """The loss ``st_ito_tpu/ito/engine.py run_autodiff`` differentiates,
    written out (it is a closure there)."""
    x = jax_engine._peak_norm(jnp.asarray(x))
    target = jax_embeds(jax_engine._peak_norm(jnp.asarray(y)), jmodel, SR)
    embed = jax.jit(lambda a: jax_embeds(a, jmodel, SR))
    if chain is None:
        def render(w):
            return _processor_op_by_op(x, w[None])
    else:
        one = jax.jit(jax_build_render_fn(chain, SR, x.shape[1]))

        def render(w):
            return one(w, x[0])[None]

    def loss(theta):
        out = embed(render(jax.nn.sigmoid(theta)))
        return jnp.mean(jax_engine._embedding_distance(out, target))

    return loss


@pytest.mark.parametrize("with_chain", [False, True],
                         ids=["processor", "chain"])
def test_first_gradient_matches_jax(models, io_pair, with_chain,
                                    monkeypatch):
    jmodel, model = models
    x, y = io_pair
    monkeypatch.setattr(jdyn, "ballistics_parallel",
                        jax.jit(jdyn.ballistics_parallel))
    P = vst_chain().num_params if with_chain else 51
    loss, grad = jax.value_and_grad(jax_loss_fn(
        x, y, jmodel, vst_chain(jax=True) if with_chain else None))(
            jnp.zeros(P))
    fn, num_params, _ = engine.autodiff_loss_fn(
        x, y, SR, model, chain=vst_chain() if with_chain else None,
        device="cpu")
    assert num_params == P
    theta = torch.zeros(P, requires_grad=True)
    got = engine.autodiff_step(fn, theta)
    assert abs(got.item() - float(loss)) <= 1e-5
    assert_grads(theta.grad.numpy(), grad)


def assert_histories(got, want):
    """The module docstring's rules for five steps of both packages."""
    fg, fw = np.asarray(got["fval_history"]), np.asarray(want["fval_history"])
    assert fg.shape == fw.shape == (5,) and np.isfinite(fg).all()
    assert np.abs(fg - fw).max() <= 1e-4
    wg = np.asarray(got["wopt_history"], np.float64)
    ww = np.asarray(want["wopt_history"], np.float64)
    assert wg.shape == ww.shape
    full = np.abs(ww[0] - 0.5) >= 0.9 * 0.25 * LR  # sigmoid'(0) = 1/4
    assert full.sum() >= 10
    assert np.abs(wg[0] - ww[0])[full].max() <= 1e-5
    for k in range(5):
        assert (np.linalg.norm((wg[k] - ww[k])[full])
                <= 0.05 * np.linalg.norm((ww[k] - 0.5)[full])), k
    np.testing.assert_array_equal(got["wopt"], wg[-1].astype(np.float32))


@pytest.mark.parametrize("with_chain", [False, True],
                         ids=["processor", "chain"])
def test_run_autodiff_matches_jax(models, io_pair, with_chain):
    """Five steps from theta = 0 at lr 1e-2, dropout 0: the histories (the
    module docstring's rules), the keys, the output at the last w."""
    jmodel, model = models
    x, y = io_pair
    want = jax_engine.run_autodiff(
        jnp.asarray(x), jnp.asarray(y), SR, jmodel,
        chain=eq_gain_reverb(jax=True) if with_chain else None, lr=LR,
        n_iters=5, verbose=False)
    got = run_autodiff(x, y, SR, model,
                       chain=eq_gain_reverb() if with_chain else None,
                       lr=LR, n_iters=5, verbose=False, device="cpu")
    assert set(got) == set(want)
    assert_histories(got, want)
    assert got["total_evals"] == 5 and got["fopt"] == got["fval_history"][-1]
    out = got["output_audio"]
    assert out.shape == (1, 2, T) and torch.isfinite(out).all()
    assert not out.requires_grad
    if with_chain:
        assert list(got["params"]) == ["ParametricEQ", "Gain", "Reverb"]
    else:
        assert list(got["params"]) == [str(i) for i in range(51)]


def test_run_autodiff_dropout_is_deterministic(models, io_pair):
    """With embedding dropout the masks come from a generator seeded with
    ``seed``: the same seed gives the same run, another seed another, and
    both differ from the run without dropout."""
    _, model = models
    x, y = io_pair

    def run(dropout, seed):
        return run_autodiff(x, y, SR, model, chain=vst_chain(), lr=LR,
                            n_iters=2, dropout=dropout, seed=seed,
                            verbose=False, device="cpu")["fval_history"]

    a, b, c, plain = run(0.3, 1), run(0.3, 1), run(0.3, 2), run(0.0, 1)
    assert a == b and np.isfinite(a).all()
    assert a != c and a != plain


def test_cli_autodiff_matches_jax(tmp_path, monkeypatch):
    """``--algorithm autodiff`` with the synthetic target, 5 iterations on a
    48 kHz WAV: the target WAV (the JAX CLI's w_target through the
    processor) within 1e-4 x peak, the loss history as above, and the
    written output WAV and parameter JSON (51 entries)."""
    rng = np.random.default_rng(2)
    t = np.arange(T) / SR
    x = (0.3 * np.sin(2 * np.pi * 330 * t) * np.ones((2, 1))
         + 0.05 * rng.standard_normal((2, T)))
    wav = str(tmp_path / "tune.wav")
    save_audio(wav, x.astype(np.float32), SR)
    export_encoder_npz(jax_params(1, random_bn=False),
                       str(tmp_path / "afx-rep.npz"),
                       JaxCnn14Config(**SMALL_CLI))
    monkeypatch.setenv("STITO_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("STITO_COMPILE_CACHE", "0")
    common = [wav, "None", "--algorithm", "autodiff", "--max-iters", "5",
              "--max-length", str(T)]
    want = jax_cli.main(common + ["--output-dir", str(tmp_path / "j")])
    got = run_optim.main(common + ["--device", "cpu", "--output-dir",
                                   str(tmp_path / "t")])
    fg, fw = np.asarray(got["fval_history"]), np.asarray(want["fval_history"])
    assert fg.shape == (5,) and np.abs(fg - fw).max() <= 1e-4
    dirs = {k: str(tmp_path / k / "tune_to_synthetic_target_autodiff")
            for k in ("j", "t")}
    tj, _ = load_audio(os.path.join(dirs["j"], "target_audio.wav"))
    tt, sr = load_audio(os.path.join(dirs["t"], "target_audio.wav"))
    assert sr == SR and tt.shape == (2, T)
    assert np.abs(tt - tj).max() <= 1e-4 * np.abs(tj).max()
    audio, sr = load_audio(os.path.join(dirs["t"],
                                        "output_audio_sigma=0.33.wav"))
    assert sr == SR and audio.shape == (2, T) and np.isfinite(audio).all()
    with open(os.path.join(dirs["t"], "parameters_sigma=0.33.json")) as f:
        params = json.load(f)
    assert len(params) == 51 and np.isfinite(list(params.values())).all()
