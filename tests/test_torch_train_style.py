"""The port's StyleTransferSystem (``train/style.py``) against
st_ito_tpu's on the CPU at a small width: each loss type, the chain and
both processors, on-the-fly targets, split sections, the eval step, the
train block and the learning-rate schedule. The JAX weights are carried in
by ``style_system_state_dict_from_jax`` and the port's draws (gains,
on-the-fly parameters, SpecAugment, dropout) handed to the JAX trace
(``torch_train_draws``), the JAX step jitted once with the draws as its
arguments. The chain holds no delay: under jit XLA rounds the delay length
one ulp differently from the eager form (ROADMAP §3)."""

import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_train_draws import record_draws, replay_draws  # noqa: E402

from st_ito_tpu.chain import EFFECT_REGISTRY as JREG
from st_ito_tpu.chain import ChainSpec as JChain
from st_ito_tpu.models.cnn14 import Cnn14Config as JaxCnn14Config
from st_ito_tpu.train import style as jstyle

from st_ito_torch.chain import EFFECT_REGISTRY, ChainSpec
from st_ito_torch.models.cnn14 import Cnn14Config
from st_ito_torch.models.convert import (flatten_params,
                                         style_system_params_to_jax,
                                         style_system_state_dict_from_jax)
from st_ito_torch.train import style as tstyle

torch.set_num_threads(1)

# hop 128: 65 frames a half section of T 16384
SMALL = dict(embed_dim=16, base_channels=4, window_size=512, hop_size=128,
             mel_bins=64)
T = 16384
B = 2
LR = 1e-5  # see test_torch_train_param.LR
STAGES = ("parametric_eq", "compressor", "distortion", "reverb")


def audio(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3
            ).astype(np.float32)


def systems(**kw):
    kw = dict(dict(lr=LR, analysis_length=T, weight_decay=1e-2), **kw)
    jcfg = jstyle.StyleTransferConfig(encoder=JaxCnn14Config(**SMALL), **kw)
    tcfg = tstyle.StyleTransferConfig(encoder=Cnn14Config(**SMALL), **kw)
    jchain = JChain(stages=tuple(JREG[n]() for n in STAGES),
                    with_bypass=False)
    chain = ChainSpec(stages=tuple(EFFECT_REGISTRY[n]() for n in STAGES),
                      with_bypass=False)
    js = jstyle.StyleTransferSystem(jcfg, chain=jchain)
    ts = tstyle.StyleTransferSystem(tcfg, chain=chain, device="cpu")
    jstate = jax.jit(js.init)(jax.random.PRNGKey(0))
    model = tstyle.StyleModel(tcfg, ts.num_params,
                              torch.Generator().manual_seed(0))
    model.load_state_dict(style_system_state_dict_from_jax(jstate.params))
    return js, ts, jstate, ts.make_state(model)


def traced(fn):
    """fn(*args) under the port's draws passed as traced arguments."""
    @partial(jax.jit, static_argnums=0)
    def run(kinds, values, *args):
        with replay_draws(list(zip(kinds, values))):
            return fn(*args)

    return lambda draws, *args: run(tuple(k for k, _ in draws),
                                    [jnp.asarray(v) for _, v in draws], *args)


def make_batch(rng, num_params):
    return {"input_audio": audio((B, 2, T), int(rng.integers(1 << 30))),
            "target_audio": audio((B, 2, T), int(rng.integers(1 << 30))),
            "target_params": rng.random((B, num_params)).astype(np.float32)}


def close(got, want, rel=1e-4):
    got, want = float(got), float(want)
    return abs(got - want) <= rel * max(abs(want), 1e-3)


def run_steps(steps, seed=0, **kw):
    """``steps`` train steps in both packages; every metric of every step
    within 1e-4 relative."""
    js, ts, jstate, state = systems(**kw)
    jstep = traced(js.make_train_step())
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed + 5)
    for _ in range(steps):
        batch = make_batch(rng, ts.num_params)
        with record_draws(g) as draws:
            state, metrics = ts.make_train_step()(
                state, {k: torch.from_numpy(v) for k, v in batch.items()}, g)
        jstate, jm = jstep(draws, jstate,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(1))
        for k, v in jm.items():
            assert close(metrics[k], v), (k, float(metrics[k]), float(v))
    assert state.step == int(jstate.step) == steps
    return js, ts, jstate, state


def test_audio_loss_on_the_fly_split_section_chain():
    """The DeepAFx-ST+ analog at a small width: the audio loss through the
    differentiable chain, on-the-fly targets, split sections; then the
    eval step (no model draws, the render of the prediction)."""
    js, ts, jstate, state = run_steps(2, loss_type="audio", on_the_fly=True,
                                      split_section=True)
    batch = make_batch(np.random.default_rng(9), ts.num_params)
    g = torch.Generator().manual_seed(3)
    with record_draws(g) as draws:
        loss, (metrics, aux) = ts.make_eval_step()(
            state.model, {k: torch.from_numpy(v) for k, v in batch.items()},
            g)
    jloss, (jm, jaux) = traced(js.make_eval_step())(
        draws, jstate.params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(2))
    assert close(loss, jloss)
    want = np.asarray(jaux["params_pred"])
    assert np.abs(aux["params_pred"].numpy() - want).max() <= 1e-5
    out = np.asarray(jaux["output_audio"])
    assert np.abs(aux["output_audio"].numpy() - out).max() <= (
        1e-4 * np.abs(out).max())


def test_train_block_equals_single_steps():
    _, ts, _, state = systems(loss_type="audio", on_the_fly=True,
                              split_section=True)
    ref = ts.make_state(tstyle.StyleModel(ts.cfg, ts.num_params,
                                          torch.Generator()))
    ref.model.load_state_dict(state.model.state_dict())
    pool = torch.from_numpy(audio((4, 2, T), 7))
    idx = torch.tensor([[0, 3], [2, 1]])
    state, losses = ts.make_train_block(2)(state, pool, idx,
                                           torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    want = []
    for i in range(2):
        ref, m = ts.make_train_step()(ref, {"input_audio": pool[idx[i]]}, g)
        want.append(m["loss"])
    assert torch.equal(losses, torch.stack(want))
    for (k, a), b in zip(state.model.state_dict().items(),
                         ref.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_bins_and_round_trip():
    vals = torch.tensor([[0.0, 0.5, 1.0, 0.33]])
    want = jstyle.params_to_bin_index(jnp.asarray(vals.numpy()), 8)
    assert np.array_equal(tstyle.params_to_bin_index(vals, 8).numpy(),
                          np.asarray(want))
    logits = torch.from_numpy(audio((2, 3, 8), 1))
    assert np.allclose(
        tstyle.classifier_logits_to_params(logits, 8).numpy(),
        np.asarray(jstyle.classifier_logits_to_params(
            jnp.asarray(logits.numpy()), 8)))
    _, _, jstate, state = systems(loss_type="parameter-classification",
                                  num_bins=8)
    back = flatten_params(style_system_params_to_jax(
        state.model.state_dict()))
    want = flatten_params(jstate.params)
    assert set(back) == set(want)
    assert all(np.array_equal(back[k], want[k]) for k in want)
