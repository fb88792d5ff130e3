"""The port's pretext trainer (``train/param.py``) and the Cnn14's train
mode against st_ito_tpu's, on the CPU at a small width: the JAX weights
carried in by ``param_estimator_state_dict_from_jax``, the same batches,
and the port's SpecAugment stripes and dropout masks handed to the JAX
trace (``torch_train_draws``). The JAX step is jitted once with the draws
as its arguments, so every step reuses one compile."""

import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_train_draws import record_draws, replay_draws  # noqa: E402

from st_ito_tpu.models.bn_stats import merge_bn_stats
from st_ito_tpu.models.cnn14 import Cnn14Config as JaxCnn14Config
from st_ito_tpu.models.cnn14 import cnn14_apply, init_cnn14_params
from st_ito_tpu.train import param as jparam

from st_ito_torch.models.cnn14 import Cnn14, Cnn14Config
from st_ito_torch.models.convert import (cnn14_state_dict_from_jax,
                                         flatten_params,
                                         param_estimator_params_to_jax,
                                         param_estimator_state_dict_from_jax)
from st_ito_torch.train import param as tparam

torch.set_num_threads(1)

# hop 256: 133 frames at T 33792, so SpecAugment's 64-frame stripes leave
# most of each clip (at hop 1024 a stripe from frame 0 often covers all 34)
SMALL = dict(embed_dim=16, base_channels=4, window_size=1024, hop_size=256,
             mel_bins=64)
T = 33792
B = 3
# Adam's first step moves a parameter whose gradient is rounding noise by a
# full lr in either package (ROADMAP §3): at lr 1e-4 that alone moves the
# third step's loss by 1e-4 relative in the diff mode, at 1e-5 by 1e-5
LR = 1e-5


def audio(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3
            ).astype(np.float32)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_cnn14_train_forward_buffers_and_gradients_match_jax():
    """Train mode with SpecAugment and dropout: embeddings 1e-4 x max,
    the BatchNorm buffers 1e-4 relative against ``merge_bn_stats``, the
    gradient 1e-3 relative L2 over all parameters. (Per tensor block 1's
    can lie 1e-2 apart: the time max's argmax flips with float32
    rounding, and a 1e-6 relative change of the input moves block 1's
    gradient by 1e-2 in JAX itself.)"""
    params = jax.jit(init_cnn14_params, static_argnums=1)(
        jax.random.PRNGKey(0), JaxCnn14Config(**SMALL))
    x = audio((B, 2, T), 0)
    net = Cnn14(Cnn14Config(**SMALL))
    net.load_state_dict(cnn14_state_dict_from_jax(params))
    net.requires_grad_(True).train()
    g = torch.Generator().manual_seed(1)
    with record_draws(g) as draws:
        mid, side = net(torch.from_numpy(x), generator=g)
    assert [k for k, _ in draws] == ["randint"] * 8 + ["rand"] * 6
    (mid.sum() + (side ** 2).sum()).backward()

    def loss(p):
        m, s, st = cnn14_apply(p, jnp.asarray(x), JaxCnn14Config(**SMALL),
                               training=True, rng=jax.random.PRNGKey(5),
                               return_stats=True)
        return jnp.sum(m) + jnp.sum(s ** 2), (m, s, st)

    with replay_draws(draws):
        (_, (m, s, stats)), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(params)
    for got, want in ((mid, m), (side, s)):
        want = np.asarray(want)
        assert np.abs(got.detach().numpy() - want).max() <= (
            1e-4 * np.abs(want).max())
    merged = flatten_params(merge_bn_stats(params, stats))
    sd = net.state_dict()
    for k, want in merged.items():
        if "running" in k:
            assert rel_l2(sd[k], want) <= 1e-4, k
    flat = flatten_params(grads)
    names = [n for n, p in net.named_parameters() if p.grad is not None]
    assert set(flat) - set(names) == {"bn0.weight", "bn0.bias"} | {
        k for k in flat if "running" in k}
    got = np.concatenate([net.get_parameter(n).grad.numpy().ravel()
                          for n in names])
    want = np.concatenate([flat[n].ravel() for n in names])
    assert rel_l2(got, want) <= 1e-3


def test_bn_stats_frozen_keeps_the_buffers():
    net = Cnn14(Cnn14Config(**SMALL)).train()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    from st_ito_torch.models.cnn14 import bn_stats_frozen

    with bn_stats_frozen(net):
        net(torch.from_numpy(audio((2, 2, T), 3)))
    after = net.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(m.track_running_stats for m in net.modules()
               if isinstance(m, torch.nn.BatchNorm2d))
    net(torch.from_numpy(audio((2, 2, T), 3)))
    assert not torch.equal(before["conv_block1.bn1.running_mean"],
                           net.state_dict()["conv_block1.bn1.running_mean"])


def make_batch(rng, n, num_adv=0, adv_type="dataset"):
    batch = {"inputs": audio((n, 2, T), int(rng.integers(1 << 30))),
             "outputs": audio((n, 2, T), int(rng.integers(1 << 30))),
             "instance_index": rng.integers(0, 5, n).astype(np.int32),
             "preset_index": rng.integers(0, 3, n).astype(np.int32),
             "tar_index": rng.integers(0, max(num_adv, 1), n).astype(
                 np.int32)}
    if adv_type == "classifier":
        batch["content_logits"] = rng.standard_normal(
            (n, num_adv)).astype(np.float32)
    return batch


def configs(embed_mode, adv, encoder_type="cnn14"):
    from st_ito_tpu.models.encoders import DsTCNConfig as JDs
    from st_ito_torch.models.encoders import DsTCNConfig as TDs

    kw = dict(lr=LR, num_instances=5, num_presets=3, weight_decay=1e-2,
              embed_mode=embed_mode, encoder_type=encoder_type)
    if adv:
        kw.update(num_adv_classes=4, adv_logits_type=adv, adv_weight=0.5)
    if encoder_type == "dstcn":
        small = dict(embed_dim=16, ninputs=2, nblocks=3, channel_width=4)
        enc_j, enc_t = JDs(**small), TDs(**small)
    else:
        enc_j, enc_t = JaxCnn14Config(**SMALL), Cnn14Config(**SMALL)
    return (jparam.ParamEstimatorConfig(encoder=enc_j, **kw),
            tparam.ParamEstimatorConfig(encoder=enc_t, **kw))


def jax_stepper(jcfg):
    """step(state, batch, draws) with the draws as traced arguments: one
    compile for every step."""
    inner = jparam.make_param_train_step(jcfg)

    @partial(jax.jit, static_argnums=3)
    def run(state, batch, values, kinds):
        with replay_draws(list(zip(kinds, values))):
            return inner(state, batch, jax.random.PRNGKey(7))

    return lambda state, batch, draws: run(
        state, batch, [jnp.asarray(v) for _, v in draws],
        tuple(k for k, _ in draws))


def port_state(jcfg, tcfg, seed=0):
    jstate = jax.jit(jparam.init_param_estimator, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)
    model = tparam.ParamEstimator(tcfg, torch.Generator().manual_seed(0))
    model.load_state_dict(param_estimator_state_dict_from_jax(
        jstate.params, tcfg.encoder_type))
    return jstate, tparam.make_state(model, tcfg)


def assert_trajectories_match(jcfg, tcfg, steps=3, seed=0):
    """Each step's loss within 1e-4 relative; after the steps, over the
    elements that Adam moved a full step (lr) every step in one direction
    in JAX, each tensor's displacement within 2e-2 relative L2 of JAX's
    (the heads' elements within 0.01 lr each), and the BatchNorm buffers
    within 1e-4 relative. The encoder's gradient follows float32 rounding
    where the time max's argmax flips (its Cnn14 test), so its weights are
    held in L2."""
    rng = np.random.default_rng(seed)
    jstate, state = port_state(jcfg, tcfg, seed)
    start = flatten_params(jstate.params)
    step = tparam.make_param_train_step(tcfg)
    jstep = jax_stepper(jcfg)
    g = torch.Generator().manual_seed(seed + 11)
    for _ in range(steps):
        batch = make_batch(rng, B, tcfg.num_adv_classes, tcfg.adv_logits_type)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        with record_draws(g) as draws:
            state, metrics = step(state, tb, g)
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()}, draws)
        for k, v in jmetrics.items():
            want = float(v)
            assert abs(float(metrics[k]) - want) <= 1e-4 * max(
                abs(want), 1e-3), (k, float(metrics[k]), want)
    assert state.step == int(jstate.step) == steps
    got = state.model.state_dict()
    want = flatten_params(jstate.params)
    moved = 0
    for k, w in want.items():
        g_ = got[k].numpy()
        if "running" in k:
            assert rel_l2(g_, w) <= 1e-4, k
            continue
        full = np.abs(w - start[k]) >= 0.9 * steps * LR
        if not full.any():
            continue
        moved += int(full.sum())
        assert rel_l2((g_ - start[k])[full], (w - start[k])[full]) <= 2e-2, k
        if not k.startswith("encoder."):
            assert np.abs(g_ - w)[full].max() <= 0.01 * LR, k
    assert moved > 0
    return state


@pytest.mark.parametrize("embed_mode", ["blind", "diff", "concat"])
def test_param_train_steps_match_jax(embed_mode):
    assert_trajectories_match(*configs(embed_mode, None))


def test_state_dict_round_trip_to_jax():
    jcfg, tcfg = configs("concat", "dataset")
    jstate, state = port_state(jcfg, tcfg)
    back = flatten_params(param_estimator_params_to_jax(
        state.model.state_dict()))
    want = flatten_params(jstate.params)
    assert set(back) == set(want)
    assert all(np.array_equal(back[k], want[k]) for k in want)
