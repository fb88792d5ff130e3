"""The port's pretext trainer against st_ito_tpu's, continued: the
adversary in both ``adv_logits_type``s (its own Adam on detached
features, the generator on the negated CE), a dsTCN encoder, and
``make_param_train_block`` against single steps (the helpers and limits
of ``test_torch_train_param``)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_train_param import (assert_trajectories_match,  # noqa
                                    configs, make_batch)

from st_ito_torch.train import param as tparam
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("adv", ["dataset", "classifier"])
def test_adversary_steps_match_jax(adv):
    state = assert_trajectories_match(*configs("concat", adv))
    assert state.d_opt.state  # the discriminator's Adam stepped


def test_dstcn_encoder_steps_match_jax():
    assert_trajectories_match(*configs("concat", None, "dstcn"))


def test_train_block_equals_single_steps():
    """k steps over a pool with the on-card augmentation equal k single
    steps on the same gathered, augmented batches with the same
    generator, bit for bit."""
    _, tcfg = configs("concat", "dataset")
    rng = np.random.default_rng(3)
    pool = {k: torch.from_numpy(v) for k, v in
            make_batch(rng, 5, tcfg.num_adv_classes).items()}
    idx = torch.from_numpy(rng.integers(0, 5, (3, 2)))

    def fresh():
        model = tparam.ParamEstimator(tcfg, torch.Generator().manual_seed(0))
        return tparam.make_state(model, tcfg)

    block = tparam.make_param_train_block(tcfg, 3, augment=True)
    state, losses = block(fresh(), pool, idx, torch.Generator().manual_seed(9))
    ref = fresh()
    g = torch.Generator().manual_seed(9)
    step = tparam.make_param_train_step(tcfg)
    want = []
    for i in range(3):
        batch = tparam.augment_batch(
            {k: v[idx[i]] for k, v in pool.items()}, g)
        ref, m = step(ref, batch, g)
        want.append(m["loss"])
    assert torch.equal(losses, torch.stack(want))
    for (k, a), b in zip(state.model.state_dict().items(),
                         ref.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert state.step == ref.step == 3


def test_augment_batch_gains_and_joint_flip():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(64, 2, 8)
    x[:, 1] = 2.0
    out = tparam.augment_batch({"inputs": x, "outputs": x.clone()}, g)
    for key in ("inputs", "outputs"):
        y = out[key]
        gain = y.amin(dim=(1, 2))
        assert torch.all((gain <= 1.0) & (gain >= 10 ** (-32 / 20) - 1e-7))
    flip_in = out["inputs"][:, 0, 0] > out["inputs"][:, 1, 0]
    flip_out = out["outputs"][:, 0, 0] > out["outputs"][:, 1, 0]
    assert torch.equal(flip_in, flip_out) and 0 < int(flip_in.sum()) < 64


def _encoder_configs():
    from st_ito_torch.models.clap import CLAPAudioConfig
    from st_ito_torch.models.clap_laion import ClapLaionConfig
    from st_ito_torch.models.gcn import DeepGCNConfig
    from st_ito_torch.models.htsat import HTSATConfig

    tower = dict(dim=16, depths=(1, 1, 1, 1), heads=(2, 2, 4, 4),
                 num_frames=64)
    return {
        "gcn": DeepGCNConfig(embed_dim=16, model_size="t", num_frames=64),
        "htsat": HTSATConfig(embed_dim=16, **tower),
        "clap": CLAPAudioConfig(embed_dim=16,
                                tower=HTSATConfig(embed_dim=24, **tower)),
        "clap-laion": ClapLaionConfig(
            spec_size=64, n_mels=16, patch=4, window=4, depths=(1, 2, 1),
            heads=(2, 4, 8), patch_dim=16, hidden=64, proj_dim=16),
    }


@pytest.mark.parametrize("encoder_type", ["gcn", "htsat", "clap",
                                          "clap-laion"])
def test_every_encoder_type_trains(encoder_type):
    """Two steps with each remaining encoder_type at a small width (their
    forwards are held against JAX in test_torch_backbones, test_torch_gcn
    and test_torch_clap): finite losses, the encoder's weights moved, the
    BatchNorm buffers (DeepGCN's) updated."""
    cfg = tparam.ParamEstimatorConfig(
        encoder=_encoder_configs()[encoder_type], encoder_type=encoder_type,
        lr=1e-3, num_instances=5, num_presets=3)
    state = tparam.init_param_estimator(cfg, seed=0, device="cpu")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = tparam.make_param_train_step(cfg)
    g = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(0)
    for _ in range(2):
        batch = {k: torch.from_numpy(v) for k, v in
                 make_batch(rng, 2).items()}
        state, metrics = step(state, batch, g)
        assert torch.isfinite(metrics["loss"])
    after = state.model.state_dict()
    moved = [k for k in before if k.startswith("encoder.")
             and before[k].is_floating_point()
             and not torch.equal(before[k], after[k])]
    assert any("running" not in k for k in moved)
    if encoder_type == "gcn":
        assert any("running_mean" in k for k in moved)
