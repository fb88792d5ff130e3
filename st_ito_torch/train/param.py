"""Pretext training: classify which effect instance and preset produced a
clip — port of ``st_ito_tpu/train/param.py`` (reference:
st_ito/methods/param.py:43-359):

- encoder(outputs) -> (mid, side); optional L2 norm
- embed_mode blind: feats = [out_mid ‖ out_side]
          diff:  feats = [in_mid - out_mid ‖ in_side - out_side]
          concat: feats = [in_mid ‖ out_mid ‖ in_side ‖ out_side]
- instance head: MLP(feats) -> num_instances, CE
- preset head: MLP([instance_logits ‖ feats]) -> num_presets, CE
- optional adversarial content invariance: the generator minimises the
  NEGATED discriminator CE on the dataset id (or on softmaxed classifier
  logits); the discriminator trains on detached feats with its own Adam.

The state is a module (``ParamEstimator``), its optimisers and the step
(``ParamTrainState``). ``torch.optim.AdamW(lr, weight_decay)`` is
``optax.adamw``: eps 1e-8, the decay decoupled and scaled by lr; a
parameter the step's graph does not reach gets a zero gradient, so that it
decays as optax decays it. BatchNorm keeps the running-statistics update of
the outputs' forward only: the inputs' forward runs under
``bn_stats_frozen``, as the JAX trainer merges the outputs' stats alone.
The random draws (SpecAugment, dropout) come from the ``torch.Generator``
passed to a step, the outputs' forward's before the inputs'.

Data parallelism: ``make_param_train_step(cfg, mesh)`` (axis "data") gives
each rank its rows of the global batch; every random draw is the global
batch's, sliced (``parallel.global_draw``), BatchNorm runs on the global
batch's statistics (``parallel/batchnorm.py``), the gradients are
all-reduced (mean) before either optimiser steps and the metrics are
all-reduced means: N ranks compute what one process computes on the whole
batch, and their states stay equal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F

from st_ito_torch.models.cnn14 import (Cnn14, Cnn14Config, bn_stats_frozen,
                                       init_cnn14_, no_tf32)
from st_ito_torch.parallel.collectives import (all_reduce_mean,
                                               average_gradients, global_draw,
                                               sharded, shard_rows)
from st_ito_torch.utils import phase_timer, resolve_device


@dataclasses.dataclass(frozen=True)
class ParamEstimatorConfig:
    encoder: Any = Cnn14Config()  # the encoder_type's config
    encoder_type: str = "cnn14"  # cnn14 | dstcn | gcn | htsat | clap | clap-laion
    lr: float = 1e-4
    num_instances: int = 63
    num_presets: int = 10
    num_adv_classes: int = 0
    adv_logits_type: str = "dataset"  # or "classifier"
    adv_weight: float = 1.0
    weight_decay: float = 1e-4
    embed_mode: str = "concat"  # blind | diff | concat
    norm: str | None = "L2"

    @property
    def head_input_dim(self) -> int:
        d = self.encoder.embed_dim
        return 4 * d if self.embed_mode == "concat" else 2 * d


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of every array of a global batch (the batch
    itself without a mesh); raises unless the batch divides over the
    ranks."""
    if mesh is None:
        return batch
    return {k: shard_rows(v, mesh) for k, v in batch.items()}


def reduce_metrics(metrics: dict, mesh) -> dict:
    """Each metric's mean over the ranks (each rank's a mean over its
    equal share of the batch)."""
    if mesh is None:
        return metrics
    return {k: all_reduce_mean(v, mesh) for k, v in metrics.items()}


def build_encoder(cfg, encoder_type: str, generator: torch.Generator
                  ) -> nn.Module:
    """A trainable encoder of ``encoder_type`` (random weights from
    ``generator``; ``clap-laion`` from ``cfg.ckpt_path`` where that file
    exists), in train mode with every parameter requiring grad."""
    if encoder_type == "cnn14":
        net = init_cnn14_(Cnn14(cfg), generator)
    elif encoder_type == "dstcn":
        from st_ito_torch.models.encoders import DsTCN, xavier_init_

        net = xavier_init_(DsTCN(cfg), generator)
    elif encoder_type == "gcn":
        from st_ito_torch.models.gcn import DeepGCN, init_deepgcn_

        net = init_deepgcn_(DeepGCN(cfg), generator)
    elif encoder_type == "htsat":
        from st_ito_torch.models.htsat import HTSAT, init_htsat_

        net = init_htsat_(HTSAT(cfg), generator)
    elif encoder_type == "clap":
        from st_ito_torch.models.clap import CLAPAudio, init_clap_audio_

        net = init_clap_audio_(CLAPAudio(cfg), generator)
    elif encoder_type == "clap-laion":
        # the "-pt" variant: the converted LAION checkpoint where present,
        # else random weights (training from scratch)
        from st_ito_torch.models.clap_laion import load_clap_laion_model

        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))
        net = load_clap_laion_model(ckpt_path=cfg.ckpt_path,
                                    allow_random=True, seed=seed,
                                    config=cfg, device="cpu").net
    else:
        raise ValueError(f"unknown encoder_type: {encoder_type}")
    return net.requires_grad_(True).train()


def encode(net: nn.Module, x: torch.Tensor, encoder_type: str,
           generator: torch.Generator | None = None):
    """(mid, side) of x (B, C, T); the draws of dropout and SpecAugment
    from ``generator`` where the encoder has them."""
    if encoder_type in ("cnn14", "dstcn", "gcn"):
        return net(x, generator=generator)
    if encoder_type == "clap-laion":
        from st_ito_torch.models.clap_laion import clap_laion_pretext_apply

        return clap_laion_pretext_apply(net, x, net.config)
    return net(x)


def xavier_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    a = math.sqrt(6.0 / (w.shape[-1] + w.shape[-2]))
    with torch.no_grad():
        w.copy_((torch.rand(w.shape, generator=generator) * 2.0 - 1.0) * a)


class MLP(nn.Module):
    """fc1 (in -> 2 in), ReLU, fc2 (-> out); Xavier-uniform weights, zero
    biases. ``frozen_params`` applies it with its weights detached."""

    def __init__(self, in_dim: int, out_dim: int, generator: torch.Generator):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, 2 * in_dim)
        self.fc2 = nn.Linear(2 * in_dim, out_dim)
        for fc in (self.fc1, self.fc2):
            xavier_uniform_(fc.weight, generator)
            nn.init.zeros_(fc.bias)

    def forward(self, x, frozen_params: bool = False):
        p = [t.detach() if frozen_params else t for t in
             (self.fc1.weight, self.fc1.bias, self.fc2.weight, self.fc2.bias)]
        return F.linear(torch.relu(F.linear(x, p[0], p[1])), p[2], p[3])


class ParamEstimator(nn.Module):
    """encoder, instance_estimator, [preset_estimator], [discriminator]:
    the JAX params dict's keys."""

    def __init__(self, cfg: ParamEstimatorConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        in_dim = cfg.head_input_dim
        self.encoder = build_encoder(cfg.encoder, cfg.encoder_type, generator)
        self.instance_estimator = MLP(in_dim, cfg.num_instances, generator)
        if cfg.num_presets > 0:
            self.preset_estimator = MLP(in_dim + cfg.num_instances,
                                        cfg.num_presets, generator)
        if cfg.num_adv_classes > 0:
            self.discriminator = MLP(in_dim, cfg.num_adv_classes, generator)

    def generator_parameters(self):
        return [p for n, p in self.named_parameters()
                if not n.startswith("discriminator.")]


@dataclasses.dataclass
class ParamTrainState:
    model: ParamEstimator
    opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer | None
    step: int = 0


def init_param_estimator(cfg: ParamEstimatorConfig, seed: int = 0,
                         device="cuda") -> ParamTrainState:
    """A fresh estimator on ``device`` (default the card), its weights from
    a ``torch.Generator`` seeded with ``seed``, with AdamW over everything
    but the discriminator and Adam over the discriminator."""
    dev = resolve_device(device)
    model = ParamEstimator(cfg, torch.Generator().manual_seed(seed)).to(dev)
    return make_state(model, cfg)


def make_state(model: ParamEstimator, cfg: ParamEstimatorConfig
               ) -> ParamTrainState:
    """The optimisers around ``model`` (after weights were loaded into it)."""
    opt = torch.optim.AdamW(model.generator_parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    d_opt = None
    if cfg.num_adv_classes > 0:
        d_opt = torch.optim.Adam(model.discriminator.parameters(), lr=cfg.lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    return ParamTrainState(model=model, opt=opt, d_opt=d_opt, step=0)


def _l2(e):
    return e / torch.clamp_min(
        torch.linalg.vector_norm(e, dim=-1, keepdim=True), 1e-12)


def compute_feats(model: ParamEstimator, cfg: ParamEstimatorConfig, inputs,
                  outputs, generator=None):
    """The heads' input; in train mode the outputs' forward updates the
    BatchNorm buffers and the inputs' does not."""
    out_mid, out_side = encode(model.encoder, outputs, cfg.encoder_type,
                               generator)
    if cfg.norm == "L2":
        out_mid, out_side = _l2(out_mid), _l2(out_side)
    if cfg.embed_mode == "blind":
        return torch.cat([out_mid, out_side], dim=-1)
    with bn_stats_frozen(model.encoder):
        in_mid, in_side = encode(model.encoder, inputs, cfg.encoder_type,
                                 generator)
    if cfg.norm == "L2":
        in_mid, in_side = _l2(in_mid), _l2(in_side)
    if cfg.embed_mode == "diff":
        return torch.cat([in_mid - out_mid, in_side - out_side], dim=-1)
    return torch.cat([in_mid, out_mid, in_side, out_side], dim=-1)


def _soft_ce(logits, target_probs):
    """optax.softmax_cross_entropy, averaged over the batch."""
    return -(target_probs * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def adversary_ce(cfg: ParamEstimatorConfig, adv_logits, batch):
    if cfg.adv_logits_type == "classifier":
        return _soft_ce(adv_logits, torch.softmax(batch["content_logits"], -1))
    return F.cross_entropy(adv_logits, batch["tar_index"].long())


def param_estimator_loss(model: ParamEstimator, cfg: ParamEstimatorConfig,
                         batch: dict, training: bool,
                         generator: torch.Generator | None = None):
    """Returns (loss, (metrics, feats)); the module's mode is set by
    ``training``. Metrics are detached 0-d tensors."""
    model.train(training)
    with no_tf32():
        feats = compute_feats(model, cfg, batch["inputs"], batch["outputs"],
                              generator)
        instance_logits = model.instance_estimator(feats)
        inst = batch["instance_index"].long()
        instance_loss = F.cross_entropy(instance_logits, inst)
        loss = instance_loss
        metrics = {"instance_loss": instance_loss.detach(),
                   "instance_acc": (instance_logits.argmax(-1) == inst)
                   .float().mean()}
        if cfg.num_presets > 0:
            preset_logits = model.preset_estimator(
                torch.cat([instance_logits, feats], dim=-1))
            pre = batch["preset_index"].long()
            preset_loss = F.cross_entropy(preset_logits, pre)
            loss = loss + preset_loss
            metrics["preset_loss"] = preset_loss.detach()
            metrics["preset_acc"] = (preset_logits.argmax(-1) == pre
                                     ).float().mean()
        if cfg.num_adv_classes > 0:
            adv_logits = model.discriminator(feats, frozen_params=True)
            adv_loss = -adversary_ce(cfg, adv_logits, batch)
            loss = loss + adv_loss
            metrics["adv_loss"] = adv_loss.detach()
    metrics["loss"] = loss.detach()
    return loss, (metrics, feats)


def fill_grads(params) -> None:
    """A zero gradient for each parameter the backward pass did not reach
    (optax updates every leaf: Adam's moments and the decay go on)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def train_step(state: ParamTrainState, batch: dict,
               generator: torch.Generator | None,
               cfg: ParamEstimatorConfig, mesh=None):
    """One step in place on a global batch (this rank's rows of it under
    ``mesh``); returns (state, metrics)."""
    model = state.model
    batch = shard_batch(batch, mesh)
    dev = batch["inputs"].device
    gen_params = model.generator_parameters()
    for p in model.parameters():
        p.grad = None
    with phase_timer.span("forward", dev), sharded(mesh, model):
        loss, (metrics, feats) = param_estimator_loss(model, cfg, batch,
                                                      True, generator)
    with phase_timer.span("backward", dev):
        with no_tf32():
            loss.backward()
        fill_grads(gen_params)
        average_gradients(gen_params, mesh)
    with phase_timer.span("optimizer", dev):
        state.opt.step()
        if cfg.num_adv_classes > 0:
            feats_d = feats.detach()
            with no_tf32():
                d_loss = adversary_ce(cfg, model.discriminator(feats_d),
                                      batch) * cfg.adv_weight
                d_loss.backward()
            fill_grads(model.discriminator.parameters())
            average_gradients(model.discriminator.parameters(), mesh)
            state.d_opt.step()
            metrics["d_loss"] = d_loss.detach()
    state.step += 1
    return state, reduce_metrics(metrics, mesh)


def make_param_train_step(cfg: ParamEstimatorConfig, mesh=None):
    """step(state, batch, generator) -> (state, metrics): one AdamW step
    (and the adversary's Adam step) on batch tensors on the model's
    device. With ``mesh`` (``parallel.make_mesh``, axis "data") every rank
    is given the same global batch, of a size that divides over the ranks,
    and the same generator state, and steps on its rows of it (see the
    module's docstring)."""
    def step(state, batch, generator=None):
        return train_step(state, batch, generator, cfg, mesh)

    return step


def augment_batch(batch: dict, generator: torch.Generator) -> dict:
    """NpzShardDataset's augmentation on the card: independent 0 to -32 dB
    gains for inputs and outputs, then a joint LR flip per example
    (reference: dataset_param.py:218-232), drawn in that order."""
    x = batch["inputs"]
    bs, dev = x.shape[0], x.device

    def rand():
        return global_draw(lambda s: torch.rand(s, generator=generator,
                                                device=dev), (bs,))

    gi = 10.0 ** (-rand() * 32.0 / 20.0)
    go = 10.0 ** (-rand() * 32.0 / 20.0)
    flip = (rand() < 0.5)[:, None, None]
    out = dict(batch)
    for key, g in (("inputs", gi), ("outputs", go)):
        y = batch[key] * g[:, None, None]
        out[key] = torch.where(flip, y.flip(1), y)
    return out


def make_param_train_block(cfg: ParamEstimatorConfig, k: int,
                           augment: bool = False):
    """k pretext steps over a device-resident example pool:
    block(state, pool, idx, generator) -> (state, losses (k,)), pool the
    example dict on the card, idx (k, bs) gather indices. With
    ``augment`` each step's batch gets ``augment_batch`` first (the pool
    stays un-augmented). The same as k steps of ``make_param_train_step``
    on the gathered batches with the same generator."""
    def block(state, pool, idx, generator=None):
        losses = []
        for i in range(k):
            ind = torch.as_tensor(idx[i], device=pool["inputs"].device)
            batch = {name: arr.index_select(0, ind)
                     for name, arr in pool.items()}
            if augment:
                batch = augment_batch(batch, generator)
            state, metrics = train_step(state, batch, generator, cfg)
            losses.append(metrics["loss"])
        return state, torch.stack(losses)

    return block
