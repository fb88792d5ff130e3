"""Style-transfer training: the learned-inference baseline (DeepAFx-ST
style) — port of ``st_ito_tpu/train/style.py`` (reference:
st_ito/methods/style.py:542-894):

- predict_params: encoder(input), encoder(target) on analysis_length centre
  crops -> concat the 4 mid/side embeds -> ParameterRegressor (MLP +
  sigmoid) or ParameterClassifier (a softmax over num_bins per parameter,
  the heads stacked)
- render: the chain through the differentiable renderer
  (``build_batched_render_fn(fast=False, fuse_lti=False)``: every stage
  as the per-candidate renderer applies it, batched), or the 21/51-param
  processors of ``proc.py``
- losses: parameter regression (MSE), parameter classification (CE),
  audio (multi-resolution STFT)
- on_the_fly: random target params (gain pinned at 0.5, the reverb mix
  zeroed at random) rendered in the step on the card, without gradient
- split_section: train on (input_A, target_B) halves; random 0 to -12 dB
  gains on input and target

The random draws come from the ``torch.Generator`` passed to a step, in
the JAX trace's order: the input gains, the on-the-fly draws, the target
gains, then the input's encoder forward and the target's. BatchNorm keeps
the input forward's update (the target's runs under ``bn_stats_frozen``).
``total_steps > 0`` scales the learning rate by 0.1 from step
int(0.8 total) and again from int(0.95 total), the boundaries as
``optax.piecewise_constant_schedule``'s dict holds them.

Data parallelism: ``make_train_step(mesh)`` (axis "data") steps each rank
on its rows of the global batch, as ``train/param.py`` does: the input
peak is the global batch's (an all-reduced max), every draw (the gains,
the on-the-fly targets' parameters) is the global batch's sliced,
BatchNorm and the audio loss run on global sums, and the gradients and
metrics are all-reduced means.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from st_ito_torch import proc
from st_ito_torch.chain import ChainSpec
from st_ito_torch.chain.executor import build_batched_render_fn
from st_ito_torch.models.cnn14 import (Cnn14, Cnn14Config, bn_stats_frozen,
                                       init_cnn14_, no_tf32)
from st_ito_torch.ops.losses import multi_resolution_stft_loss
from st_ito_torch.parallel.collectives import (average_gradients, batch_max,
                                               global_draw, sharded)
from st_ito_torch.train.param import (fill_grads, reduce_metrics, shard_batch,
                                      xavier_uniform_)
from st_ito_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class StyleTransferConfig:
    encoder: Cnn14Config = Cnn14Config()
    lr: float = 1e-4
    analysis_length: int = 131072
    weight_decay: float = 1e-3
    max_epochs: int = 250
    loss_type: str = "parameter-regression"  # | parameter-classification | audio
    autodiff_processor: str = "chain"  # chain | simple | complex
    on_the_fly: bool = False
    split_section: bool = False
    num_bins: int = 64
    sample_rate: int = 48000
    total_steps: int = 0  # > 0 enables the reference's MultiStepLR schedule

    @property
    def head_input_dim(self) -> int:
        return 4 * self.encoder.embed_dim


class Regressor(nn.Module):
    """MLP (D -> 2D -> P) + sigmoid."""

    def __init__(self, input_dim: int, num_params: int,
                 generator: torch.Generator):
        super().__init__()
        self.fc1 = nn.Linear(input_dim, 2 * input_dim)
        self.fc2 = nn.Linear(2 * input_dim, num_params)
        for fc in (self.fc1, self.fc2):
            xavier_uniform_(fc.weight, generator)
            nn.init.zeros_(fc.bias)

    def forward(self, embed):
        return torch.sigmoid(self.fc2(torch.relu(self.fc1(embed))))


class _Stacked(nn.Module):
    def __init__(self, p: int, o: int, i: int, generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(p, o, i))
        self.bias = nn.Parameter(torch.zeros(p, o))
        for w in self.weight.data:
            xavier_uniform_(w, generator)


class Classifier(nn.Module):
    """Per-parameter heads stacked: embed (bs, D) -> logits
    (bs, num_params, num_bins)."""

    def __init__(self, input_dim: int, num_params: int, num_bins: int,
                 generator: torch.Generator, hidden_dim: int = 256):
        super().__init__()
        self.fc1 = _Stacked(num_params, hidden_dim, input_dim, generator)
        self.fc2 = _Stacked(num_params, num_bins, hidden_dim, generator)

    def forward(self, embed):
        h = torch.einsum("bd,phd->bph", embed, self.fc1.weight) + self.fc1.bias
        h = torch.relu(h)
        return (torch.einsum("bph,pnh->bpn", h, self.fc2.weight)
                + self.fc2.bias)


def classifier_logits_to_params(logits, num_bins: int):
    vals = torch.linspace(0.0, 1.0, num_bins, device=logits.device)
    return vals[logits.argmax(-1)]


def params_to_bin_index(params, num_bins: int):
    """searchsorted into linspace(0, 1, num_bins) (reference:
    style.py:493-499)."""
    vals = torch.linspace(0.0, 1.0, num_bins, device=params.device)
    return torch.searchsorted(vals, params.contiguous()).to(torch.int32)


class StyleModel(nn.Module):
    """encoder + estimator: the JAX params dict's keys."""

    def __init__(self, cfg: StyleTransferConfig, num_params: int,
                 generator: torch.Generator):
        super().__init__()
        self.encoder = init_cnn14_(Cnn14(cfg.encoder), generator
                                   ).requires_grad_(True).train()
        if cfg.loss_type == "parameter-classification":
            self.estimator = Classifier(cfg.head_input_dim, num_params,
                                        cfg.num_bins, generator)
        else:
            self.estimator = Regressor(cfg.head_input_dim, num_params,
                                       generator)


@dataclasses.dataclass
class StyleTrainState:
    model: StyleModel
    opt: torch.optim.Optimizer
    sched: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def lr_scale(total_steps: int) -> Callable[[int], float]:
    """The schedule's factor after ``count`` steps: 0.1 for each boundary
    at or below it (a repeated boundary counts once, as in a dict)."""
    bounds = {int(total_steps * 0.8): 0.1, int(total_steps * 0.95): 0.1}

    def scale(count: int) -> float:
        f = 1.0
        for b, s in bounds.items():
            if count >= b:
                f *= s
        return f

    return scale


class StyleTransferSystem:
    """Holds the config, the chain and the functions; the state lives in
    ``StyleTrainState``. Runs on ``device`` (default the card)."""

    def __init__(self, cfg: StyleTransferConfig, chain: ChainSpec | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.chain = chain
        self.device = resolve_device(device)
        if cfg.autodiff_processor == "simple":
            self.num_params = proc.NUM_SIMPLE_PARAMS
            self._proc = proc.apply_simple_autodiff_processor
        elif cfg.autodiff_processor == "complex":
            self.num_params = proc.NUM_COMPLEX_PARAMS
            self._proc = proc.apply_complex_autodiff_processor
        else:
            assert chain is not None, \
                "chain required for autodiff_processor='chain'"
            self.num_params = chain.num_params
            render = build_batched_render_fn(
                chain, cfg.sample_rate, 2, fast=False, fuse_lti=False,
                peak_normalize_output=False, device=self.device)
            self._proc = lambda audio, params, sr: render(params, audio)

    # -- init ---------------------------------------------------------------

    def init(self, seed: int = 0) -> StyleTrainState:
        model = StyleModel(self.cfg, self.num_params,
                           torch.Generator().manual_seed(seed))
        return self.make_state(model.to(self.device))

    def make_state(self, model: StyleModel) -> StyleTrainState:
        """AdamW (and the schedule) around ``model``."""
        cfg = self.cfg
        opt = torch.optim.AdamW(model.parameters(), lr=cfg.lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.weight_decay)
        scale = (lr_scale(cfg.total_steps) if cfg.total_steps > 0
                 else (lambda count: 1.0))
        sched = torch.optim.lr_scheduler.LambdaLR(opt, scale)
        return StyleTrainState(model=model, opt=opt, sched=sched, step=0)

    # -- model --------------------------------------------------------------

    def predict_params(self, model: StyleModel, input_audio, target_audio,
                       training: bool, generator=None):
        """(w, logits or None) (reference: style.py:662-701)."""
        cfg = self.cfg
        L = cfg.analysis_length

        def center_crop(x):
            T = x.shape[-1]
            if T > L:
                s = (T - L) // 2
                return x[..., s:s + L]
            return x

        model.train(training)
        with no_tf32():
            in_mid, in_side = model.encoder(center_crop(input_audio),
                                            generator=generator)
            with bn_stats_frozen(model.encoder):
                tg_mid, tg_side = model.encoder(center_crop(target_audio),
                                                generator=generator)
            feats = torch.cat([in_mid, in_side, tg_mid, tg_side], dim=-1)
            if cfg.loss_type == "parameter-classification":
                logits = model.estimator(feats)
                return classifier_logits_to_params(logits, cfg.num_bins), \
                    logits
            return model.estimator(feats), None

    def render(self, audio, w):
        return self._proc(audio, w, self.cfg.sample_rate)

    def forward(self, model: StyleModel, input_audio, target_audio,
                render_audio: bool = True, training: bool = False,
                generator=None):
        w, logits = self.predict_params(model, input_audio, target_audio,
                                        training, generator)
        if render_audio:
            output_audio = self.render(input_audio, w)
        else:
            output_audio = torch.zeros_like(input_audio)
        return output_audio, w, logits

    # -- training step --------------------------------------------------------

    def loss_fn(self, model: StyleModel, batch: dict,
                generator: torch.Generator | None, training: bool = True):
        """batch: {"input_audio" (bs, 2, T), "target_audio",
        "target_params"} (reference: style.py:726-886). Returns
        (loss, (metrics, aux))."""
        cfg = self.cfg
        input_audio = batch["input_audio"]
        target_audio = batch.get("target_audio")
        target_params = batch.get("target_params")
        bs, dev = input_audio.shape[0], input_audio.device

        def rand(*shape):
            return global_draw(lambda s: torch.rand(
                s, generator=generator, device=dev), shape)

        def db_gain(db):
            return (10 ** (db / 20.0))[:, None, None]

        peak = batch_max(input_audio.abs().max())
        input_audio = input_audio / torch.clamp_min(peak, 1e-8)
        input_audio = input_audio * db_gain(-rand(bs) * 12.0)

        if cfg.on_the_fly:
            target_params = rand(bs, self.num_params)
            target_params[:, -1] = 0.5  # pin gain
            rev_on = (rand(bs) <= 0.5).to(torch.float32)
            target_params[:, -2] *= rev_on
            x_t = input_audio * db_gain(-rand(bs) * 24.0)
            with torch.no_grad():
                target_audio = self.render(x_t, target_params)
                peaks = target_audio.abs().amax(dim=(-2, -1), keepdim=True)
                g = torch.clamp(1.0 / torch.clamp_min(peaks, 1e-8),
                                10 ** (-48 / 20), 10 ** (48 / 20))
                target_audio = target_audio * g

        target_audio = target_audio * db_gain(-rand(bs) * 12.0)

        T = input_audio.shape[-1]
        if cfg.split_section:
            input_A = input_audio[..., : T // 2]
            target_A = target_audio[..., : T // 2]
            target_B = target_audio[..., T // 2:]
        else:
            input_A, target_A, target_B = input_audio, target_audio, \
                target_audio

        render_audio = cfg.loss_type == "audio" or not training
        w, logits = self.predict_params(model, input_A, target_B, training,
                                        generator if training else None)
        if render_audio:
            output_A = self.render(input_A, w)
        else:
            output_A = torch.zeros_like(input_A)

        metrics = {}
        if cfg.loss_type == "audio":
            loss = multi_resolution_stft_loss(output_A, target_A)
            metrics["audio_loss"] = loss.detach()
        elif cfg.loss_type == "parameter-regression":
            loss = torch.mean((w - target_params) ** 2)
            metrics["param_loss"] = loss.detach()
        else:  # parameter-classification
            target_idx = params_to_bin_index(target_params, cfg.num_bins)
            loss = F.cross_entropy(logits.reshape(-1, cfg.num_bins),
                                   target_idx.reshape(-1).long())
            metrics["param_loss"] = loss.detach()

        if cfg.loss_type != "audio" and not training:
            metrics["audio_loss"] = multi_resolution_stft_loss(
                output_A, target_A).detach()

        metrics["loss"] = loss.detach()
        aux = {"output_audio": output_A.detach(), "params_pred": w.detach()}
        return loss, (metrics, aux)

    def train_step(self, state: StyleTrainState, batch: dict,
                   generator: torch.Generator | None, mesh=None):
        model = state.model
        batch = shard_batch(batch, mesh)
        for p in model.parameters():
            p.grad = None
        with sharded(mesh, model):
            loss, (metrics, _) = self.loss_fn(model, batch, generator, True)
        with no_tf32():
            loss.backward()
        fill_grads(model.parameters())
        average_gradients(model.parameters(), mesh)
        state.opt.step()
        state.sched.step()
        state.step += 1
        return state, reduce_metrics(metrics, mesh)

    def make_train_step(self, mesh=None) -> Callable:
        """step(state, batch, generator) -> (state, metrics), in place.
        With ``mesh`` (axis "data") every rank is given the same global
        batch and generator state and steps on its rows (see the module's
        docstring)."""
        if mesh is None:
            return self.train_step

        def step(state, batch, generator=None):
            return self.train_step(state, batch, generator, mesh)

        return step

    def make_eval_step(self) -> Callable:
        """eval(model, batch, generator) -> (loss, (metrics, aux)), the
        module in eval mode, without gradient."""
        def evaluate(model, batch, generator=None):
            with torch.no_grad():
                return self.loss_fn(model, batch, generator, training=False)

        return evaluate

    def make_train_block(self, k: int) -> Callable:
        """k steps over a device-resident source pool:
        block(state, pool (N, C, T), idx (k, bs), generator) ->
        (state, losses (k,)), each step's batch {"input_audio":
        pool[idx[i]]} (the on-the-fly trainer's)."""
        def block(state, pool, idx, generator=None):
            losses = []
            for i in range(k):
                ind = torch.as_tensor(idx[i], device=pool.device)
                state, metrics = self.train_step(
                    state, {"input_audio": pool.index_select(0, ind)},
                    generator)
                losses.append(metrics["loss"])
            return state, torch.stack(losses)

        return block
