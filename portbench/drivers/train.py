"""AFx-Rep pretext training: ``cli/train.py train_pretext``'s own loop, the
port's step function (``make_param_train_step``) over batches from
``NpzShardDataset`` and ``prefetch_batches``, each batch copied to the card
by the CLI's ``to_device``, each step ending in the fetch of its loss.

Set-up writes the shards from the seed under ``$TMPDIR`` (removed at the
end of the run), builds the estimator (``init_param_estimator``) and loads
weights drawn from the seed into it (``load_state_dict``), and runs the
first ``warm_steps`` steps through the window's own loop and feed: they
warm every shape up and are the steps the check follows. It reads their
losses, each leaf's first gradient from AdamW's state after step 1
(``exp_avg / (1 - beta1)``) and each leaf's change after them. The window
then steps on from there with the same state and loader until ``seconds``
have passed.

The check: the plain reference (``reference/pretext.py``, float64) takes
the same steps from the same weights, batches (read again from the shards)
and draws: ``loss_gap`` is the widest relative gap of a step's loss;
``grad_gap`` and ``change_gap`` the worst leaf's gap between the program's
norm and the reference's, over the larger of the reference's norm of that
leaf and of the median leaf (``change_gap`` leaves out leaves whose
reference gradient is under a thousandth of the median leaf's: they move
by weight decay and rounding alone)."""

from __future__ import annotations

import glob
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench.core import shards, weights
from portbench.reference import pretext


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def estimator_config(cfg):
    from st_ito_torch.models.cnn14 import Cnn14Config
    from st_ito_torch.train import ParamEstimatorConfig

    return ParamEstimatorConfig(
        encoder=Cnn14Config(**cfg["encoder"]), lr=cfg["lr"],
        num_instances=cfg["num_instances"], num_presets=cfg["num_presets"],
        num_adv_classes=cfg["num_adv_classes"],
        weight_decay=cfg["weight_decay"], embed_mode=cfg["embed_mode"],
        norm=cfg["norm"])


def setup(ctx):
    from st_ito_torch.cli.train import to_device
    from st_ito_torch.data import NpzShardDataset, prefetch_batches
    from st_ito_torch.train import init_param_estimator, make_param_train_step

    cfg, traffic, dev, seed = (ctx["config"], ctx["traffic"], ctx["device"],
                               ctx["seed"])
    folder = tempfile.mkdtemp(prefix="portbench-shards-")
    shards.write(folder, seed, traffic["examples"], traffic["shard_examples"],
                 cfg["length"], cfg["encoder"]["sample_rate"],
                 cfg["num_instances"], cfg["num_presets"], dev)
    pcfg = estimator_config(cfg)
    state = init_param_estimator(pcfg, seed=0, device=dev)
    state.model.load_state_dict(weights.draw(
        seed, pretext.param_specs(cfg), dev))
    step_fn = make_param_train_step(pcfg)
    ds = NpzShardDataset(folder, length=cfg["length"],
                         batch_size=cfg["batch_size"], seed=seed)

    def feed():
        while True:
            for batch in prefetch_batches(iter(ds)):
                yield batch

    st = {"folder": folder, "state": state, "step_fn": step_fn,
          "feed": feed(), "gen": torch.Generator(device=dev).manual_seed(seed),
          "to_device": to_device}
    named = dict(state.model.named_parameters())
    start = {k: p.detach().clone() for k, p in named.items()}
    losses, grad1 = [], {}
    for t in range(traffic["warm_steps"]):
        losses.append(step(ctx, st)[0])
        if t == 0:
            grad1 = first_gradient(state.opt, named)
    change = {k: float(torch.linalg.vector_norm(p.detach() - start[k]))
              for k, p in named.items()}
    del start
    st["warm"] = {"losses": losses, "grad1": grad1, "change": change}
    return st


def first_gradient(opt, named: dict) -> dict:
    """Each leaf's gradient norm as AdamW got it in its first step:
    exp_avg / (1 - beta1); 0 for a leaf it holds no moment of."""
    beta1 = opt.param_groups[0]["betas"][0]
    out = {}
    for k, p in named.items():
        m = opt.state.get(p, {}).get("exp_avg")
        out[k] = 0.0 if m is None else float(
            torch.linalg.vector_norm(m) / (1.0 - beta1))
    return out


def step(ctx, st):
    """One step of the CLI's loop: (loss, seconds waited for the batch)."""
    t0 = time.perf_counter()
    batch = next(st["feed"])
    waited = time.perf_counter() - t0
    batch = st["to_device"](batch, ctx["device"])
    st["state"], metrics = st["step_fn"](st["state"], batch, st["gen"])
    return float(metrics["loss"]), waited


def window(ctx, st):
    dev = ctx["device"]
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    losses, wait = [], 0.0
    t0 = time.perf_counter()
    while True:
        loss, waited = step(ctx, st)
        losses.append(loss)
        wait += waited
        if time.perf_counter() - t0 >= ctx["seconds"]:
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    batch = ctx["config"]["batch_size"]
    return {"window_s": window_s, "peak_bytes": peak, "steps": len(losses),
            "examples": batch * len(losses), "data_wait_s": wait,
            "grad_items_per_example": 4, "attempted": len(losses),
            "failed": sum(1 for v in losses if not np.isfinite(v))}


def release(st):
    st.pop("state", None)
    st.pop("step_fn", None)
    st.pop("feed", None)


def gaps(got: dict, want: dict) -> dict:
    """loss_gap, grad_gap, change_gap of ``got`` against ``want`` (both as
    ``pretext.steps`` returns them)."""
    lg = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                  want["losses"]))
    med_g = float(np.median(list(want["grad1"].values())))
    moved = [k for k, g in want["grad1"].items() if g >= 1e-3 * med_g]
    med_c = float(np.median([want["change"][k] for k in moved]))

    def worst(key, leaves, med):
        return max(abs(got[key][k] - want[key][k]) / max(want[key][k], med)
                   for k in leaves)

    return {"loss_gap": lg, "grad_gap": worst("grad1", want["grad1"], med_g),
            "change_gap": worst("change", moved, med_c)}


def reference_steps(ctx, st, dtype=torch.float64, **kw):
    cfg, dev, seed = ctx["config"], ctx["device"], ctx["seed"]
    paths = sorted(glob.glob(os.path.join(st["folder"], "shard_*.npz")))
    data = pretext.batches(paths, seed, cfg["batch_size"], cfg["length"],
                           len(st["warm"]["losses"]), dev)
    w = weights.draw(seed, pretext.param_specs(cfg), dev, dtype=dtype)
    return pretext.steps(w, cfg, data, seed, dev, **kw)


def check(ctx, st, rec) -> dict:
    try:
        want = reference_steps(ctx, st)
    finally:
        shutil.rmtree(st["folder"], ignore_errors=True)
    return gaps(st["warm"], want)
