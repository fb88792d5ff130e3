"""Training CLI — port of ``st_ito_tpu/cli/train.py``: YAML-config driven,
the LightningCLI equivalent (reference: scripts/main.py + cfg/*.yaml).

    python -m st_ito_torch.cli.train --config cfg/pretext-panns.yaml \\
        [--max-steps N] [--shard-dir DIR] [--val-shard-dir DIR]
        [--run-dir DIR] [--resume] [--device cuda|cpu]

Runs on ``--device`` (default the card; without one it raises). The
configs are read by ``yaml_subset`` (PyYAML is not needed). The subsystems
the reference got from Lightning:
- checkpoints by ``torch.save`` (``checkpoints/last.pt`` and
  ``last.step``) with ``--resume``;
- the config copied into the run directory (``config.yaml``, in the
  subset; MoveConfigCallback, reference: st_ito/callbacks.py:76-94);
- metrics to stdout and ``<run>/metrics.jsonl``, with ``examples_per_sec``
  at each log step (``STITO_WANDB=1`` also logs to wandb where installed);
- validation: loss, accuracy and the confusion matrix as ``.npy`` (a PNG
  where matplotlib is installed) for the pretext task
  (ConfusionMatrixCallback, reference: callbacks.py:97-164), audio
  snapshots for the style task (LogAudioCallback, callbacks.py:17-73);
- ``encoder.npz`` exported after pretext training through
  ``export_encoder_npz``, which ``load_param_model`` reads.

``--num-devices N`` above 1 (or ``num_devices`` in the YAML) is data
parallelism over N ranks (``parallel.make_mesh(N, "data")``): the CLI
starts them itself (NCCL with one card a rank, or gloo ranks with
``--device cpu``), or, started by ``torchrun``, joins torchrun's group of
N. Every rank reads the same global batches with the same seed and steps
on its rows of each; rank 0 alone writes the config copy, the
checkpoints, ``encoder.npz`` and the metrics, and runs the pretext
validation; ``--resume`` reads the checkpoint on every rank.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from st_ito_torch.cli import yaml_subset
from st_ito_torch.utils import resolve_device


def load_config(path: str) -> dict:
    return yaml_subset.load(path)


def _encoder_config(d: dict, encoder_type: str = "cnn14"):
    d = dict(d)
    for k in ("depths", "heads"):
        if k in d:
            d[k] = tuple(d[k])
    if encoder_type == "dstcn":
        from st_ito_torch.models.encoders import DsTCNConfig

        return DsTCNConfig(**d)
    if encoder_type == "gcn":
        from st_ito_torch.models.gcn import DeepGCNConfig

        return DeepGCNConfig(**d)
    if encoder_type == "htsat":
        from st_ito_torch.models.htsat import HTSATConfig

        return HTSATConfig(**d)
    if encoder_type == "clap":
        from st_ito_torch.models.clap import CLAPAudioConfig

        if "tower" in d:
            d["tower"] = _encoder_config(d["tower"], "htsat")
        return CLAPAudioConfig(**d)
    if encoder_type == "clap-laion":
        from st_ito_torch.models.clap_laion import ClapLaionConfig

        return ClapLaionConfig(**d)
    from st_ito_torch.models.cnn14 import Cnn14Config

    return Cnn14Config(**d)


def _build_chain(spec):
    from st_ito_torch.chain import (EFFECT_REGISTRY, ChainSpec, basic_chain,
                                    chain_from_json, chain_preset)

    if spec in (None, "basic"):
        return basic_chain(with_bypass=False)
    if isinstance(spec, str) and spec.endswith(".json"):
        # the reference's vst_json chain spec (methods/style.py:545)
        return chain_from_json(spec, with_bypass=False)
    if isinstance(spec, str):
        return chain_preset(spec, with_bypass=False)
    if isinstance(spec, list):
        return ChainSpec(
            stages=tuple(EFFECT_REGISTRY[name]() for name in spec),
            with_bypass=False,
        )
    raise ValueError(f"bad chain spec: {spec}")


class MetricsLogger:
    def __init__(self, run_dir: str):
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._wandb = None
        if os.environ.get("STITO_WANDB") == "1":
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project="st-ito-torch", dir=run_dir)
            except ImportError:
                pass

    def log(self, step: int, metrics: dict, prefix: str = "train"):
        rec = {"step": step,
               **{f"{prefix}_{k}": float(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(rec, step=step)
        msg = "  ".join(f"{k}={v:.4f}" for k, v in rec.items() if k != "step")
        print(f"step {step:6d}  {msg}", flush=True)


def save_checkpoint(ckpt_dir: str, state, step: int, tag: str = "last"):
    """``<tag>.pt`` (the module's state_dict, the optimisers', the
    schedule's, the step), written under a temporary name first, and
    ``<tag>.step``."""
    blob = {"model": state.model.state_dict(), "step": step,
            "opt": state.opt.state_dict()}
    for name in ("d_opt", "sched"):
        part = getattr(state, name, None)
        if part is not None:
            blob[name] = part.state_dict()
    path = os.path.join(ckpt_dir, f"{tag}.pt")
    torch.save(blob, path + ".tmp")
    os.replace(path + ".tmp", path)
    with open(os.path.join(ckpt_dir, f"{tag}.step"), "w") as f:
        f.write(str(step))


def restore_checkpoint(ckpt_dir: str, state, tag: str = "last"):
    """(state, step) from ``<tag>.pt`` where it exists, else (state, 0)."""
    path = os.path.join(ckpt_dir, f"{tag}.pt")
    if not os.path.isfile(path):
        return state, 0
    dev = next(state.model.parameters()).device
    blob = torch.load(path, map_location=dev, weights_only=True)
    state.model.load_state_dict(blob["model"])
    state.opt.load_state_dict(blob["opt"])
    for name in ("d_opt", "sched"):
        if name in blob:
            getattr(state, name).load_state_dict(blob[name])
    state.step = int(blob["step"])
    return state, state.step


def _confusion_matrix(preds: np.ndarray, labels: np.ndarray,
                      n: int) -> np.ndarray:
    cm = np.zeros((n, n), np.int64)
    for p, l in zip(preds, labels):
        cm[l, p] += 1
    return cm


def to_device(batch: dict, dev: torch.device) -> dict:
    """Copies of a loader batch on ``dev`` (the loader's arrays are views
    into scratch it reuses)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(dev) if dev.type != "cpu" else t.clone()
    return out


def _run_dir(cfg, args, default, lead=True):
    run_dir = args.run_dir or os.path.join("runs", cfg.get("name", default))
    if lead:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config.yaml"), "w") as f:
            f.write(yaml_subset.dumps(cfg))
    return run_dir


def _device(args, mesh):
    return mesh.device if mesh is not None else resolve_device(args.device)


def _took_a_step(step: int, epoch_start: int) -> None:
    if step == epoch_start:
        raise RuntimeError("an epoch of the dataset yielded no batch: fewer "
                           "examples than the batch size?")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_pretext(cfg: dict, args, mesh=None) -> dict:
    from st_ito_torch.data import NpzShardDataset, prefetch_batches
    from st_ito_torch.models.registry import export_encoder_npz
    from st_ito_torch.train import (ParamEstimatorConfig,
                                    init_param_estimator,
                                    make_param_train_step)
    from st_ito_torch.train.param import param_estimator_loss

    dev = _device(args, mesh)
    lead = mesh is None or mesh.rank == 0
    model_cfg = dict(cfg.get("model", {}))
    encoder_type = model_cfg.get("encoder_type", "cnn14")
    enc = _encoder_config(model_cfg.pop("encoder", {}), encoder_type)
    pcfg = ParamEstimatorConfig(encoder=enc, **model_cfg)

    run_dir = _run_dir(cfg, args, "pretext", lead)
    logger = MetricsLogger(run_dir) if lead else None
    seed = cfg.get("seed", 0)
    state = init_param_estimator(pcfg, seed=seed, device=dev)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if lead:
        os.makedirs(ckpt_dir, exist_ok=True)
    if args.resume:
        state, start_step = restore_checkpoint(ckpt_dir, state)
        if lead:
            print(f"resumed from step {start_step}", flush=True)

    step_fn = make_param_train_step(pcfg, mesh)
    data_cfg = cfg.get("data", {})
    shard_dir = args.shard_dir or data_cfg["shard_dir"]
    ds = NpzShardDataset(
        shard_dir,
        length=data_cfg.get("length", 262144),
        batch_size=data_cfg.get("batch_size", 32),
        seed=seed,
    )
    if lead:
        print(f"decode: {'native' if ds.use_native else 'numpy'}",
              flush=True)

    val_ds = None
    val_dir = args.val_shard_dir or data_cfg.get("val_shard_dir")
    if val_dir and lead:
        val_ds = NpzShardDataset(
            val_dir, length=data_cfg.get("length", 262144),
            batch_size=data_cfg.get("batch_size", 32), seed=seed + 1,
            random_gain=False, random_flip=False,
        )

    max_steps = args.max_steps or cfg.get("max_steps", 1000)
    log_every = cfg.get("log_every", 25)
    ckpt_every = cfg.get("ckpt_every", 500)
    val_every = cfg.get("val_every", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def run_validation(step):
        """Val loss and accuracy, and the confusion matrix."""
        losses, preds, labels = [], [], []
        for vi, vbatch in enumerate(iter(val_ds)):
            if vi >= cfg.get("val_batches", 8):
                break
            vbatch = to_device(vbatch, dev)
            with torch.no_grad():
                loss, (_, feats) = param_estimator_loss(
                    state.model, pcfg, vbatch, False)
                logits = state.model.instance_estimator(feats)
            losses.append(float(loss))
            preds.append(logits.argmax(-1).cpu().numpy())
            labels.append(vbatch["instance_index"].cpu().numpy())
        if not losses:
            return
        preds, labels = np.concatenate(preds), np.concatenate(labels)
        logger.log(step, {"loss": float(np.mean(losses)),
                          "instance_acc": float((preds == labels).mean())},
                   prefix="val")
        cm = _confusion_matrix(preds, labels, pcfg.num_instances)
        cm_dir = os.path.join(run_dir, "confusion")
        os.makedirs(cm_dir, exist_ok=True)
        np.save(os.path.join(cm_dir, f"step{step}.npy"), cm)
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(5, 4))
            ax.imshow(cm, cmap="viridis")
            ax.set_xlabel("predicted")
            ax.set_ylabel("true")
            fig.savefig(os.path.join(cm_dir, f"step{step}.png"), dpi=120)
            plt.close(fig)
        except ImportError:
            pass

    step = state.step
    step_s = []
    t0 = time.perf_counter()
    while step < max_steps:
        epoch_start = step
        for batch in prefetch_batches(iter(ds)):
            batch = to_device(batch, dev)
            ts = time.perf_counter()
            state, metrics = step_fn(state, batch, gen)
            _sync(dev)
            step_s.append(time.perf_counter() - ts)
            step = state.step
            if step % log_every == 0 and lead:
                metrics = dict(metrics)
                metrics["examples_per_sec"] = (
                    log_every * len(batch["inputs"])
                    / max(time.perf_counter() - t0, 1e-9))
                t0 = time.perf_counter()
                logger.log(step, metrics)
            if val_ds is not None and val_every and step % val_every == 0:
                run_validation(step)
            if step % ckpt_every == 0 and lead:
                save_checkpoint(ckpt_dir, state, step)
            if step >= max_steps:
                break
        _took_a_step(step, epoch_start)
    export_path = os.path.join(run_dir, "encoder.npz")
    if lead:
        save_checkpoint(ckpt_dir, state, step)
        export_encoder_npz(state.model.encoder.state_dict(), export_path,
                           config=pcfg.encoder)
        print(f"done at step {step}; checkpoints in {ckpt_dir}; "
              f"encoder exported to {export_path}", flush=True)
    return {"state": state, "step_s": step_s, "run_dir": run_dir,
            "use_native": ds.use_native}


def train_style(cfg: dict, args, mesh=None) -> dict:
    from st_ito_torch.data import StyleShardDataset, prefetch_batches
    from st_ito_torch.train.style import (StyleTransferConfig,
                                          StyleTransferSystem)
    from st_ito_torch.utils import save_audio

    dev = _device(args, mesh)
    lead = mesh is None or mesh.rank == 0
    model_cfg = dict(cfg.get("model", {}))
    enc = _encoder_config(model_cfg.pop("encoder", {}))
    chain = _build_chain(model_cfg.pop("chain", "basic"))
    scfg = StyleTransferConfig(encoder=enc, **model_cfg)
    system = StyleTransferSystem(scfg, chain=chain, device=dev)

    run_dir = _run_dir(cfg, args, "style", lead)
    logger = MetricsLogger(run_dir) if lead else None
    seed = cfg.get("seed", 0)
    state = system.init(seed)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if lead:
        os.makedirs(ckpt_dir, exist_ok=True)
    if args.resume:
        state, start_step = restore_checkpoint(ckpt_dir, state)
        if lead:
            print(f"resumed from step {start_step}", flush=True)

    step_fn = system.make_train_step(mesh)
    eval_fn = system.make_eval_step()
    data_cfg = cfg.get("data", {})
    shard_dir = args.shard_dir or data_cfg["shard_dir"]
    ds = StyleShardDataset(
        shard_dir,
        length=data_cfg.get("length", 131072),
        batch_size=data_cfg.get("batch_size", 16),
        seed=seed,
        input_only=scfg.on_the_fly,
    )

    max_steps = args.max_steps or cfg.get("max_steps", 1000)
    log_every = cfg.get("log_every", 25)
    ckpt_every = cfg.get("ckpt_every", 500)
    val_every = cfg.get("val_every", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)

    step = state.step
    step_s = []
    t0 = time.perf_counter()
    while step < max_steps:
        epoch_start = step
        for batch in prefetch_batches(iter(ds)):
            batch = to_device(batch, dev)
            ts = time.perf_counter()
            state, metrics = step_fn(state, batch, gen)
            _sync(dev)
            step_s.append(time.perf_counter() - ts)
            step = state.step
            if step % log_every == 0 and lead:
                metrics = dict(metrics)
                metrics["examples_per_sec"] = (
                    log_every * len(batch["input_audio"])
                    / max(time.perf_counter() - t0, 1e-9))
                t0 = time.perf_counter()
                logger.log(step, metrics)
            # every rank evaluates, so that every rank's generator advances
            if val_every and step % val_every == 0:
                _, (vmetrics, aux) = eval_fn(state.model, batch, gen)
            if val_every and step % val_every == 0 and lead:
                logger.log(step, vmetrics, prefix="val")
                # audio snapshot (LogAudioCallback equivalent)
                audio_dir = os.path.join(run_dir, "audio")
                os.makedirs(audio_dir, exist_ok=True)
                out = aux["output_audio"][0].cpu().numpy()
                out = out / max(np.abs(out).max(), 1e-8)
                save_audio(os.path.join(audio_dir, f"val_step{step}.wav"),
                           out, scfg.sample_rate)
            if step % ckpt_every == 0 and lead:
                save_checkpoint(ckpt_dir, state, step)
            if step >= max_steps:
                break
        _took_a_step(step, epoch_start)
    if lead:
        save_checkpoint(ckpt_dir, state, step)
        print(f"done at step {step}; checkpoints in {ckpt_dir}", flush=True)
    return {"state": state, "system": system, "step_s": step_s,
            "run_dir": run_dir}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--max-steps", type=int, default=0)
    parser.add_argument("--shard-dir", type=str, default=None)
    parser.add_argument("--val-shard-dir", type=str, default=None)
    parser.add_argument("--run-dir", type=str, default=None)
    parser.add_argument("--num-devices", type=int, default=0)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    task = cfg.get("task", "pretext")
    if task not in ("pretext", "style"):
        raise ValueError(f"unknown task: {task}")
    mesh = None
    n_dev = args.num_devices or cfg.get("num_devices", 0)
    if n_dev and n_dev > 1:
        import torch.distributed as dist

        from st_ito_torch.parallel import launch, make_mesh
        from st_ito_torch.parallel.mesh import default_backend

        resolve_device(args.device)
        if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
            from st_ito_torch.cli import train

            launch(train._rank_main, (argv,), n_dev,
                   default_backend(args.device))
            return None
        mesh = make_mesh(n_dev, "data", device=args.device)
    run = train_pretext if task == "pretext" else train_style
    try:
        return run(cfg, args, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _rank_main(argv):
    """One rank of ``--num-devices``, in a process ``parallel.launch``
    started."""
    main(argv)


if __name__ == "__main__":
    main()
