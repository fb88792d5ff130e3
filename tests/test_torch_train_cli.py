"""``python -m st_ito_torch.cli.train`` end to end on the CPU
(``--device cpu``) for a pretext and a style config at a small width:
steps, checkpoint, ``--resume``, the run directory's config copy, metrics
with ``examples_per_sec``, validation's confusion matrix, the style
task's audio snapshots, the ``encoder.npz`` export read back by
``load_param_model``, ``--num-devices 2`` raising with ROADMAP §1 item 13;
and the YAML-subset reader against ``yaml.safe_load`` on every
``cfg/*.yaml``."""

import glob
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from st_ito_torch.cli import train as cli
from st_ito_torch.cli import yaml_subset

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
T = 8192
ENCODER = {"embed_dim": 8, "base_channels": 2, "window_size": 512,
           "hop_size": 128, "mel_bins": 32}


@pytest.mark.parametrize("path", sorted(glob.glob(str(ROOT / "cfg" /
                                                       "*.yaml"))),
                         ids=os.path.basename)
def test_yaml_subset_reads_the_configs_as_safe_load(path):
    want = yaml.safe_load(open(path))
    assert yaml_subset.load(path) == want
    text = yaml_subset.dumps(want)
    assert yaml.safe_load(text) == want and yaml_subset.loads(text) == want


def test_yaml_subset_scalars_resolve_as_safe_load():
    text = ("a: 1.0e-4\nb: 1e-4\nc: yes\nd: [1, 2.5, x y, '3']\ne:\n"
            "f: ~\ng: -7 # comment\nh: 'it''s'\ni:\n  - 1\n  - two\n"
            "j: .inf\nk: 0x10\n")
    assert yaml_subset.loads(text) == yaml.safe_load(text.replace(
        "k: 0x10\n", "")) | {"k": "0x10"}


def write_pretext_shards(folder, n_shards=2, n=8, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    for s in range(n_shards):
        np.savez(os.path.join(folder, f"shard_{s:05d}.npz"),
                 inputs=(rng.standard_normal((n, 2, T + 500)) * 0.3).astype(
                     np.float16),
                 outputs=(rng.standard_normal((n, 2, T + 500)) * 0.3).astype(
                     np.float16),
                 instance_index=rng.integers(0, 4, n).astype(np.int32),
                 preset_index=rng.integers(0, 3, n).astype(np.int32),
                 tar_index=np.zeros(n, np.int32),
                 params=rng.random((n, 31)).astype(np.float32))
    return folder


def write_config(path, cfg):
    with open(path, "w") as f:
        f.write(yaml_subset.dumps(cfg))
    return str(path)


def pretext_config(tmp_path):
    return {"task": "pretext", "name": "t", "seed": 0, "max_steps": 3,
            "log_every": 1, "ckpt_every": 2, "val_every": 2,
            "val_batches": 1,
            "model": {"encoder": dict(ENCODER), "lr": 1.0e-4,
                      "num_instances": 4, "num_presets": 3,
                      "weight_decay": 1.0e-4, "embed_mode": "concat",
                      "norm": "L2"},
            "data": {"shard_dir": str(tmp_path / "shards"), "length": T,
                     "batch_size": 4}}


def test_pretext_cli_trains_resumes_and_exports(tmp_path):
    write_pretext_shards(str(tmp_path / "shards"))
    cfg = pretext_config(tmp_path)
    path = write_config(tmp_path / "p.yaml", cfg)
    run = tmp_path / "run"
    args = ["--config", path, "--run-dir", str(run), "--device", "cpu",
            "--val-shard-dir", str(tmp_path / "shards")]
    out = cli.main(args + ["--max-steps", "2"])
    assert out["state"].step == 2 and out["use_native"]
    assert yaml.safe_load(open(run / "config.yaml")) == cfg
    assert open(run / "checkpoints" / "last.step").read() == "2"
    recs = [json.loads(l) for l in open(run / "metrics.jsonl")]
    train = [r for r in recs if "train_loss" in r]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) and r["train_examples_per_sec"]
               > 0 for r in train)
    assert any("val_instance_acc" in r for r in recs)
    cm = np.load(run / "confusion" / "step2.npy")
    assert cm.shape == (4, 4) and cm.sum() == 4

    saved = {k: v.clone() for k, v in out["state"].model.state_dict().items()}
    out = cli.main(args + ["--max-steps", "3", "--resume"])
    assert out["state"].step == 3
    resumed = cli.restore_checkpoint(
        str(run / "checkpoints"), out["state"])[0]
    assert resumed.step == 3
    assert not torch.equal(saved["encoder.fc_mid.weight"],
                           out["state"].model.state_dict()[
                               "encoder.fc_mid.weight"])

    from st_ito_torch.models import get_param_embeds, load_param_model

    model = load_param_model(str(run / "encoder.npz"), device="cpu")
    assert model.config.base_channels == 2
    enc = out["state"].model.encoder.eval()
    x = torch.from_numpy((np.random.default_rng(1).standard_normal(
        (2, 2, T)) * 0.3).astype(np.float32))
    with torch.no_grad():
        want = enc(x)
    got = model(x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    emb = get_param_embeds(x, model, 48000)
    assert all(torch.isfinite(v).all() for v in emb.values())


def test_pretext_cli_resume_without_checkpoint_starts_at_0(tmp_path):
    write_pretext_shards(str(tmp_path / "shards"), n_shards=1)
    path = write_config(tmp_path / "p.yaml", pretext_config(tmp_path))
    out = cli.main(["--config", path, "--run-dir", str(tmp_path / "r"),
                    "--device", "cpu", "--max-steps", "1", "--resume"])
    assert out["state"].step == 1


def test_style_cli_on_the_fly_audio_loss(tmp_path):
    write_pretext_shards(str(tmp_path / "shards"), n_shards=1)
    cfg = {"task": "style", "name": "s", "seed": 0, "max_steps": 2,
           "log_every": 1, "ckpt_every": 1, "val_every": 2,
           "model": {"encoder": dict(ENCODER),
                     "chain": ["parametric_eq", "compressor", "distortion",
                               "reverb"],
                     "lr": 1.0e-4, "analysis_length": T // 2,
                     "loss_type": "audio", "autodiff_processor": "chain",
                     "on_the_fly": True, "split_section": True},
           "data": {"shard_dir": str(tmp_path / "shards"), "length": T,
                    "batch_size": 2}}
    path = write_config(tmp_path / "s.yaml", cfg)
    run = tmp_path / "run"
    args = ["--config", path, "--run-dir", str(run), "--device", "cpu"]
    out = cli.main(args)
    assert out["state"].step == 2
    assert (run / "audio" / "val_step2.wav").is_file()
    out = cli.main(args + ["--max-steps", "3", "--resume"])
    assert out["state"].step == 3
    assert out["state"].sched.last_epoch == 3

    from st_ito_torch.ito import run_learned_inference

    x = np.random.default_rng(2).standard_normal((1, 1, T)).astype(
        np.float32) * 0.3
    res = run_learned_inference(x, x, 48000, out["system"], out["state"])
    assert res["output_audio"].shape == (1, 2, T)
    assert len(res["params"]) == out["system"].num_params


def test_a_dataset_without_a_full_batch_raises(tmp_path):
    write_pretext_shards(str(tmp_path / "shards"), n_shards=1, n=2)
    cfg = pretext_config(tmp_path)
    cfg["data"]["batch_size"] = 4
    path = write_config(tmp_path / "p.yaml", cfg)
    with pytest.raises(RuntimeError, match="no batch"):
        cli.main(["--config", path, "--run-dir", str(tmp_path / "r"),
                  "--device", "cpu", "--max-steps", "1"])


@pytest.mark.parametrize("task", ["pretext-panns.yaml", "style-audio-otf.yaml"])
def test_num_devices_above_one_raises_item_13(task):
    with pytest.raises(NotImplementedError, match="item 13"):
        cli.main(["--config", str(ROOT / "cfg" / task), "--num-devices",
                  "2", "--device", "cpu"])


@pytest.mark.parametrize("path", sorted(glob.glob(str(ROOT / "cfg" /
                                                       "*.yaml"))),
                         ids=os.path.basename)
def test_every_config_builds_the_ports_configs(path):
    """Each cfg/*.yaml's model section makes the port's config objects as
    the CLI makes them (every key a field of the port's dataclasses)."""
    from st_ito_torch.train import ParamEstimatorConfig
    from st_ito_torch.train.style import StyleTransferConfig

    cfg = cli.load_config(path)
    model_cfg = dict(cfg["model"])
    if cfg["task"] == "pretext":
        enc = cli._encoder_config(model_cfg.pop("encoder", {}),
                                  model_cfg.get("encoder_type", "cnn14"))
        pcfg = ParamEstimatorConfig(encoder=enc, **model_cfg)
        assert pcfg.head_input_dim > 0
    else:
        enc = cli._encoder_config(model_cfg.pop("encoder", {}))
        chain = cli._build_chain(model_cfg.pop("chain", "basic"))
        assert StyleTransferConfig(encoder=enc, **model_cfg).head_input_dim
        assert chain.num_params > 0
