"""Both CLIs with ``--num-devices 2 --device cpu``, end to end through
their ``main``: the CLI starts 2 gloo ranks (``parallel.launch``: spawned
interpreters, one torch thread each), every rank computes the same run
and rank 0 alone writes. Held against
``--num-devices 1`` of the port (in this process) and, for
``run_optim``, against the JAX CLI with ``--num-devices 2`` (its "pop"
mesh over the forced host devices, on its TPU plan with the Pallas
kernels interpreted, as ``test_torch_cli`` runs it): ``--metric mfcc``,
so that both packages' host CMA-ES asks for the same populations and
lands on the same parameters. (The MFCC embed floors at 80 dB under the
maximum over the whole population: a rank takes the global maximum.)
The training CLI: two pretext steps and a resumed third on the small
Cnn14 of ``test_torch_train_cli``, the losses within 1e-4 relative, the
heads' output weights and the BatchNorm statistics within 1e-5
(``tests/test_train_param.py``'s limits for a sharded step)."""

import json
import os

import numpy as np
import pytest
import torch

from st_ito_tpu.cli import run_optim as jax_cli

from st_ito_torch.cli import run_optim
from st_ito_torch.cli import train as train_cli
from st_ito_torch.utils import save_audio

from tests.test_torch_render import force_jax_tpu_plan
from tests.test_torch_train_cli import (pretext_config, write_config,
                                        write_pretext_shards)
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture
def two_ranks(tmp_path, monkeypatch):
    """run(main, args): ``main(args + --num-devices 2 --device cpu)`` from
    the test's temporary directory, its ranks given one thread each (the
    spawned interpreters inherit the environment); a rank that fails
    makes ``main`` raise."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")

    def run(main, args):
        assert main(args + ["--num-devices", "2", "--device", "cpu"]) is None

    return run


def _params(out):
    run_dir = os.path.join(out, "tune_to_synthetic_target_es")
    with open(os.path.join(run_dir, "parameters_sigma=0.33.json")) as f:
        params = json.load(f)
    return np.asarray([v for p in params.values() for v in p.values()],
                      np.float64)


def test_run_optim_two_ranks_match_one_and_the_jax_mesh(tmp_path, two_ranks,
                                                        capfd, monkeypatch):
    monkeypatch.setenv("STITO_COMPILE_CACHE", "0")  # no cache under $HOME
    rng = np.random.default_rng(1)
    t = np.arange(8192) / 48000
    x = (0.3 * np.sin(2 * np.pi * 330 * t) * np.ones((2, 1))
         + 0.05 * rng.standard_normal((2, 8192)))
    wav = str(tmp_path / "tune.wav")
    save_audio(wav, x.astype(np.float32), 48000)
    common = [wav, "None", "--metric", "mfcc", "--popsize", "8",
              "--max-iters", "2", "--max-length", "8192"]
    capfd.readouterr()
    two_ranks(run_optim.main, common + ["--output-dir", str(tmp_path / "two")])
    text = capfd.readouterr().out  # rank 0's summary, from its own stdout
    summary = json.loads(text[text.index("{\n"):])
    assert summary["total_evals"] == 24
    one = run_optim.main(common + ["--num-devices", "1", "--device", "cpu",
                                   "--output-dir", str(tmp_path / "one")])
    with pytest.MonkeyPatch.context() as mp:
        force_jax_tpu_plan(mp)
        want = jax_cli.main(common + ["--num-devices", "2", "--output-dir",
                                      str(tmp_path / "jax")])
    np.testing.assert_allclose(summary["fopt"], one["fopt"], rtol=1e-6)
    assert abs(summary["fopt"] - float(want["fopt"])) <= 1e-4
    got = _params(str(tmp_path / "two"))
    np.testing.assert_array_equal(got, _params(str(tmp_path / "one")))
    np.testing.assert_allclose(got, _params(str(tmp_path / "jax")),
                               rtol=1e-6)
    assert sorted(os.listdir(tmp_path / "two")) == [
        "tune_to_synthetic_target_es"]


def _train_records(run):
    return [json.loads(line) for line in open(run / "metrics.jsonl")]


def test_train_cli_two_ranks_match_one(tmp_path, two_ranks):
    """Two steps, then a third resumed from the checkpoint (read by both
    ranks); one metrics record per step, written by rank 0."""
    write_pretext_shards(str(tmp_path / "shards"))
    cfg = pretext_config(tmp_path)
    path = write_config(tmp_path / "p.yaml", cfg)
    state = {}
    for name in ("two", "one"):
        run = tmp_path / name
        for steps, resume in (("2", []), ("3", ["--resume"])):
            args = ["--config", path, "--run-dir", str(run), "--max-steps",
                    steps, "--val-shard-dir", str(tmp_path / "shards")]
            if name == "two":
                two_ranks(train_cli.main, args + resume)
            else:
                out = train_cli.main(args + resume + ["--num-devices", "1",
                                                      "--device", "cpu"])
        blob = torch.load(run / "checkpoints" / "last.pt",
                          weights_only=True)
        assert blob["step"] == 3
        state[name] = blob["model"]
    assert out["state"].step == 3
    got, want = _train_records(tmp_path / "two"), _train_records(
        tmp_path / "one")
    train = [r for r in got if "train_loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3]
    for a, b in zip(train, [r for r in want if "train_loss" in r]):
        assert abs(a["train_loss"] - b["train_loss"]) <= 1e-4 * abs(
            b["train_loss"])
    assert any("val_instance_acc" in r for r in got)
    for k, w in state["one"].items():
        if "running" in k or k == "instance_estimator.fc2.weight":
            np.testing.assert_allclose(state["two"][k], w, atol=1e-5,
                                       err_msg=k)
    assert (tmp_path / "two" / "encoder.npz").is_file()
