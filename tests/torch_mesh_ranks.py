"""Test helper: the ranks of the mesh tests (``tests/test_torch_mesh*.py``).

``start(suite, world, folder)`` starts ``world`` processes of this file,
``python tests/torch_mesh_ranks.py SUITE RANK WORLD FOLDER``; each joins a
gloo group through a file store in FOLDER (no fixed TCP port: the suite's
workers run side by side), with one torch thread, makes
``parallel.make_mesh(WORLD, axis, device="cpu")``, reads the suite's inputs
from ``FOLDER/inputs.pt``, runs every case of the suite once and writes
``FOLDER/results.rank{RANK}.pt``. The returned handle's ``wait()`` joins
them within a deadline of its own and raises with a rank's error output
when one fails or hangs. A case is also callable in the test process with
``mesh=None`` (the path without a group, which world size 1 takes).

The cases import torch and the port only: the test files import JAX, and
a process that has imported JAX must not be forked.
"""

import datetime
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SR = 48000
RANK_TIMEOUT = 300  # seconds for a group to run its suite


# --------------------------------------------------------------------------
# starting and joining a group
# --------------------------------------------------------------------------


class Group:
    def __init__(self, procs, folder, world):
        self.procs, self.folder, self.world = procs, folder, world
        self.deadline = time.monotonic() + RANK_TIMEOUT

    def kill(self) -> None:
        """Stop every rank still running."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self) -> list:
        """Every rank's results, in rank order."""
        errs = []
        for rank, p in enumerate(self.procs):
            try:
                _, err = p.communicate(
                    timeout=max(self.deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                raise AssertionError(f"rank {rank} did not finish within "
                                     f"{RANK_TIMEOUT} s")
            if p.returncode != 0:
                errs.append(f"rank {rank} exited {p.returncode}:\n"
                            + err.decode()[-4000:])
        assert not errs, "\n".join(errs)
        return [torch.load(os.path.join(self.folder, f"results.rank{r}.pt"),
                           weights_only=False) for r in range(self.world)]


def start(suite: str, world: int, folder) -> Group:
    folder = str(folder)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, __file__, suite, str(r), str(world), folder],
        cwd=str(ROOT), env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE) for r in range(world)]
    return Group(procs, folder, world)


# --------------------------------------------------------------------------
# inputs shared by the ranks and the test process
# --------------------------------------------------------------------------


def audio(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def delay_reverb():
    from st_ito_torch.chain import ChainSpec, basic_delay, basic_reverb

    return ChainSpec((basic_delay(), basic_reverb()))


def param_model(inputs):
    from st_ito_torch.models import Cnn14, Cnn14Config, ParamModel

    net = Cnn14(Cnn14Config(**inputs["cnn14"]))
    net.load_state_dict(inputs["cnn14_sd"])
    return ParamModel(net=net, config=net.config,
                      embed_dim=net.config.embed_dim)


# --------------------------------------------------------------------------
# suite "es": the population over "pop"
# --------------------------------------------------------------------------


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def es_cases(inputs, mesh, folder):
    from st_ito_torch.ito import (make_fitness_fn, run_es, run_es_multitrack,
                                  run_staged_es)
    from st_ito_torch.models import get_param_embeds

    model, chain = param_model(inputs), delay_reverb()
    x, y, W = inputs["x"], inputs["y"], inputs["W"]
    tgt = get_param_embeds(y, model, SR)
    out = {}

    fit = make_fitness_fn(chain, model, SR, 2, mesh=mesh, device="cpu")
    out["fitness"] = fit(W, x[0], tgt)
    out["pop_indivisible"] = _raises(lambda: fit(W[:7], x[0], tgt))
    g = torch.Generator().manual_seed(11)
    fit_d = make_fitness_fn(chain, model, SR, 2, dropout=0.3, mesh=mesh,
                            device="cpu")
    out["fitness_dropout"] = fit_d(W, x[0], tgt, None, g)
    out["generator_after"] = torch.rand(3, generator=g)
    fv, emb, Y = make_fitness_fn(chain, model, SR, 2, return_audio=True,
                                 mesh=mesh, device="cpu")(W, x[0], tgt)
    out["audio_fitness"], out["audio_mid"], out["audio"] = fv, emb["mid"], Y

    common = dict(popsize=8, sigma0=0.3, seed=7, verbose=False, mesh=mesh,
                  device="cpu")

    def keep(res, *keys):
        return {k: res[k] for k in keys}

    hist = ("fval_history", "wopt", "wopt_history", "total_evals")
    out["host"] = keep(run_es(x, y, SR, chain, model, max_iters=2,
                              find_w0=True, **common), *hist)
    snap = os.path.join(folder, "device_es.npz")
    out["device"] = keep(run_es(x, y, SR, chain, model, max_iters=4,
                                find_w0=False, gens_per_dispatch=2,
                                es_state_path=snap, **common), *hist)
    out["device_resumed"] = keep(run_es(
        x, y, SR, chain, model, max_iters=2, find_w0=False,
        gens_per_dispatch=2, es_state_path=snap, **common), *hist)
    out["device_dropout"] = keep(run_es(
        x, y, SR, chain, model, max_iters=3, find_w0=False, dropout=0.3,
        gens_per_dispatch=2, **common), *hist)
    out["savepop"] = keep(run_es(
        x, y, SR, chain, model, max_iters=1, find_w0=True, savepop=True,
        run_dir=os.path.join(folder, "savepop"), **common), *hist)
    mt = dict(max_iters=2, popsize=4, seed=3, mesh=mesh, device="cpu")
    out["multitrack"] = keep(run_es_multitrack(
        inputs["xs"], inputs["ys"], SR, chain, model, **mt),
        "fval_history", "wopt")
    out["multitrack_dropout"] = keep(run_es_multitrack(
        inputs["xs"], inputs["ys"], SR, chain, model, dropout=0.3, **mt),
        "fval_history", "wopt")
    out["staged"] = keep(run_staged_es(
        x, y, SR, chain, model, max_iters=2, popsize=4, seed=5,
        verbose=False, es_state_path=os.path.join(folder, "staged"),
        mesh=mesh, device="cpu"), "fval_history", "wopt", "wopt_history")
    return out


# --------------------------------------------------------------------------
# suite "train": the batch over "data"
# --------------------------------------------------------------------------

# hop 256: 133 frames at T 33792 (SpecAugment's stripes leave most of a clip)
PRETEXT_ENCODER = dict(embed_dim=16, base_channels=4, window_size=1024,
                       hop_size=256, mel_bins=64)
PRETEXT_T, PRETEXT_B = 33792, 4
STYLE_ENCODER = dict(embed_dim=16, base_channels=4, window_size=512,
                     hop_size=128, mel_bins=64)
STYLE_T, STYLE_B = 16384, 2
STEPS = 2


def pretext_config(lr=1e-4):
    from st_ito_torch.models.cnn14 import Cnn14Config
    from st_ito_torch.train import param as tparam

    return tparam.ParamEstimatorConfig(
        encoder=Cnn14Config(**PRETEXT_ENCODER), lr=lr, num_instances=5,
        num_presets=3, weight_decay=1e-2, embed_mode="concat",
        num_adv_classes=4, adv_logits_type="dataset", adv_weight=0.5)


def pretext_batch(step, n=PRETEXT_B):
    rng = np.random.default_rng(100 + step)
    return {"inputs": audio((n, 2, PRETEXT_T), int(rng.integers(1 << 30))),
            "outputs": audio((n, 2, PRETEXT_T), int(rng.integers(1 << 30))),
            "instance_index": rng.integers(0, 5, n).astype(np.int32),
            "preset_index": rng.integers(0, 3, n).astype(np.int32),
            "tar_index": rng.integers(0, 4, n).astype(np.int32)}


def style_config(lr=1e-5):
    """lr 1e-5, as the style parity tests: Adam's first step moves an
    element whose gradient is rounding noise by a whole lr (ROADMAP §3),
    which at 1e-4 moves the second step's audio loss by 1e-4 relative."""
    from st_ito_torch.models.cnn14 import Cnn14Config
    from st_ito_torch.train import style as tstyle

    return tstyle.StyleTransferConfig(
        encoder=Cnn14Config(**STYLE_ENCODER), lr=lr,
        analysis_length=STYLE_T, weight_decay=1e-2,
        loss_type="parameter-regression",
        autodiff_processor="simple", on_the_fly=True, split_section=True)


def style_batch(step):
    return {"input_audio": audio((STYLE_B, 2, STYLE_T), 200 + step)}


def bn_inputs():
    """A BatchNorm2d's input (8, 3, 5, 4), the loss weights, and the
    module's affine parameters and buffers."""
    rng = np.random.default_rng(4)
    return {"x": torch.from_numpy(rng.standard_normal((8, 3, 5, 4)) * 2 + 1
                                  ).float(),
            "c": torch.from_numpy(rng.standard_normal((8, 3, 5, 4))).float(),
            "weight": torch.tensor([1.5, 0.5, -1.0]),
            "bias": torch.tensor([0.1, -0.2, 0.3])}


def bn_case(mesh):
    """Two forwards of a train-mode BatchNorm2d on the global batch (the
    first under ``bn_stats_frozen``), the loss mean(y c) over the batch:
    the outputs and input gradients gathered, the parameters' gradients
    averaged, the buffers."""
    from st_ito_torch.models.cnn14 import bn_stats_frozen
    from st_ito_torch.parallel import (all_gather_rows, average_gradients,
                                       sharded, shard_rows)

    d = bn_inputs()
    bn = torch.nn.BatchNorm2d(3).train()
    with torch.no_grad():
        bn.weight.copy_(d["weight"])
        bn.bias.copy_(d["bias"])
    rows = (lambda t: t) if mesh is None else (lambda t: shard_rows(t, mesh))
    x = rows(d["x"]).clone().requires_grad_(True)
    with sharded(mesh, bn):
        with bn_stats_frozen(bn):
            y0 = bn(x)
        y = bn(x)
    ((y + y0) * rows(d["c"])).mean().backward()
    if mesh is not None:
        average_gradients(bn.parameters(), mesh)
    gather = (lambda t: t) if mesh is None else (
        lambda t: all_gather_rows(t, mesh))
    return {"y": gather(y.detach()), "x_grad": gather(x.grad),
            "weight_grad": bn.weight.grad, "bias_grad": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var,
            "num_batches_tracked": bn.num_batches_tracked}


def run_steps(state, step, batches, g, around=None):
    """STEPS steps: each step's metrics, the first step's gradients and
    the state after each step. ``around(g)``, where given, is a context
    manager that each step runs inside (a test's recorder of the draws
    from g)."""
    import contextlib

    out = {"metrics": [], "states": []}
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v) for k, v in batches(i).items()}
        with (around(g) if around else contextlib.nullcontext()):
            state, m = step(state, batch, g)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append({k: v.clone()
                              for k, v in state.model.state_dict().items()})
        if i == 0:
            out["grads"] = {n: p.grad.clone() for n, p in
                            state.model.named_parameters()}
    out["generator_after"] = torch.rand(3, generator=g)
    return out


def pretext_state(inputs):
    """The estimator with the test's weights (the JAX init's, carried
    over), and its optimisers."""
    from st_ito_torch.train import param as tparam

    cfg = pretext_config()
    model = tparam.ParamEstimator(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(inputs["pretext_sd"])
    return tparam.make_state(model, cfg)


def stft_loss_case(mesh):
    """The multi-resolution STFT loss of a batch of 4 (its spectral
    convergence's norms and its L1 mean global sums inside ``sharded``)
    and its gradient, the rows gathered."""
    from st_ito_torch.ops.losses import multi_resolution_stft_loss
    from st_ito_torch.parallel import all_gather_rows, sharded, shard_rows

    rows = (lambda t: t) if mesh is None else (lambda t: shard_rows(t, mesh))
    pred = torch.from_numpy(audio((4, 2, 4096), 30))
    target = torch.from_numpy(audio((4, 2, 4096), 31))
    p = rows(pred).clone().requires_grad_(True)
    with sharded(mesh):
        loss = multi_resolution_stft_loss(p, rows(target))
    loss.backward()
    grad = p.grad if mesh is None else all_gather_rows(p.grad, mesh)
    return {"loss": loss.detach(), "grad": grad}


def pretext_case(inputs, mesh, around=None):
    from st_ito_torch.train import param as tparam

    step = tparam.make_param_train_step(pretext_config(), mesh)
    return run_steps(pretext_state(inputs), step, pretext_batch,
                     torch.Generator().manual_seed(11), around)


def style_system():
    from st_ito_torch.train import style as tstyle

    return tstyle.StyleTransferSystem(style_config(), device="cpu")


def style_case(inputs, mesh, around=None):
    from st_ito_torch.train import style as tstyle

    system = style_system()
    model = tstyle.StyleModel(system.cfg, system.num_params,
                              torch.Generator().manual_seed(0))
    model.load_state_dict(inputs["style_sd"])
    return run_steps(system.make_state(model), system.make_train_step(mesh),
                     style_batch, torch.Generator().manual_seed(5), around)


def batch_refusal(inputs, mesh):
    """The message of a pretext step on a batch of 3, or None."""
    from st_ito_torch.train import param as tparam

    batch = {k: torch.from_numpy(v) for k, v in pretext_batch(0, 3).items()}
    return _raises(lambda: tparam.make_param_train_step(
        pretext_config(), mesh)(pretext_state(inputs), batch, None))


def train_cases(inputs, mesh, folder):
    return {"bn": bn_case(mesh), "stft_loss": stft_loss_case(mesh),
            "pretext": pretext_case(inputs, mesh),
            "style": style_case(inputs, mesh),
            "batch_indivisible": batch_refusal(inputs, mesh)}


SUITES = {"es": ("pop", es_cases), "train": ("data", train_cases)}


def main(suite, rank, world, folder):
    import torch.distributed as dist

    from st_ito_torch.parallel import make_mesh

    torch.set_num_threads(1)
    axis, cases = SUITES[suite]
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(folder, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    try:
        mesh = make_mesh(world, axis, device="cpu")
        path = os.path.join(folder, "inputs.pt")
        inputs = (torch.load(path, weights_only=False)
                  if os.path.exists(path) else {})
        out = cases(inputs, mesh, folder)
        torch.save(out, os.path.join(folder, f"results.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
