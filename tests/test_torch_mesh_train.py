"""Training over a mesh (axis "data"): a gloo group of 2 ranks on the CPU
(``torch_mesh_ranks``, one group for the module) against world size 1 of
the port (the path without a group) and against st_ito_tpu's own steps on
``st_ito_tpu.parallel.make_mesh(2, "data")``: the global-batch
BatchNorm's forward and backward, the multi-resolution STFT loss (the
style step's audio loss) on global sums, two pretext steps with the
adversary (the Cnn14 of ``test_torch_train_param``, global batch 4) and
two style steps (the parameter-regression loss, on-the-fly targets
through the simple processor, split sections; global batch 2). Both
packages start from the JAX init's weights; the port's draws of world
size 1 (SpecAugment, dropout, the gains and the on-the-fly parameters)
are handed to the JAX steps (``torch_train_draws``), jitted once with the
draws as arguments (``reference_jit``).

Against world size 1, the JAX mesh test's limits
(``tests/test_train_param.py::test_train_step_sharded_matches_single``):
every metric of every step within 1e-4 relative, the pretext heads'
output weights within 1e-5 after the first step, and the BatchNorm
running statistics within 1e-5; the first step's all-reduced gradients
within 1e-4 (relative L2 over all parameters), and both ranks' states
equal after every step. Later steps' weights are not held elementwise:
Adam's first step moves an element whose gradient is rounding noise by a
whole lr, in a direction the rounding picks (ROADMAP §3). Against the JAX
mesh, the limits of the port's own trainer tests: every metric within
1e-4 relative, the BatchNorm buffers within 1e-4 relative L2.
"""

import contextlib
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_ranks as ranks  # noqa: E402
from torch_train_draws import (reference_jit, record_draws,  # noqa: E402
                               replay_draws)

from st_ito_tpu.models.cnn14 import Cnn14Config as JaxCnn14Config
from st_ito_tpu.parallel import make_mesh as jax_make_mesh
from st_ito_tpu.train import param as jparam
from st_ito_tpu.train import style as jstyle

from st_ito_torch.models.convert import (flatten_params,
                                         param_estimator_state_dict_from_jax,
                                         style_system_state_dict_from_jax)
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

torch.set_num_threads(1)


def _jax_states():
    pcfg = jparam.ParamEstimatorConfig(
        encoder=JaxCnn14Config(**ranks.PRETEXT_ENCODER), lr=1e-4,
        num_instances=5, num_presets=3, weight_decay=1e-2,
        embed_mode="concat", num_adv_classes=4, adv_logits_type="dataset",
        adv_weight=0.5)
    scfg = jstyle.StyleTransferConfig(
        encoder=JaxCnn14Config(**ranks.STYLE_ENCODER), lr=1e-5,
        analysis_length=ranks.STYLE_T, weight_decay=1e-2,
        loss_type="parameter-regression",
        autodiff_processor="simple", on_the_fly=True, split_section=True)
    system = jstyle.StyleTransferSystem(scfg)
    key = jax.random.PRNGKey(0)
    return (pcfg, reference_jit(jparam.init_param_estimator,
                                static_argnums=1)(key, pcfg),
            system, reference_jit(system.init)(key))


def _traced(step):
    """step(state, batch, key) under the port's draws passed as traced
    arguments: one compile for every step."""
    @partial(reference_jit, static_argnums=0)
    def run(kinds, values, state, batch):
        with replay_draws(list(zip(kinds, values))):
            return step(state, batch, jax.random.PRNGKey(7))

    return lambda draws, state, batch: run(
        tuple(k for k, _ in draws), [jnp.asarray(v) for _, v in draws],
        state, batch)


def _jax_steps(step, state, batches, draws, mesh):
    """The steps on the mesh, the state replicated over it from the
    start (so that the second step reuses the first step's compile)."""
    state = jax.device_put(state, NamedSharding(mesh, PartitionSpec()))
    metrics, states = [], []
    for i, d in enumerate(draws):
        batch = {k: jnp.asarray(v) for k, v in batches(i).items()}
        state, m = step(d, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(flatten_params(state.params))
    return metrics, states


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    folder = tmp_path_factory.mktemp("mesh_train")
    pcfg, pstate, system, sstate = _jax_states()
    inputs = {"pretext_sd": param_estimator_state_dict_from_jax(
        pstate.params), "style_sd": style_system_state_dict_from_jax(
        sstate.params)}
    torch.save(inputs, folder / "inputs.pt")
    group = ranks.start("train", 2, folder)
    try:
        draws = {"pretext": [], "style": []}

        def around(name):
            @contextlib.contextmanager
            def recorder(g):
                with record_draws(g) as d:
                    yield
                draws[name].append(d)

            return recorder

        ws1 = {"bn": ranks.bn_case(None),
               "stft_loss": ranks.stft_loss_case(None),
               "pretext": ranks.pretext_case(inputs, None, around("pretext")),
               "style": ranks.style_case(inputs, None, around("style")),
               "batch_indivisible": ranks.batch_refusal(inputs, None)}
        mesh = jax_make_mesh(2, "data")
        want = {
            "pretext": _jax_steps(
                _traced(jparam.make_param_train_step(pcfg, mesh=mesh)),
                pstate, ranks.pretext_batch, draws["pretext"], mesh),
            "style": _jax_steps(_traced(system.make_train_step(mesh=mesh)),
                                sstate, ranks.style_batch, draws["style"],
                                mesh)}
        ws2 = group.wait()
    finally:
        group.kill()
    return {"ws2": ws2, "ws1": ws1, "jax": want}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _metrics_close(got, want, rel=1e-4):
    assert got.keys() <= want.keys() or want.keys() <= got.keys()
    for k in set(got) & set(want):
        assert abs(got[k] - want[k]) <= rel * max(abs(want[k]), 1e-3), (
            k, got[k], want[k])


def test_global_stft_loss_and_its_gradient(runs):
    """The audio loss over the ranks is one process's on the whole batch
    (its spectral convergence is a ratio of norms over the batch, not a
    mean of the rows'), on every rank; each rank's gradient is world size
    times its rows' share, as the BatchNorm's is."""
    (r0, r1), want = [r["stft_loss"] for r in runs["ws2"]], runs["ws1"][
        "stft_loss"]
    assert torch.equal(r0["loss"], r1["loss"])
    np.testing.assert_allclose(r0["loss"], want["loss"], rtol=1e-6)
    np.testing.assert_allclose(r0["grad"] / 2, want["grad"], rtol=1e-5,
                               atol=1e-7 * float(want["grad"].abs().max()))


def test_global_batchnorm_forward_and_backward(runs):
    """Train-mode BatchNorm over the ranks equals one process's on the
    whole batch: the outputs, the input gradients (a rank's loss is its
    rows' mean, so its gradient carries the world size), the parameters'
    averaged gradients, and one update of the running statistics (the
    frozen forward updates nothing), the unbiased global variance in the
    running variance."""
    got, want = runs["ws2"][0]["bn"], runs["ws1"]["bn"]
    np.testing.assert_allclose(got["y"], want["y"], atol=1e-6)
    np.testing.assert_allclose(got["x_grad"] / 2, want["x_grad"],
                               atol=1e-7)
    for k in ("weight_grad", "bias_grad", "running_mean", "running_var"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    assert int(got["num_batches_tracked"]) == 1
    x = ranks.bn_inputs()["x"].double()
    var = x.var(dim=(0, 2, 3), unbiased=True)
    np.testing.assert_allclose(got["running_var"], 0.9 + 0.1 * var,
                               rtol=1e-5)


@pytest.mark.parametrize("case", ["pretext", "style"])
def test_ranks_hold_one_state(runs, case):
    r0, r1 = runs["ws2"]
    for s0, s1 in zip(r0[case]["states"], r1[case]["states"]):
        for k in s0:
            assert torch.equal(s0[k], s1[k]), k
    assert r0[case]["metrics"] == r1[case]["metrics"]
    assert torch.equal(r0[case]["generator_after"],
                       r1[case]["generator_after"])


@pytest.mark.parametrize("case,head", [
    ("pretext", "instance_estimator.fc2.weight"), ("style", None)])
def test_step_matches_world_size_1(runs, case, head):
    """(The style steps run at lr 1e-5, where every element's first Adam
    step is about 1e-5: their heads' weights say nothing at atol 1e-5, so
    their gradients carry the check.)"""
    got, want = runs["ws2"][0][case], runs["ws1"][case]
    for g_, w_ in zip(got["metrics"], want["metrics"]):
        _metrics_close(g_, w_)
    names = sorted(got["grads"])
    assert _rel(torch.cat([got["grads"][n].ravel() for n in names]),
                torch.cat([want["grads"][n].ravel() for n in names])) <= 1e-4
    s1, w1 = got["states"][0], want["states"][0]
    if head is not None:
        np.testing.assert_allclose(s1[head], w1[head], atol=1e-5)
    for k in s1:
        if "running" in k:
            np.testing.assert_allclose(s1[k], w1[k], atol=1e-5, err_msg=k)
    assert torch.equal(got["generator_after"], want["generator_after"])


@pytest.mark.parametrize("case", ["pretext", "style"])
def test_step_matches_the_jax_mesh(runs, case):
    got = runs["ws2"][0][case]
    jmetrics, jstates = runs["jax"][case]
    assert len(jmetrics) == len(got["metrics"]) == ranks.STEPS
    for g_, w_ in zip(got["metrics"], jmetrics):
        _metrics_close(g_, w_)
    for state, jst in zip(got["states"], jstates):
        for k, w in jst.items():
            if "running" in k:
                assert _rel(state[k], w) <= 1e-4, k


def test_indivisible_batch_raises(runs):
    msg = runs["ws2"][0]["batch_indivisible"]
    assert msg is not None and "axis of 3 does not split over 2 ranks" in msg
    assert runs["ws1"]["batch_indivisible"] is None
