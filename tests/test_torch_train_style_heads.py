"""The port's StyleTransferSystem against st_ito_tpu's, continued:
parameter regression with the 21-parameter processor across both of the
learning-rate schedule's boundaries, parameter classification with the
51-parameter processor and its eval step, and the schedule's boundaries
against ``optax.piecewise_constant_schedule`` (the helpers and limits of
``test_torch_train_style``)."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_train_style import LR, close, make_batch, run_steps, traced  # noqa: E402,E501
from torch_train_draws import record_draws  # noqa: E402

from st_ito_torch.train import style as tstyle
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

torch.set_num_threads(1)


def test_regression_simple_processor_schedule():
    """Parameter regression with the 21-parameter processor across both
    of the schedule's boundaries (total_steps 10: x0.1 from step 8 and
    again from step 9); the learning rate each step as optax's."""
    js, ts, jstate, state = run_steps(10, autodiff_processor="simple",
                                      total_steps=10)
    assert state.opt.param_groups[0]["lr"] == pytest.approx(LR * 0.01)


def test_classification_complex_processor_eval():
    js, ts, jstate, state = run_steps(
        2, loss_type="parameter-classification",
        autodiff_processor="complex", num_bins=8)
    batch = make_batch(np.random.default_rng(4), ts.num_params)
    g = torch.Generator().manual_seed(3)
    with record_draws(g) as draws:
        loss, (metrics, _) = ts.make_eval_step()(
            state.model, {k: torch.from_numpy(v) for k, v in batch.items()},
            g)
    jloss, (jm, _) = traced(js.make_eval_step())(
        draws, jstate.params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(2))
    for k, v in jm.items():
        assert close(metrics[k], v), k


@pytest.mark.parametrize("total", [4, 10, 37, 100])
def test_schedule_boundaries_match_optax(total):
    sched = optax.piecewise_constant_schedule(
        1.0, {int(total * 0.8): 0.1, int(total * 0.95): 0.1})
    scale = tstyle.lr_scale(total)
    for count in range(total + 2):
        assert scale(count) == pytest.approx(float(sched(count)), rel=1e-6)
