"""The control on the card, at a size a test run holds: the reference one
precision step below the configuration's, put in the program's place, must
fail a limit that a sound run of the program meets. The full-size readings
of PERF.md come from ``portbench/readings.py``.

    python3 -m pytest portbench/tests -m cuda"""

import pytest
import torch

from portbench.core import bench

pytestmark = pytest.mark.cuda


def run_and_release(ctx):
    driver = bench.load_module("drivers", ctx["traffic"]["driver"])
    state = driver.setup(ctx)
    rec = driver.window(ctx, state)
    driver.release(state)
    torch.cuda.empty_cache()
    return driver, state, rec


@pytest.mark.parametrize("cell, samples", [("ito-basic-p512", 262144),
                                           ("ito-style-p512", 262144),
                                           ("ito-long-p128", 2 * 262144)])
def test_ito_control_fails(cuda_device, cell, samples):
    ctx = bench.make_context(cell, 2 ** 31 + 101, 0.1, False, cuda_device,
                             overrides={"traffic.popsize": 64,
                                        "traffic.samples": samples,
                                        "config.max_iters": 3,
                                        "traffic.pool": 1})
    driver, state, rec = run_and_release(ctx)
    limits = ctx["traffic"]["limits"]
    program = driver.check(ctx, state, rec)
    assert all(program[k] <= lim for k, lim in limits.items()), program
    control = driver.check(ctx, state, rec, mode="control")
    assert any(control[k] > lim for k, lim in limits.items()), control


def test_train_control_and_faults_fail(cuda_device):
    ctx = bench.make_context("pretext-b32", 2 ** 31 + 102, 0.1, False,
                             cuda_device,
                             overrides={"config.batch_size": 8,
                                        "traffic.examples": 32,
                                        "traffic.shard_examples": 16})
    driver, state, rec = run_and_release(ctx)
    limits = ctx["traffic"]["limits"]

    def fails(got):
        return any(got[k] > limits[k] for k in limits)

    try:
        want = driver.reference_steps(ctx, state)
        assert not fails(driver.gaps(state["warm"], want))
        assert fails(driver.gaps(driver.reference_steps(
            ctx, state, dtype=torch.float32, allow_tf32=True), want))
        assert fails(driver.gaps(driver.reference_steps(
            ctx, state, rows=slice(4, None)), want))
        assert fails(driver.gaps(driver.reference_steps(
            ctx, state, alter_label=True), want))
    finally:
        import shutil
        shutil.rmtree(state["folder"], ignore_errors=True)
