"""Whole runs of the harness on the CPU at a tiny size: the result line has
the contract's form, the readers read what they should, and the command
refuses to run without a card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import SMALL_ITO, SMALL_TRAIN
from portbench.core import bench

CPU = torch.device("cpu")


def run(cell, overrides, trace=False, seconds=0.5, seed=2 ** 31 + 5):
    ctx = bench.make_context(cell, seed, seconds, trace, CPU,
                             overrides=overrides)
    return bench.run_cell(ctx, time.perf_counter())


def assert_form(line, metric_names):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == set(metric_names)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


@pytest.mark.parametrize("cell", ["ito-basic-p512", "ito-style-p512"])
def test_ito_line(cell):
    line, checks = run(cell, SMALL_ITO)
    # no device metric is read off the CPU: the memory peak is the card's
    assert_form(line, ["evals_per_s", "setup_s"])
    assert line["device"]["platform"] == "cpu"
    assert line["correct"], checks
    assert set(checks) == {"fitness_gap", "render_gap", "output_gap"}


def test_ito_traced_line_reads_host_metrics_only():
    line, _ = run("ito-basic-p512", SMALL_ITO, trace=True)
    # on the CPU the trace holds no device operation, the spans are not
    # recorded and no kernel launches: only the host clock's share reads
    assert_form(line, ["job_overhead_pct"])
    assert line["device"]["busy_s"] == 0.0


def test_train_line():
    line, checks = run("pretext-b32", SMALL_TRAIN, seconds=1.0)
    assert_form(line, ["train_examples_per_s", "setup_s"])
    assert line["correct"], checks
    assert set(checks) == {"loss_gap", "grad_gap", "change_gap"}


def test_train_traced_line():
    line, _ = run("pretext-b32", SMALL_TRAIN, trace=True, seconds=1.0)
    assert_form(line, ["data_wait_pct"])


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run(
        [sys.executable, os.path.join(bench.HERE, "run.py"), "--workload",
         "ito-basic-p512", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=bench.ROOT, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
