"""BENCHMARK.json against the contract's form, and every configuration,
traffic, metric reader and kernel count found by name."""

import json
import os
import re

import pytest

from portbench.core import bench

SPEC = bench.load_json(bench.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    n = 24  # the time a full check takes with the most cells allowed
    assert n * (14 * (SPEC["run_seconds"] + 60) + 180) + 2 * (
        SPEC["run_seconds"] + 60) + 1200 <= 43200


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"])
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    data = bench.load_json(bench.ROOT, cfg["file"])
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] == 1
    assert len(cell["why"]) <= 200
    traffic = bench.load_json(bench.HERE, "workloads",
                              f"{cell['traffic']}.json")
    assert os.path.isfile(os.path.join(bench.HERE, "drivers",
                                       f"{traffic['driver']}.py"))
    driver = bench.load_module("drivers", traffic["driver"])
    for fn in ("setup", "window", "release", "check"):
        assert callable(getattr(driver, fn))
    assert traffic["limits"], "every number compared has a limit"
    e2e = [m["name"] for m in bench.for_cell(SPEC["end_to_end"], cell["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert bench.for_cell(SPEC["per_layer"], cell["name"])


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    reader = bench.load_module("metrics", metric["name"])
    assert callable(reader.read)
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert set(metric["workloads"]) <= set(next(
            m for m in SPEC["end_to_end"] if m["name"] == metric["moves"]
        ).get("workloads", cells))


@pytest.mark.parametrize("kernel", ["k1", "k3", "k4", "k6", "k8", "k9"])
def test_kernel_counts_found_by_name(kernel):
    assert callable(bench.load_module("counts", kernel).per_launch)


def test_file_is_small():
    assert os.path.getsize(os.path.join(bench.ROOT, "BENCHMARK.json")) < 65536
    json.dumps(SPEC)
