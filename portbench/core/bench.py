"""One run of one cell: set-up, the measured window, the metrics, the
check of what the window produced, and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic
(``workloads/<traffic>.json``, whose ``driver`` names
``drivers/<driver>.py``), and each metric's reader
(``metrics/<metric>.py``, a function ``read(ctx, rec)`` that returns a
number or None when it finds nothing to read).

A driver module has ``setup(ctx) -> state`` (everything up to the window,
warm-up included), ``window(ctx, state) -> rec`` (the measured window;
``rec`` carries ``attempted``, ``failed``, ``window_s`` and what the readers
read), ``release(state)`` (frees the program's state) and ``check(ctx,
state, rec) -> {name: value}`` (the comparison with the plain reference;
the traffic file's ``limits`` name the numbers that decide ``correct``)."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "st_ito_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, by path (names
    may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def for_cell(entries, cell: str):
    return [m for m in entries if cell in m.get("workloads", [cell])]


class Context(dict):
    """What a driver and a reader see: ``cell``, ``seed``, ``seconds``,
    ``trace``, ``device``, ``config``, ``traffic``, ``spec``; and
    ``count(name)``, the module ``counts/<name>.py``."""

    def count(self, name: str):
        cache = self.setdefault("_counts", {})
        if name not in cache:
            cache[name] = load_module("counts", name)
        return cache[name]


def make_context(cell: str, seed: int, seconds: float, trace: bool, device,
                 spec: dict | None = None, overrides: dict | None = None
                 ) -> Context:
    spec = spec or load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    config = load_json(HERE, "configs", f"{entry['config']}.json")
    traffic = load_json(HERE, "workloads", f"{entry['traffic']}.json")
    for key, value in (overrides or {}).items():
        target, field = key.split(".", 1)
        {"config": config, "traffic": traffic}[target][field] = value
    return Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                   device=device, config=config, traffic=traffic, spec=spec,
                   entry=entry)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def read_metrics(ctx: Context, rec: dict) -> dict:
    """The cell's metrics for this mode (end-to-end without a trace,
    per-layer with one), each read by its own reader."""
    entries = for_cell(ctx["spec"]["per_layer" if ctx["trace"]
                                   else "end_to_end"], ctx["cell"])
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(ctx, rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(ctx: Context, t_start: float) -> tuple[dict, dict]:
    """Runs the cell; returns (result line, checks)."""
    import torch

    from portbench.core import trace as tracing

    dev = ctx["device"]
    on_card = dev.type == "cuda"
    driver = load_module("drivers", ctx["traffic"]["driver"])
    state = driver.setup(ctx)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    with tracing.profiled(ctx["trace"]) as prof:
        with torch.profiler.record_function(tracing.WINDOW):
            rec = driver.window(ctx, state)
    rec["setup_s"] = setup_s
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name(dev) if on_card
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(rec["peak_bytes"])}
    line = {}
    if prof is not None:
        red = tracing.reduce(prof)
        rec["trace"] = red
        device["busy_s"] = red["busy_s"]
        device["window_s"] = red["window_s"]
        line["breakdown"] = tracing.breakdown(red)
    metrics = read_metrics(ctx, rec)
    driver.release(state)
    if on_card:
        torch.cuda.empty_cache()
    numbers = driver.check(ctx, state, rec)
    checks = {k: (numbers[k], limit)
              for k, limit in ctx["traffic"]["limits"].items()}
    correct = (rec["failed"] == 0 and rec["attempted"] > 0 and all(
        math.isfinite(v) and v <= limit for v, limit in checks.values()))
    line = {"correct": bool(correct), "attempted": int(rec["attempted"]),
            "failed": int(rec["failed"]), "metrics": metrics,
            "device": device, **line,
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()}}
    return line, checks


def main(argv=None) -> int:
    import argparse

    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_JAX", "0")

    import torch

    spec = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in spec["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < entry["chips"]):
        print(f"needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    ctx = make_context(args.workload, args.seed, args.seconds,
                       bool(args.trace), torch.device("cuda", 0), spec)
    line, checks = run_cell(ctx, t_start)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
