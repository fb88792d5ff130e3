"""The readings that a cell's limits are set from, on the card, several
seeds in one process: for each seed a run as the benchmark makes it (its
window ``--seconds`` long) with the program's numbers, and on the first
``--control`` seeds the control's numbers (the reference one precision
step below the configuration's, in the program's place; for an ITO cell
also its render alone and its embed alone) and the faults' (ITO: the
search's state left unchanged, half the population scored; training: the
reference with half the batch left out of the loss, or with one example's
label altered, in the program's place). ``--set key=value`` overrides a
configuration or traffic key (``config.head_centring=0.5``).

    python3 portbench/readings.py --workload <cell> --seeds 11,12,13 --seconds 10 --control 3

One JSON line a seed and reading on standard output."""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.core import bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--set", action="append", default=[])
    args = ap.parse_args(argv)
    overrides = {k: json.loads(v) for k, v in
                 (item.split("=", 1) for item in args.set)}
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        ctx = bench.make_context(args.workload, seed, args.seconds, False, dev,
                                 overrides=overrides)
        driver = bench.load_module("drivers", ctx["traffic"]["driver"])
        state = driver.setup(ctx)
        rec = driver.window(ctx, state)
        driver.release(state)
        torch.cuda.empty_cache()
        out = {"seed": seed, "attempted": rec["attempted"]}
        if ctx["traffic"]["driver"] == "ito":
            out["program"] = driver.check(ctx, state, rec)
            if i < args.control:
                for mode in driver.MODES[1:]:
                    out[mode] = driver.check(ctx, state, rec, mode=mode)
            f = driver.program_fitness(rec["jobs"][0]["probe"],
                                       ctx["traffic"]["popsize"],
                                       driver.chunks_of(ctx), dev)
            out["fitness_spread"] = [float(np.std(fg)) for fg in f]
            d = rec["_detail"]["program"]
            out["worst"] = {n: sorted([t for t in d if t[1] == n],
                                      key=lambda t: -t[0])[:3]
                            for n in ("fitness_gap", "render_gap")}
        else:
            out.update(train_readings(driver, ctx, state, i < args.control))
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


def train_readings(driver, ctx, state, control: bool) -> dict:
    import shutil

    out = {}
    try:
        want = driver.reference_steps(ctx, state)
        out["program"] = driver.gaps(state["warm"], want)
        if control:
            out["control"] = driver.gaps(driver.reference_steps(
                ctx, state, dtype=torch.float32, allow_tf32=True), want)
            half = ctx["config"]["batch_size"] // 2
            out["fault_half_batch"] = driver.gaps(driver.reference_steps(
                ctx, state, rows=slice(half, None)), want)
            out["fault_label"] = driver.gaps(driver.reference_steps(
                ctx, state, alter_label=True), want)
            out["fault_unchanged"] = driver.gaps(
                {**want, "change": {k: 0.0 for k in want["change"]}}, want)
    finally:
        shutil.rmtree(state["folder"], ignore_errors=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
