"""Metric-monotonicity sweep CLI — port of ``st_ito_tpu/cli/eval_sweep.py``:

    python -m st_ito_torch.cli.eval_sweep --effect distortion \\
        --param drive_db [--metric param] [--out results/sweep.json] \\
        [--plot results/sweep.png] [--device cuda]

``--device`` (default ``cuda``) is where the sweep renders and embeds;
``--plot`` needs matplotlib.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--effect", type=str, default="distortion")
    parser.add_argument("--param", type=str, default="drive_db")
    parser.add_argument("--metric", type=str, default="param")
    parser.add_argument("--num-steps", type=int, default=11)
    parser.add_argument("--length", type=int, default=131072)
    parser.add_argument("--out", type=str, default="results/sweep.json")
    parser.add_argument("--plot", type=str, default="")
    parser.add_argument("--allow-random-model", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from st_ito_torch.cli.eval_psm import _synth_sources
    from st_ito_torch.eval.metrics import METRICS
    from st_ito_torch.eval.sweep import sweep_parameter
    from st_ito_torch.models.registry import load_param_model
    from st_ito_torch.utils import resolve_device

    dev = resolve_device(args.device)
    load_fn, embed_fn = METRICS[args.metric]
    model = (load_param_model(allow_random=args.allow_random_model,
                              device=dev)
             if args.metric == "param" else load_fn())

    x = _synth_sources(1, T=args.length)[0]
    res = sweep_parameter(x, args.effect, args.param, model, embed_fn,
                          num_steps=args.num_steps, device=dev)
    print(f"{args.effect}.{args.param}: monotonicity rho = "
          f"{res['monotonicity']:.3f}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    if args.plot:
        from st_ito_torch.eval.plots import plot_sweep_results

        plot_sweep_results({f"{args.effect}.{args.param}": res}, args.plot)
    print(f"results written to {args.out}")
    return res


if __name__ == "__main__":
    main()
