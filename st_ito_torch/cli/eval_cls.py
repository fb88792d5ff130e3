"""Style-classification eval CLI — port of ``st_ito_tpu/cli/eval_cls.py``:

    python -m st_ito_torch.cli.eval_cls [--audio-dir DIR] \\
        [--metrics param mfcc] [--per-style 8] [--length 131072] \\
        [--out results/cls.json] [--allow-random-model] [--device cuda]

Without --audio-dir, synthesized sources are used. ``--device`` (default
``cuda``) is where the styles render, the clips embed and the probe
trains.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--audio-dir", type=str, default=None)
    parser.add_argument("--metrics", nargs="+", default=["param", "mfcc"])
    parser.add_argument("--per-style", type=int, default=8)
    parser.add_argument("--length", type=int, default=131072)
    parser.add_argument("--out", type=str, default="results/cls.json")
    parser.add_argument("--allow-random-model", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from st_ito_torch.cli.eval_psm import _load_sources, _synth_sources
    from st_ito_torch.eval.cls import (STYLES, make_style_dataset,
                                       run_probe_task, run_zero_shot_task)
    from st_ito_torch.eval.metrics import METRICS
    from st_ito_torch.models.registry import load_param_model
    from st_ito_torch.utils import resolve_device

    dev = resolve_device(args.device)
    sources = (_load_sources(args.audio_dir) if args.audio_dir
               else _synth_sources(T=2 * args.length))
    clips, labels = make_style_dataset(sources, per_style=args.per_style,
                                       length=args.length, device=dev)

    results = {}
    for name in args.metrics:
        load_fn, embed_fn = METRICS[name]
        model = (load_param_model(allow_random=args.allow_random_model,
                                  device=dev)
                 if name == "param" else load_fn())
        results[name] = {
            "zero_shot_acc": run_zero_shot_task(clips, labels, model,
                                                embed_fn, device=dev),
            "probe_acc": run_probe_task(clips, labels, model, embed_fn,
                                        device=dev),
            "chance": 1.0 / len(STYLES),
        }
        print(f"{name}: zero-shot {results[name]['zero_shot_acc']:.3f}  "
              f"probe {results[name]['probe_acc']:.3f}  "
              f"(chance {results[name]['chance']:.3f})")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"results written to {args.out}")
    return results


if __name__ == "__main__":
    main()
