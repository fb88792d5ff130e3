"""PST benchmark CLI — port of ``st_ito_tpu/cli/eval_pst.py``:

    python -m st_ito_torch.cli.eval_pst [--examples-dir DIR] \\
        [--dataset-type real|contrived --root-dir DIR [--mode music]] \\
        [--chain general] [--popsize 128] [--max-iters 32] \\
        [--metrics param mfcc] [--output-dir output/pst] \\
        [--allow-random-model] [--device cuda]

--examples-dir holds pairs <name>_input.wav / <name>_target.wav;
--dataset-type loads the reference benchmark's curated sets from
--root-dir (``eval/pst_examples.py``). Without either, two synthesized
pairs are used (a self-contained benchmark). ``--device`` (default
``cuda``) is where every method and metric runs. The figure
(``pst_plot.png`` in the output directory) is drawn where matplotlib is
installed; without it the CLI says so and draws none.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import os

import numpy as np


def _load_examples(examples_dir):
    from st_ito_torch.utils import load_audio

    examples = []
    for ip in sorted(glob.glob(os.path.join(examples_dir, "*_input.wav"))):
        name = os.path.basename(ip)[: -len("_input.wav")]
        tp = os.path.join(examples_dir, f"{name}_target.wav")
        if not os.path.isfile(tp):
            continue
        x, _ = load_audio(ip)
        y, _ = load_audio(tp)
        examples.append({"name": name, "input": x, "target": y})
    return examples


def _synth_examples(chain, sr=48000, T=262144, n=2, device="cuda"):
    """n pairs, the JAX CLI's: an input of enveloped partials, and a target
    of other partials rendered through ``chain`` at a setting drawn from
    numpy's ``default_rng(100 + i)`` with every stage on (the per-candidate
    renderer on ``device``)."""
    import torch

    from st_ito_torch.chain import build_render_fn
    from st_ito_torch.utils import resolve_device

    dev = resolve_device(device)
    render = build_render_fn(chain, sr, 2, device=dev)
    t = np.arange(T) / sr
    examples = []
    for i in range(n):
        r = np.random.default_rng(i)
        x = sum(np.sin(2 * np.pi * 147 * (i + 1) * k * t + r.random() * 6) * a
                for k, a in [(1, 1), (2, .5), (3, .33), (5, .15)])
        x *= np.exp(-((t % 0.35) / 0.12))
        x = np.stack([x, np.roll(x, 60)]).astype(np.float32) * 0.6
        w = np.random.default_rng(100 + i).uniform(
            0.15, 0.85, chain.num_params).astype(np.float32)
        for _, start, _ in chain.stage_slices():
            if chain.with_bypass:
                w[start] = 0.0
        r2 = np.random.default_rng(i + 50)
        x2 = sum(np.sin(2 * np.pi * 220 * (i + 1) * k * t + r2.random() * 6) * a
                 for k, a in [(1, 1), (2, .5), (3, .33)])
        x2 = np.stack([x2, np.roll(x2, 40)]).astype(np.float32) * 0.6
        y = render(torch.from_numpy(w), torch.from_numpy(x2)).cpu().numpy()
        examples.append({"name": f"synthetic{i}", "input": x, "target": y})
    return examples


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--examples-dir", type=str, default=None)
    parser.add_argument("--dataset-type", type=str, default=None,
                        choices=["real", "contrived"],
                        help="load the reference benchmark's curated example "
                             "sets from --root-dir (eval/pst_examples.py)")
    parser.add_argument("--mode", type=str, default="music",
                        choices=["speech", "guitar", "vocals", "music"])
    parser.add_argument("--root-dir", type=str, default=None,
                        help="the benchmark dataset's root directory")
    parser.add_argument("--all-examples", action="store_true",
                        help="all 10 curated pairs, not just the benchmark's "
                             "4 active indices")
    parser.add_argument("--chain", type=str, default="general",
                        choices=["general", "simple", "speech", "mastering",
                                 "vocals", "guitar", "basic"])
    parser.add_argument("--popsize", type=int, default=128)
    parser.add_argument("--max-iters", type=int, default=32)
    parser.add_argument("--metrics", nargs="+", default=["param", "mfcc"])
    parser.add_argument("--output-dir", type=str, default="output/pst")
    parser.add_argument("--allow-random-model", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from st_ito_torch.chain import basic_chain, chain_preset
    from st_ito_torch.eval.metrics import METRICS
    from st_ito_torch.eval.plots import plot_pst_results
    from st_ito_torch.eval.pst import default_methods, run_pst_benchmark
    from st_ito_torch.models.registry import get_param_embeds, load_param_model
    from st_ito_torch.utils import resolve_device

    dev = resolve_device(args.device)
    chain = (basic_chain() if args.chain == "basic"
             else chain_preset(args.chain))

    model = load_param_model(allow_random=args.allow_random_model, device=dev)
    metrics = {}
    for name in args.metrics:
        load_fn, embed_fn = METRICS[name]
        metrics[name] = ((model if name == "param" else load_fn()), embed_fn)

    if args.dataset_type == "real":
        from st_ito_torch.eval.pst_examples import load_real_examples

        examples = load_real_examples(args.root_dir, args.mode,
                                      all_examples=args.all_examples)
    elif args.dataset_type == "contrived":
        from st_ito_torch.eval.pst_examples import load_contrived_examples

        examples = load_contrived_examples(args.root_dir, args.mode)
    elif args.examples_dir:
        examples = _load_examples(args.examples_dir)
    else:
        examples = _synth_examples(chain, device=dev)
    methods = default_methods(chain, model, get_param_embeds,
                              popsize=args.popsize, max_iters=args.max_iters,
                              device=dev)
    results = run_pst_benchmark(examples, methods, metrics,
                                output_dir=args.output_dir, device=dev)
    if importlib.util.find_spec("matplotlib") is None:
        print("pst_plot.png not drawn: matplotlib is not installed")
    else:
        plot_pst_results(results,
                         os.path.join(args.output_dir, "pst_plot.png"),
                         metric_key=args.metrics[0])
    for ex, per_method in results.items():
        for m, e in per_method.items():
            sims = "  ".join(f"{k}={v:+.4f}" for k, v in e.items()
                             if k.endswith("_sim"))
            print(f"{ex:12s} {m:12s} {sims}  t={e['time_elapsed']:.1f}s")
    return results


if __name__ == "__main__":
    main()
