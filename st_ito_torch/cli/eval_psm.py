"""PSM benchmark CLI — port of ``st_ito_tpu/cli/eval_psm.py``:

    python -m st_ito_torch.cli.eval_psm --audio-dir dir_of_wavs \\
        [--metrics param mfcc mir] [--num-examples 32] \\
        [--out results/psm.json] [--plot results/psm.png] [--device cuda]

Without --audio-dir, synthesized test signals are used. ``--device``
(default ``cuda``) is where the quadruplets render and embed; ``--plot``
needs matplotlib.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def _load_sources(audio_dir, max_files=16):
    from st_ito_torch.utils import load_audio

    return [load_audio(path)[0] for path in sorted(
        glob.glob(os.path.join(audio_dir, "*.wav")))[:max_files]]


def _synth_sources(n=4, T=131072, sr=48000):
    """n stereo signals of three decaying partials, the JAX CLI's."""
    out = []
    t = np.arange(T) / sr
    for i in range(n):
        r = np.random.default_rng(i)
        x = sum(np.sin(2 * np.pi * 98 * (i + 1) * k * t + r.random() * 6) * a
                for k, a in [(1, 1), (2, .5), (3, .33)])
        x *= np.exp(-((t % 0.3) / 0.1))
        out.append(np.stack([x, np.roll(x, 40)]).astype(np.float32) * 0.6)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--audio-dir", type=str, default=None)
    parser.add_argument("--metrics", nargs="+", default=["param", "mfcc"])
    parser.add_argument("--num-examples", type=int, default=32)
    parser.add_argument("--num-distractors", type=int, default=3)
    parser.add_argument("--out", type=str, default="results/psm.json")
    parser.add_argument("--plot", type=str, default="")
    parser.add_argument("--allow-random-model", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from st_ito_torch.eval.metrics import METRICS
    from st_ito_torch.eval.psm import run_psm_benchmark
    from st_ito_torch.models.registry import load_param_model
    from st_ito_torch.utils import resolve_device

    dev = resolve_device(args.device)
    sources = (_load_sources(args.audio_dir) if args.audio_dir
               else _synth_sources())

    metrics = {}
    for name in args.metrics:
        load_fn, embed_fn = METRICS[name]
        model = (load_param_model(allow_random=args.allow_random_model,
                                  device=dev)
                 if name == "param" else load_fn())
        metrics[name] = (model, embed_fn)

    results = run_psm_benchmark(
        sources, metrics, out_path=args.out, num_examples=args.num_examples,
        num_distractors=args.num_distractors, device=dev)
    for cond, per_metric in results.items():
        for m, res in per_metric.items():
            accs = res["accuracy_by_distractors"]
            print(f"{cond:14s} {m:8s} " + "  ".join(
                f"d={d}:{a:.2f}" for d, a in sorted(accs.items())))
    if args.plot:
        from st_ito_torch.eval.plots import plot_psm_results

        plot_psm_results(results, args.plot)
    print(f"results written to {args.out}")
    return results


if __name__ == "__main__":
    main()
