"""Production Style Transfer (PST) benchmark: methods x metrics, with the
time of each method — port of ``st_ito_tpu/eval/pst.py``.

For every (input, target) example each method produces an output; its
score under a metric is the mean cosine similarity of the output's and
the target's style embeddings. With an ``output_dir`` the outputs, input
and target are written at -22 LUFS beside a timestamped results JSON,
under the JAX package's file names."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from st_ito_torch.eval.metrics import style_similarity
from st_ito_torch.ops.loudness import loudness_normalize
from st_ito_torch.ops.waveshape import fade_in
from st_ito_torch.utils import resolve_device, save_audio


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_pst_benchmark(examples: list[dict], methods: dict, metrics: dict,
                      sample_rate: int = 48000,
                      output_dir: str | None = None,
                      target_lufs: float = -22.0, fade_samples: int = 32768,
                      device="cuda") -> dict:
    """examples: [{"name", "input" (C, T), "target" (C, T)}] as arrays;
    methods: name -> {"func": callable(input, target, sr) -> result dict,
    "kwargs": {...}}, each given (1, C, T) tensors on ``device``;
    metrics: name -> (model, embed_func), the models on ``device``.

    A method's ``time_elapsed`` is the host's wall clock around its call,
    the device synchronised at its end."""
    dev = resolve_device(device)
    results: dict = {}
    for ex in examples:
        name = ex["name"]
        x = torch.as_tensor(np.asarray(ex["input"]), dtype=torch.float32,
                            device=dev)[None]
        y = torch.as_tensor(np.asarray(ex["target"]), dtype=torch.float32,
                            device=dev)[None]
        if fade_samples:
            x = fade_in(x, fade_samples)
            y = fade_in(y, fade_samples)

        target_embeds = {m: embed_func(y, model, sample_rate)
                         for m, (model, embed_func) in metrics.items()}

        results[name] = {}
        for method_name, method in methods.items():
            _sync(dev)
            t0 = time.time()
            out = method["func"](x, y, sample_rate, **method.get("kwargs", {}))
            _sync(dev)
            elapsed = time.time() - t0

            output_audio = torch.as_tensor(out["output_audio"],
                                           dtype=torch.float32, device=dev)
            if output_audio.shape[1] == 1 and x.shape[1] == 2:
                output_audio = torch.cat([output_audio] * 2, dim=1)

            entry = {"time_elapsed": elapsed}
            for m, (model, embed_func) in metrics.items():
                out_embeds = embed_func(output_audio, model, sample_rate)
                sim = style_similarity(out_embeds, target_embeds[m])
                entry[f"{m}_sim"] = float(sim.mean())
            if "params" in out:
                entry["params"] = out["params"]
            results[name][method_name] = entry

            if output_dir:
                ex_dir = os.path.join(output_dir, name)
                os.makedirs(ex_dir, exist_ok=True)
                norm = loudness_normalize(output_audio, sample_rate,
                                          target_lufs)
                save_audio(os.path.join(ex_dir, f"{method_name}.wav"),
                           norm[0], sample_rate)

        if output_dir:
            ex_dir = os.path.join(output_dir, name)
            os.makedirs(ex_dir, exist_ok=True)
            for tag, sig in (("input", x), ("target", y)):
                norm = loudness_normalize(sig, sample_rate, target_lufs)
                save_audio(os.path.join(ex_dir, f"{tag}.wav"), norm[0],
                           sample_rate)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        with open(os.path.join(output_dir, f"results_{stamp}.json"), "w") as f:
            json.dump(results, f, indent=2, default=float)
    return results


def default_methods(chain, model, embed_func, popsize=128, max_iters=32,
                    sigma0=0.33, seed=0, style_systems: dict | None = None,
                    gens_per_dispatch: int = 1, device="cuda"):
    """The reference benchmark's methods: input, random, rule-based and
    style-es (``run_es`` with a random crop and no w0 search), each on
    ``device``. The learned baselines (deepafx-st, deepafx-st+) need
    ``run_learned_inference``, which is ROADMAP §1 item 10: a non-empty
    ``style_systems`` raises."""
    from st_ito_torch.ito import run_es, run_input, run_random, run_rule_based

    if style_systems:
        raise NotImplementedError(
            f"style_systems {sorted(style_systems)}: the learned-inference "
            f"baselines (run_learned_inference) are ROADMAP §1 item 10, not "
            f"ported to st_ito_torch yet")
    dev = resolve_device(device)
    return {
        "input": {"func": lambda x, y, sr: run_input(x, y, sr)},
        "random": {"func": lambda x, y, sr: run_random(
            x, y, sr, chain, model, seed=seed, device=dev)},
        "rule-based": {"func": lambda x, y, sr: run_rule_based(
            x, y, sr, device=dev)},
        "style-es": {"func": lambda x, y, sr: run_es(
            x, y, sr, chain, model, embed_func=embed_func,
            max_iters=max_iters, popsize=popsize, sigma0=sigma0,
            random_crop=True, find_w0=False, seed=seed, verbose=False,
            gens_per_dispatch=gens_per_dispatch, device=dev)},
    }
