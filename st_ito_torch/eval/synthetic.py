"""Synthetic known-target evaluation and objective scoring — port of
``st_ito_tpu/eval/synthetic.py``.

Targets rendered from known parameters at easy, medium and hard
difficulty; each method's output is scored with the multi-resolution STFT
loss and the style similarity against the target. The targets render on
``device`` (default the card) through the per-candidate renderer
(``build_render_fn``, plain PyTorch); each method runs where its own
``device`` keyword puts it.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from st_ito_torch.chain import ChainSpec, build_render_fn
from st_ito_torch.eval.metrics import style_similarity
from st_ito_torch.ops.losses import multi_resolution_stft_loss
from st_ito_torch.utils import resolve_device


def make_synthetic_cases(chain: ChainSpec, x, sample_rate: int = 48000,
                         seed: int = 0, device="cuda") -> list[dict]:
    """Easy/medium/hard x2: targets rendered from known parameter vectors
    whose distance from the chain defaults increases with difficulty
    (numpy's ``default_rng(seed)``, the JAX package's draws). x: (C, T)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    render = build_render_fn(chain, sample_rate, x.shape[0], device=dev)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    w0 = np.asarray(chain.init_params())
    cases = []
    with torch.no_grad():
        for difficulty, scale in (("easy", 0.15), ("medium", 0.3),
                                  ("hard", 0.5)):
            for rep in range(2):
                w = np.clip(w0 + rng.uniform(-scale, scale, w0.shape), 0, 1)
                y = render(torch.as_tensor(w, dtype=torch.float32), x)
                cases.append({
                    "name": f"{difficulty}_{rep}",
                    "difficulty": difficulty,
                    "w_target": w,
                    "target": y.cpu().numpy(),
                })
    return cases


def evaluate_outputs(outputs: dict, target, model, embed_func,
                     sample_rate: int = 48000, device="cuda") -> dict:
    """outputs: method -> (1, C, T). Returns per-method {mrstft,
    style_sim} against target (C, T)."""
    dev = resolve_device(device)
    with torch.no_grad():
        t = torch.as_tensor(target, dtype=torch.float32, device=dev)[None]
        target_embeds = embed_func(t, model, sample_rate)
        results = {}
        for name, y in outputs.items():
            y = torch.as_tensor(y, dtype=torch.float32, device=dev)
            mrstft = float(multi_resolution_stft_loss(y, t))
            e = embed_func(y, model, sample_rate)
            sim = float(style_similarity(e, target_embeds).mean())
            results[name] = {"mrstft": mrstft, "style_sim": sim}
    return results


def run_synthetic_benchmark(chain: ChainSpec, x, methods: dict, model,
                            embed_func, sample_rate: int = 48000,
                            out_path: str | None = None, seed: int = 0,
                            device="cuda") -> dict:
    """Every method (name -> {"func", "kwargs"}, called as
    ``func(x[None], target[None], sample_rate, **kwargs)`` and returning
    ``output_audio``) on every synthetic case, scored by
    ``evaluate_outputs``; written to ``out_path`` as JSON when given."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    cases = make_synthetic_cases(chain, x, sample_rate, seed, dev)
    results = {}
    for case in cases:
        target = torch.as_tensor(case["target"], device=dev)[None]
        outputs = {}
        for mname, method in methods.items():
            out = method["func"](x[None], target, sample_rate,
                                 **method.get("kwargs", {}))
            outputs[mname] = out["output_audio"]
        results[case["name"]] = evaluate_outputs(
            outputs, case["target"], model, embed_func, sample_rate, dev)
        results[case["name"]]["w_target"] = case["w_target"].tolist()
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2, default=float)
    return results
