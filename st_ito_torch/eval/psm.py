"""Production Style Metric (PSM) benchmark: quadruplet ranking — port of
``st_ito_tpu/eval/psm.py``.

Given (ref, a, b, c, ...) where ``a`` shares the reference's production
style (the same effect and parameters on different content) and the others
are distractors, a metric scores a hit when it ranks ``a`` closest to
``ref`` by cosine; accuracy is swept over the number of distractors.
Includes the quadruplet generator (the same numpy draws as the JAX
package's) and the reference's on-disk layout. Renders and embeds run on
``device`` (default the card).
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from st_ito_torch.chain import EFFECT_REGISTRY, ChainSpec
from st_ito_torch.chain.executor import build_render_fn
from st_ito_torch.eval.metrics import style_similarity
from st_ito_torch.utils import load_audio, resolve_device, save_audio


def generate_psm_quadruplets(audio_sources: list[np.ndarray],
                             effect_names: list[str] | None = None,
                             num_examples: int = 32,
                             num_distractors: int = 3, length: int = 65536,
                             sample_rate: int = 48000, seed: int = 0,
                             condition: str = "intra-effect",
                             device="cuda") -> list[dict]:
    """Returns a list of {ref, candidates (the first is the match), effect},
    numpy arrays. ``condition``: "intra-effect" (distractors of the same
    effect at other settings) or "inter-effect" (of any effect)."""
    dev = resolve_device(device)
    if effect_names is None:
        effect_names = ["parametric_eq", "compressor", "distortion", "reverb"]
    rng = np.random.default_rng(seed)

    renders = {}
    for name in effect_names:
        chain = ChainSpec(stages=(EFFECT_REGISTRY[name](),),
                          with_bypass=False)
        renders[name] = (chain, build_render_fn(chain, sample_rate, 2,
                                                peak_normalize_output=True,
                                                device=dev))

    def crop(audio):
        T = audio.shape[-1]
        s = int(rng.integers(0, max(T - length, 1)))
        out = audio[:, s:s + length]
        if out.shape[-1] < length:
            out = np.pad(out, ((0, 0), (0, length - out.shape[-1])))
        if out.shape[0] == 1:
            out = np.repeat(out, 2, axis=0)
        return torch.as_tensor(out, dtype=torch.float32, device=dev)

    def params(n):
        return torch.from_numpy(rng.random(n).astype(np.float32))

    examples = []
    with torch.no_grad():
        for _ in range(num_examples):
            name = effect_names[int(rng.integers(0, len(effect_names)))]
            chain, render = renders[name]
            w_style = params(chain.num_params)

            src_ref, src_other = rng.choice(len(audio_sources), 2,
                                            replace=True)
            x_ref = crop(audio_sources[src_ref])
            x_other = crop(audio_sources[src_other])

            ref = render(w_style, x_ref)
            correct = render(w_style, x_other)

            distractors = []
            for _ in range(num_distractors):
                if condition == "inter-effect":
                    dname = effect_names[int(rng.integers(
                        0, len(effect_names)))]
                    dchain, drender = renders[dname]
                    distractors.append(drender(params(dchain.num_params),
                                               x_other))
                else:
                    distractors.append(render(params(chain.num_params),
                                              x_other))

            examples.append({
                "ref": ref.cpu().numpy(),
                "candidates": [c.cpu().numpy()
                               for c in [correct] + distractors],
                "effect": name,
            })
    return examples


def evaluate_metric_on_quadruplets(examples: list[dict], model, embed_func,
                                   sample_rate: int = 48000,
                                   max_distractors: int | None = None,
                                   device="cuda") -> dict:
    """Accuracy against the number of distractors: a hit when the match
    ranks first among it and the first d distractors."""
    dev = resolve_device(device)
    n_cand = len(examples[0]["candidates"])
    max_d = max_distractors or (n_cand - 1)
    correct_by_d = {d: 0 for d in range(1, max_d + 1)}

    with torch.no_grad():
        for ex in examples:
            batch = torch.as_tensor(np.stack([ex["ref"]] + ex["candidates"]),
                                    dtype=torch.float32, device=dev)
            embeds = embed_func(batch, model, sample_rate)
            ref_e = {k: v[0:1] for k, v in embeds.items()}
            cand_e = {k: v[1:] for k, v in embeds.items()}
            sims = style_similarity(cand_e, ref_e).cpu().numpy()
            for d in range(1, max_d + 1):
                if int(np.argmax(sims[:d + 1])) == 0:
                    correct_by_d[d] += 1

    n = len(examples)
    return {
        "accuracy_by_distractors": {d: c / n for d, c in correct_by_d.items()},
        "num_examples": n,
    }


def save_quadruplets_to_disk(examples: list[dict], out_dir: str,
                             sample_rate: int = 48000) -> None:
    """Write quadruplets as per-example directories of ref/a/b/c... WAVs,
    the reference's on-disk PSM layout."""
    for i, ex in enumerate(examples):
        ex_dir = os.path.join(out_dir, f"{ex.get('effect', 'ex')}_{i:04d}")
        os.makedirs(ex_dir, exist_ok=True)
        save_audio(os.path.join(ex_dir, "ref.wav"), ex["ref"], sample_rate)
        for ci, cand in enumerate(ex["candidates"]):
            name = chr(ord("a") + ci)
            save_audio(os.path.join(ex_dir, f"{name}.wav"), cand,
                       sample_rate)


def load_quadruplets_from_disk(root_dir: str) -> list[dict]:
    """Read per-example directories of ref.wav and a/b/c... candidate WAVs
    ('a' is the true match, as in the reference's layout)."""
    examples = []
    for ex_dir in sorted(glob.glob(os.path.join(root_dir, "*"))):
        ref_path = os.path.join(ex_dir, "ref.wav")
        if not os.path.isfile(ref_path):
            continue
        ref, _ = load_audio(ref_path)
        candidates = [load_audio(p)[0] for p in sorted(
            glob.glob(os.path.join(ex_dir, "[a-z].wav")))]
        if candidates:
            examples.append({
                "ref": ref, "candidates": candidates,
                "effect": os.path.basename(ex_dir).rsplit("_", 1)[0],
            })
    return examples


def run_psm_benchmark(audio_sources, metrics: dict,
                      out_path: str | None = None, num_examples: int = 32,
                      num_distractors: int = 3, sample_rate: int = 48000,
                      seed: int = 0, device="cuda") -> dict:
    """metrics: name -> (model, embed_func). Returns the results per
    condition and metric; written to ``out_path`` as JSON when given."""
    results = {}
    for condition in ("intra-effect", "inter-effect"):
        examples = generate_psm_quadruplets(
            audio_sources, num_examples=num_examples,
            num_distractors=num_distractors, sample_rate=sample_rate,
            seed=seed, condition=condition, device=device)
        results[condition] = {}
        for name, (model, embed_func) in metrics.items():
            results[condition][name] = evaluate_metric_on_quadruplets(
                examples, model, embed_func, sample_rate, device=device)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2, default=float)
    return results
