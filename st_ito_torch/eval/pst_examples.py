"""PST benchmark example sets: the curated real pairs, the contrived
styled pairs and a self-contained synthetic set — port of
``st_ito_tpu/eval/pst_examples.py``.

- real examples: 10 curated (input, target) WAV pairs per mode, of which
  the benchmark uses 4 "active" indices; the files come from the
  benchmark's YouTube dataset.
- contrived examples: DAPS (speech) and MUSDB (music) sources rendered to
  the four production styles, paired neutral -> styled, in the reference's
  directory layout.
- synthetic: the same four styles rendered by ``eval/cls.py render_style``
  on any audio, for a machine where neither dataset exists.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# (input, target) WAV pairs per mode and the benchmark's active indices
REAL_EXAMPLES: dict[str, tuple[list[tuple[str, str]], list[int]]] = {
    "speech": ([
        ("speech/0YY7K7Xa5rE.wav", "speech/ASU_wpcB-1I.wav"),
        ("speech/GqPGXG5TlZw.wav", "speech/bPYtvBDMoT8.wav"),
        ("speech/Hd9pHZC7Sak.wav", "speech/sNDyQ5wdV7Y.wav"),
        ("speech/kCc8FmEb1nY.wav", "speech/-QqTwJzi7Wo.wav"),
        ("speech/njqx9QHqQnI.wav", "speech/rp18gXVZiws.wav"),
        ("speech/VkBEQDYCpeo.wav", "speech/KmHe_QUCATQ.wav"),
        ("speech/dtp6b76pMak.wav", "speech/505UazMNgLg.wav"),
        ("speech/tI0uvIgh3e8.wav", "speech/DxOIZ4sOQAw.wav"),
        ("speech/YxLm0jmazq8.wav", "speech/nyxcO2vdcCg.wav"),
        ("speech/6PZGOzYUMh4.wav", "speech/4aSHovdnCyY.wav"),
    ], [0, 1, 4, 5]),
    "guitar": ([
        ("guitar/q7dd3PAUpqE.wav", "guitar/1MxfbKkX7Zg.wav"),
        ("guitar/q7dd3PAUpqE.wav", "guitar/5Az0vI2kU8o.wav"),
        ("guitar/9uH5GvurJYc.wav", "guitar/8-lQhm67ZxE.wav"),
        ("guitar/DPGanZQH6L4.wav", "guitar/8_tM8HPkR5w.wav"),
        ("guitar/YDiUYW8gPbE.wav", "guitar/KqNrQw_Ne8w.wav"),
        ("guitar/4cH_Q-uqJhU.wav", "guitar/7Mv-Et66FS4.wav"),
        ("guitar/_xybjiuD9K0.wav", "guitar/DPGanZQH6L4.wav"),
        ("guitar/MmUX2ZKhn_Q.wav", "guitar/KqNrQw_Ne8w.wav"),
        ("guitar/BLrJSfrgYGI.wav", "guitar/ko8G5hkGqvc.wav"),
        ("guitar/Fwnj5n1SdxY.wav", "guitar/wglmFyQPL4o.wav"),
    ], [0, 2, 3, 4]),
    "vocals": ([
        ("vocals/I_QWegHp-r0.wav", "vocals/-o_MW5vifL8.wav"),
        ("vocals/n8cRTh4GEYg.wav", "vocals/CI2a5BxEIV0.wav"),
        ("vocals/IyJ34F3tjG0.wav", "vocals/UGiEw22GI-4.wav"),
        ("vocals/PGS0UvbCwGk.wav", "vocals/U1kifTk5xsU.wav"),
        ("vocals/QP37fZmj-XY.wav", "vocals/CI2a5BxEIV0.wav"),
        ("vocals/ScQISlpnjoQ.wav", "vocals/-o_MW5vifL8.wav"),
        ("vocals/Slhrbuil8Yo.wav", "vocals/w1vxWWD1j50.wav"),
        ("vocals/U1kifTk5xsU.wav", "vocals/w1vxWWD1j50.wav"),
        ("vocals/UKyuxmgir2w.wav", "vocals/uOWK-ArhziU.wav"),
        ("vocals/uOWK-ArhziU.wav", "vocals/Wbuj60Ew2p4.wav"),
    ], [0, 2, 3, 9]),
    "music": ([
        ("music/wXhTHyIgQ_U.wav", "music/PAa2KuxXSYw.wav"),
        ("music/TUVcZfQe-Kw.wav", "music/qku2WZ7aRYw.wav"),
        ("music/1JNmz17gnMw.wav", "music/R-MSfd2S7lo.wav"),
        ("music/UqyT8IEBkvY.wav", "music/TUVcZfQe-Kw.wav"),
        ("music/wXhTHyIgQ_U.wav", "music/UqyT8IEBkvY.wav"),
        ("music/ylXk1LBvIqU.wav", "music/ORxKWb8kKz8.wav"),
        ("music/7nJRGARveVc.wav", "music/1JNmz17gnMw.wav"),
        ("music/HAIDqt2aUek.wav", "music/dhNfddJRulQ.wav"),
        ("music/HMO-gn2qrnc.wav", "music/HAIDqt2aUek.wav"),
        ("music/IL-6hwW4ViA.wav", "music/LwHWGnhg3o4.wav"),
    ], [5, 6, 7, 8]),
}

CONTRIVED_STYLES = ("bright", "broadcast", "telephone", "warm")

# the chain preset of each benchmark mode (the reference runs "general" for
# every mode; the per-content chains map to chain_preset names)
MODE_CHAINS = {
    "speech": "speech",
    "guitar": "guitar",
    "vocals": "vocals",
    "music": "mastering",
    "general": "general",
}


def _conform(audio: np.ndarray, sr: int, sample_rate: int,
             max_length: int | None) -> np.ndarray:
    """(C, T) float32 at ``sample_rate`` (``ops/resample.py``, on the CPU),
    stereo, optionally truncated."""
    from st_ito_torch.ops.resample import resample

    if audio.ndim == 1:
        audio = audio[None]
    if sr != sample_rate:
        audio = resample(torch.as_tensor(audio, dtype=torch.float32), sr,
                         sample_rate).numpy()
    if audio.shape[0] == 1:
        audio = np.concatenate([audio, audio], axis=0)
    if max_length and audio.shape[-1] > max_length:
        audio = audio[..., :max_length]
    return audio.astype(np.float32)


def load_real_examples(root_dir: str, mode: str, all_examples: bool = False,
                       sample_rate: int = 48000,
                       max_length: int | None = None) -> list[dict]:
    """The curated real pairs of ``mode`` from the benchmark dataset's
    directory, as ``run_pst_benchmark`` examples [{"name", "input",
    "target"}]: only the benchmark's active indices unless
    ``all_examples``."""
    from st_ito_torch.utils import load_audio

    pairs, indices = REAL_EXAMPLES[mode]
    chosen = range(len(pairs)) if all_examples else indices
    examples = []
    for i in chosen:
        in_rel, tgt_rel = pairs[i]
        x, sr_x = load_audio(os.path.join(root_dir, in_rel))
        y, sr_y = load_audio(os.path.join(root_dir, tgt_rel))
        examples.append({
            "name": f"{mode}_{i}",
            "input": _conform(x, sr_x, sample_rate, max_length),
            "target": _conform(y, sr_y, sample_rate, max_length),
        })
    return examples


def contrived_example_paths(mode: str, root_dir: str,
                            index_range=range(80, 100)
                            ) -> list[tuple[str, str]]:
    """(neutral, styled) path pairs in the reference's directory layout."""
    if mode == "music":
        dataset_name, sub = "musdb18_44100", "musdb18_44100_styles_100/test"
    elif mode == "speech":
        dataset_name, sub = "cleanraw", "daps_24000_styles_100/test"
    else:
        raise ValueError(f"Unknown contrived mode: {mode}")
    pairs = []
    base = f"{dataset_name}_test.wav"
    for style in CONTRIVED_STYLES:
        for n in index_range:
            pairs.append((
                os.path.join(root_dir, sub, "neutral", f"{n:03d}_neutral_{base}"),
                os.path.join(root_dir, sub, style, f"{n:03d}_{style}_{base}"),
            ))
    return pairs


def load_contrived_examples(root_dir: str, mode: str,
                            sample_rate: int = 48000,
                            max_length: int | None = None,
                            index_range=range(80, 100)) -> list[dict]:
    from st_ito_torch.utils import load_audio

    examples = []
    for in_path, tgt_path in contrived_example_paths(mode, root_dir,
                                                     index_range):
        x, sr_x = load_audio(in_path)
        y, sr_y = load_audio(tgt_path)
        style = os.path.basename(os.path.dirname(tgt_path))
        n = os.path.basename(tgt_path).split("_")[0]
        examples.append({
            "name": f"{mode}_{style}_{n}",
            "input": _conform(x, sr_x, sample_rate, max_length),
            "target": _conform(y, sr_y, sample_rate, max_length),
        })
    return examples


def synthesize_contrived_examples(sources, sample_rate: int = 48000,
                                  styles=CONTRIVED_STYLES,
                                  device="cuda") -> list[dict]:
    """Each (C, T) source rendered to each style on ``device``
    (``eval/cls.py render_style``), peak-normalised to 0.9, and paired
    neutral input -> styled target (numpy arrays)."""
    from st_ito_torch.eval.cls import render_style
    from st_ito_torch.utils import resolve_device

    dev = resolve_device(device)
    examples = []
    for i, src in enumerate(sources):
        x = torch.as_tensor(np.asarray(src, np.float32), device=dev)
        if x.shape[0] == 1:
            x = torch.cat([x, x], dim=0)
        for style in styles:
            y = render_style(x, style, sample_rate)
            y = y / torch.clamp_min(y.abs().max(), 1e-8) * 0.9
            examples.append({
                "name": f"synthetic_{style}_{i}",
                "input": x.cpu().numpy(),
                "target": y.cpu().numpy(),
            })
    return examples


def benchmark_chain(mode_or_type: str, with_bypass: bool = True):
    """The chain of a benchmark run: a MODE_CHAINS key or a chain_preset
    name."""
    from st_ito_torch.chain import chain_preset

    name = MODE_CHAINS.get(mode_or_type, mode_or_type)
    return chain_preset(name, with_bypass=with_bypass)
