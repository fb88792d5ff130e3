"""Dataset synthesis on the card — port of ``st_ito_tpu/data/datagen.py``:
the same numpy draws in the same order, the same shard layout,
``index.json`` and float16 audio.

Pretext dataset (reference: scripts/data/vst_datagen_mp.py): each example
is (input clip, the clip rendered through a random (instance, preset)
pair, instance index, preset index, source-dataset index). Each instance
renders through ``build_batched_render_fn(fast=True)`` on ``device``
(default the card) in fixed sub-batches of ``examples_per_shard``, so the
single-effect chains run on the port's kernels: a lone EQ on K6, the
compressor on K7, the gate's and the multiband's detectors on K8, the
phaser's allpasses on K11, delay and reverb on K3 -> K4.

Style dataset (reference: scripts/data/vst_datagen_style.py): input/output/
params triplets through a full chain with random parameters, rendered per
item by ``build_render_fn``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from st_ito_torch.chain import ChainSpec
from st_ito_torch.chain.executor import build_batched_render_fn, build_render_fn
from st_ito_torch.data.presets import PresetBank
from st_ito_torch.utils import resolve_device


def _nonsilent_crop(rng, audio: np.ndarray, length: int,
                    silence_db: float = -48.0, max_tries: int = 10):
    """Random crop rejecting silent regions
    (reference: st_ito/dataset/dataset_sim.py:61-108)."""
    C, T = audio.shape
    if T <= length:
        out = np.zeros((C, length), audio.dtype)
        out[:, :T] = audio
        return out
    for _ in range(max_tries):
        s = int(rng.integers(0, T - length))
        crop = audio[:, s:s + length]
        if 20 * np.log10(max(np.sqrt(np.mean(crop**2)), 1e-10)) > silence_db:
            return crop
    return crop


def generate_pretext_dataset(
    audio_sources: list[np.ndarray],
    bank: PresetBank,
    out_dir: str,
    num_examples: int,
    length: int = 262144,
    examples_per_shard: int = 64,
    sample_rate: int = 48000,
    seed: int = 0,
    source_dataset_ids: list[int] | None = None,
    device="cuda",
) -> list[str]:
    """audio_sources: list of (C, T) float arrays (decoded audio files).
    Returns list of shard paths."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)

    renders = {
        i: build_batched_render_fn(bank.chain_for(i), sample_rate, 2,
                                   fast=True, peak_normalize_output=False,
                                   device=dev)
        for i in range(bank.num_instances)}

    # Render per instance, then shuffle everything across instances before
    # writing shards: shards must be class-mixed or training batches become
    # class-pure (the reference picks a random tar per example,
    # dataset_param.py:109-125).
    all_in, all_out, all_inst, all_pre, all_tar = [], [], [], [], []
    inst_ids = rng.integers(0, bank.num_instances, num_examples)
    for inst in range(bank.num_instances):
        n = int((inst_ids == inst).sum())
        if n == 0:
            continue
        preset_idx = rng.integers(0, bank.num_presets, n)
        P = int(bank.param_counts[inst])
        W = bank.presets[inst, preset_idx, :P]
        src_ids = rng.integers(0, len(audio_sources), n)
        inputs = np.stack([
            _nonsilent_crop(rng, audio_sources[int(s)], length) for s in src_ids
        ])
        if inputs.shape[1] == 1:
            inputs = np.repeat(inputs, 2, axis=1)
        # fixed-size sub-batches (the tail padded with its last example):
        # every instance renders at one shape
        outs = []
        for s in range(0, n, examples_per_shard):
            Wb = W[s:s + examples_per_shard]
            Xb = inputs[s:s + examples_per_shard]
            nb = len(Wb)
            if nb < examples_per_shard:
                padn = examples_per_shard - nb
                Wb = np.concatenate([Wb, np.tile(Wb[-1:], (padn, 1))])
                Xb = np.concatenate([Xb, np.tile(Xb[-1:], (padn, 1, 1))])
            with torch.no_grad():
                y = renders[inst](
                    torch.from_numpy(np.ascontiguousarray(Wb, np.float32)),
                    torch.from_numpy(np.ascontiguousarray(Xb, np.float32)))
            outs.append(y[:nb].cpu().numpy())
        outputs = np.concatenate(outs)
        peaks = np.abs(outputs).max(axis=(-2, -1), keepdims=True)
        outputs = outputs / np.maximum(peaks, 1e-8)
        all_in.append(inputs.astype(np.float16))
        all_out.append(outputs.astype(np.float16))
        all_inst.append(np.full(n, inst, np.int32))
        all_pre.append(preset_idx.astype(np.int32))
        all_tar.append(
            np.asarray([source_dataset_ids[int(s)] for s in src_ids], np.int32)
            if source_dataset_ids is not None else np.zeros(n, np.int32))

    inputs = np.concatenate(all_in)
    outputs = np.concatenate(all_out)
    inst_arr = np.concatenate(all_inst)
    pre_arr = np.concatenate(all_pre)
    tar_arr = np.concatenate(all_tar)
    perm = rng.permutation(len(inputs))

    shard_paths = []
    for shard_idx, s in enumerate(range(0, len(perm), examples_per_shard)):
        sel = perm[s:s + examples_per_shard]
        path = os.path.join(out_dir, f"shard_{shard_idx:05d}.npz")
        np.savez(
            path,
            inputs=inputs[sel], outputs=outputs[sel],
            instance_index=inst_arr[sel], preset_index=pre_arr[sel],
            tar_index=tar_arr[sel],
        )
        shard_paths.append(path)

    with open(os.path.join(out_dir, "index.json"), "w") as f:
        json.dump({
            "kind": "pretext",
            "num_examples": num_examples,
            "length": length,
            "sample_rate": sample_rate,
            "num_instances": bank.num_instances,
            "num_presets": bank.num_presets,
            "instance_names": bank.instance_names,
            "shards": [os.path.basename(p) for p in shard_paths],
        }, f, indent=2)
    return shard_paths


def generate_style_dataset(
    audio_sources: list[np.ndarray],
    chain: ChainSpec,
    out_dir: str,
    num_examples: int,
    length: int = 131072,
    examples_per_shard: int = 64,
    sample_rate: int = 48000,
    seed: int = 0,
    device="cuda",
) -> list[str]:
    """Input/output/params triplets through the full chain with random params."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    render = build_render_fn(chain, sample_rate, 2,
                             peak_normalize_output=False, device=dev)

    shard_paths = []
    shard_idx = 0
    remaining = num_examples
    while remaining > 0:
        n = min(examples_per_shard, remaining)
        W = rng.random((n, chain.num_params)).astype(np.float32)
        src_ids = rng.integers(0, len(audio_sources), n)
        inputs = np.stack([
            _nonsilent_crop(rng, audio_sources[int(s)], length) for s in src_ids
        ])
        if inputs.shape[1] == 1:
            inputs = np.repeat(inputs, 2, axis=1)
        x = torch.from_numpy(np.ascontiguousarray(inputs, np.float32)).to(dev)
        with torch.no_grad():
            outputs = torch.stack([
                render(torch.from_numpy(W[i]).to(dev), x[i])
                for i in range(n)]).cpu().numpy()

        path = os.path.join(out_dir, f"shard_{shard_idx:05d}.npz")
        np.savez(path, inputs=inputs.astype(np.float16),
                 outputs=outputs.astype(np.float16), params=W)
        shard_paths.append(path)
        shard_idx += 1
        remaining -= n

    with open(os.path.join(out_dir, "index.json"), "w") as f:
        json.dump({
            "kind": "style",
            "num_examples": num_examples,
            "length": length,
            "sample_rate": sample_rate,
            "num_params": chain.num_params,
            "shards": [os.path.basename(p) for p in shard_paths],
        }, f, indent=2)
    return shard_paths
