"""Pretext shards made from the run's seed with the benchmark's own code,
in the layout ``NpzShardDataset`` reads: ``shard_XXXX.npz`` with
``inputs`` and ``outputs`` (n, 2, T) float16 and ``instance_index``,
``preset_index``, ``tar_index`` (n,) int32.

An input is program material (``audio.program_audio``) and its output the
same clip through an FFT-domain tilt and a tanh drive (``audio.styled``);
the labels are uniform. Made on the card in blocks, written once."""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench.core import audio


def write(folder: str, seed: int, examples: int, per_shard: int, T: int,
          sr: int, num_instances: int, num_presets: int, device) -> list[str]:
    os.makedirs(folder, exist_ok=True)
    gen = audio.generator(seed, 7, device=device)
    paths = []
    for s in range(0, examples, per_shard):
        n = min(per_shard, examples - s)
        ins, outs = [], []
        for i in range(n):
            g = audio.generator(seed, 11, s + i, device=device)
            x = audio.program_audio(g, 2, T, sr, device)
            ins.append(x.to(torch.float16).cpu().numpy())
            outs.append(audio.styled(x, g, sr).to(torch.float16).cpu().numpy())
        inst = torch.randint(0, num_instances, (n,), generator=gen,
                             device=device).to(torch.int32).cpu().numpy()
        pre = torch.randint(0, num_presets, (n,), generator=gen,
                            device=device).to(torch.int32).cpu().numpy()
        path = os.path.join(folder, f"shard_{s // per_shard:04d}.npz")
        np.savez(path, inputs=np.stack(ins), outputs=np.stack(outs),
                 instance_index=inst, preset_index=pre,
                 tar_index=np.zeros(n, np.int32))
        paths.append(path)
    return paths
