"""On-the-fly contrastive similarity dataset — port of
``st_ito_tpu/data/sim.py``: the same numpy draws, the paired renders by
``build_batched_render_fn(fast=True)`` per registry effect on ``device``
(default the card).

Quadruplets (a, b, a_out, b_out): two different audio clips, the SAME random
effect with the SAME random parameters applied to both
(reference: st_ito/dataset/dataset_sim.py:189-255).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from st_ito_torch.chain import EFFECT_REGISTRY, ChainSpec
from st_ito_torch.chain.executor import build_batched_render_fn
from st_ito_torch.utils import resolve_device


class SimilarityDataset:
    def __init__(
        self,
        audio_sources: list[np.ndarray],
        effect_names: list[str] | None = None,
        length: int = 131072,
        batch_size: int = 8,
        sample_rate: int = 48000,
        seed: int = 0,
        min_gain_db: float = -12.0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.sources = audio_sources
        self.names = effect_names or sorted(EFFECT_REGISTRY.keys())
        self.length = length
        self.batch_size = batch_size
        self.sample_rate = sample_rate
        self.rng = np.random.default_rng(seed)
        self.min_gain_db = min_gain_db
        self._renders = {}
        for name in self.names:
            chain = ChainSpec(stages=(EFFECT_REGISTRY[name](),),
                              with_bypass=False)
            self._renders[name] = (
                chain,
                build_batched_render_fn(chain, sample_rate, 2, fast=True,
                                        device=self.device),
            )

    def _crop(self, audio: np.ndarray) -> np.ndarray:
        C, T = audio.shape
        L = self.length
        if T <= L:
            out = np.zeros((C, L), audio.dtype)
            out[:, :T] = audio
        else:
            s = int(self.rng.integers(0, T - L))
            out = audio[:, s:s + L]
        if out.shape[0] == 1:
            out = np.repeat(out, 2, axis=0)
        return out

    def __iter__(self) -> Iterator[dict]:
        while True:
            name = self.names[int(self.rng.integers(0, len(self.names)))]
            chain, render = self._renders[name]
            B = self.batch_size
            W = self.rng.random((B, chain.num_params)).astype(np.float32)

            ia = self.rng.integers(0, len(self.sources), B)
            ib = self.rng.integers(0, len(self.sources), B)
            a = np.stack([self._crop(self.sources[int(i)]) for i in ia])
            b = np.stack([self._crop(self.sources[int(i)]) for i in ib])

            # random per-item gains (reference applies random gains per clip)
            for arr in (a, b):
                g_db = self.rng.uniform(self.min_gain_db, 0.0, B)
                arr *= (10.0 ** (g_db / 20.0))[:, None, None]

            Wt = torch.from_numpy(W)
            with torch.no_grad():
                a_out = render(Wt, torch.from_numpy(
                    np.ascontiguousarray(a, np.float32))).cpu().numpy()
                b_out = render(Wt, torch.from_numpy(
                    np.ascontiguousarray(b, np.float32))).cpu().numpy()
            yield {
                "a": a, "b": b, "a_out": a_out, "b_out": b_out,
                "effect": name, "params": W,
            }
