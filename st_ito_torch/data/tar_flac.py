"""Tar-of-FLAC streaming dataset (the reference's published data format)
— port of ``st_ito_tpu/data/tar_flac.py``, host numpy with the same draws.

The reference's PluginTarfileDataset streams examples out of N tar
archives: a random tar per example, one sequential cursor per tar that
wraps at EOF, each example a directory member holding ``input.flac``, one
or more processed variants, and a ``details.json`` with instance/preset/
dataset ids (reference: st_ito/dataset/dataset_param.py:40-237,
decode via torchaudio/libsndfile). Members decode through the
from-scratch native codec (csrc/stito_io.cpp via native/io.py).

Augmentation matches NpzShardDataset (and the reference): independent
random crops of the pair (dataset_param.py:176-201), per-side random gain
0..-32 dB (:218-227), joint LR flip (:230-232).
"""

from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np


class TarFlacDataset:
    def __init__(
        self,
        tar_paths: list[str],
        length: int = 262144,
        batch_size: int = 32,
        seed: int = 0,
        random_gain: bool = True,
        random_flip: bool = True,
    ):
        from st_ito_torch.native.io import tar_index

        if isinstance(tar_paths, str):
            tar_paths = [tar_paths]
        self.tar_paths = list(tar_paths)
        if not self.tar_paths:
            raise FileNotFoundError("no tar archives given")
        self.length = length
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.random_gain = random_gain
        self.random_flip = random_flip

        # example index per tar: prefix -> {member basename: (offset, size)}
        self.examples: list[list[tuple[str, dict]]] = []
        kept_paths: list[str] = []
        for path in self.tar_paths:
            groups: dict[str, dict] = {}
            for name, off, size in tar_index(path):
                prefix, _, base = name.rpartition("/")
                groups.setdefault(prefix, {})[base] = (off, size)
            ex = [(p, m) for p, m in sorted(groups.items())
                  if "input.flac" in m
                  and any(b.endswith(".flac") and b != "input.flac"
                          for b in m)]
            if ex:
                self.examples.append(ex)
                kept_paths.append(path)
        if not self.examples:
            raise FileNotFoundError("no (input.flac, variant) pairs in tars")
        self.tar_paths = kept_paths
        self._cursors = [0] * len(self.examples)
        self._files = [open(p, "rb") for p in kept_paths]

    def _read(self, ti: int, off: int, size: int) -> bytes:
        f = self._files[ti]
        f.seek(off)
        return f.read(size)

    def _next_example(self, rng):
        from st_ito_torch.native.io import flac_decode

        ti = int(rng.integers(0, len(self.examples)))
        exs = self.examples[ti]
        prefix, members = exs[self._cursors[ti] % len(exs)]
        self._cursors[ti] += 1  # sequential stream; wraps at EOF
        inp, _ = flac_decode(self._read(ti, *members["input.flac"]))
        variants = [b for b in members
                    if b.endswith(".flac") and b != "input.flac"]
        pick = variants[int(rng.integers(0, len(variants)))]
        out, _ = flac_decode(self._read(ti, *members[pick]))
        details = {}
        if "details.json" in members:
            details = json.loads(self._read(ti, *members["details.json"]))
        return inp, out, int(details.get("instance", 0)), \
            int(details.get("preset", 0)), ti

    def _conform(self, x: np.ndarray, start: int) -> np.ndarray:
        L = self.length
        if x.shape[0] == 1:
            x = np.concatenate([x, x], axis=0)  # mono -> stereo
        T = x.shape[-1]
        if T >= L:
            return np.asarray(x[:, start:start + L], np.float32)
        y = np.zeros((x.shape[0], L), np.float32)
        y[:, :T] = x
        return y

    def __iter__(self) -> Iterator[dict]:
        rng = self.rng
        while True:
            ins, outs, insts, pres, tars = [], [], [], [], []
            for _ in range(self.batch_size):
                inp, out, inst, pre, ti = self._next_example(rng)
                for x, acc in ((inp, ins), (out, outs)):
                    T = x.shape[-1]
                    s = int(rng.integers(0, T - self.length)) \
                        if T > self.length else 0
                    acc.append(self._conform(x, s))
                insts.append(inst)
                pres.append(pre)
                tars.append(ti)
            inputs = np.stack(ins)
            outputs = np.stack(outs)
            if self.random_gain:
                inputs *= (10.0 ** (-rng.random(len(inputs)) * 32 / 20)
                           ).astype(np.float32)[:, None, None]
                outputs *= (10.0 ** (-rng.random(len(outputs)) * 32 / 20)
                            ).astype(np.float32)[:, None, None]
            if self.random_flip:
                flip = rng.random(len(inputs)) < 0.5
                inputs[flip] = inputs[flip][:, ::-1, :]
                outputs[flip] = outputs[flip][:, ::-1, :]
            yield {
                "inputs": inputs, "outputs": outputs,
                "instance_index": np.asarray(insts, np.int32),
                "preset_index": np.asarray(pres, np.int32),
                "tar_index": np.asarray(tars, np.int32),
            }

    def close(self):
        for f in self._files:
            f.close()


def export_shards_to_tar(shard_dir: str, out_tar: str,
                         sample_rate: int = 48000, mode: int = 2) -> int:
    """Export an npz shard directory (data/datagen.py output) to the
    reference's published tar-of-FLAC layout: one directory member per
    example with input.flac, proc.flac and details.json
    (reference: st_ito/dataset/dataset_param.py tar format;
    scripts/data/vst_datagen*.py producers). mode 2 = mid/side FLAC.
    Returns the number of exported examples."""
    import glob
    import io as _io
    import tarfile

    import numpy as np

    from st_ito_torch.native.io import flac_encode

    paths = sorted(p for p in glob.glob(os.path.join(shard_dir, "shard_*.npz"))
                   if not p.endswith("_logits.npz"))
    if not paths:
        raise FileNotFoundError(f"no shards in {shard_dir}")
    n = 0
    with tarfile.open(out_tar, "w") as tf:
        for path in paths:
            with np.load(path) as d:
                inputs = np.asarray(d["inputs"], np.float32)
                outputs = np.asarray(d["outputs"], np.float32)
                inst = np.asarray(d["instance_index"])
                pre = np.asarray(d["preset_index"])
                tar_ids = np.asarray(d["tar_index"])
            for i in range(len(inputs)):
                prefix = f"ex{n:06d}"
                members = {
                    f"{prefix}/input.flac":
                        flac_encode(inputs[i], sample_rate, mode=mode),
                    f"{prefix}/proc.flac":
                        flac_encode(outputs[i], sample_rate, mode=mode),
                    f"{prefix}/details.json": json.dumps({
                        "instance": int(inst[i]), "preset": int(pre[i]),
                        "dataset": int(tar_ids[i]),
                    }).encode(),
                }
                for name, payload in members.items():
                    ti = tarfile.TarInfo(name)
                    ti.size = len(payload)
                    tf.addfile(ti, _io.BytesIO(payload))
                n += 1
    return n
