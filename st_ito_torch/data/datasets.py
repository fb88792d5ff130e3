"""Streaming shard datasets with host-side augmentation + prefetch — port
of ``st_ito_tpu/data/datasets.py``: host numpy with the same numpy draws,
so a seed gives the JAX package's batches bit for bit. The trainer copies
each batch to the card (yielded batches are views into reused scratch).

As in the JAX package (reference: st_ito/dataset/dataset_param.py:40-237):
- shards are visited in random order, examples within a shard shuffled
- independent random crops of input and output (reference: :176-201)
- per-side random gain 0..-32 dB (reference: :218-227)
- random LR channel flip (reference: :230-232)
- ``num_workers`` decodes shards in a thread pool feeding a bounded batch
  queue — the analog of the reference's DataLoader ``num_workers`` +
  ``tarfile_worker_init_fn`` (dataset_param.py:313-341); npz member reads
  and f16->f32 conversion release the GIL, so workers overlap on multicore
  hosts
- crops are sliced from the stored float16 BEFORE widening to float32, so
  decode bandwidth scales with the crop length, not the stored length
- ``prefetch_batches`` overlaps host batch assembly with device compute via
  a background thread.
"""

from __future__ import annotations

import glob
import json
import os
import queue
import threading
from typing import Iterator

import numpy as np

from st_ito_torch.utils import phase_timer


class NpzShardDataset:
    """Pretext dataset over .npz shards written by generate_pretext_dataset."""

    def __init__(
        self,
        shard_dir: str,
        length: int = 262144,
        batch_size: int = 32,
        seed: int = 0,
        random_gain: bool = True,
        random_flip: bool = True,
        independent_crops: bool = True,
        num_workers: int = 0,
        buffer_batches: int = 8,
        use_native: bool | None = None,
        decode_threads: int = 4,
    ):
        self.paths = sorted(
            p for p in glob.glob(os.path.join(shard_dir, "shard_*.npz"))
            if not p.endswith("_logits.npz"))
        if not self.paths:
            raise FileNotFoundError(f"no shards in {shard_dir}")
        index_path = os.path.join(shard_dir, "index.json")
        self.meta = {}
        if os.path.isfile(index_path):
            with open(index_path) as f:
                self.meta = json.load(f)
        self.length = length
        self.batch_size = batch_size
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._epoch = 0  # mixed into parallel worker seeds per __iter__
        self.random_gain = random_gain
        self.random_flip = random_flip
        self.independent_crops = independent_crops
        self.num_workers = num_workers
        self.buffer_batches = buffer_batches
        self.decode_threads = decode_threads
        if use_native is None:
            # the JAX package's host rule: the native decode where the
            # library builds (which decode ran is ``self.use_native``)
            from st_ito_torch.native.io import io_available

            use_native = io_available()
        self.use_native = use_native
        # Reused decode scratch (triple-buffered by shard counter): a fresh
        # allocation per shard costs first-touch page faults. Yielded batches are VIEWS into these buffers, valid until the
        # shard after next — fine for bounded prefetch (<= 1 shard deep).
        self._byte_scratch: dict = {}
        self._f32_scratch: dict = {}
        self._shard_counter = 0

    def _bytes_buf(self, side: str):
        from st_ito_torch.native.io import ByteScratch

        # keyed per worker thread: parallel shard decodes must not share
        key = (side, threading.get_ident(), self._shard_counter % 3)
        if key not in self._byte_scratch:
            self._byte_scratch[key] = ByteScratch()
        return self._byte_scratch[key]

    def _f32_buf(self, side: str, shape) -> np.ndarray:
        key = (side, threading.get_ident(), self._shard_counter % 3, shape)
        if key not in self._f32_scratch:
            self._f32_scratch[key] = np.empty(shape, np.float32)
        return self._f32_scratch[key]

    def _decode(self, inputs, outputs, rng, order=None):
        """Crop + widen + gain + flip for one shard.

        Crop positions and gains are drawn independently for inputs and
        outputs (reference: dataset_param.py:176-201, 218-227); the LR flip
        is drawn ONCE per example and applied to both sides jointly
        (reference: dataset_param.py:230-232 — flipping only one side
        would break the channel correspondence of the pair).

        With the native engine available, the whole decode runs as one
        multithreaded C++ pass per side (csrc/stito_io.cpp
        stito_decode_shard) — the Python path is GIL-bound numpy."""
        n, chs, T = inputs.shape
        L = self.length
        gains_i = gains_o = None
        if self.random_gain:
            gains_i = (10.0 ** (-rng.random(n) * 32.0 / 20.0)).astype(
                np.float32)
            gains_o = (10.0 ** (-rng.random(n) * 32.0 / 20.0)).astype(
                np.float32)
        flips = None
        if self.random_flip and chs == 2:
            flips = rng.random(n) < 0.5

        def draw_starts():
            if T <= L:
                return np.zeros(n, np.int64)
            if self.independent_crops:
                return rng.integers(0, T - L, n).astype(np.int64)
            return np.full(n, int(rng.integers(0, T - L)), np.int64)

        si, so = draw_starts(), draw_starts()

        if (self.use_native and T >= L and inputs.dtype == np.float16
                and outputs.dtype == np.float16):
            from st_ito_torch.native.io import decode_shard

            inputs = decode_shard(inputs, si, gains_i, flips, L,
                                  self.decode_threads, order=order,
                                  out=self._f32_buf("in", (n, chs, L)))
            outputs = decode_shard(outputs, so, gains_o, flips, L,
                                   self.decode_threads, order=order,
                                   out=self._f32_buf("out", (n, chs, L)))
            return inputs, outputs

        if order is not None:  # non-native path shuffles up front
            inputs, outputs = inputs[order], outputs[order]

        def one(x, starts, gains):
            if T < L:
                y = np.zeros((n, chs, L), np.float32)
                y[..., :T] = x
            else:
                y = np.stack([np.asarray(x[i, :, s:s + L], np.float32)
                              for i, s in enumerate(starts)])
            if gains is not None:
                y = y * gains[:, None, None]
            if flips is not None:
                y[flips] = y[flips][:, ::-1, :]
            return y

        return one(inputs, si, gains_i), one(outputs, so, gains_o)

    def _shard_batches(self, path: str, rng) -> Iterator[dict]:
        """Decode one shard into full batches (the per-worker unit). The
        shuffle is fused into the native decode (no permuted copies of the
        stored float16 arrays)."""
        self._shard_counter += 1
        native = self.use_native
        with np.load(path) as d:
            if native:
                from st_ito_torch.native.io import npz_member_into

                # zero-copy views into reused byte scratch
                inputs = npz_member_into(path, "inputs",
                                         self._bytes_buf("in"))
                outputs = npz_member_into(path, "outputs",
                                          self._bytes_buf("out"))
            else:
                inputs = d["inputs"]
                outputs = d["outputs"]
            inst = d["instance_index"]
            pre = d["preset_index"]
            tar = d["tar_index"]
            perm = rng.permutation(len(inputs))
            inst, pre, tar = inst[perm], pre[perm], tar[perm]
        # precomputed AST logits for the adversarial "classifier" mode
        # (scripts/label_audio.py; reference: dataset_param.py:88-93)
        logits = None
        logits_path = path[:-4] + "_logits.npz"
        if os.path.isfile(logits_path):
            with np.load(logits_path) as dl:
                logits = dl["logits"][perm].astype(np.float32)

        inputs, outputs = self._decode(inputs, outputs, rng, order=perm)

        batch = {
            "inputs": inputs, "outputs": outputs,
            "instance_index": inst.astype(np.int32),
            "preset_index": pre.astype(np.int32),
            "tar_index": tar.astype(np.int32),
        }
        if logits is not None:
            batch["content_logits"] = logits
        n = len(batch["inputs"])
        full = (n // self.batch_size) * self.batch_size
        for s in range(0, full, self.batch_size):
            yield {k: v[s:s + self.batch_size] for k, v in batch.items()}
        if full < n:
            yield {k: v[full:] for k, v in batch.items()}  # partial (merged)

    def _iter_sequential(self) -> Iterator[dict]:
        order = self.rng.permutation(len(self.paths))
        carry: dict | None = None
        for pi in order:
            for batch in self._shard_batches(self.paths[pi], self.rng):
                if carry is not None:
                    # merge only keys present on BOTH sides: a shard dir
                    # with partially-present *_logits.npz siblings must
                    # degrade to label-free batches, not KeyError or
                    # misaligned content_logits rows
                    batch = {k: np.concatenate([carry[k], batch[k]])
                             for k in batch if k in carry}
                    carry = None
                n = len(batch["inputs"])
                if n < self.batch_size:
                    carry = batch
                    continue
                full = (n // self.batch_size) * self.batch_size
                for s in range(0, full, self.batch_size):
                    yield {k: v[s:s + self.batch_size]
                           for k, v in batch.items()}
                if full < n:
                    carry = {k: v[full:] for k, v in batch.items()}

    def _iter_parallel(self) -> Iterator[dict]:
        """Thread-pool shard decoding (reference DataLoader-workers analog).
        Each worker owns a seeded RNG; partial tail batches are dropped
        (like drop_last)."""
        path_q: queue.Queue = queue.Queue()
        for pi in self.rng.permutation(len(self.paths)):
            path_q.put(self.paths[pi])
        out_q: queue.Queue = queue.Queue(maxsize=self.buffer_batches)
        _DONE = object()
        self._epoch += 1
        epoch = self._epoch  # fresh crops/gains/flips every epoch

        def worker(wid: int):
            rng = np.random.default_rng([self.seed, epoch, wid])
            try:
                while True:
                    try:
                        path = path_q.get_nowait()
                    except queue.Empty:
                        break
                    for batch in self._shard_batches(path, rng):
                        if len(batch["inputs"]) == self.batch_size:
                            out_q.put(batch)
            finally:
                out_q.put(_DONE)

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        done = 0
        while done < len(threads):
            item = out_q.get()
            if item is _DONE:
                done += 1
                continue
            yield item

    def __iter__(self) -> Iterator[dict]:
        if self.num_workers and self.num_workers > 1:
            return self._iter_parallel()
        return self._iter_sequential()


class StyleShardDataset:
    """Style triplets (input, output, params); input_only mode for the
    on-the-fly trainer (reference: dataset_style.py:85-93)."""

    def __init__(self, shard_dir: str, length: int = 131072,
                 batch_size: int = 16, seed: int = 0,
                 input_only: bool = False):
        self.paths = sorted(glob.glob(os.path.join(shard_dir, "shard_*.npz")))
        if not self.paths:
            raise FileNotFoundError(f"no shards in {shard_dir}")
        self.length = length
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.input_only = input_only

    def __iter__(self) -> Iterator[dict]:
        order = self.rng.permutation(len(self.paths))
        for pi in order:
            with np.load(self.paths[pi]) as d:
                T = d["inputs"].shape[-1]
                if T > self.length:
                    s = int(self.rng.integers(0, T - self.length))
                    sl = slice(s, s + self.length)
                else:
                    sl = slice(None)
                inputs = np.asarray(d["inputs"][..., sl], np.float32)
                outputs = np.asarray(d["outputs"][..., sl], np.float32)
                params = d["params"].astype(np.float32)
            perm = self.rng.permutation(len(inputs))
            inputs, outputs, params = inputs[perm], outputs[perm], params[perm]
            for s in range(0, len(inputs) - self.batch_size + 1, self.batch_size):
                bsl = slice(s, s + self.batch_size)
                batch = {"input_audio": inputs[bsl], "target_params": params[bsl]}
                if self.input_only:
                    batch["target_audio"] = inputs[bsl]  # rendered on the fly
                else:
                    batch["target_audio"] = outputs[bsl]
                yield batch


def prefetch_batches(iterable, buffer_size: int = 2) -> Iterator:
    """Run the (host-side) batch iterator in a background thread; an
    exception there is raised here, after the batches made before it."""
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    _END = object()
    failed: list = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # handed to the consumer
            failed.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        with phase_timer.host_span("loader_wait"):
            item = q.get()
        if item is _END:
            break
        yield item
    if failed:
        raise failed[0]
