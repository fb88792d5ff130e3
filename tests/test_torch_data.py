"""The port's data pipeline (``st_ito_torch/data``, ``native/io.py``)
against st_ito_tpu's: the shard datasets bit for bit on both decode paths
and in the worker pool, the style and tar-of-FLAC datasets bit for bit,
the native binding's library built into the port's own directory, the
preset bank's accept/reject decisions, and dataset synthesis (indices
exact, audio within the render tolerance plus one float16 ulp)."""

import glob
import os

import numpy as np
import pytest
import torch

from st_ito_tpu.data import datagen as jgen
from st_ito_tpu.data import datasets as jds
from st_ito_tpu.data import presets as jpresets
from st_ito_tpu.data import tar_flac as jtar
from st_ito_tpu.native import io as jio

from st_ito_torch.data import datagen as tgen
from st_ito_torch.data import datasets as tds
from st_ito_torch.data import presets as tpresets
from st_ito_torch.data import tar_flac as ttar
from st_ito_torch.native import io as tio

torch.set_num_threads(1)
SR = 48000


def write_shards(folder, n_shards=3, n=10, T=3000, logits=False, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    for s in range(n_shards):
        path = os.path.join(folder, f"shard_{s:05d}.npz")
        np.savez(path,
                 inputs=(rng.standard_normal((n, 2, T)) * 0.3).astype(
                     np.float16),
                 outputs=(rng.standard_normal((n, 2, T)) * 0.3).astype(
                     np.float16),
                 instance_index=rng.integers(0, 5, n).astype(np.int32),
                 preset_index=rng.integers(0, 3, n).astype(np.int32),
                 tar_index=rng.integers(0, 2, n).astype(np.int32),
                 params=rng.random((n, 4)).astype(np.float32))
        if logits:
            np.savez(path[:-4] + "_logits.npz",
                     logits=rng.standard_normal((n, 6)).astype(np.float16))
    return folder


def batches(ds, k):
    out = []
    for b in ds:
        out.append({key: np.array(v) for key, v in b.items()})
        if len(out) == k:
            break
    return out


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_native_library_builds_in_the_ports_directory():
    path = tio.library_path()
    assert "st_ito_torch_io" in str(path) and tio.io_available()
    assert path.is_file()
    audio = (np.random.default_rng(1).standard_normal((2, 5000)) * 0.3
             ).astype(np.float32)
    for mode in (0, 1, 2, 3):
        data = tio.flac_encode(audio, SR, mode=mode)
        assert data == jio.flac_encode(audio, SR, mode=mode)
        got, sr = tio.flac_decode(data)
        want, _ = jio.flac_decode(data)
        assert sr == SR and np.array_equal(got, want)
        assert tio.flac_info(data) == jio.flac_info(data)


@pytest.mark.parametrize("use_native", [True, False])
def test_npz_shard_dataset_is_bitwise_jax(tmp_path, use_native):
    """Sequential epochs (carry across shards, _logits.npz siblings),
    batch 4 over 3 shards of 10, the length below and above T."""
    folder = write_shards(str(tmp_path / "s"), logits=True)
    for length in (2048, 4000):
        kw = dict(length=length, batch_size=4, seed=3, use_native=use_native)
        got = tds.NpzShardDataset(folder, **kw)
        want = jds.NpzShardDataset(folder, **kw)
        assert got.use_native == use_native
        for _ in range(2):  # two epochs: the rng carries on
            assert_batches_equal(batches(got, 100), batches(want, 100))


def test_npz_shard_dataset_default_decode_is_native(tmp_path):
    folder = write_shards(str(tmp_path / "s"), n_shards=1)
    assert tds.NpzShardDataset(folder).use_native


def test_npz_shard_dataset_workers_are_bitwise_jax(tmp_path):
    """The thread pool: one shard and two workers; the yielded full
    batches are those JAX's worker w (rng [seed, epoch, w]) makes of the
    shard, for the worker that took it."""
    folder = write_shards(str(tmp_path / "s"), n_shards=1)
    kw = dict(length=2048, batch_size=4, seed=5, num_workers=2)
    got = batches(tds.NpzShardDataset(folder, **kw), 100)
    ref = jds.NpzShardDataset(folder, **kw)
    path = glob.glob(os.path.join(folder, "shard_*.npz"))[0]
    options = []
    for wid in range(2):
        rng = np.random.default_rng([5, 1, wid])
        options.append([{k: np.array(v) for k, v in b.items()}
                        for b in ref._shard_batches(path, rng)
                        if len(b["inputs"]) == 4])
    assert len(got) == 2
    assert any(all(all(np.array_equal(g[k], w[k]) for k in w)
                   for g, w in zip(got, opt)) for opt in options)


@pytest.mark.parametrize("input_only", [False, True])
def test_style_shard_dataset_is_bitwise_jax(tmp_path, input_only):
    folder = write_shards(str(tmp_path / "s"))
    kw = dict(length=2048, batch_size=3, seed=2, input_only=input_only)
    assert_batches_equal(batches(tds.StyleShardDataset(folder, **kw), 100),
                         batches(jds.StyleShardDataset(folder, **kw), 100))


def test_prefetch_keeps_order():
    items = list(range(20))
    assert list(tds.prefetch_batches(iter(items))) == items


def test_prefetch_raises_the_loaders_error():
    """An error in the loader's thread reaches the consumer after the
    batches made before it (the training loop would otherwise start a
    fresh epoch forever)."""
    def loader():
        yield 1
        raise KeyError("decode failed")

    got = []
    with pytest.raises(KeyError, match="decode failed"):
        for item in tds.prefetch_batches(loader()):
            got.append(item)
    assert got == [1]


def test_npz_member_header_by_public_readers(tmp_path):
    path = str(tmp_path / "m.npz")
    for arr in (np.arange(12, dtype=np.float16).reshape(3, 4),
                np.zeros((2, 3), np.int32, order="F")):
        np.savez(path, a=arr)
        got = tio.npz_member_into(path, "a", tio.ByteScratch())
        assert got.dtype == arr.dtype and np.array_equal(got, arr)


def test_tar_flac_export_and_dataset_are_bitwise_jax(tmp_path):
    folder = write_shards(str(tmp_path / "s"), n_shards=2, n=3)
    got_tar, want_tar = str(tmp_path / "t.tar"), str(tmp_path / "j.tar")
    assert ttar.export_shards_to_tar(folder, got_tar) == 6
    jtar.export_shards_to_tar(folder, want_tar)
    with open(got_tar, "rb") as a, open(want_tar, "rb") as b:
        assert a.read() == b.read()
    kw = dict(length=2048, batch_size=4, seed=1)
    got = ttar.TarFlacDataset([got_tar], **kw)
    want = jtar.TarFlacDataset([want_tar], **kw)
    assert_batches_equal(batches(got, 3), batches(want, 3))
    got.close()
    want.close()


def _db(v):
    return 20 * np.log10(max(np.sqrt(np.mean(v ** 2)), 1e-10))


def least_margin(tries, x, num_presets, max_tries, silence_db=-48.0,
                 min_diff_db=-30.0):
    """Replays the bank's rejection over the port's renders in order and
    returns the least |quantity - threshold| of every comparison it makes
    (silence, difference from the input, from each accepted render)."""
    margins, accepted, n = [], [], 0
    for y in tries:
        n += 1
        checks = [(_db(y), silence_db), (_db(y - x), min_diff_db)] + [
            (_db(y - r), min_diff_db) for r in accepted]
        ok = True
        for value, threshold in checks:
            margins.append(abs(value - threshold))
            if value < threshold:
                ok = False
                break
        if ok:
            accepted.append(y)
        if len(accepted) == num_presets or n == max_tries:
            accepted, n = [], 0
    return min(margins)


def test_preset_bank_decisions_match_jax(monkeypatch, capsys):
    """The same presets where every accept/reject decision clears its
    threshold by more than 1e-3 dB in the port's renders; the least
    margin is printed."""
    names = ["gain", "distortion", "parametric_eq", "compressor",
             "stereo_widener"]
    kw = dict(effect_names=names, num_presets=3, probe_len=8192, seed=4,
              max_tries=25)
    tries = []
    real = tpresets.build_render_fn

    def watched(*a, **k):
        render = real(*a, **k)

        def run(w, x):
            y = render(w, x)
            tries.append(y.numpy().copy())
            return y
        return run

    monkeypatch.setattr(tpresets, "build_render_fn", watched)
    got = tpresets.sample_preset_bank(device="cpu", **kw)
    want = jpresets.sample_preset_bank(**kw)
    probe = tpresets.probe_signal(8192, SR)
    x = np.stack([probe, probe])
    margin = least_margin(tries, x, 3, 25)
    print(f"least margin {margin!r} dB")
    assert margin > 1e-3
    assert got.instance_names == want.instance_names
    assert np.array_equal(got.param_counts, want.param_counts)
    assert np.array_equal(got.presets, want.presets)
    path = str(os.path.join(os.path.dirname(__file__), "..", "build",
                            "bank_roundtrip.npz"))
    got.save(path)
    back = tpresets.PresetBank.load(path)
    os.remove(path)
    assert back.instance_names == got.instance_names
    assert np.array_equal(back.presets, got.presets)


def sources():
    rng = np.random.default_rng(0)
    return [(rng.standard_normal((2, 12000)) * 0.3).astype(np.float32),
            (rng.standard_normal((2, 9000)) * 0.3).astype(np.float32),
            (rng.standard_normal((2, 20000)) * 0.2).astype(np.float32)]


def assert_shards_close(got_dir, want_dir, exact_keys):
    gp = sorted(glob.glob(os.path.join(got_dir, "shard_*.npz")))
    wp = sorted(glob.glob(os.path.join(want_dir, "shard_*.npz")))
    assert [os.path.basename(p) for p in gp] == [os.path.basename(p)
                                                for p in wp]
    for a, b in zip(gp, wp):
        with np.load(a) as da, np.load(b) as db:
            assert set(da.files) == set(db.files)
            for k in exact_keys:
                assert np.array_equal(da[k], db[k]), k
            for k in ("inputs", "outputs"):
                assert da[k].dtype == np.float16
                g = da[k].astype(np.float32)
                w = db[k].astype(np.float32)
                ulp = np.spacing(np.abs(db[k])).astype(np.float32)
                peak = np.abs(w).max()
                assert np.all(np.abs(g - w) <= 1e-4 * peak + ulp), k
    with open(os.path.join(got_dir, "index.json")) as f:
        gi = f.read()
    with open(os.path.join(want_dir, "index.json")) as f:
        assert gi == f.read()


def test_generate_pretext_dataset_matches_jax(tmp_path):
    bank = jpresets.PresetBank(
        instance_names=["gain", "distortion", "parametric_eq",
                        "compressor", "reverb"],
        presets=np.random.default_rng(1).random((5, 2, 18)).astype(
            np.float32),
        param_counts=np.array([1, 2, 18, 4, 4], np.int32))
    tbank = tpresets.PresetBank(bank.instance_names, bank.presets,
                                bank.param_counts)
    kw = dict(num_examples=12, length=8192, examples_per_shard=4, seed=2,
              source_dataset_ids=[0, 1, 2])
    tgen.generate_pretext_dataset(sources(), tbank, str(tmp_path / "t"),
                                  device="cpu", **kw)
    jgen.generate_pretext_dataset(sources(), bank, str(tmp_path / "j"), **kw)
    assert_shards_close(str(tmp_path / "t"), str(tmp_path / "j"),
                        ("instance_index", "preset_index", "tar_index"))


def test_generate_style_dataset_matches_jax(tmp_path):
    from st_ito_tpu.chain import EFFECT_REGISTRY as JREG
    from st_ito_tpu.chain import ChainSpec as JChain
    from st_ito_torch.chain import EFFECT_REGISTRY, ChainSpec

    names = ("parametric_eq", "compressor", "distortion", "reverb")
    kw = dict(num_examples=5, length=8192, examples_per_shard=3, seed=1)
    tgen.generate_style_dataset(
        sources(), ChainSpec(tuple(EFFECT_REGISTRY[n]() for n in names),
                             with_bypass=False),
        str(tmp_path / "t"), device="cpu", **kw)
    jgen.generate_style_dataset(
        sources(), JChain(tuple(JREG[n]() for n in names), with_bypass=False),
        str(tmp_path / "j"), **kw)
    assert_shards_close(str(tmp_path / "t"), str(tmp_path / "j"),
                        ("params",))


def test_similarity_dataset_matches_jax(monkeypatch):
    """The same draws (effect, parameters, crops, gains) bit for bit for
    four batches, and the paired renders against the JAX package's on its
    TPU plan (its lone EQ a biquad scan, as the port's K6): within 1e-4 x
    peak, or, for a float32-ill-conditioned EQ setting, no farther than 4x
    the JAX package's own two plans lie apart (on its CPU plan it samples
    the EQ's response; the first batch's EQ reads 1.4e-4 x peak from the
    TPU plan in the port and 8.1e-5 in JAX's CPU plan)."""
    import sys

    from st_ito_tpu.data.sim import SimilarityDataset as JaxSim

    from st_ito_torch.data.sim import SimilarityDataset

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_render import force_jax_tpu_plan

    names = ["gain", "distortion", "parametric_eq"]
    kw = dict(effect_names=names, length=8192, batch_size=3, seed=5)
    cpu_plan = iter(JaxSim(sources(), **kw))
    force_jax_tpu_plan(monkeypatch)
    want = iter(JaxSim(sources(), **kw))
    got = iter(SimilarityDataset(sources(), device="cpu", **kw))
    seen = set()
    for _ in range(4):
        g, w, c = next(got), next(want), next(cpu_plan)
        assert g["effect"] == w["effect"]
        seen.add(g["effect"])
        for k in ("a", "b", "params"):
            assert np.array_equal(g[k], w[k]), k
        for k in ("a_out", "b_out"):
            ref = np.asarray(w[k])
            err = np.abs(g[k] - ref).max()
            spread = np.abs(np.asarray(c[k]) - ref).max()
            assert (err <= 1e-4 * np.abs(ref).max()
                    or err <= 4 * spread), (g["effect"], k, err, spread)
    assert seen == {"distortion", "parametric_eq"}
