"""The port's DeepGCN (``models/gcn.py``, model size ``t`` at the small
width of ``tests/test_encoders.py``) against st_ito_tpu's on the CPU, the
JAX weights carried across by ``convert.deepgcn_state_dict_from_jax``, in
eval and in train mode (the JAX apply's ``training``; no dropout); the
BatchNorm running statistics that DeepGCN and the FX-encoder update in
train mode, against the JAX package's ``merge_bn_stats(params,
stats_tree(...))`` (``models/bn_stats.py``, torch's convention); the head
dropout's keep rate and scale from a ``torch.Generator``.

Tolerances: embeddings within 1e-4 x max|want| and at cosine > 1 - 1e-5
per item; running statistics within 1e-5 x max(1, |want|) elementwise
(float32 means and variances over a few thousand elements). DeepGCN's
k-NN picks each node's nine nearest candidates by float32 distances; a
near tie between the ninth and tenth could fall either way in XLA's and
torch's rounding: the end-to-end comparisons give both packages the
port's picks, and the picks themselves are held node by node, each
package's own on the same features, where a node may differ only at a
near tie (``KNN_TIE``) and only a few nodes may (``KNN_FLIP_SHARE``)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from st_ito_tpu.models import bn_stats as jbn
from st_ito_tpu.models import encoders as jenc
from st_ito_tpu.models import gcn as jgcn

from st_ito_torch.models import convert, encoders, gcn

from tests.test_torch_encoders import FXE, random_bn

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)


def audio(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.3


def assert_close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), err


def assert_cosine(got, want, limit=1e-5):
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert (cos > 1.0 - limit).all(), cos


def set_mode(net, training):
    return net.train() if training else net.eval()


# ---------------------------------------------------------------- DeepGCN

GCN = dict(embed_dim=16, model_size="t", num_frames=64)


def share_neighbours(monkeypatch, net, x, jax_picks=None):
    """The port's forward on x with every graph conv's k-NN indices
    recorded; then ``jax.lax.top_k`` replaced, for the JAX forward traced
    next, by a function that returns those indices in the same order, so
    that both packages aggregate the same neighbours. Returns the port's
    embedding and, per graph conv, (its picks, its feat and cand in
    float64). Where ``jax_picks`` is a list, the JAX forward appends to it
    the picks of the real ``jax.lax.top_k`` on the distances it forms."""
    picked = []
    real = gcn.knn_indices

    def record(feat, cand, k):
        idx = real(feat, cand, k)
        picked.append((idx.numpy(), feat.double().numpy(),
                       cand.double().numpy()))
        return idx

    monkeypatch.setattr(gcn, "knn_indices", record)
    with torch.no_grad():
        got, _ = net(torch.from_numpy(x))
    monkeypatch.setattr(gcn, "knn_indices", real)
    order = iter(picked)
    real_top_k = jax.lax.top_k

    def top_k(operand, k):
        idx = jnp.asarray(next(order)[0], jnp.int32)
        assert idx.shape == operand.shape[:-1] + (k,)
        if jax_picks is not None:
            jax.debug.callback(lambda i: jax_picks.append(np.asarray(i)),
                               real_top_k(operand, k)[1], ordered=True)
        return jnp.take_along_axis(operand, idx, axis=-1), idx

    monkeypatch.setattr(jax.lax, "top_k", top_k)
    return got, picked


@pytest.fixture(scope="module")
def gcn_case():
    """JAX DeepGCN-t params at the small width with every BatchNorm's
    statistics and affine moved off their init, and an input."""
    jcfg = jgcn.DeepGCNConfig(**GCN)
    params = jax.jit(lambda k: jgcn.init_deepgcn_params(k, jcfg))(
        jax.random.PRNGKey(7))
    params["pos_embed"] = jnp.asarray(
        audio(params["pos_embed"].shape, 8) * 0.1)
    random_bn(params, np.random.default_rng(9))
    return jcfg, params, audio((2, 2, 33792), 10)


def port_gcn(params, training):
    net = set_mode(gcn.DeepGCN(gcn.DeepGCNConfig(**GCN)), training)
    net.load_state_dict(convert.deepgcn_state_dict_from_jax(params))
    return net


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_deepgcn_matches_jax(gcn_case, training, monkeypatch):
    """Both packages aggregating the same neighbours (the port's k-NN
    picks, ``share_neighbours``): everything but the picks is held."""
    jcfg, params, x = gcn_case
    got, _ = share_neighbours(monkeypatch, port_gcn(params, training), x)
    want, _ = jax.jit(lambda p, a: jgcn.deepgcn_apply(
        p, a, jcfg, training=training))(params, jnp.asarray(x))
    assert_close(got, want)
    assert_cosine(got, want)


# a near tie: a node's k-th and (k+1)-th candidate distances within this
# of each other, relative to the (k+1)-th (float64, on the port's
# features); and the share of a graph conv's nodes whose pick sets the two
# packages may decide apart at such ties
KNN_TIE = 1e-5
KNN_FLIP_SHARE = 0.01


def knn_gaps(feat, cand, k):
    """(B, N) relative gap between each node's k-th and (k+1)-th nearest
    candidate, float64 distances of feat (B, C, N) to cand (B, C, M)."""
    d = ((feat[:, :, :, None] - cand[:, :, None, :]) ** 2).sum(1)
    d = np.sort(d, axis=-1)
    return (d[..., k] - d[..., k - 1]) / np.maximum(d[..., k], 1e-300)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_deepgcn_knn_picks_match_jax(gcn_case, training, monkeypatch):
    """Each graph conv's k nearest candidates, picked by the port's
    ``knn_indices`` and by the JAX forward's own ``jax.lax.top_k`` on the
    distances it forms (both aggregating the port's picks, so that the
    features stay the same up to rounding): every node whose pick sets
    differ holds a near tie (``KNN_TIE``), and no more than
    ``KNN_FLIP_SHARE`` of a conv's nodes differ; the counts and gaps are
    reported."""
    jcfg, params, x = gcn_case
    jax_picks = []
    _, port = share_neighbours(monkeypatch, port_gcn(params, training), x,
                               jax_picks)
    jax.block_until_ready(jax.jit(lambda p, a: jgcn.deepgcn_apply(
        p, a, jcfg, training=training))(params, jnp.asarray(x)))
    jax.effects_barrier()
    assert len(jax_picks) == len(port) > 0
    for layer, ((mine, feat, cand), theirs) in enumerate(zip(port,
                                                             jax_picks)):
        assert theirs.shape == mine.shape
        k = mine.shape[-1]
        flipped = (np.sort(mine, -1) != np.sort(theirs, -1)).any(-1)
        if not flipped.any():
            continue
        assert cand.shape[-1] > k
        gaps = knn_gaps(feat, cand, k)[flipped]
        print(f"DeepGCN ({'train' if training else 'eval'}) graph conv "
              f"{layer}: {int(flipped.sum())} of {flipped.size} nodes' "
              f"picks differ, their k-th/(k+1)-th gaps from "
              f"{gaps.min()!r} to {gaps.max()!r}")
        assert (gaps < KNN_TIE).all(), gaps
        assert flipped.mean() <= KNN_FLIP_SHARE, flipped.mean()


def assert_stats(net, merged):
    """Every BatchNorm's running statistics in the port's state_dict
    against the JAX params with the recorded statistics merged in."""
    sd = net.state_dict()
    flat = convert.flatten_params(merged)
    keys = [k for k in flat if k.endswith(("running_mean", "running_var"))]
    assert keys and all(k in sd for k in keys)
    for k in keys:
        want = flat[k]
        err = np.abs(sd[k].numpy() - want) / np.maximum(1.0, np.abs(want))
        assert err.max() <= 1e-5, (k, err.max())


def test_deepgcn_batchnorm_buffers_match_jax(gcn_case, monkeypatch):
    """One train-mode forward: every BatchNorm2d's buffers updated in
    place as the JAX package records them (momentum 0.1, the unbiased
    batch variance), the stem's and the backbone's moved; both packages
    aggregating the same neighbours."""
    jcfg, params, x = gcn_case
    net = port_gcn(params, True)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    share_neighbours(monkeypatch, net, x)
    # the collector is keyed by the traced pytree's dicts: one trace
    _, _, stats = jax.jit(lambda p, a: jgcn.deepgcn_apply(
        p, a, jcfg, training=True, return_stats=True))(params, jnp.asarray(x))
    assert_stats(net, jbn.merge_bn_stats(params, stats))
    for k in ("stem.0.bn.running_mean", "backbone.0.fc1.bn.running_var"):
        assert not torch.equal(net.state_dict()[k], before[k])
    assert int(net.state_dict()["stem.0.bn.num_batches_tracked"]) == 1


def test_fx_encoder_batchnorm_buffers_match_jax():
    """The FX-encoder in train mode: the output by the batch's statistics
    and every BatchNorm1d's buffers, against the JAX apply with
    ``training=True`` under ``collect_bn_stats``."""
    jcfg = jenc.FXEncoderConfig(embed_dim=8, **FXE)
    params = jax.jit(lambda k: jenc.init_fx_encoder_params(k, jcfg))(
        jax.random.PRNGKey(11))
    random_bn(params, np.random.default_rng(12))
    x = audio((3, 2, 301), 13)
    def apply(p, a):
        with jbn.collect_bn_stats() as collected:
            out = jenc.fx_encoder_apply(p, a, jcfg, training=True)
        return out, jbn.stats_tree(p, collected)

    want, stats = jax.jit(apply)(params, jnp.asarray(x))
    merged = jbn.merge_bn_stats(params, stats)
    net = encoders.FXEncoder(encoders.FXEncoderConfig(embed_dim=8, **FXE))
    net.load_state_dict(convert.fx_encoder_state_dict_from_jax(params))
    net.train()
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert_close(got, want)
    sd = convert.fx_encoder_state_dict_from_jax(merged)
    for k, v in net.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            want_k = sd[k].numpy()
            err = np.abs(v.numpy() - want_k) / np.maximum(1.0,
                                                          np.abs(want_k))
            assert err.max() <= 1e-5, (k, err.max())


def test_head_dropout_keep_rate_and_scale():
    """Keep 0.8 of the elements, the kept scaled by 1 / 0.8, the mask a
    function of the generator's seed alone; in train mode with a generator
    the embedding changes, in eval mode it does not."""
    h = torch.ones(400, 1000)
    a = gcn.head_dropout(h, torch.Generator().manual_seed(0))
    b = gcn.head_dropout(h, torch.Generator().manual_seed(0))
    c = gcn.head_dropout(h, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    kept = a != 0
    assert abs(float(kept.float().mean()) - gcn.KEEP) < 0.005
    torch.testing.assert_close(a[kept], torch.full_like(a[kept],
                                                        1.0 / gcn.KEEP))

    net = gcn.DeepGCN(gcn.DeepGCNConfig(**GCN))
    gcn.init_deepgcn_(net, torch.Generator().manual_seed(2))
    x = torch.from_numpy(audio((2, 1, 33792), 14))
    with torch.no_grad():
        net.eval()
        e0 = net(x, torch.Generator().manual_seed(3))[0]
        e1 = net(x)[0]
        net.train()
        d0 = net(x, torch.Generator().manual_seed(3))[0]
        d1 = net(x, torch.Generator().manual_seed(3))[0]
        d2 = net(x)[0]
    torch.testing.assert_close(e0, e1, rtol=0, atol=0)
    torch.testing.assert_close(d0, d1, rtol=0, atol=0)
    assert not torch.allclose(d0, d2)
