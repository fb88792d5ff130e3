"""The counts of operations and bytes against hand sums at small shapes."""

import math

from portbench.core import bench
from portbench.core.bench import Context


def ctx(**traffic):
    t = {"popsize": 4, "samples": 64, "chunked": False, "chain": "style"}
    t.update(traffic)
    return Context(config={"channels": 2, "sample_rate": 48000},
                   traffic=t)


def test_cnn14_flops_hand_sum():
    enc = {"hop_size": 4, "mel_bins": 8, "base_channels": 1, "embed_dim": 3}
    # 9 frames x 8 bins; channels 1, 2, 4, 8, 16, 32; pooled 5 times
    shapes = [(9, 8), (4, 4), (2, 2), (1, 1), (0, 0), (0, 0)]
    chans = [1, 2, 4, 8, 16, 32]
    want, cin = 0, 1
    for (h, w), c in zip(shapes, chans):
        want += 2 * 9 * h * w * (cin * c + c * c)
        cin = c
    want += 2 * 32 * 3
    got = bench.load_module("counts", "cnn14").forward_flops(enc, 32)
    assert got == want


def test_cnn14_deployed_is_10_29_gmac():
    import json
    enc = json.load(open(bench.os.path.join(
        bench.HERE, "configs", "afxrep-cnn14-ito.json")))["encoder"]
    f = bench.load_module("counts", "cnn14").forward_flops(enc, 262144)
    assert abs(f / 2e9 - 10.2924) < 1e-3


def test_scan_kernel_counts():
    c = ctx()
    rec = {"generations": 3}
    # K1: 3 fitness calls of 4 candidates in 2 launches each (sub-batches
    # of 2): 2 candidates x 2 channels a launch
    ops, nbytes = bench.load_module("counts", "k1").per_launch(c, rec, 6)
    assert ops == 94 * 4 * 64 and nbytes == 4 * (4 * 64 + 2 * 64)
    ops, nbytes = bench.load_module("counts", "k6").per_launch(c, rec, 3)
    assert ops == 58 * 8 * 64 and nbytes == 4 * (8 * 64 + 2 * 64)
    # K8 on the style chain: multiband's 3 and the limiter's 1 a call,
    # one lane a candidate
    ops, nbytes = bench.load_module("counts", "k8").per_launch(c, rec, 12)
    assert ops == 9 * 4 * 64 and nbytes == 4 * 2 * 4 * 64


def test_fft_kernel_counts():
    c = ctx(chain="basic")
    rec = {"generations": 1}
    n, F = 128, 65  # next_pow2(64 + 64)
    fft = 5 * n * math.log2(n) * 4
    ops, nbytes = bench.load_module("counts", "k4").per_launch(c, rec, 1)
    assert ops == fft and nbytes == 4 * (2 * 4 * 64 + 4 * 4 * F)
    ops, nbytes = bench.load_module("counts", "k3").per_launch(c, rec, 1)
    assert ops == fft + 290 * 4 * F
    assert nbytes == 4 * (2 * 4 * 64 + 4 * 4 * F + 38 * F + 9 * 4)
    ops, nbytes = bench.load_module("counts", "k9").per_launch(c, rec, 1)
    assert ops == 290 * 4 * F and nbytes == 4 * (8 * 4 * F + 38 * F + 9 * 4)


def test_long_mode_guard_is_ten_seconds():
    from portbench.counts.common import fft_size
    c = ctx(chunked=True, samples=2880000)
    assert fft_size(c) == 1 << 22
