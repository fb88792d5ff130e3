"""The readers of the program's spans: None where their spans are missing,
and the right number on a synthetic record (the ITO readers, which read
``rec["spans"]``) or on a filled ``phase_timer`` (the training readers,
which read it directly, on the card only)."""

import numpy as np
import pytest
import torch

from portbench.core import bench
from st_ito_torch.utils import phase_timer

CARD = {"device": torch.device("cuda", 0)}
ITO = {"generations": 4, "window_s": 2.0,
       "spans": {"render": [10.0, 20.0, 30.0, 40.0], "ask": [1.0, 2.0],
                 "tell": [3.0, 4.0],
                 "generation": [float(v) for v in range(1, 101)]}}
TRAIN = {"forward": [80.0, 100.0], "backward": [200.0, 220.0],
         "optimizer": [4.0, 6.0], "h2d": [20.0, 30.0],
         "loader_wait": [100.0, 50.0, 150.0]}


def read(name, ctx, rec):
    return bench.load_module("metrics", name).read(ctx, rec)


@pytest.fixture
def filled_timer():
    phase_timer.reset(False)
    for name, ms in TRAIN.items():
        phase_timer._host_ns[name] = [int(v * 1e6) for v in ms]
    yield
    phase_timer.reset(False)


@pytest.mark.parametrize("name, want", [
    ("render_ms_per_gen", 25.0),
    ("es_host_ms_per_gen", 5.0),
    ("gen_ms_p95", float(np.percentile(np.arange(1, 101), 95))),
])
def test_ito_readers(name, want):
    assert read(name, CARD, ITO) == pytest.approx(want)
    assert read(name, CARD, {**ITO, "spans": {}}) is None
    assert read(name, CARD, {"generations": 4}) is None


@pytest.mark.parametrize("name, want", [
    ("h2d_ms_per_step", 25.0),
    ("fwd_ms_per_step", 90.0),
    ("bwd_ms_per_step", 210.0),
    ("optim_ms_per_step", 5.0),
    ("loader_wait_pct", 100.0 * 0.3 / 2.0),
])
def test_train_readers(name, want, filled_timer):
    rec = {"steps": 2, "window_s": 2.0}
    assert read(name, CARD, rec) == pytest.approx(want)
    # off the card nothing is read, as the ITO driver reads no spans there
    assert read(name, {"device": torch.device("cpu")}, rec) is None
    phase_timer.reset(False)
    assert read(name, CARD, rec) is None
