"""The port's named spans (``utils.py PhaseTimer``) on the CPU: the host
loop's ``ask`` and ``tell`` host spans and ``prefetch_batches``'
``loader_wait``, recorded when the timer is enabled or a profiler session
runs and not otherwise; the profiler ranges they open hold no operator (a
range around device work would be mirrored as a device event); and the span
names of the package are those of PERF.md's span table."""

import os
import re

import numpy as np
import pytest
import torch

from st_ito_torch.chain import basic_chain
from st_ito_torch.data import prefetch_batches
from st_ito_torch.ito import run_es
from st_ito_torch.models.cnn14 import Cnn14, Cnn14Config
from st_ito_torch.models.registry import ParamModel
from st_ito_torch.utils import phase_timer

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, T, POP, GENS = 48000, 8192, 8, 3


@pytest.fixture(autouse=True)
def timer_off():
    phase_timer.reset(False)
    yield
    phase_timer.reset(False)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    config = Cnn14Config(embed_dim=8, window_size=512, hop_size=256,
                         mel_bins=32, base_channels=2)
    return ParamModel(net=Cnn14(config).eval(), config=config, embed_dim=8)


def _run(model):
    rng = np.random.default_rng(0)
    x = (0.5 * rng.standard_normal((1, 2, T))).astype(np.float32)
    y = (0.5 * rng.standard_normal((1, 2, T))).astype(np.float32)
    return run_es(x, y, SR, basic_chain(), model, max_iters=GENS,
                  popsize=POP, crop_len=T, find_w0=False, seed=0,
                  verbose=False, early_stop_patience=10**6, device="cpu")


def test_enabled_timer_records_host_loop_spans(model):
    phase_timer.reset(True)
    _run(model)
    spans = phase_timer.read_ms()
    assert sorted(spans) == ["ask", "tell"]
    assert len(spans["ask"]) == GENS and len(spans["tell"]) == GENS
    assert all(ms >= 0.0 for v in spans.values() for ms in v)


def test_inactive_timer_records_nothing(model):
    assert phase_timer.span("x", torch.device("cuda")) is \
        phase_timer.host_span("y")
    _run(model)
    assert phase_timer.read_ms() == {}


def test_profiler_ranges_hold_no_operator(model):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _run(model)
    events = list(prof.events())
    ranges = [e for e in events if e.name.startswith("st_ito.")]
    assert sorted(e.name for e in ranges) == (["st_ito.ask"] * GENS
                                              + ["st_ito.tell"] * GENS)
    for r in ranges:
        inside = [e.name for e in events
                  if e.name.startswith("aten::") and e.thread == r.thread
                  and r.time_range.start <= e.time_range.start
                  < r.time_range.end]
        assert inside == [], (r.name, inside)
    # the profiler session made the spans active with the timer off
    assert len(phase_timer.read_ms()["ask"]) == GENS


def test_loader_wait_span_per_get():
    n = 5
    phase_timer.reset(True)
    assert list(prefetch_batches(iter(range(n)))) == list(range(n))
    assert len(phase_timer.read_ms()["loader_wait"]) == n + 1


def _table_names() -> set[str]:
    """The span names of PERF.md's span table (rows whose kind is host or
    device)."""
    with open(os.path.join(ROOT, "PERF.md")) as f:
        text = f.read()
    lines = text.split("### Spans and counters", 1)[1].splitlines()
    first = next(i for i, line in enumerate(lines) if line.startswith("|"))
    names = set()
    for row in lines[first + 2:]:
        if not row.startswith("|"):
            break
        cells = [c.strip() for c in row.strip("|").split("|")]
        if re.search(r"\b(host|device)\b", cells[1]):
            names.add(cells[0].strip("`"))
    return names


def test_span_names_match_the_table():
    pat = re.compile(r"phase_timer\.(?:host_)?span\(\s*\"([^\"]+)\"")
    found = set()
    for folder, _, files in os.walk(os.path.join(ROOT, "st_ito_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(folder, name)) as f:
                    found.update(pat.findall(f.read()))
    assert found == _table_names()
    assert len(found) == 10
