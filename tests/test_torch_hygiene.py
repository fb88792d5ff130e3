"""st_ito_torch stands alone and never leaves the card on its own: no JAX
import anywhere in the port or chip_smoke.py, entry points that default to
the card, and kernel wrappers that raise rather than fall back."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import st_ito_torch
from st_ito_torch.chain import (basic_chain, build_batched_render_fn,
                                build_render_fn, chain_from_json)
from st_ito_torch.cli import run_optim
from st_ito_torch.ito import make_fitness_fn, run_es
from st_ito_torch.models import Cnn14, Cnn14Config, ParamModel, load_param_model
from st_ito_torch.ops import dynamics
from st_ito_torch.ops import lti
from st_ito_torch.ops.kernels import _build, eqcomp, fused_fft, mega_fft, scan
from st_ito_torch.ops.kernels import packed_response as k9

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(Path(st_ito_torch.__file__).parent.rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_package_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "st_ito_tpu", "flax",
                                  "optax")]
    assert not bad, f"{path} imports {bad}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card(no_card):
    chain = basic_chain()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_batched_render_fn(chain, 48000, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_render_fn(chain, 48000, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_param_model(allow_random=True)
    net = Cnn14(Cnn14Config(embed_dim=8, base_channels=2))
    model = ParamModel(net=net, config=net.config, embed_dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_fitness_fn(chain, model, 48000, 2)
    x = torch.zeros(1, 2, 48000)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_es(x, x, 48000, chain, model, max_iters=1, popsize=4,
               find_w0=False, verbose=False)
    style = chain_from_json(str(ROOT / "chains/eq+multiband-comp+limiter.json"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_batched_render_fn(style, 48000, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_fitness_fn(style, model, 48000, 2, normalize_stages=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_optim.main(["in.wav", "None", "--allow-random-model"])


def test_wrappers_raise_when_the_kernel_cannot_load(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel; when the kernel
    library cannot be built or loaded the wrapper raises, and never runs
    its plain version instead. (A "meta" tensor stands in for a CUDA one
    here: the CPU build of torch has no CUDA tensors.)"""
    def refuse(name):
        raise RuntimeError(f"cannot load kernel {name}")

    monkeypatch.setattr(_build, "load", refuse)
    dev = torch.device("meta")
    B, T = 2, 64
    b = torch.zeros(B, 1, 6, 3, device=dev)
    with pytest.raises(RuntimeError, match="cannot load kernel eqcomp"):
        eqcomp.eq_compressor_fused(
            torch.zeros(2, T, device=dev), b, b, threshold_db=-10.0,
            ratio=4.0, knee_db=0.5, alpha_attack=0.9, alpha_release=0.99,
            shared_lead_shape=(B, 2))
    Z = [torch.zeros(B, 33, device=dev) for _ in range(4)]
    stages = [("gain", {"gain_db": torch.zeros(B, device=dev)}, None)]
    with pytest.raises(RuntimeError, match="cannot load kernel packed"):
        k9.packed_response_apply(*Z, stages, {"gain": {}})
    # the four kernels of the mega paths, at the smallest shape they admit
    n, T = 2 ** 14, 2 ** 13
    grid = [torch.zeros((B,) + mega_fft.half_grid(n), device=dev)
            for _ in range(4)]
    with pytest.raises(RuntimeError, match="cannot load kernel packed"):
        k9.packed_response_apply_rp_padded(*grid, stages, {"gain": {}}, n)
    x = torch.zeros(B, 2, T, device=dev)
    with pytest.raises(RuntimeError, match="cannot load kernel mega_fft"):
        mega_fft.fwd_pack_fft(x, n)
    with pytest.raises(RuntimeError, match="cannot load kernel mega_fft"):
        mega_fft.fwd_pack_fft_response(x, stages, n, 48000)
    with pytest.raises(RuntimeError, match="cannot load kernel mega_fft"):
        mega_fft.inv_unpack_fft(*grid, n, T)
    for group in (mega_fft.packed_lti_apply_mega,
                  mega_fft.packed_lti_apply_mega2):
        with pytest.raises(RuntimeError, match="cannot load kernel mega_fft"):
            group(x, stages, n, 48000)
    # K6 on a shared and a per-candidate input, and K8, also from where the
    # linked compressor reaches it
    act = torch.ones(B, 1, device=dev)
    for xs, lead in ((torch.zeros(2, 64, device=dev), (B, 2)),
                     (torch.zeros(B, 2, 64, device=dev), None)):
        with pytest.raises(RuntimeError, match="cannot load kernel scan"):
            scan.biquad_cascade(xs, b, b, active=act, shared_lead_shape=lead)
    c = torch.zeros(B, 1, 64, device=dev)
    with pytest.raises(RuntimeError, match="cannot load kernel scan"):
        scan.ballistics(c, 0.9, 0.99)
    with pytest.raises(RuntimeError, match="cannot load kernel scan"):
        dynamics.compressor(torch.zeros(B, 2, 64, device=dev), 48000,
                            threshold_db=-10.0, fast=True, link_channels=True)
    # K7, also from where the unlinked compressor reaches it, and K11
    xs = torch.zeros(B, 2, 64, device=dev)
    with pytest.raises(RuntimeError, match="cannot load kernel scan"):
        scan.compressor_fused(xs, -10.0, 4.0, 0.5, 0.9, 0.99, active=act)
    with pytest.raises(RuntimeError, match="cannot load kernel scan"):
        dynamics.compressor(xs, 48000, fast=True, link_channels=False)
    with pytest.raises(RuntimeError, match="cannot load kernel scan"):
        scan.linear_recurrence(c, c)
    # K10, alone and from the fused LTI group
    z = torch.zeros(B, n, device=dev)
    for sign in (-1, 1):
        with pytest.raises(RuntimeError, match="cannot load kernel fused_fft"):
            fused_fft.fft_fused(z, z, sign=sign, n=n, out_len=T)
    with pytest.raises(RuntimeError, match="cannot load kernel fused_fft"):
        lti.packed_lti_apply_rp(x, stages, n, {"gain": {}}, fft_impl="fused")


def test_the_mega_entry_points_take_the_kernel_for_any_other_device(
        monkeypatch):
    """The plain versions run for CPU tensors only: with the kernel
    functions replaced by markers, a CPU tensor never reaches them and a
    tensor elsewhere always does."""
    hits = []
    for name in ("fwd_pack_fft_cuda", "fwd_pack_fft_response_cuda",
                 "inv_unpack_fft_cuda"):
        monkeypatch.setattr(mega_fft, name,
                            lambda *a, _n=name: hits.append(_n))
    monkeypatch.setattr(k9, "packed_response_padded_cuda",
                        lambda *a: hits.append("k2"))
    n, T = 2 ** 14, 2 ** 13
    stages = [("gain", {"gain_db": torch.zeros(1)}, None)]
    x = torch.zeros(1, 2, T)
    Y = mega_fft.fwd_pack_fft_response(x, stages, n, 48000)
    mega_fft.inv_unpack_fft(*Y, n, T)
    k9.packed_response_apply_rp_padded(*mega_fft.fwd_pack_fft(x, n), stages,
                                       {"gain": {}}, n)
    assert hits == []
    meta = torch.device("meta")
    xm = x.to(meta)
    stages_m = [("gain", {"gain_db": torch.zeros(1, device=meta)}, None)]
    mega_fft.fwd_pack_fft(xm, n)
    mega_fft.fwd_pack_fft_response(xm, stages_m, n, 48000)
    grid = [y.to(meta) for y in Y]
    mega_fft.inv_unpack_fft(*grid, n, T)
    k9.packed_response_apply_rp_padded(*grid, stages_m, {"gain": {}}, n)
    assert hits == ["fwd_pack_fft_cuda", "fwd_pack_fft_response_cuda",
                    "inv_unpack_fft_cuda", "k2"]



def test_unlinked_fast_compressor_off_the_cpu_takes_k7(monkeypatch):
    """The fast unlinked compressor is one pass of K7: off the CPU it
    launches compressor_fused_cuda (replaced by a marker here) and never
    quietly runs the op-by-op form or the plain version; on the CPU it
    runs the plain version. (A "meta" tensor stands in for a CUDA one.)"""
    hits = []
    monkeypatch.setattr(
        scan, "compressor_fused_cuda",
        lambda x_in, vec, with_active: hits.append(
            (tuple(vec.shape), with_active)) or torch.empty_like(x_in))
    monkeypatch.setattr(scan, "ballistics_cuda",
                        lambda *a: pytest.fail("took the op-by-op form"))
    x = torch.zeros(2, 2, 64, device="meta")
    y = dynamics.compressor(x, 48000, fast=True, link_channels=False,
                            active=torch.ones(2, 1, device="meta"))
    assert y.shape == x.shape and y.device.type == "meta"
    assert hits == [((7, 4), True)]
    y = dynamics.compressor(torch.zeros(2, 2, 64), 48000, fast=True,
                            link_channels=False)
    assert y.shape == x.shape and y.device.type == "cpu"
    assert len(hits) == 1


def _new_entry_points():
    """The benchmarks', CLIs' and encoders' entry points, each called as a
    user would call it without naming a device."""
    from st_ito_torch.cli import embed, eval_cls, eval_pst
    from st_ito_torch.eval import cls, listen, pst, pst_examples
    from st_ito_torch.models import (load_beats_model, load_fx_encoder_model,
                                     load_vggish_model, load_wav2clip_model)

    x = [np.zeros((2, 4096), np.float32)]
    return {
        "eval_pst": lambda: eval_pst.main(["--allow-random-model"]),
        "eval_cls": lambda: eval_cls.main(["--allow-random-model"]),
        "embed": lambda: embed.main(["--allow-random"]),
        "run_pst_benchmark": lambda: pst.run_pst_benchmark([], {}, {}),
        "default_methods": lambda: pst.default_methods(basic_chain(), None,
                                                       None),
        "make_style_dataset": lambda: cls.make_style_dataset(x),
        "synthesize_contrived_examples": lambda: (
            pst_examples.synthesize_contrived_examples(x)),
        "evaluate_listening_correlation": lambda: (
            listen.evaluate_listening_correlation([], {})),
        "fx-encoder": lambda: load_fx_encoder_model(allow_random=True),
        "vggish": lambda: load_vggish_model(allow_random=True),
        "wav2clip": lambda: load_wav2clip_model(allow_random=True),
        "beats": lambda: load_beats_model(allow_random=True),
        **_training_entry_points(),
    }


def _training_entry_points():
    """Training's entry points: the CLI, the trainers (a StyleTransferSystem
    is where ``run_learned_inference`` runs), the data synthesis."""
    from st_ito_torch.cli import train
    from st_ito_torch.data import (PresetBank, generate_pretext_dataset,
                                   generate_style_dataset,
                                   sample_preset_bank)
    from st_ito_torch.data.sim import SimilarityDataset
    from st_ito_torch.train import ParamEstimatorConfig, init_param_estimator
    from st_ito_torch.train.style import (StyleTransferConfig,
                                          StyleTransferSystem)

    x = [np.zeros((2, 4096), np.float32)]
    bank = PresetBank(["gain"], np.zeros((1, 1, 1), np.float32),
                      np.ones(1, np.int32))
    cfg = str(ROOT / "cfg" / "pretext-panns.yaml")
    return {
        "train_cli_pretext": lambda: train.main(["--config", cfg]),
        "train_cli_style": lambda: train.main(
            ["--config", str(ROOT / "cfg" / "style-audio-otf.yaml")]),
        "init_param_estimator": lambda: init_param_estimator(
            ParamEstimatorConfig()),
        "StyleTransferSystem": lambda: StyleTransferSystem(
            StyleTransferConfig(), chain=basic_chain(with_bypass=False)),
        "sample_preset_bank": lambda: sample_preset_bank(["gain"]),
        "generate_pretext_dataset": lambda: generate_pretext_dataset(
            x, bank, "unused", 1),
        "generate_style_dataset": lambda: generate_style_dataset(
            x, basic_chain(), "unused", 1),
        "SimilarityDataset": lambda: SimilarityDataset(x, ["gain"]),
    }


@pytest.mark.parametrize("name", sorted(_new_entry_points()))
def test_benchmark_entry_points_default_to_the_card(name, no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _new_entry_points()[name]()
