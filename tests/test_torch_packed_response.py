"""K9, the fused LTI response + packed hermitian apply: the port's plain
PyTorch version against st_ito_tpu's packed_response_apply_rp (interpret
mode) and its pure-jnp reference, and (on a card only) the CUDA kernel
against the plain version."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from st_ito_tpu.ops.pallas.packed_response import (
    _build_stage_inputs,
    packed_response_apply_rp,
    packed_response_apply_rp_reference,
)

from st_ito_torch.ops.kernels import packed_response as k9

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000


def _case(B, n, seed, with_masks=True):
    """Seeded half-grid spectra and delay + reverb stages with a fractional
    delay (complex DC/Nyquist responses) and mixed bypass masks."""
    rng = np.random.default_rng(seed)
    F = n // 2 + 1
    Z = [rng.standard_normal((B, F)).astype(np.float32) for _ in range(4)]
    delay = {"delay_seconds": rng.uniform(0.01, 1.0, B) + 0.37 / SR,
             "feedback": rng.uniform(0.05, 1.0, B),
             "mix": rng.uniform(0.0, 1.0, B)}
    reverb = {k: rng.uniform(0.0, 1.0, B)
              for k in ("room_size", "damping", "wet_dry", "width")}
    stages = []
    for effect, p in (("delay", delay), ("reverb", reverb)):
        m = None
        if with_masks:
            m = rng.random(B) > 0.4
            m[0] = True
        stages.append((effect, {k: v.astype(np.float32) for k, v in p.items()},
                       m))
    return Z, stages


def _port(Z, stages, n, device="cpu"):
    t_stages = [(e, {k: torch.as_tensor(v, device=device)
                     for k, v in p.items()},
                 None if m is None else torch.as_tensor(m, device=device))
                for e, p, m in stages]
    tables = k9.rp_tables([e for e, _, _ in stages], SR, n, device)
    return k9.packed_response_apply(
        *(torch.as_tensor(z, device=device) for z in Z), t_stages, tables)


def _jax(Z, stages, n, reference):
    F = n // 2 + 1
    Fp = -(-F // 512) * 512
    j_stages = [(e, {k: jnp.asarray(v) for k, v in p.items()},
                 None if m is None else jnp.asarray(m))
                for e, p, m in stages]
    descrs, P, A, T = _build_stage_inputs(j_stages, Z[0].shape[0], n, SR, Fp)
    if reference:
        Zp = [jnp.pad(jnp.asarray(z), ((0, 0), (0, Fp - F))) for z in Z]
        out = packed_response_apply_rp_reference(*Zp, descrs, P, A, T,
                                                 nyq_bin=F - 1)
        return [np.asarray(o)[:, :F] for o in out]
    out = packed_response_apply_rp(*map(jnp.asarray, Z), descrs, P, A, T,
                                   interpret=True)
    return [np.asarray(o) for o in out]


def _assert_rel(got, want, rel):
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float(np.abs(np.asarray(g) - w).max())
        assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("reference", [False, True],
                         ids=["pallas_interpret", "jnp_reference"])
@pytest.mark.parametrize("with_masks", [True, False])
def test_plain_matches_jax(reference, with_masks):
    n = 2048
    Z, stages = _case(3, n, 5, with_masks)
    got = [o.numpy() for o in _port(Z, stages, n)]
    _assert_rel(got, _jax(Z, stages, n, reference), 1e-4)


def test_dc_nyquist_bins_are_corrected():
    """The fractional delay makes the DC and Nyquist responses complex, so
    the correction changes those bins: the uncorrected JAX reference must
    differ there, and the port must match the corrected one."""
    n = 1024
    Z, stages = _case(3, n, 9)
    got = [o.numpy() for o in _port(Z, stages, n)]
    F = n // 2 + 1
    j_stages = [(e, {k: jnp.asarray(v) for k, v in p.items()},
                 jnp.asarray(m)) for e, p, m in stages]
    descrs, P, A, T = _build_stage_inputs(j_stages, 3, n, SR, F)
    raw = packed_response_apply_rp_reference(*map(jnp.asarray, Z), descrs, P,
                                             A, T)
    for k in (0, F - 1):
        assert np.abs(got[0][:, k] - np.asarray(raw[0])[:, k]).max() > 1e-3
    _assert_rel(got, _jax(Z, stages, n, True), 1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    # 70 candidates: two 64-candidate chunks per frequency tile, one ragged
    n = 2 ** 16
    Z, stages = _case(70, n, 13)
    want = [o.numpy() for o in _port(Z, stages, n)]
    before = k9.launches
    got = _port(Z, stages, n, cuda_device)
    torch.cuda.synchronize()
    assert k9.launches == before + 1
    _assert_rel([g.cpu().numpy() for g in got], want, 1e-4)
