"""K1, the fused EQ -> compressor (-> distortion) scan: the port's plain
PyTorch version against st_ito_tpu's eq_compressor_fused_pallas run in
interpret mode, and (on a card only) the CUDA kernel against the plain
version."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from st_ito_tpu.ops.pallas.scan import eq_compressor_fused_pallas

from st_ito_torch.chain import basic_chain
from st_ito_torch.chain.executor import stage_params
from st_ito_torch.chain.responses import _eq_section_stack
from st_ito_torch.ops.dynamics import _time_constant_alpha
from st_ito_torch.ops.kernels import eqcomp

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000


def _inputs(B, C, T, seed, shared, with_dist, with_masks):
    """Seeded inputs for both implementations: per-candidate or shared x,
    the basic EQ's 6 sections and compressor/distortion scalars as
    (B, 1) columns, and bypass masks mixing on and off."""
    rng = np.random.default_rng(seed)
    chain = basic_chain()
    (eq, eq_s, _), (comp, c_s, _), (dist, d_s, _) = chain.stage_slices()[:3]
    W = torch.from_numpy(rng.random((B, chain.num_params)).astype(np.float32))
    p_eq = stage_params(eq, W, eq_s, 1)
    p_c = stage_params(comp, W, c_s, 1)
    p_d = stage_params(dist, W, d_s, 1)
    b, a = _eq_section_stack(p_eq, SR)
    x = rng.standard_normal((C, T) if shared else (B, C, T)).astype(
        np.float32) * 0.5

    def col(v):
        return np.asarray(v, np.float32)[:, None]

    def mask():
        m = (rng.random(B) > 0.5).astype(np.float32)
        m[0], m[-1] = 1.0, 0.0
        return col(m)

    kw = dict(
        threshold_db=col(p_c["threshold_db"]), ratio=col(p_c["ratio"]),
        knee_db=0.5,
        alpha_attack=col(_time_constant_alpha(p_c["attack_ms"], SR)),
        alpha_release=col(_time_constant_alpha(p_c["release_ms"], SR)),
        makeup_gain_db=0.0)
    if with_masks:
        kw.update(eq_active=mask(), comp_active=mask())
    if with_dist:
        kw.update(drive_db=col(p_d["drive_db"]),
                  dist_gain_db=col(p_d["output_gain_db"]))
        if with_masks:
            kw["dist_active"] = mask()
    shared_lead = (B, C) if shared else None
    return x, b[:, None].numpy(), a[:, None].numpy(), kw, shared_lead


def _port(x, b, a, kw, shared_lead, device="cpu"):
    def t(v):
        return (torch.as_tensor(v, device=device)
                if isinstance(v, np.ndarray) else v)

    return eqcomp.eq_compressor_fused(
        t(x), t(b), t(a), shared_lead_shape=shared_lead,
        **{k: t(v) for k, v in kw.items()})


@pytest.mark.parametrize("shared,with_dist,with_masks", [
    (True, True, True),     # the basic chain's head on the shared input
    (False, True, True),    # per-candidate input
    (False, False, True),   # the 2-stage EQ -> compressor form
    (True, False, False),   # no bypass slots
])
def test_plain_matches_pallas_interpret(shared, with_dist, with_masks):
    B, C, T = 3, 2, 3000
    x, b, a, kw, shared_lead = _inputs(B, C, T, 7, shared, with_dist,
                                       with_masks)
    got = _port(x, b, a, kw, shared_lead).numpy()
    want = np.asarray(eq_compressor_fused_pallas(
        jnp.asarray(x), jnp.asarray(b), jnp.asarray(a),
        shared_lead_shape=shared_lead, t_block=512, interpret=True,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}))
    assert got.shape == want.shape == (B, C, T)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_launch_count_is_zero_on_cpu():
    x, b, a, kw, shared_lead = _inputs(2, 2, 64, 1, True, True, True)
    before = eqcomp.launches
    _port(x, b, a, kw, shared_lead)
    assert eqcomp.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
def test_kernel_matches_plain_on_card(cuda_device, shared):
    # 74 lanes: three 32-lane blocks, the last one ragged; T ragged too
    B, C, T = 37, 2, 2000
    x, b, a, kw, shared_lead = _inputs(B, C, T, 11, shared, True, True)
    want = _port(x, b, a, kw, shared_lead).numpy()
    before = eqcomp.launches
    got = _port(x, b, a, kw, shared_lead, cuda_device)
    torch.cuda.synchronize()
    assert eqcomp.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want, atol=1e-4)
