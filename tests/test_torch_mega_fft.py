"""K5, K4, K2, K3 and the mega / mega2 groups: the port's plain PyTorch
versions against st_ito_tpu's Pallas kernels in interpret mode, at the two
smallest sizes the path admits (n = 2^14 splits 128 x 128, n = 2^15 splits
256 x 128), and (on a card only) the CUDA kernels against the plain
versions.

Tolerances. Spectra: 2e-5 x max|want| per comparison on the bins k <= n/2
(the JAX tests' limit for its 3-pass bf16 dots against a float64 FFT,
``tests/test_mega_fft.py``; bins past n/2 are junk on both sides). Response
outputs: 1e-4 x max|want| (K9's limit). Time-domain groups: atol 5e-5,
rtol 1e-4 (``tests/test_mega_fft.py:124``)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from st_ito_tpu.ops.pallas import mega_fft as jmf
from st_ito_tpu.ops.pallas.packed_response import (
    packed_response_apply_rp_padded as jax_k2,
)

import chip_smoke as cs
from st_ito_torch.chain import rp_responses as rp
from st_ito_torch.ops.kernels import mega_fft as mf
from st_ito_torch.ops.kernels import packed_response as k9

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000
# (n, T): T = n/2 and a T < n/2 that is a multiple of n2 = 128
SIZES = [(2 ** 14, 2 ** 13), (2 ** 15, 37 * 128)]
B = 8  # the JAX K2 and the executor's mega gate take B % 8 == 0


def _x(n, T, seed, Bx=B):
    x = np.random.default_rng(seed).standard_normal((Bx, 2, T))
    return (x / np.abs(x).max()).astype(np.float32)


def _stages(seed, with_masks, Bx=B):
    """Delay (fractional, so DC and Nyquist responses are complex) + reverb,
    as numpy; masks mixed per stage or absent."""
    rng = np.random.default_rng(seed)
    delay = {"delay_seconds": rng.uniform(0.01, 0.2, Bx) + 0.37 / SR,
             "feedback": rng.uniform(0.05, 0.7, Bx),
             "mix": rng.uniform(0.0, 1.0, Bx)}
    reverb = {k: rng.uniform(0.0, 1.0, Bx)
              for k in ("room_size", "damping", "wet_dry", "width")}
    out = []
    for effect, p in (("delay", delay), ("reverb", reverb)):
        m = None
        if with_masks:
            m = rng.random(Bx) > 0.4
            m[0] = True
        out.append((effect, {k: v.astype(np.float32) for k, v in p.items()},
                    m))
    return out


def _t_stages(stages, device="cpu"):
    return [(e, {k: torch.as_tensor(v, device=device) for k, v in p.items()},
             None if m is None else torch.as_tensor(m, device=device))
            for e, p, m in stages]


def _j_stages(stages):
    return [(e, {k: jnp.asarray(v) for k, v in p.items()},
             None if m is None else jnp.asarray(m)) for e, p, m in stages]


def _valid(arrays, n):
    """The F valid bins of each half-grid array, as numpy (B, F)."""
    F = n // 2 + 1
    return [np.asarray(a).reshape(np.asarray(a).shape[0], -1)[:, :F]
            for a in arrays]


def _assert_rel(got, want, rel):
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float(np.abs(g - w).max())
        assert np.isfinite(err) and err <= rel * scale, (err, scale)


GRID = [(n, T) for n in (0, 100, 4096, 8192, 2 ** 14, 2 ** 15, 2 ** 17,
                         2 ** 19, 2 ** 20)
        for T in (0, 64, 128, 4096, 8192, 8200, 2 ** 14, 37 * 128, 2 ** 18,
                  2 ** 19, 2 ** 21)]


@pytest.mark.parametrize("n,T", GRID)
def test_supported_matches_jax(n, T):
    assert mf.supported(n, T) == jmf.supported(n, T)


@pytest.mark.parametrize("n", [2 ** k for k in range(8, 22)])
def test_radix_and_half_grid_match_jax(n):
    assert mf._radix(n) == jmf._radix(n)
    assert mf.half_grid(n) == jmf.half_grid(n)


def test_radix_rejects_other_sizes():
    with pytest.raises(ValueError, match="power-of-two"):
        mf._radix(3000)
    with pytest.raises(ValueError, match="unsupported"):
        mf.fwd_pack_fft(torch.zeros(1, 2, 100), 128)


@pytest.mark.parametrize("n,T", SIZES)
def test_k5_plain_matches_jax(n, T):
    x = _x(n, T, 1)
    got = mf.fwd_pack_fft(torch.from_numpy(x), n)
    want = jmf.fwd_pack_fft(jnp.asarray(x), n, interpret=True)
    assert tuple(got[0].shape) == want[0].shape == (B,) + mf.half_grid(n)
    _assert_rel(_valid(got, n), _valid(want, n), 2e-5)


@pytest.mark.parametrize("n,T", SIZES)
def test_k4_plain_matches_jax_and_ignores_masked_bins(n, T):
    """A random full spectrum presented as (Ylo, Yhig), with junk in every
    bin the inverse must not read: past n/2 in both, and the DC and Nyquist
    duplicates of Yhig."""
    rng = np.random.default_rng(2)
    Y = (rng.standard_normal((B, n)) + 1j * rng.standard_normal((B, n))
         ).astype(np.complex64)
    F = n // 2 + 1
    Rp, n1 = mf.half_grid(n)
    lo = np.zeros((B, Rp * n1), np.complex64)
    hig = np.zeros((B, Rp * n1), np.complex64)
    lo[:, :F] = Y[:, :F]
    hig[:, :F] = Y[:, (n - np.arange(F)) % n]
    lo[:, F:] = 99.0
    hig[:, F:] = -99.0
    hig[:, 0] = 123.0
    hig[:, F - 1] = -123.0
    parts = [a.reshape(B, Rp, n1).copy()
             for a in (lo.real, lo.imag, hig.real, hig.imag)]
    got = mf.inv_unpack_fft(*(torch.from_numpy(a) for a in parts), n,
                            T).numpy()
    want = np.asarray(jmf.inv_unpack_fft(*(jnp.asarray(a) for a in parts), n,
                                         T, interpret=True))
    assert got.shape == want.shape == (B, 2, T)
    _assert_rel([got], [want], 2e-5)
    # and against the transform itself
    ref = np.fft.ifft(Y.astype(np.complex128), axis=-1)[:, :T]
    _assert_rel([got[:, 0], got[:, 1]], [ref.real, ref.imag], 2e-5)
    # NaN in the masked bins never reaches the output
    for a, sl in ((parts[0], slice(F, None)), (parts[1], slice(F, None)),
                  (parts[2], slice(F - 1, None)),
                  (parts[3], slice(F - 1, None))):
        a.reshape(B, -1)[:, sl] = np.nan
    parts[2][:, 0, 0] = parts[3][:, 0, 0] = np.nan
    again = mf.inv_unpack_fft(*(torch.from_numpy(a) for a in parts), n,
                              T).numpy()
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("with_masks", [True, False])
@pytest.mark.parametrize("n,T", SIZES)
def test_k2_plain_matches_jax(n, T, with_masks):
    rng = np.random.default_rng(3)
    Rp, n1 = mf.half_grid(n)
    Z = [rng.standard_normal((B, Rp, n1)).astype(np.float32)
         for _ in range(4)]
    stages = _stages(4, with_masks)
    tables = k9.rp_tables(["delay", "reverb"], SR, n, "cpu")
    got = k9.packed_response_apply_rp_padded(
        *(torch.from_numpy(z) for z in Z), _t_stages(stages), tables, n)
    want = jax_k2(*(jnp.asarray(z) for z in Z), _j_stages(stages), n, SR,
                  n // 2 + 1, Rp * n1, interpret=True)
    assert tuple(got[0].shape) == want[0].shape == (B, Rp, n1)
    _assert_rel(_valid(got, n), _valid(want, n), 1e-4)
    # the plain version zeroes what the kernel leaves as junk
    assert all(float(g.reshape(B, -1)[:, n // 2 + 1:].abs().max()) == 0.0
               for g in got)


@pytest.mark.parametrize("with_masks", [True, False])
@pytest.mark.parametrize("n,T", SIZES)
def test_k3_plain_matches_jax(n, T, with_masks):
    x = _x(n, T, 5)
    stages = _stages(6, with_masks)
    got = mf.fwd_pack_fft_response(torch.from_numpy(x), _t_stages(stages), n,
                                   SR)
    want = jmf.fwd_pack_fft_response(jnp.asarray(x), _j_stages(stages), n,
                                     SR, interpret=True)
    assert tuple(got[0].shape) == want[0].shape == (B,) + mf.half_grid(n)
    _assert_rel(_valid(got, n), _valid(want, n), 1e-4)


@pytest.mark.parametrize("with_masks", [True, False])
@pytest.mark.parametrize("group", ["mega", "mega2"])
@pytest.mark.parametrize("n,T", SIZES)
def test_group_matches_jax(n, T, group, with_masks):
    x = _x(n, T, 7)
    stages = _stages(8, with_masks)
    got = getattr(mf, f"packed_lti_apply_{group}")(
        torch.from_numpy(x), _t_stages(stages), n, SR).numpy()
    want = np.asarray(getattr(jmf, f"packed_lti_apply_{group}")(
        jnp.asarray(x), _j_stages(stages), n, SR, interpret=True))
    assert got.shape == want.shape == (B, 2, T)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("n,T", SIZES)
def test_groups_match_the_mx_path(n, T):
    """mega2 == mega == the port's own mx path (ops/lti.py): on the CPU all
    three are torch.fft around the same response math."""
    from st_ito_torch.ops.lti import packed_lti_apply_rp

    x = torch.from_numpy(_x(n, T, 9, Bx=5))
    stages = _t_stages(_stages(10, True, Bx=5))
    tables = k9.rp_tables(["delay", "reverb"], SR, n, "cpu")
    mx = packed_lti_apply_rp(x, stages, n, tables).numpy()
    for fn in (mf.packed_lti_apply_mega, mf.packed_lti_apply_mega2):
        np.testing.assert_allclose(fn(x, stages, n, SR).numpy(), mx,
                                   atol=5e-5, rtol=1e-4)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(n, T, dev):
    Bc = 37
    x = torch.from_numpy(_x(n, T, 11, Bx=Bc))
    stages = _stages(12, True, Bx=Bc)
    return Bc, x, stages, x.to(dev), _t_stages(stages, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n,T", SIZES)
def test_fft_kernels_match_plain_on_card(cuda_device, n, T):
    # 37 candidates: K5, K3 and K4, one persistent launch each, through
    # their ring of 9 one-candidate scratch slots four times over
    _, x, stages, xd, stages_d = _card_case(n, T, cuda_device)
    before = dict(mf.launches)
    Z = mf.fwd_pack_fft(xd, n)
    Z_want = mf.fwd_pack_fft(x, n)
    _assert_rel(_valid([z.cpu() for z in Z], n), _valid(Z_want, n), 1e-4)
    Y = mf.fwd_pack_fft_response(xd, stages_d, n, SR)
    Y_want = mf.fwd_pack_fft_response(x, _t_stages(stages), n, SR)
    _assert_rel(_valid([y.cpu() for y in Y], n), _valid(Y_want, n), 1e-4)
    y = mf.inv_unpack_fft(*Y, n, T)
    torch.cuda.synchronize()
    _assert_rel([y.cpu().numpy()],
                [mf.inv_unpack_fft(*Y_want, n, T).numpy()], 1e-4)
    assert {k: mf.launches[k] - before[k] for k in before} == {
        "fwd_pack_fft": 1, "fwd_pack_fft_response": 1, "inv_unpack_fft": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("n,T", SIZES)
def test_k2_kernel_matches_plain_on_card(cuda_device, n, T):
    Bc, x, stages, _, stages_d = _card_case(n, T, cuda_device)
    Z = mf.fwd_pack_fft(x, n)
    tables = k9.rp_tables(["delay", "reverb"], SR, n, "cpu")
    want = k9.packed_response_apply_rp_padded(*Z, _t_stages(stages), tables,
                                              n)
    before = k9.launches_padded
    got = k9.packed_response_apply_rp_padded(
        *(z.to(cuda_device) for z in Z), stages_d,
        k9.rp_tables(["delay", "reverb"], SR, n, cuda_device), n)
    torch.cuda.synchronize()
    assert k9.launches_padded == before + 1
    _assert_rel(_valid([g.cpu() for g in got], n), _valid(want, n), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,T", SIZES)
def test_k3_kernel_matches_k5_k2_on_card(cuda_device, n, T):
    """K3 within 1e-4 x max|want| of K5 -> K2 on the card (it forms the
    Freeverb phasors from factors and divides approximately, so no longer
    bitwise)."""
    _, _, _, xd, stages_d = _card_case(n, T, cuda_device)
    tables = k9.rp_tables(["delay", "reverb"], SR, n, cuda_device)
    want = k9.packed_response_apply_rp_padded(*mf.fwd_pack_fft(xd, n),
                                              stages_d, tables, n)
    got = mf.fwd_pack_fft_response(xd, stages_d, n, SR)
    torch.cuda.synchronize()
    _assert_rel(_valid([g.cpu() for g in got], n),
                _valid([w.cpu() for w in want], n), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,T", SIZES)
def test_k3_kernel_holds_on_comb_resonances_on_card(cuda_device, n, T):
    """At the delay's resonances K3 (the approximate divide, the factored
    phasors) stays within 1e-4 x max|want| of its plain version and of
    K5 -> K2."""
    Bc = 37
    x = torch.from_numpy(_x(n, T, 13, Bx=Bc))
    stages = cs.resonant_stage_case(Bc, np.random.default_rng(14), "cpu")
    stages_d = _t_stages(stages, cuda_device)
    xd = x.to(cuda_device)
    got = mf.fwd_pack_fft_response(xd, stages_d, n, SR)
    want = mf.fwd_pack_fft_response(x, stages, n, SR)
    split = k9.packed_response_apply_rp_padded(
        *mf.fwd_pack_fft(xd, n), stages_d,
        k9.rp_tables(["delay", "reverb"], SR, n, cuda_device), n)
    torch.cuda.synchronize()
    got = _valid([g.cpu() for g in got], n)
    _assert_rel(got, _valid(want, n), 1e-4)
    _assert_rel(got, _valid([s.cpu() for s in split], n), 1e-4)


def test_resonant_stages_sit_on_resonances():
    """The whole delays are exact, so some bins of each candidate have
    k D = 0 mod n and the plain response peaks near 1 / (1 - 0.999) there."""
    n = SIZES[0][0]
    stages = cs.resonant_stage_case(37, np.random.default_rng(14), "cpu")
    D = stages[0][1]["delay_seconds"] * SR
    assert len(cs.RESONANT_D) >= 10 and torch.equal(D, torch.round(D))
    tables = k9.rp_tables(["delay"], SR, n, "cpu")
    kind, (hr, hi) = rp.delay_build(
        {k: v[:, None] for k, v in stages[0][1].items()}, tables["delay"])
    mag = torch.sqrt(hr * hr + hi * hi)
    assert float(mag.amax(1).min()) > 900.0
