"""K10, the batched complex DFT of the ``fused`` LTI path: the port's plain
version (``torch.fft``) against st_ito_tpu's fft_fused run in interpret mode,
the shape rule both packages share, and (on a card only) the CUDA kernel
against the plain version.

Tolerance: 2e-5 x the spectrum's peak, the JAX package's own for its kernel
(``tests/test_fused_fft.py``): its 3-pass bf16 contractions reach about
1e-5 of the peak after two stages, while torch.fft is float32 throughout.
On the card the kernel is held within 1e-4 x max|want| of the plain
version, as chip_smoke.py holds every FFT kernel."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from st_ito_tpu.ops.pallas import fused_fft as jax_fused_fft

from st_ito_torch.ops.kernels import fused_fft, mega_fft
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

N = 2 ** 14  # the smallest size ``supported`` admits: n1 = n2 = 128
TOL = 2e-5


def _cplx(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _both(z, **kw):
    """(port, JAX) outputs of one call as complex numpy arrays."""
    yr, yi = fused_fft.fft_fused(torch.from_numpy(z.real.copy()),
                                 torch.from_numpy(z.imag.copy()), **kw)
    jr, ji = jax_fused_fft.fft_fused(jnp.asarray(z.real), jnp.asarray(z.imag),
                                     interpret=True, **kw)
    return (yr.numpy() + 1j * yi.numpy(),
            np.asarray(jr) + 1j * np.asarray(ji))


@pytest.mark.parametrize("in_len,sign,out_len", [
    (N, -1, None),         # full input
    (N // 2, -1, None),    # a guard band: the second half an implicit pad
    (N, 1, N // 2),        # the inverse keeping the first half
    (N, 1, 1000),          # an odd out_len, not a multiple of n1
])
def test_plain_matches_pallas_interpret(in_len, sign, out_len):
    z = _cplx((2, in_len), in_len + sign)
    got, want = _both(z, sign=sign, n=N, out_len=out_len)
    assert got.shape == want.shape == (2, out_len or N)
    full = np.pad(z, ((0, 0), (0, N - in_len)))
    peak = np.abs(np.fft.fft(full) if sign < 0
                  else np.fft.ifft(full) * N).max()
    assert np.abs(got - want).max() <= TOL * peak


@pytest.mark.parametrize("n,in_len", [
    (4100, 4096), (131072, 131000), (131072, 65536), (N, N // 2), (8192, 8192),
    (2 ** 19, 2 ** 18), (2 ** 19, 2 ** 19 + 512),
])
def test_supported_is_the_jax_rule(n, in_len):
    assert fused_fft.supported(n, in_len) == jax_fused_fft.supported(n, in_len)


def test_unsupported_shapes_and_precisions_raise():
    z = torch.zeros(1, 4096)
    with pytest.raises(ValueError, match="fused_fft"):
        fused_fft.fft_fused(z, z, n=4100)
    with pytest.raises(ValueError, match="fused_fft"):
        fused_fft.fft_fused(z, z, n=8192)  # n2 = 64 < 128
    with pytest.raises(NotImplementedError, match="float32"):
        fused_fft.fft_fused(torch.zeros(1, N), torch.zeros(1, N),
                            precision="default")


@pytest.mark.parametrize("n", [N, 2 ** 15, 2 ** 19])
def test_root_tables_form_every_twiddle(n):
    """The kernel's twiddle between its passes, W_n^(k1*j2) for k1 < n1 and
    j2 < n2, as the product of its two root tables W_n^(h*n1) x W_n^l
    (k1*j2 = h*n1 + l), in float32 as the kernel forms it, against the
    exact root: within 3e-7 (a few float32 roundings)."""
    n1, n2 = mega_fft._radix(n)
    roots = fused_fft._roots(n, "cpu")
    k1 = torch.arange(n1)[:, None]
    j2 = torch.arange(0, n2, max(1, n2 // 64))[None, :]
    e = k1 * j2
    a = torch.complex(*roots[e >> (n1.bit_length() - 1)].unbind(-1))
    b = torch.complex(*roots[n2 + (e & (n1 - 1))].unbind(-1))
    exact = torch.exp(-2j * np.pi * e.to(torch.float64) / n)
    assert float((a * b - exact).abs().max()) <= 3e-7


def test_launch_count_is_zero_on_cpu():
    z = torch.zeros(1, N)
    before = fused_fft.launches
    fused_fft.fft_fused(z, z, precision="highest")
    assert fused_fft.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,in_len,sign,out_len", [
    (N, N // 2, -1, None), (2 ** 15, 2 ** 15, 1, 1000),
    (2 ** 15, 3 * 128, -1, 2 ** 14)])
def test_kernel_matches_plain_on_card(cuda_device, n, in_len, sign,
                                      out_len):
    # B 11 candidates through the kernel's scratch ring of 9: slots reused
    z = _cplx((11, in_len), 3)
    zr, zi = torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy())
    want = fused_fft.fft_fused(zr, zi, sign=sign, n=n, out_len=out_len)
    before = fused_fft.launches
    got = fused_fft.fft_fused(zr.to(cuda_device), zi.to(cuda_device),
                              sign=sign, n=n, out_len=out_len)
    torch.cuda.synchronize()
    assert fused_fft.launches == before + 1
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_fused_group_on_a_broadcast_input_matches_mx_on_card(cuda_device):
    """The group K10 -> K9 -> K10 on a population-broadcast (stride 0)
    input, as a chain that opens with its LTI group hands it, against the
    mx path: atol 5e-5, rtol 1e-4 on a peak-normalised input."""
    from st_ito_torch.ops import lti
    from st_ito_torch.ops.kernels.packed_response import rp_tables

    B, T, n = 5, 2 ** 13, 2 ** 14
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, T)).astype(np.float32)
    x = torch.from_numpy(x / np.abs(x).max()).to(cuda_device)
    x = x[None].expand(B, 2, T)
    stages = [("delay", {
        "delay_seconds": torch.full((B,), 0.05, device=cuda_device),
        "feedback": torch.full((B,), 0.5, device=cuda_device),
        "mix": torch.linspace(0.1, 0.9, B, device=cuda_device)}, None)]
    tables = rp_tables(["delay"], 48000, n, cuda_device)
    before = fused_fft.launches
    got = lti.packed_lti_apply_rp(x, stages, n, tables, fft_impl="fused")
    want = lti.packed_lti_apply_rp(x, stages, n, tables)
    torch.cuda.synchronize()
    assert fused_fft.launches == before + 2
    assert float(((got - want).abs() - 1e-4 * want.abs()).max()) <= 5e-5
