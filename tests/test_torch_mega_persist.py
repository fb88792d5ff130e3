"""The persistent kernels K5, K3 and K4 (``csrc/mega_fft.cu`` on the ticket
scheduler of ``csrc/fft_persist.cuh``, shared with K10): their index maps
on the CPU. A replica of the scheduler's ticket decode covers every (pass,
chunk, item) once, and every wait it makes is on an earlier ticket; a torch
model of the kernel's data flow (pass-1 column tiles into a ring of
scratch slots, pass-2 tiles of rows and their mirror rows, taken in ticket
order) equals the plain version's (Zlo, Zrev); the epilogue's walk of the
half-grid bins takes every bin once and pairs it with its mirror; the
Freeverb phasors K3 forms from row and column factors lie
within float32 rounding of the table's, and keep the response within K3's
tolerance. K4, the inverse: the scheduler with its plan, its gather's
reads (each valid bin once), and a torch model of its two passes against
the plain version and the JAX kernel; on a card, the kernel itself. At the
smallest n the mega path admits (2^14: n1 = n2 = 128), at 2^15 and at the
headline's 2^19."""

import math

import numpy as np
import pytest
import torch

from st_ito_torch.chain.rp_responses import (FREEVERB_ROWS,
                                             freeverb_tables)
from st_ito_torch.ops.kernels import mega_fft as mf
from st_ito_torch.ops.kernels import packed_response as k9

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

# csrc/fft_persist.cuh: chunks between a chunk's two passes, scratch slots
LAG, RING = 3, 9
# csrc/fft_core.cuh tile_log: the widest tile of at most 2^4 rows of a
# length whose padded rows fit 70 KB
TILE_BYTES, MAX_TILE_LOG = 70 * 1024, 4


def tile_log(length):
    pitch = length + length // 16 + 4  # row_pitch, in float2
    lg = MAX_TILE_LOG
    while lg > 0 and (pitch * 8) << lg > TILE_BYTES:
        lg -= 1
    return lg


def plan(n, B, pass1_only=False):
    """The kernel's plan (``mega_fft.cu forward``) as a dict: one candidate
    a chunk, its column tiles and row tiles of R rows and R mirror rows."""
    n1, n2 = mf._radix(n)
    log_cw = min(tile_log(n1), n2.bit_length() - 1)
    R = 1 << (min(tile_log(n2), n1.bit_length() - 1) - 1)
    return dict(B=B, n_p1=n2 >> log_cw, n_p2=n1 // (2 * R), cw=1 << log_cw,
                rows=R, pass1_only=pass1_only)


def tickets(p):
    return p["B"] * (p["n_p1"] + (0 if p["pass1_only"] else p["n_p2"]))


def decode(p, t):
    """fft_persist.cuh decode: ticket t -> (pass 1?, chunk, item)."""
    n_p1, n_p2 = p["n_p1"], p["n_p2"]
    if p["pass1_only"]:
        return True, t // n_p1, t % n_p1
    lead = min(LAG, p["B"])
    both = (p["B"] - lead) * (n_p1 + n_p2)
    if t < lead * n_p1:
        return True, t // n_p1, t % n_p1
    if t < lead * n_p1 + both:
        u = t - lead * n_p1
        s, r = lead + u // (n_p1 + n_p2), u % (n_p1 + n_p2)
        return (True, s, r) if r < n_p1 else (False, s - LAG, r - n_p1)
    v = t - lead * n_p1 - both
    return False, p["B"] - lead + v // n_p2, v % n_p2


@pytest.mark.parametrize("B", [1, 3, 9, 10, 37, 512])
@pytest.mark.parametrize("n", [2 ** 14, 2 ** 19])
def test_tickets_cover_every_item_once_and_wait_on_earlier_ones(n, B):
    p = plan(n, B)
    seen = {}
    for t in range(tickets(p)):
        item = decode(p, t)
        assert item not in seen
        seen[item] = t
    chunks = range(B)
    assert set(seen) == ({(True, c, r) for c in chunks
                          for r in range(p["n_p1"])}
                         | {(False, c, r) for c in chunks
                            for r in range(p["n_p2"])})
    for (first, c, r), t in seen.items():
        if first and c >= RING:  # the slot's last reader, chunk c - RING
            assert all(seen[(False, c - RING, q)] < t
                       for q in range(p["n_p2"]))
        if not first:  # every pass-1 item of the chunk
            assert all(seen[(True, c, q)] < t for q in range(p["n_p1"]))


def test_pass1_only_tickets_are_the_pass1_items():
    p = plan(2 ** 14, 37, pass1_only=True)
    items = [decode(p, t) for t in range(tickets(p))]
    assert items == [(True, c, r) for c in range(37)
                     for r in range(p["n_p1"])]


def _bitrev(v, bits):
    return int(format(v, f"0{bits}b")[::-1], 2)


def _slot_row(sl, a, R, n1):
    if sl < R:
        return a + sl
    k1 = a + sl - R
    return n1 // 2 if k1 == 0 else n1 - k1


def _epilogue_items(n, R, tile):
    """mega_fft.cu mirror_rows_tile's epilogue walk of one tile: the list
    of (slot, position q, mirror slot, mirror position) in the threads'
    order, the Nyquist item last in the first tile."""
    n1, n2 = mf._radix(n)
    bits = n2.bit_length() - 1
    a, first = tile * R, tile == 0
    out = []
    for it in range(R * n2 + (1 if first else 0)):
        if it < R * n2:
            sl, q = it % (2 * R), (it // (2 * R)) * 2
        else:
            sl, q = 0, 1
        self_ = first and sl in (0, R)
        msl = sl if self_ else sl ^ R
        k2 = _bitrev(q, bits)
        mq = (_bitrev((n2 - k2) % n2, bits) if first and sl == 0
              else n2 - 1 - q)
        out.append((sl, q, msl, mq))
    return out


@pytest.mark.parametrize("n", [2 ** 14, 2 ** 15, 2 ** 19])
def test_epilogue_walk_takes_every_bin_with_its_mirror(n):
    """The epilogue's walk over the row tiles takes each bin of the half
    grid once, the Nyquist bin as the first tile's last item, and the
    item's mirror slot and position hold the bin (n - k) mod n."""
    n1, n2 = mf._radix(n)
    R = plan(n, 1)["rows"]
    assert R == (4 if n2 > 512 else 8)  # 16 rows of n2 <= 512 in 70 KB
    bits = n2.bit_length() - 1
    bins, mirrors = [], []
    for tile in range(n1 // (2 * R)):
        a = tile * R
        for sl, q, msl, mq in _epilogue_items(n, R, tile):
            bins.append(_bitrev(q, bits) * n1 + _slot_row(sl, a, R, n1))
            mirrors.append(_bitrev(mq, bits) * n1 + _slot_row(msl, a, R, n1))
    assert bins[R * n2] == n // 2
    assert sorted(bins) == list(range(n // 2 + 1))
    for k, m in zip(bins, mirrors):
        assert m == (n - k) % n


# the (cos, sin) rows of the Freeverb table's 17 phasors, in the order of
# its "_phasor_delays" and of the kernel's factors: z^-1, then comb j of
# channel ch at 1 + 8*ch + j
PHASOR_ROWS = ([(0, 1)] + [(2 + j, 10 + j) for j in range(8)]
               + [(18 + j, 26 + j) for j in range(8)])


def _factored(tables, n):
    """The phasors K3 forms (mega_fft.cu FactoredTab), bin by bin: u[d][k2]
    times v[d][k1] in float32, as (cos, sin) rows in the table's layout."""
    n1, _ = mf._radix(n)
    table = tables["_packed"]
    u, v = mf.freeverb_factors(tables["_phasor_delays"], n, table.device)
    k = torch.arange(n // 2 + 1)
    a, b = u[k // n1, :17].transpose(0, 1), v[k % n1, :17].transpose(0, 1)
    re = a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1]
    im = a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]
    out = table.clone()
    for d, (rc, rs) in enumerate(PHASOR_ROWS):
        out[rc], out[rs] = re[d], im[d]
    return out


@pytest.mark.parametrize("n", [2 ** 14, 2 ** 15, 2 ** 19])
def test_factored_phasors_match_the_table(n):
    """Every phasor of every bin, formed from the factors (exact phases in
    float64, rounded once), within float32 rounding (1e-6) of the table's
    own value (whose phase is rounded in float32)."""
    tables = freeverb_tables(48000, n, n // 2 + 1)
    table = tables["_packed"]
    got = _factored(tables, n)
    assert float((got - table).abs().max()) <= 1e-6
    assert torch.equal(got[mf.ALLPASS_ROWS], table[mf.ALLPASS_ROWS])


def test_factored_phasors_keep_k3_within_its_tolerance():
    """K2's plain version with the table's phasors replaced by the
    factored ones (the response K3's epilogue forms) against it with the
    table: within 1e-4 x max|want| (measured 5.7e-6), on the reverb's
    resonances at every room size and damping."""
    n, B = 2 ** 14, 16
    F = n // 2 + 1
    rng = np.random.default_rng(9)
    tables = k9.rp_tables(["reverb"], 48000, n, "cpu")
    Z = [torch.from_numpy(rng.standard_normal((B, F)).astype(np.float32))
         for _ in range(4)]
    params = {k: torch.from_numpy(rng.uniform(0.0, 1.0, B).astype(
        np.float32)) for k in ("room_size", "damping", "wet_dry", "width")}
    params["room_size"][:2] = torch.tensor([1.0, 0.0])
    params["damping"][:2] = torch.tensor([0.0, 1.0])
    stages = [("reverb", params, None)]
    want = k9.packed_response_plain(*Z, stages, tables)
    packed = _factored(tables["reverb"], n)
    factored, i = {"_packed": packed}, 0
    for name, count in FREEVERB_ROWS:
        factored[name] = packed[i:i + count]
        i += count
    got = k9.packed_response_plain(*Z, stages, {"reverb": factored})
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert err <= 1e-4 * scale, (err, scale)


def forward_model(x, n):
    """The persistent forward's data flow in torch (complex128): tickets in
    order; a pass-1 item transforms a column tile of its candidate over j1
    and writes it, times the twiddle, to the candidate's ring slot; a
    pass-2 item takes the tile's rows and their mirrors from the slot,
    transforms them over j2 and emits each epilogue item's (Zlo, Zrev) at
    its bin. Returns flat (B, n/2 + 1) Zlo and Zrev, NaN where no item
    wrote."""
    B, _, T = x.shape
    n1, n2 = mf._radix(n)
    bits = n2.bit_length() - 1
    p = plan(n, B)
    R = p["rows"]
    z = torch.zeros((B, n), dtype=torch.complex128)
    z[:, :T] = torch.complex(x[:, 0].double(), x[:, 1].double())
    z = z.reshape(B, n1, n2)  # [b, j1, j2]
    slots = torch.full((RING, n1, n2), math.nan, dtype=torch.complex128)
    k1 = torch.arange(n1, dtype=torch.float64)[:, None]
    F = n // 2 + 1
    lo = torch.full((B, F), math.nan, dtype=torch.complex128)
    rev = lo.clone()
    for t in range(tickets(p)):
        first, c, r = decode(p, t)
        slot = slots[c % RING]
        if first:
            j2 = torch.arange(r * p["cw"], (r + 1) * p["cw"])
            cols = torch.fft.fft(z[c][:, j2], dim=0)  # [k1, j2]
            tw = torch.exp(-2j * math.pi * k1 * j2.double()[None, :] / n)
            slot[:, j2] = cols * tw
            continue
        rows = [_slot_row(sl, r * R, R, n1) for sl in range(2 * R)]
        Y = torch.fft.fft(slot[rows], dim=1)  # [slot, k2]
        for sl, q, msl, mq in _epilogue_items(n, R, r):
            k = _bitrev(q, bits) * n1 + rows[sl]
            lo[c, k] = Y[sl, _bitrev(q, bits)]
            rev[c, k] = Y[msl, _bitrev(mq, bits)]
    return lo, rev


@pytest.mark.parametrize("B", [13, 2])
def test_forward_model_matches_plain(B):
    """B 13 (the ring of 9 slots taken again), 2 (fewer candidates than
    the lag), T n/2: the model's spectra equal torch.fft's to 1e-12
    relative, and the plain version's within float32 rounding."""
    n, T = 2 ** 14, 2 ** 13
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((B, 2, T)))
    lo, rev = forward_model(x, n)
    want = mf.fwd_pack_fft_plain(x.float(), n)
    F = n // 2 + 1
    zw = [w.reshape(B, -1)[:, :F].double() for w in want]
    z = torch.fft.fft(torch.complex(x[:, 0], x[:, 1]), n=n, dim=-1)
    ref_lo = z[:, :F]
    ref_rev = torch.cat([z[:, :1], torch.flip(z[:, n // 2:], (-1,))], -1)
    scale = float(ref_lo.abs().max())
    assert float((lo - ref_lo).abs().max()) <= 1e-12 * scale
    assert float((rev - ref_rev).abs().max()) <= 1e-12 * scale
    assert float((torch.complex(zw[0], zw[1]) - lo).abs().max()) \
        <= 1e-5 * scale
    assert float((torch.complex(zw[2], zw[3]) - rev).abs().max()) \
        <= 1e-5 * scale


# ------------------------------------------------------------------- K4


def inverse_plan(n, B):
    """K4's plan (``mega_fft.cu inv_unpack_fft_launch``), K10's: pass-1
    items are tiles of cw adjacent columns j2 (transforms of length n1 over
    the bins u = j1*n2 + j2), pass-2 items tiles of `rows` rows k1
    (transforms of length n2)."""
    n1, n2 = mf._radix(n)
    log_cw = min(tile_log(n1), n2.bit_length() - 1)
    log_rows = min(tile_log(n2), n1.bit_length() - 1)
    return dict(B=B, n_p1=n2 >> log_cw, n_p2=n1 >> log_rows, cw=1 << log_cw,
                rows=1 << log_rows, pass1_only=False)


@pytest.mark.parametrize("B", [1, 2, 3, 9, 10, 37])
@pytest.mark.parametrize("n", [2 ** 14, 2 ** 15, 2 ** 19])
def test_inverse_tickets_cover_every_item_once_and_wait_on_earlier_ones(n,
                                                                        B):
    """The scheduler's decode with K4's plan: each (pass, candidate, item)
    once, every pass-2 item after all of its candidate's pass-1 items, and
    every pass-1 item whose ring slot was used RING candidates earlier after
    all of that candidate's pass-2 items (the waits are on earlier tickets,
    so every wait ends)."""
    p = inverse_plan(n, B)
    n1, n2 = mf._radix(n)
    assert (p["n_p1"] * p["cw"], p["n_p2"] * p["rows"]) == (n2, n1)
    seen = {}
    for t in range(tickets(p)):
        item = decode(p, t)
        assert item not in seen
        seen[item] = t
    assert set(seen) == ({(True, c, r) for c in range(B)
                          for r in range(p["n_p1"])}
                         | {(False, c, r) for c in range(B)
                            for r in range(p["n_p2"])})
    for (first, c, r), t in seen.items():
        if first and c >= RING:
            assert all(seen[(False, c - RING, q)] < t
                       for q in range(p["n_p2"]))
        if not first:
            assert all(seen[(True, c, q)] < t for q in range(p["n_p1"]))


def inverse_gather(n, u):
    """K4's pass-1 gather rule (``mega_fft.cu HalfGridInput``): the array
    ("lo" or "hi") and bin it reads for Y[u]."""
    return ("lo", u) if u <= n // 2 else ("hi", n - u)


@pytest.mark.parametrize("n", [2 ** 14, 2 ** 15, 2 ** 19])
def test_inverse_gather_reads_each_valid_bin_once(n):
    """Over every bin u = j1*n2 + j2 the gather reads Ylo at each k <= n/2
    once and Yhig at each 1 <= k <= n/2 - 1 once, nothing else, and the bin
    it reads holds Y[u] (Ylo[k] = Y[k], Yhig[m] = Y[n - m])."""
    n1, n2 = mf._radix(n)
    reads = {"lo": [], "hi": []}
    for j1 in range(n1):
        for j2 in range(n2):
            u = j1 * n2 + j2
            src, m = inverse_gather(n, u)
            assert m == (u if src == "lo" else n - u)
            reads[src].append(m)
    assert sorted(reads["lo"]) == list(range(n // 2 + 1))
    assert sorted(reads["hi"]) == list(range(1, n // 2))


def inverse_model(parts, n, T):
    """K4's data flow in torch (complex64, as the kernel's float32 pairs):
    tickets in order; a pass-1 item gathers its column tile (bins
    u = j1*n2 + j2 of its columns j2) by the gather rule, transforms it
    over j1 and writes it, times the conjugated product of the two root
    tables (``mega_fft._roots``), to the candidate's ring slot; a pass-2
    item transforms its rows k1 over j2 and writes the samples
    v = k2*n1 + k1 < T, scaled by 1/n. Returns (B, 2, T), NaN where no item
    wrote."""
    n1, n2 = mf._radix(n)
    flat = [a.reshape(a.shape[0], -1) for a in parts]
    arrays = {"lo": torch.complex(flat[0], flat[1]),
              "hi": torch.complex(flat[2], flat[3])}
    B = flat[0].shape[0]
    p = inverse_plan(n, B)
    roots = mf._roots(n, "cpu")
    roots = torch.complex(roots[:, 0], roots[:, 1])
    slots = torch.full((RING, n1, n2), math.nan, dtype=torch.complex64)
    y = torch.full((B, n), math.nan, dtype=torch.complex64)
    j1 = torch.arange(n1)
    for t in range(tickets(p)):
        first, c, r = decode(p, t)
        slot = slots[c % RING]
        if first:
            for j2 in range(r * p["cw"], (r + 1) * p["cw"]):
                col = torch.stack([arrays[src][c, m] for src, m in (
                    inverse_gather(n, int(u)) for u in j1 * n2 + j2)])
                a = torch.fft.ifft(col, norm="forward")  # over j1, unscaled
                e = j1 * j2  # k1 runs over the same range as j1
                w = roots[e // n1] * roots[n2 + e % n1]
                slot[:, j2] = a * w.conj()
            continue
        k1 = torch.arange(r * p["rows"], (r + 1) * p["rows"])
        out = torch.fft.ifft(slot[k1], dim=1, norm="forward") / n  # [k1, k2]
        y[c].view(n2, n1)[:, k1] = out.transpose(0, 1)
    y = y[:, :T]
    return torch.stack([y.real, y.imag], dim=1)


def _half_grid_case(B, n, seed):
    """A random full spectrum Y as K4's inputs (YloR, YloI, YhigR, YhigI),
    NaN in every bin K4 must not read (chip_smoke.py poison)."""
    import chip_smoke as cs

    rng = np.random.default_rng(seed)
    Y = (rng.standard_normal((B, n)) + 1j * rng.standard_normal((B, n))
         ).astype(np.complex64)
    F = n // 2 + 1
    Rp, n1 = mf.half_grid(n)
    lo = np.zeros((B, Rp * n1), np.complex64)
    hig = np.zeros((B, Rp * n1), np.complex64)
    lo[:, :F] = Y[:, :F]
    hig[:, :F] = Y[:, (n - np.arange(F)) % n]
    parts = [torch.from_numpy(a.reshape(B, Rp, n1).copy())
             for a in (lo.real, lo.imag, hig.real, hig.imag)]
    return parts, cs.poison(parts, n)


@pytest.mark.parametrize("T_rows", ["half", 33])
@pytest.mark.parametrize("n", [2 ** 14, 2 ** 15])
def test_inverse_model_matches_plain_and_jax(n, T_rows):
    """The model of K4's two passes, fed NaN in every bin it must not read,
    against the plain version (torch.fft.ifft on the valid bins): within
    1e-6 x max|want| (measured 1.8e-7 to 2.3e-7: the root-table twiddle and
    the transforms' float32 roundings); and against the JAX kernel
    (interpret mode) on the clean inputs within 2e-5 x max|want|, the JAX
    tests' own limit for its three-pass bf16 products
    (``tests/test_mega_fft.py``), which put the JAX kernel itself 0.85e-5
    to 1.01e-5 from the plain version here. B 3, T = n/2 and 33 x 128."""
    import jax.numpy as jnp

    from st_ito_tpu.ops.pallas import mega_fft as jmf

    T = n // 2 if T_rows == "half" else T_rows * 128
    B = 3
    parts, poisoned = _half_grid_case(B, n, 11)
    got = inverse_model(poisoned, n, T)
    want = mf.inv_unpack_fft_plain(*parts, n, T)
    jax_want = torch.from_numpy(np.array(jmf.inv_unpack_fft(
        *(jnp.asarray(a.numpy()) for a in parts), n, T, interpret=True)))
    assert got.shape == want.shape == jax_want.shape == (B, 2, T)
    assert torch.isfinite(got).all()
    for ref, tol in ((want, 1e-6), (jax_want, 2e-5)):
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= tol * scale


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 10, 37])
def test_inverse_kernel_matches_plain_on_card(cuda_device, B):
    """K4, one persistent launch, against its plain version with NaN in
    every bin it must not read, at n 2^15 (T n/2 and 37 x 128) and n 2^14:
    within 1e-4 x max|want|."""
    for n, T in ((2 ** 15, 2 ** 14), (2 ** 15, 37 * 128), (2 ** 14, 2 ** 13)):
        parts, poisoned = _half_grid_case(B, n, B)
        before = mf.launches["inv_unpack_fft"]
        got = mf.inv_unpack_fft(*(a.to(cuda_device) for a in poisoned), n, T)
        torch.cuda.synchronize()
        assert mf.launches["inv_unpack_fft"] == before + 1
        want = mf.inv_unpack_fft_plain(*parts, n, T)
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
