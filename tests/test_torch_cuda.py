"""The port's CUDA codec kernels on the card, each against its plain
PyTorch version on the same inputs, byte-exact.  Skips without a card.

This file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import itertools

import numpy as np
import pytest
import torch

from glusterfs_tpu_torch.ops import gf256_cuda

STRIPES = [1, 3, 127, 129]

# (k, r) and stripe counts at which the fused kernels are held against
# their plain versions, here and in chip_smoke.py: C = 8k not a multiple
# of 16 (k = 1, 3, 5), the served and timed shapes, and 16+8, whose
# encode has R = 192 output planes (two passes over each tile); one tile
# and its neighbours, unaligned tails, and 4229 stripes, past two whole
# waves of the persistent grid (8 stripes a block, 2 blocks on each of
# 132 SMs: 2112 stripes a wave; the test checks the card's count)
FUSED_CONFIGS = [(1, 1), (3, 2), (5, 3), (4, 2), (8, 4), (16, 4), (16, 8)]
FUSED_STRIPES = [1, 3, 7, 8, 9, 127, 129, 4229]


def _survivors(k, n, seed):
    rng = np.random.default_rng(seed)
    return tuple(sorted(int(x) for x in rng.choice(n, k, replace=False)))


@pytest.mark.cuda
@pytest.mark.parametrize("k,r", FUSED_CONFIGS)
def test_kernels_match_plain_versions_on_card(k, r):
    """Each fused kernel vs its plain version at FUSED_STRIPES: partial
    last tiles (stripes past S are neither read nor written), C not a
    multiple of the 16-plane ring slot, R past 160 (several passes) and
    a grid that walks several tiles a block; each launch counted
    (chip_smoke.py repeats this, and times 4+2, 8+4 and 16+4 at 256
    MiB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    n = k + r
    wave = 8 * torch.cuda.get_device_properties(0).multi_processor_count \
        * max(gf256_cuda.xor_blocks_per_sm(p) for p in (n * 8, k * 8))
    assert max(FUSED_STRIPES) > wave
    gf256_cuda.reset_launches()
    for s in FUSED_STRIPES:
        data = np.random.default_rng(s).integers(0, 256, s * k * 512,
                                                 dtype=np.uint8)
        x = torch.from_numpy(data).to(dev)
        frags = gf256_cuda.fused_encode(x, k, n)
        assert torch.equal(frags, gf256_cuda.encode_plain(x, k, n))
        assert torch.equal(gf256_cuda.fused_parity(x, k, n),
                           gf256_cuda.parity_plain(x, k, n))
        rows = _survivors(k, n, s)
        surv = frags[list(rows)].contiguous()
        assert torch.equal(gf256_cuda.fused_decode(surv, k, rows), x)
        wanted = tuple(j for j in range(k) if j not in rows) or (0,)
        assert torch.equal(
            gf256_cuda.fused_reconstruct(surv, k, rows, wanted),
            gf256_cuda.reconstruct_plain(surv, k, rows, wanted))
    torch.cuda.synchronize()
    assert gf256_cuda.LAUNCHES == {**dict.fromkeys(gf256_cuda.FUSED,
                                                   len(FUSED_STRIPES)),
                                   **dict.fromkeys(gf256_cuda.KERNELS[4:], 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("k,r", [(4, 2), (8, 4), (16, 4)])
def test_plane_major_kernels_match_plain_versions_on_card(k, r):
    """xor_apply, xor3_apply and mxu_apply against their plain versions:
    plane-major with the encode matrix (non-symmetric) and a decode mask,
    and through encode/decode at stripe counts the tile does not divide.
    Each launch is counted (chip_smoke.py repeats this at 256 MiB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    n = k + r
    rows = _survivors(k, n, 7)
    mats = [gf256_cuda._bits("encode", k, (n,)),
            gf256_cuda._bits("decode", k, (rows,))]
    gf256_cuda.reset_launches()
    x = torch.from_numpy(np.random.default_rng(k).integers(
        0, 256, (k * 8, 3 * gf256_cuda.TILE3_W), dtype=np.uint8)).to(dev)
    for abits in mats:
        plain = gf256_cuda.xor_apply_plain(abits, x)
        assert torch.equal(gf256_cuda.mxu_apply_plain(abits, x), plain)
        for form in gf256_cuda.FORMULATIONS:
            assert torch.equal(gf256_cuda.apply_bitmatrix(abits, x, form),
                               plain), form
    for s in STRIPES:
        data = np.random.default_rng(s).integers(0, 256, s * k * 512,
                                                 dtype=np.uint8)
        flat = torch.from_numpy(data).to(dev)
        want = gf256_cuda.encode_plain(flat, k, n)
        for form in gf256_cuda.FORMULATIONS:
            frags = gf256_cuda.encode(flat, k, n, form)
            assert torch.equal(frags, want), (form, s)
            surv = frags[list(rows)].contiguous()
            assert torch.equal(gf256_cuda.decode(surv, rows, k, form),
                               flat), (form, s)
    torch.cuda.synchronize()
    per = len(mats) + 2 * len(STRIPES)
    assert gf256_cuda.LAUNCHES == {**dict.fromkeys(gf256_cuda.FUSED, 0),
                                   "xor_apply": per, "xor3_apply": per,
                                   "mxu_apply": per}


def _bits_and_planes(r, c, w, seed):
    rng = np.random.default_rng(seed)
    abits = rng.integers(0, 2, (r, c), dtype=np.uint8)
    x = rng.integers(0, 256, (c, w), dtype=np.uint8)
    return abits, torch.from_numpy(x).cuda()


def _ones(r, odd_rows):
    """All-ones (r, 128) bit-matrix; with ``odd_rows`` every other row
    drops its last one, so its sums on 0xFF planes are 127, the largest
    odd sum."""
    abits = np.ones((r, 128), dtype=np.uint8)
    if odd_rows:
        abits[1::2, -1] = 0
    return abits


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 24, 40, 128])
@pytest.mark.parametrize("r", [8, 16, 24, 160])
def test_mxu_apply_odd_shapes_on_card(r, c):
    """mxu_apply against its plain version, byte-exact, at k = 1, 3, 5,
    16 input fragments (C not a multiple of 32), R not a multiple of 16,
    and widths of one and of twelve 8 KiB tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    for w in (8192, 3 * 32768):
        abits, x = _bits_and_planes(r, c, w, seed=1000 * r + c)
        got = gf256_cuda.apply_bitmatrix(abits, x, "mxu")
        assert torch.equal(got, gf256_cuda.mxu_apply_plain(abits, x)), w


@pytest.mark.cuda
@pytest.mark.parametrize("odd_rows", [False, True])
def test_mxu_apply_largest_sums_on_card(odd_rows):
    """Every sum at its largest: an all-ones bit-matrix at C = 128 on
    all-0xFF planes gives 128 at every bit (bit 7's operand is -128 as
    s8), and 127 on the rows that drop a one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    abits = _ones(24, odd_rows)
    x = torch.full((128, 8192), 0xFF, dtype=torch.uint8, device="cuda")
    got = gf256_cuda.apply_bitmatrix(abits, x, "mxu")
    want = gf256_cuda.mxu_apply_plain(abits, x)
    assert torch.equal(got, want)
    assert int(want[1, 0]) == (0xFF if odd_rows else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("tight", [True, False])
@pytest.mark.parametrize("n", [15, 16, 31, 32, 63, 64, 127, 128])
def test_mxu_apply_pairing_limits_on_card(n, tight):
    """Row sums each side of a power of two, where the kernel changes how
    many bits of each plane byte one product reads (it pairs two bits
    while every row sum stays below 16, 32, 64 or 128): N ones in the
    even rows, N - 1 in the odd ones, on all-0xFF planes and on random
    ones; C is the fewest whole fragments that hold N (``tight``) or
    128."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    c = -(-n // 8) * 8 if tight else 128
    abits = np.zeros((24, c), dtype=np.uint8)
    abits[:, :n] = 1
    abits[1::2, n - 1] = 0
    ones = torch.full((c, 8192), 0xFF, dtype=torch.uint8, device="cuda")
    got = gf256_cuda.apply_bitmatrix(abits, ones, "mxu")
    assert torch.equal(got, gf256_cuda.mxu_apply_plain(abits, ones))
    assert (int(got[0, 0]), int(got[1, 0])) == \
        ((0xFF, 0) if n % 2 else (0, 0xFF))
    _, x = _bits_and_planes(1, c, 3 * 32768, seed=n)
    assert torch.equal(gf256_cuda.apply_bitmatrix(abits, x, "mxu"),
                       gf256_cuda.mxu_apply_plain(abits, x))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")


# one tile, and 13 x 32 KiB: 832 column tiles, which no grid of whole
# blocks per SM divides
XOR_WIDTHS = {"xor": (8192, 13 * 32768), "xor3": (32768, 13 * 32768)}


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["xor", "xor3"])
@pytest.mark.parametrize("c", [8, 24, 40, 128])
@pytest.mark.parametrize("r", [8, 16, 24, 160])
def test_xor_apply_odd_shapes_on_card(r, c, form):
    """xor_apply and xor3_apply against their plain version, byte-exact,
    at k = 1, 3, 5, 16 input fragments, R of 8 to 160 (1 to 20 output
    planes per warp), one tile and a tile count no grid divides."""
    _card()
    for w in XOR_WIDTHS[form]:
        abits, x = _bits_and_planes(r, c, w, seed=1000 * r + c)
        got = gf256_cuda.apply_bitmatrix(abits, x, form)
        assert torch.equal(got, gf256_cuda.xor_apply_plain(abits, x)), w


XOR_EDGE_CASES = ["ones", "ones-odd", "zero-rows", "single-one-rows",
                  "300-rows"]


def xor_edge_case(case):
    """(bit-matrix, planes) in numpy of one edge case of the XOR kernels:
    an all-ones 160 x 128 matrix on 0xFF planes (and every other row one
    short), all-zero rows among random ones, single-one rows (a copy of
    one plane each), 300 output planes (several passes over each tile);
    32 KiB planes.  The CPU tests and chip_smoke.py use the same
    cases."""
    w = 32768
    rng = np.random.default_rng(11)
    if case.startswith("ones"):
        return _ones(160, case == "ones-odd"), np.full((128, w), 0xFF,
                                                       dtype=np.uint8)
    x = rng.integers(0, 256, (40, w), dtype=np.uint8)
    if case == "zero-rows":
        abits = rng.integers(0, 2, (24, 40), dtype=np.uint8)
        abits[::3] = 0
    elif case == "single-one-rows":
        abits = np.zeros((40, 40), dtype=np.uint8)
        abits[np.arange(40), rng.permutation(40)] = 1
    else:
        abits = rng.integers(0, 2, (300, 40), dtype=np.uint8)
    return abits, x


@pytest.mark.cuda
@pytest.mark.parametrize("case", XOR_EDGE_CASES)
def test_xor_apply_edge_cases_on_card(case):
    """An all-ones 160 x 128 matrix on 0xFF planes (sums of 128: all
    bytes 0; 127 on every other row: 0xFF), all-zero rows, single-one
    rows (copies of one plane) and 300 output planes, on both XOR
    kernels."""
    _card()
    abits, x = xor_edge_case(case)
    x = torch.from_numpy(x).cuda()
    want = gf256_cuda.xor_apply_plain(abits, x)
    for form in ("xor", "xor3"):
        assert torch.equal(gf256_cuda.apply_bitmatrix(abits, x, form),
                           want), form
    if case.startswith("ones"):
        assert int(want[1, 0]) == (0xFF if case == "ones-odd" else 0)
    if case == "single-one-rows":
        assert torch.equal(want, x[np.nonzero(abits)[1].tolist()])


@pytest.mark.cuda
def test_plane_major_kernels_all_4p2_decode_masks_on_card():
    """Every 4+2 decode mask (15 surviving sets) on xor_apply, xor3_apply
    and mxu_apply, each against the plain XOR chains."""
    _card()
    x = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (32, 2 * 32768), dtype=np.uint8)).cuda()
    masks = list(itertools.combinations(range(6), 4))
    assert len(masks) == 15
    for rows in masks:
        want = gf256_cuda.xor_apply_plain(
            gf256_cuda._bits("decode", 4, (rows,)), x)
        for form in gf256_cuda.FORMULATIONS:
            got = gf256_cuda._apply_cached(form, x, "decode", 4, (rows,))
            assert torch.equal(got, want), (form, rows)


# (kernel, W, C, R) that the XOR kernels' C entry points must refuse
XOR_REFUSALS = [
    ("xor", 4096, 8, 8), ("xor", 8192 + 512, 8, 8), ("xor", 8192, 0, 8),
    ("xor", 8192, 129, 8), ("xor", 8192, 8, 0), ("xor3", 8192, 8, 8),
    ("xor3", 32768 + 8192, 8, 8), ("xor3", 32768, 129, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("form,w,c,r", XOR_REFUSALS)
def test_xor_entry_points_refuse_what_the_tiling_cannot_cover(form, w, c,
                                                              r):
    """The C entry point returns cudaErrorInvalidValue (1) for a width
    that is not a whole number of the kernel's tiles (8 KiB, 32 KiB for
    xor3) or a plane count outside 1..128 inputs, >= 1 outputs, and
    writes nothing."""
    _card()
    lib = gf256_cuda.library()
    x = torch.zeros((129, 65536), dtype=torch.uint8, device="cuda")
    y = torch.zeros_like(x)
    masks = torch.zeros((129, 2), dtype=torch.int64, device="cuda")
    err = getattr(lib, f"gf256_{form}_apply")(
        x.data_ptr(), y.data_ptr(), masks.data_ptr(), w, c, r, 0,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 1
    assert int(y.count_nonzero()) == 0


@pytest.mark.cuda
def test_xor_blocks_per_sm_on_card():
    """At least two blocks of the XOR kernels' body reside on an SM at
    every row count (the ring does not grow with C)."""
    _card()
    for r in (8, 48, 96, 160, 300):
        assert gf256_cuda.xor_blocks_per_sm(r) >= 2, r
