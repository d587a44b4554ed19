"""The port's plane-major kernels (glusterfs_tpu_torch.ops.gf256_cuda
``apply_bitmatrix`` with ``xor``, ``xor3`` and ``mxu``, and the
stripe-major ``encode``/``decode`` sandwich around them) on the CPU,
i.e. their plain versions, against the JAX package's Pallas kernels in
interpret mode on the same numpy inputs.  Tolerance: exact byte
equality.

At 16+4 the Pallas XOR kernels take about 20 s each to trace in
interpret mode, so there the encode matrix meets Pallas ``xor`` and
``xor3`` and the decode mask meets Pallas ``mxu``; every port
formulation is held against each Pallas result computed.  Likewise the
XOR kernels' odd shapes meet Pallas at C <= 40 and, everywhere, the
JAX package's numpy XOR chains ``gf256._xor_matmul_planes``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glusterfs_tpu.ops import gf256, gf256_pallas
from glusterfs_tpu_torch.ops import gf256_cuda
from tests.test_torch_cuda import XOR_EDGE_CASES, xor_edge_case

W = 32 << 10
FORMS = ("xor", "xor3", "mxu")
# (k, r, surviving rows of the decode mask: two or more fragments lost)
CONFIGS = [(4, 2, (1, 2, 4, 5)), (8, 4, (0, 2, 3, 5, 7, 8, 10, 11)),
           (16, 4, tuple(range(2, 18)))]


def _planes(c, seed):
    return np.random.default_rng(seed).integers(0, 256, (c, W),
                                                dtype=np.uint8)


def _pallas(abits, x, form):
    return np.asarray(gf256_pallas.apply_bitmatrix(
        abits, jnp.asarray(x), form, interpret=True))


def _pallas_forms(k, matrix):
    if k < 16:
        return FORMS
    return ("xor", "xor3") if matrix == "encode" else ("mxu",)


@pytest.mark.parametrize("matrix", ["encode", "decode"])
@pytest.mark.parametrize("k,r,rows", CONFIGS)
def test_apply_bitmatrix_matches_pallas(k, r, rows, matrix):
    n = k + r
    abits = gf256.expand_bitmatrix(gf256.encode_matrix(k, n)) \
        if matrix == "encode" else gf256.decode_bits_cached(k, rows)
    x = _planes(k * 8, seed=k + (matrix == "decode"))
    got = {f: gf256_cuda.apply_bitmatrix(abits, torch.from_numpy(x),
                                         f).numpy() for f in FORMS}
    for pf in _pallas_forms(k, matrix):
        want = _pallas(abits, x, pf)
        assert want.shape == (abits.shape[0], W)
        for f in FORMS:
            assert np.array_equal(got[f], want), (f, pf)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("s", [1, 3, 127, 129])
def test_entry_points_match_pallas_4p2(s, form):
    k, n, rows = 4, 6, (1, 2, 4, 5)
    data = np.random.default_rng(s).integers(0, 256, s * k * 512,
                                             dtype=np.uint8)
    want = gf256_pallas.encode(data, k, n, form, interpret=True)
    frags = gf256_cuda.encode(torch.from_numpy(data), k, n, form).numpy()
    assert np.array_equal(frags, want)
    surv = np.ascontiguousarray(frags[list(rows)])
    want = gf256_pallas.decode(surv, rows, k, form, interpret=True)
    got = gf256_cuda.decode(torch.from_numpy(surv), rows, k, form).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, data)


def test_entry_points_match_pallas_16p4():
    k, n, rows = 16, 20, tuple(range(4, 20))
    data = np.random.default_rng(16).integers(0, 256, 3 * k * 512,
                                              dtype=np.uint8)
    want = gf256_pallas.encode(data, k, n, "mxu", interpret=True)
    surv = np.ascontiguousarray(want[list(rows)])
    want_dec = gf256_pallas.decode(surv, rows, k, "mxu", interpret=True)
    assert np.array_equal(want_dec, data)
    for form in FORMS + ("fused",):
        frags = gf256_cuda.encode(torch.from_numpy(data), k, n, form)
        assert np.array_equal(frags.numpy(), want), form
        got = gf256_cuda.decode(torch.from_numpy(surv), rows, k, form)
        assert np.array_equal(got.numpy(), want_dec), form


def test_apply_bitmatrix_error_contract():
    abits = gf256.expand_bitmatrix(gf256.encode_matrix(4, 6))
    x = torch.zeros((32, 8192), dtype=torch.uint8)
    with pytest.raises(ValueError, match="formulation"):
        gf256_cuda.apply_bitmatrix(abits, x, "fused")
    with pytest.raises(ValueError, match="plane rows"):
        gf256_cuda.apply_bitmatrix(abits, x[:31], "xor")
    with pytest.raises(ValueError, match="multiple of 8192"):
        gf256_cuda.apply_bitmatrix(abits, torch.zeros((32, 4096),
                                                      dtype=torch.uint8))
    with pytest.raises(ValueError, match="for xor3"):
        gf256_cuda.apply_bitmatrix(abits, x, "xor3")
    for form in ("xor", "mxu"):  # 8 KiB is enough for these two
        assert gf256_cuda.apply_bitmatrix(abits, x, form).shape == (48, 8192)
    with pytest.raises(ValueError, match="formulation"):
        gf256_cuda.encode(torch.zeros(2048, dtype=torch.uint8), 4, 6, "bogus")
    with pytest.raises(ValueError):  # not a whole stripe
        gf256_cuda.encode(torch.zeros(2000, dtype=torch.uint8), 4, 6, "mxu")


def test_mxu_plain_steps_through_wide_inputs():
    """The plain mxu version works in column steps; a width that is not
    a whole number of steps still gives the XOR chains' bytes."""
    abits = gf256.decode_bits_cached(16, tuple(range(4, 20)))
    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (128, 3 * 16384 + 8192), dtype=np.uint8))
    assert gf256_cuda._MXU_PLAIN_STEP_BITS // 128 < x.shape[1]
    assert torch.equal(gf256_cuda.mxu_apply_plain(abits, x),
                       gf256_cuda.xor_apply_plain(abits, x))


def test_cpu_calls_count_no_launches():
    gf256_cuda.reset_launches()
    data = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, 2048, dtype=np.uint8))
    for form in FORMS:
        frags = gf256_cuda.encode(data, 4, 6, form)
        gf256_cuda.decode(frags[[0, 1, 2, 5]].contiguous(), (0, 1, 2, 5), 4,
                          form)
    assert sum(gf256_cuda.LAUNCHES.values()) == 0


def _mxu_case(case):
    """(bit-matrix, planes) of one extreme or odd mxu shape: ``ones`` is
    an all-ones (24, 128) matrix on all-0xFF planes, every sum 128 (bit
    7's operand is -128 as s8); ``ones-odd`` drops the last one of every
    other row (sum 127); ``sumN`` has N ones in its even rows and N - 1
    in its odd ones, on all-0xFF planes: every sum is N or N - 1, each
    side of a power of two where the kernel's bit pairing changes;
    ``RxC`` is a random matrix with R not a multiple of 16 and C not a
    multiple of 32."""
    w = 8192
    if case.startswith("sum"):
        n = int(case[3:])
        abits = np.zeros((24, 128), dtype=np.uint8)
        abits[:, :n] = 1
        abits[1::2, n - 1] = 0
        return abits, np.full((128, w), 0xFF, dtype=np.uint8)
    if case.startswith("ones"):
        abits = np.ones((24, 128), dtype=np.uint8)
        if case == "ones-odd":
            abits[1::2, -1] = 0
        return abits, np.full((128, w), 0xFF, dtype=np.uint8)
    r, c = (int(v) for v in case.split("x"))
    rng = np.random.default_rng(r * 1000 + c)
    return (rng.integers(0, 2, (r, c), dtype=np.uint8),
            rng.integers(0, 256, (c, w), dtype=np.uint8))


@pytest.mark.parametrize("case", ["ones", "ones-odd", "24x40", "8x24",
                                  "sum15", "sum16", "sum31", "sum32",
                                  "sum63", "sum64"])
def test_mxu_extreme_and_odd_shapes_match_pallas(case):
    abits, x = _mxu_case(case)
    want = _pallas(abits, x, "mxu")
    got = gf256_cuda.mxu_apply_plain(abits, torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, gf256_cuda.xor_apply_plain(
        abits, torch.from_numpy(x)).numpy())
    if case.startswith("ones"):
        assert got[1, 0] == (0xFF if case == "ones-odd" else 0)
    if case.startswith("sum"):
        odd = int(case[3:]) % 2
        assert (got[0, 0], got[1, 0]) == ((0xFF, 0) if odd else (0, 0xFF))


# the plane-major kernels' odd shapes (k = 1, 3, 5, 16 input fragments)
ODD_C = (8, 24, 40, 128)
ODD_R = (8, 16, 24, 160)


def _xor_planes_ref(abits, x):
    """The JAX package's ``gf256._xor_matmul_planes`` on plane-major
    (C, W)."""
    c, w = x.shape
    y = gf256._xor_matmul_planes(
        abits, x.reshape(c, w // 64, 64).transpose(1, 0, 2))
    return y.transpose(1, 0, 2).reshape(abits.shape[0], w)


def _xor_forms(abits, x):
    """{(form, width): port result} of ``xor`` at one 8 KiB tile and at
    32 KiB, and of ``xor3`` at 32 KiB, on the CPU."""
    xt = torch.from_numpy(x)
    return {("xor", 8192): gf256_cuda.apply_bitmatrix(
                abits, xt[:, :8192].contiguous(), "xor").numpy(),
            ("xor", W): gf256_cuda.apply_bitmatrix(abits, xt, "xor").numpy(),
            ("xor3", W): gf256_cuda.apply_bitmatrix(abits, xt,
                                                    "xor3").numpy()}


@pytest.mark.parametrize("c", ODD_C)
@pytest.mark.parametrize("r", ODD_R)
def test_xor_forms_odd_shapes_match_pallas(r, c):
    """``xor`` and ``xor3`` on the CPU at R not a multiple of 16 and C not
    a multiple of 32: against Pallas ``xor`` (one 8 KiB tile) and
    ``xor3`` (32 KiB) in interpret mode where C <= 40, and against the
    JAX package's numpy XOR chains everywhere."""
    rng = np.random.default_rng(1000 * r + c)
    abits = rng.integers(0, 2, (r, c), dtype=np.uint8)
    x = rng.integers(0, 256, (c, W), dtype=np.uint8)
    got = _xor_forms(abits, x)
    want = _xor_planes_ref(abits, x)
    if c <= 40:
        assert np.array_equal(_pallas(abits, x[:, :8192], "xor"),
                              want[:, :8192])
        assert np.array_equal(_pallas(abits, x, "xor3"), want)
    for (form, w), y in got.items():
        assert np.array_equal(y, want[:, :w]), (form, w)


@pytest.mark.parametrize("case", XOR_EDGE_CASES)
def test_xor_forms_edge_cases(case):
    """The XOR kernels' edge cases on the CPU against the JAX package's
    numpy XOR chains, and against Pallas ``xor`` (one 8 KiB tile) where the matrix
    is small (zero and single-one rows)."""
    abits, x = xor_edge_case(case)
    want = _xor_planes_ref(abits, x)
    for (form, w), y in _xor_forms(abits, x).items():
        assert np.array_equal(y, want[:, :w]), (form, w)
    if case in ("zero-rows", "single-one-rows"):
        assert np.array_equal(_pallas(abits, x[:, :8192], "xor"),
                              want[:, :8192])
    if case.startswith("ones"):
        assert want[1, 0] == (0xFF if case == "ones-odd" else 0)
    if case == "zero-rows":
        assert not want[::3].any()
    if case == "single-one-rows":
        assert np.array_equal(want, x[np.nonzero(abits)[1]])
