"""The port's CUDA codec kernels on the card, each against its plain
PyTorch version on the same inputs, byte-exact.  Skips without a card.

This file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from glusterfs_tpu_torch.ops import gf256_cuda

STRIPES = [1, 3, 127, 129]


def _survivors(k, n, seed):
    rng = np.random.default_rng(seed)
    return tuple(sorted(int(x) for x in rng.choice(n, k, replace=False)))


@pytest.mark.cuda
@pytest.mark.parametrize("k,r", [(4, 2), (8, 4), (16, 4)])
def test_kernels_match_plain_versions_on_card(k, r):
    """Each kernel vs its plain version at unaligned stripe counts, and
    each launch counted (chip_smoke.py repeats this at 256 MiB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    n = k + r
    gf256_cuda.reset_launches()
    for s in STRIPES:
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
                                                   len(STRIPES)),
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
