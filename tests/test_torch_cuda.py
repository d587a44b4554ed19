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
    assert gf256_cuda.LAUNCHES == dict.fromkeys(gf256_cuda.KERNELS,
                                                len(STRIPES))
