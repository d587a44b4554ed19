"""The port's codec kernels (glusterfs_tpu_torch.ops.gf256_cuda) against
the JAX package: each plain PyTorch version, reached through its wrapper
with a CPU tensor, must be byte-identical to the fused Pallas kernel it
replaces (interpret mode, as tests/test_gf256_pallas.py runs it) and to
the JAX package's NumPy oracle.  Tolerance: exact byte equality."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glusterfs_tpu.ops import gf256 as jgf
from glusterfs_tpu.ops import gf256_pallas
from glusterfs_tpu_torch.ops import gf256 as tgf
from glusterfs_tpu_torch.ops import gf256_cuda

CONFIGS = [(4, 2), (8, 4), (16, 4)]
STRIPES = [1, 3, 127, 129]


def _rand(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _survivors(k, n, seed):
    rng = np.random.default_rng(seed)
    return tuple(sorted(int(x) for x in rng.choice(n, k, replace=False)))


@pytest.mark.parametrize("k,r", CONFIGS)
@pytest.mark.parametrize("s", STRIPES)
def test_plain_versions_match_oracle(k, r, s):
    """All four wrappers on CPU tensors vs the JAX package's ref_*."""
    n = k + r
    data = _rand(s * k * 512, seed=100 * k + s)
    frags = gf256_cuda.fused_encode(_t(data), k, n)
    assert frags.dtype == torch.uint8 and frags.shape == (n, s * 512)
    assert np.array_equal(frags.numpy(), jgf.ref_encode(data, k, n))

    rows = _survivors(k, n, seed=s)
    dec = gf256_cuda.fused_decode(_t(frags.numpy()[list(rows)]), k, rows)
    assert np.array_equal(dec.numpy(), data)

    par = gf256_cuda.fused_parity(_t(data), k, n)
    assert np.array_equal(par.numpy(), jgf.ref_parity(data, k, n))

    sys_frags = jgf.ref_encode(data, k, n, systematic=True)
    wanted = tuple(j for j in range(k) if j not in rows)
    if wanted:
        rec = gf256_cuda.fused_reconstruct(_t(sys_frags[list(rows)]), k,
                                           rows, wanted)
        assert np.array_equal(
            rec.numpy(),
            sys_frags[list(wanted)])


def _interpret_cases():
    cases = [(4, 2, s) for s in STRIPES] + [(8, 4, 1), (8, 4, 129)]
    return cases + [(16, 4, 3)]


@pytest.mark.parametrize("k,r,s", _interpret_cases())
def test_plain_versions_match_pallas_interpret(k, r, s):
    """Each wrapper vs the Pallas kernel it replaces, same inputs."""
    n = k + r
    data = _rand(s * k * 512, seed=7 * k + s)
    want = np.asarray(gf256_pallas._fused_encode_fn(k, n, True)(
        jnp.asarray(data)))
    got = gf256_cuda.fused_encode(_t(data), k, n).numpy()
    assert np.array_equal(got, want)

    rows = _survivors(k, n, seed=k + s)
    surv = want[list(rows)]
    want = np.asarray(gf256_pallas._fused_decode_fn(k, rows, True)(
        jnp.asarray(surv)))
    assert np.array_equal(gf256_cuda.fused_decode(_t(surv), k, rows).numpy(),
                          want)

    want = np.asarray(gf256_pallas._fused_parity_fn(k, n, True)(
        jnp.asarray(data)))
    assert np.array_equal(gf256_cuda.fused_parity(_t(data), k, n).numpy(),
                          want)

    sys_surv = jgf.ref_encode(data, k, n, systematic=True)[list(rows)]
    wanted = tuple(j for j in range(k) if j not in rows) or (0,)
    want = np.asarray(gf256_pallas._fused_reconstruct_fn(
        k, rows, wanted, True)(jnp.asarray(sys_surv)))
    got = gf256_cuda.fused_reconstruct(_t(sys_surv), k, rows, wanted)
    assert np.array_equal(got.numpy(), want)


MASKS_4P2 = list(itertools.combinations(range(6), 4))


@pytest.mark.parametrize("rows", MASKS_4P2)
def test_all_4p2_masks(rows):
    """Every one of the 15 surviving masks of 4+2, decode and
    reconstruct, vs the Pallas kernels (interpret) and the oracle."""
    k, n, s = 4, 6, 3
    data = _rand(s * k * 512, seed=sum(rows))
    frags = jgf.ref_encode(data, k, n)
    surv = frags[list(rows)]
    want = np.asarray(gf256_pallas._fused_decode_fn(k, rows, True)(
        jnp.asarray(surv)))
    got = gf256_cuda.fused_decode(_t(surv), k, rows).numpy()
    assert np.array_equal(got, want) and np.array_equal(got, data)

    sys_frags = jgf.ref_encode(data, k, n, systematic=True)
    wanted = tuple(j for j in range(k) if j not in rows)
    if wanted:
        got = gf256_cuda.fused_reconstruct(_t(sys_frags[list(rows)]), k,
                                           rows, wanted).numpy()
        assert np.array_equal(got, sys_frags[list(wanted)])


def test_bit_matrices_match_jax_package():
    """The port's copy of the GF tables and matrix builders agrees with
    the JAX package's."""
    for k, r in CONFIGS:
        n = k + r
        assert np.array_equal(tgf.encode_matrix(k, n), jgf.encode_matrix(k, n))
        assert np.array_equal(tgf.systematic_matrix(k, n),
                              jgf.systematic_matrix(k, n))
        assert np.array_equal(tgf.parity_bits_cached(k, n),
                              jgf.parity_bits_cached(k, n))
        rows = _survivors(k, n, seed=k)
        assert np.array_equal(tgf.decode_bits_cached(k, rows),
                              jgf.decode_bits_cached(k, rows))
        assert np.array_equal(tgf.reconstruct_bits_cached(k, rows, (0,)),
                              jgf.reconstruct_bits_cached(k, rows, (0,)))


def test_masks_of_packs_every_bit():
    abits = np.random.default_rng(3).integers(0, 2, (40, 128), dtype=np.uint8)
    m = gf256_cuda.masks_of(abits).view(np.uint64)
    for i in range(40):
        for j in range(128):
            assert (int(m[i, j // 64]) >> (j % 64)) & 1 == abits[i, j]


def test_cpu_versions_do_not_count_launches():
    gf256_cuda.reset_launches()
    gf256_cuda.fused_encode(_t(_rand(2 * 2048, 1)), 4, 6)
    assert all(v == 0 for v in gf256_cuda.LAUNCHES.values())


def test_wrappers_reject_bad_input():
    good = _t(_rand(2048, 2))
    with pytest.raises(TypeError):
        gf256_cuda.fused_encode(good.to(torch.int16), 4, 6)
    with pytest.raises(ValueError):
        gf256_cuda.fused_encode(good[:-1], 4, 6)
    with pytest.raises(ValueError):
        gf256_cuda.fused_decode(_t(_rand(4 * 1024, 3)).view(4, 1024)[:, ::2],
                                4, (0, 1, 2, 3))
    with pytest.raises(ValueError):
        gf256_cuda.fused_decode(_t(_rand(3 * 512, 3)).view(3, 512), 4,
                                (0, 1, 2, 3))
    with pytest.raises(ValueError):
        gf256_cuda.fused_encode(good.to("meta"), 4, 6)
