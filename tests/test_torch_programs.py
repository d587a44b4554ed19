"""The port's CSE'd XOR programs (glusterfs_tpu_torch.ops.gf256) against
the JAX package's (glusterfs_tpu.ops.gf256): ``build_xor_program``,
``schedule_program`` and the four program builders come out op for op
the same for the same matrix at 4+2, 8+4 and 16+4 (encode, parity, every
4+2 decode mask, sampled wider masks, reconstruct with 1 and 2 data rows
missing), ``run_xor_program`` gives the same planes, and the per-mask
program LRU hits, evicts, recompiles and races as the JAX package's
does.  Tolerance: exact equality of ops, outputs and bytes."""

import itertools
import threading

import numpy as np
import pytest

from glusterfs_tpu.ops import gf256 as jgf
from glusterfs_tpu_torch.ops import gf256

GEOMETRIES = [(4, 2), (8, 4), (16, 4)]


def _masks(k, r):
    """Every 4+2 mask; at wider geometries the worst case (the first r
    data fragments lost), the healthy data mask and a seeded random one."""
    n = k + r
    if (k, r) == (4, 2):
        return list(itertools.combinations(range(n), k))
    pick = np.random.default_rng(n).choice(n, k, replace=False)
    return [tuple(range(r, n)), tuple(range(k)),
            tuple(sorted(int(i) for i in pick))]


def _same(a, b):
    assert a.ops == b.ops and a.outs == b.outs and a.n_inputs == b.n_inputs


def _same_schedule(prog, jprog):
    code, slots = gf256.schedule_program(prog)
    jcode, jslots = jgf.schedule_program(jprog)
    assert slots == jslots
    assert np.array_equal(code, jcode)


@pytest.mark.parametrize("systematic", [False, True])
@pytest.mark.parametrize("k,r", GEOMETRIES)
def test_encode_and_parity_programs_op_identical(k, r, systematic):
    n = k + r
    p, jp = gf256.encode_program(k, n, systematic), \
        jgf.encode_program(k, n, systematic)
    _same(p, jp)
    _same_schedule(p, jp)
    if systematic:
        p, jp = gf256.parity_program(k, n), jgf.parity_program(k, n)
        _same(p, jp)
        _same_schedule(p, jp)


@pytest.mark.parametrize("systematic", [False, True])
@pytest.mark.parametrize("k,r", GEOMETRIES)
def test_decode_programs_op_identical(k, r, systematic):
    for rows in _masks(k, r):
        p, jp = gf256.decode_program(k, rows, systematic), \
            jgf.decode_program(k, rows, systematic)
        _same(p, jp)
        _same_schedule(p, jp)


@pytest.mark.parametrize("missing", [1, 2])
@pytest.mark.parametrize("k,r", GEOMETRIES)
def test_reconstruct_programs_op_identical(k, r, missing):
    n = k + r
    wanted = tuple(range(1, 1 + missing))  # data rows 1 (and 2) lost
    rows = tuple(i for i in range(n) if i not in wanted)[:k]
    p, jp = gf256.reconstruct_program(k, rows, wanted), \
        jgf.reconstruct_program(k, rows, wanted)
    _same(p, jp)
    _same_schedule(p, jp)
    assert len(p.outs) == missing * gf256.GF_BITS


@pytest.mark.parametrize("shape", [(8, 8), (24, 40), (160, 128)])
def test_build_xor_program_on_random_matrices(shape):
    abits = np.random.default_rng(shape[0]).integers(
        0, 2, shape, dtype=np.uint8)
    _same(gf256.build_xor_program(abits), jgf.build_xor_program(abits))


@pytest.mark.parametrize("k,r", GEOMETRIES)
def test_run_xor_program_matches_jax_and_the_matrix(k, r):
    n = k + r
    rng = np.random.default_rng(k)
    x = rng.integers(0, 256, (3, k * 8, gf256.WORD_SIZE), dtype=np.uint8)
    rows = _masks(k, r)[0]
    for prog, abits in (
            (gf256.encode_program(k, n), gf256.expand_bitmatrix(
                gf256.encode_matrix(k, n))),
            (gf256.decode_program(k, rows),
             gf256.decode_bits_cached(k, rows))):
        got = gf256.run_xor_program(prog, x)
        assert np.array_equal(got, jgf.run_xor_program(prog, x))
        assert np.array_equal(got, gf256._xor_matmul_planes(abits, x))
    with pytest.raises(ValueError):
        gf256.run_xor_program(gf256.encode_program(k, n), x[:, :-1])


def test_decode_program_decodes_every_4p2_mask():
    k, n = 4, 6
    data = np.random.default_rng(7).integers(0, 256, 5 * k * 512,
                                             dtype=np.uint8)
    frags = gf256.ref_encode(data, k, n)
    for rows in itertools.combinations(range(n), k):
        x = gf256.frags_to_planes(frags[list(rows)], k)
        got = gf256.run_xor_program(gf256.decode_program(k, rows), x)
        assert np.array_equal(got.reshape(-1), data), rows


# -- the per-mask compiled-program LRU (tests/test_decode_programs.py) ------


def test_decode_program_lru_hit_and_identity():
    k = 4
    rows = (1, 3, 4, 5)
    before = gf256.DECODE_PROGRAMS.cache_info()
    p1 = gf256.decode_program(k, rows)
    p2 = gf256.decode_program(k, [1, 3, 4, 5])  # list vs tuple: same key
    assert p1 is p2, "second request must hit the cache"
    after = gf256.DECODE_PROGRAMS.cache_info()
    assert after["hits"] >= before["hits"] + 1


def test_decode_program_lru_eviction_recompiles():
    """Shrink the LRU, push a mask out, re-request it: the recompiled
    program is identical to the evicted one and still byte-exact."""
    k, n = 4, 6
    lru = gf256.DECODE_PROGRAMS
    saved_max = lru.maxsize
    lru.cache_clear()
    lru.maxsize = 3
    try:
        victim = (2, 3, 4, 5)
        first = gf256.decode_program(k, victim)
        for rows in ((0, 1, 2, 3), (0, 2, 4, 5), (1, 2, 3, 4)):
            gf256.decode_program(k, rows)
        assert (k, victim, False) not in lru, "victim should be evicted"
        assert lru.cache_info()["evictions"] >= 1
        misses = lru.cache_info()["misses"]
        again = gf256.decode_program(k, victim)
        assert lru.cache_info()["misses"] == misses + 1, "must recompile"
        assert again == first, "recompile must be deterministic"
        data = np.random.default_rng(99).integers(0, 256, 3 * k * 512,
                                                  dtype=np.uint8)
        frags = gf256.ref_encode(data, k, n)
        x = gf256.frags_to_planes(frags[list(victim)], k)
        assert np.array_equal(gf256.run_xor_program(again, x).reshape(-1),
                              data)
    finally:
        lru.maxsize = saved_max
        lru.cache_clear()


def test_program_lru_thread_safety():
    """Concurrent first requests for the same and distinct masks race
    the build-outside-the-lock path; every result must be correct."""
    lru = gf256.ProgramLRU(gf256._build_decode_program, maxsize=8)
    masks = [(0, 1, 2, 3), (1, 2, 3, 4), (2, 3, 4, 5), (0, 2, 3, 5)]
    results: dict = {}
    errors: list = []

    def worker(i):
        try:
            rows = masks[i % len(masks)]
            results[(i, rows)] = lru(4, rows, False)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(results) == 16
    for (_i, rows), prog in results.items():
        assert prog == jgf.build_xor_program(jgf.decode_bits_cached(4, rows))
