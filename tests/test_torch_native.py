"""The port's native host codec (glusterfs_tpu_torch.native, the C++
AVX2 kernels built with g++ into the package's ``_build/``) against the
JAX package's native codec and its ``ref`` oracle: encode, decode,
decode_program, apply_bitmatrix and adler32_batch at S in {1, 3, 127,
129} stripes and k in {4, 8, 16}.  A mismatched program is refused, and a
failed build raises with the compiler's message (no fallback).
Tolerance: exact byte equality."""

import zlib

import numpy as np
import pytest

from glusterfs_tpu import native as jnative
from glusterfs_tpu.ops import gf256 as jgf
from glusterfs_tpu_torch import native
from glusterfs_tpu_torch.ops import gf256
from glusterfs_tpu_torch.ops.codec import Codec

CASES = [(k, r, s) for k, r in ((4, 2), (8, 4), (16, 4))
         for s in (1, 3, 127, 129)]


def _data(nbytes, seed):
    return np.random.default_rng(seed).integers(0, 256, nbytes,
                                                dtype=np.uint8)


@pytest.mark.parametrize("k,r,s", CASES)
def test_encode_decode_match_jax_native_and_ref(k, r, s):
    n = k + r
    data = _data(s * k * 512, seed=k * 1000 + s)
    abits = gf256.expand_bitmatrix(gf256.encode_matrix(k, n))
    frags = native.encode(data, k, n, abits)
    assert np.array_equal(frags, jnative.encode(data, k, n, abits))
    assert np.array_equal(frags, jgf.ref_encode(data, k, n))
    rows = tuple(range(r, n))  # the first r data fragments lost
    got = native.decode(frags[list(rows)], k,
                        gf256.decode_bits_cached(k, rows))
    assert np.array_equal(got, data)
    prog = gf256.decode_program(k, rows)
    got = native.decode_program(frags[list(rows)], k, prog)
    assert np.array_equal(got, jnative.decode_program(
        frags[list(rows)], k, jgf.decode_program(k, rows)))
    assert np.array_equal(got, data)


@pytest.mark.parametrize("k,r,s", CASES)
def test_systematic_and_parity_match_jax_native(k, r, s):
    n = k + r
    data = _data(s * k * 512, seed=k * 1000 + s + 7)
    sbits = gf256.expand_bitmatrix(gf256.systematic_matrix(k, n))
    frags = native.encode(data, k, n, sbits)
    assert np.array_equal(frags, jgf.ref_encode(data, k, n, systematic=True))
    pbits = gf256.parity_bits_cached(k, n)
    assert np.array_equal(native.encode(data, k, n - k, pbits),
                          jnative.encode(data, k, n - k, pbits))
    rows = tuple(sorted({0, *range(2, k), *range(k, k + 2)}))[:k]
    got = native.decode_program(frags[list(rows)], k,
                                gf256.decode_program(k, rows, True))
    assert np.array_equal(got, data)


@pytest.mark.parametrize("c,r,w", [(8, 8, 64), (40, 24, 3 * 64),
                                   (128, 160, 512)])
def test_apply_bitmatrix_matches_jax_native(c, r, w):
    rng = np.random.default_rng(c)
    abits = rng.integers(0, 2, (r, c), dtype=np.uint8)
    x = rng.integers(0, 256, (c, w), dtype=np.uint8)
    assert np.array_equal(native.apply_bitmatrix(abits, x),
                          jnative.apply_bitmatrix(abits, x))


@pytest.mark.parametrize("n,b", [(1, 1), (7, 4096), (129, 5552 + 3)])
def test_adler32_batch_matches_zlib(n, b):
    blocks = _data(n * b, seed=b).reshape(n, b)
    got = native.adler32_batch(blocks)
    assert np.array_equal(got, jnative.adler32_batch(blocks))
    assert got.tolist() == [zlib.adler32(bytes(x)) for x in blocks]


def test_refuses_mismatched_program_and_shapes():
    k = 4
    frags = _data(4 * 3 * 512, seed=1).reshape(4, 3 * 512)
    with pytest.raises(ValueError, match="program shape"):
        native.decode_program(frags, k, gf256.decode_program(8, range(8)))
    with pytest.raises(ValueError, match="program shape"):
        native.decode_program(frags, k, gf256.encode_program(4, 6))
    with pytest.raises(ValueError):
        native.decode_program(frags[:3], k, gf256.decode_program(k, range(4)))
    with pytest.raises(ValueError):
        native.encode(_data(100, 2), k, 6,
                      gf256.expand_bitmatrix(gf256.encode_matrix(k, 6)))
    with pytest.raises(ValueError, match="bit-matrix"):
        native.encode(_data(k * 512, 2), k, 6,
                      gf256.expand_bitmatrix(gf256.encode_matrix(k, 5)))


def test_library_builds_into_the_package_build_dir():
    so = native.build()
    assert so.parent == native.BUILD_DIR
    assert so.parent.name == "_build"
    assert so.parent.parent.name == "glusterfs_tpu_torch"
    assert so.name.startswith("libgf256_native_") and so.suffix == ".so"
    assert so.is_file() and native.available()
    assert native.build() == so  # once per sources and flags


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.library()
    assert "bad.cpp" in str(e.value)  # the compiler's stderr
    with pytest.raises(RuntimeError) as again:  # the same error, kept
        native.library()
    assert str(again.value) == str(e.value)
    assert not native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        Codec(4, 2, "native")  # never becomes ref
    assert not list((tmp_path / "_build").glob("*.so"))


def test_host_without_avx2_raises(monkeypatch):
    monkeypatch.setattr(native, "_has_avx2", lambda: False)
    with pytest.raises(RuntimeError, match="avx2"):
        native.build()
