"""GF(2^8) arithmetic core for the disperse (erasure-coding) engine.

Semantics match the reference implementation's Galois field and matrix
construction (reference: ``xlators/cluster/ec/src/ec-galois.c``,
``ec-method.c:22-71``, ``doc/developer-guide/ec-implementation.md``):

* Field: GF(2^8) with primitive polynomial ``0x11D``, generator 2
  (``ec-method.h:17-18``).
* Encode matrix: non-systematic reverse Vandermonde. Row for value
  ``v = i + 1`` (i in 0..N-1) is ``[v^(K-1), v^(K-2), ..., v, 1]``
  (``ec-method.c:22-35`` builds exactly this via exp + repeated division).
* Decode matrix: the unique GF(256) inverse of the K surviving rows
  (``ec-method.c:38-71`` computes it by polynomial interpolation; we use
  Gauss-Jordan — the inverse is unique, parity is proven by golden vectors
  generated from the reference's own portable C kernel).

Data layout (bit-sliced chunks, ``ec-implementation.md:485-519``):
a chunk is ``EC_METHOD_CHUNK_SIZE = 512`` bytes = 8 bit-planes of
``EC_METHOD_WORD_SIZE = 64`` bytes.  Plane ``p`` holds bit ``p`` of each of
the 512 logical GF(256) elements of the chunk; element ``e``'s bit lives at
plane byte ``e >> 3``, bit ``e & 7``.  Multiplying every element of a chunk
by a constant ``c`` is therefore a fixed 8x8 GF(2) bit-matrix applied to the
planes — which makes a full encode a single binary matmul
``(N*8, K*8) @ (K*8, bits) mod 2`` — on the card, an XOR of the input
planes each output plane's bit-matrix row selects (ops/gf256_cuda.py).
"""

from __future__ import annotations

import functools

import numpy as np

GF_BITS = 8
GF_MOD = 0x11D
GF_SIZE = 1 << GF_BITS

WORD_SIZE = 64  # bytes per bit-plane (EC_METHOD_WORD_SIZE)
CHUNK_SIZE = WORD_SIZE * GF_BITS  # 512 bytes (EC_METHOD_CHUNK_SIZE)
MAX_FRAGMENTS = 16  # EC_METHOD_MAX_FRAGMENTS


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """pow/log tables, generator 2 mod 0x11D (ec-galois.c:53-70 semantics)."""
    pow_t = np.zeros(512, dtype=np.int32)
    log_t = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        pow_t[i] = x
        pow_t[i + 255] = x
        log_t[x] = i
        x <<= 1
        if x >= 256:
            x ^= GF_MOD
    log_t[0] = -511  # sentinel: pow[log[0] + anything] never valid; callers mask
    return pow_t, log_t


POW, LOG = _build_tables()


def gf_mul(a, b):
    """Element-wise GF(256) multiply (vectorized)."""
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    nz = (a != 0) & (b != 0)
    idx = np.where(nz, LOG[a] + LOG[b], 0)  # in [0, 508] when nz
    return np.where(nz, POW[idx], 0).astype(np.uint8)


def gf_div(a, b):
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    if np.any(b == 0):
        raise ZeroDivisionError("GF(256) division by zero")
    nz = a != 0
    idx = np.where(nz, 255 + LOG[a] - LOG[b], 0)
    return np.where(nz, POW[idx], 0).astype(np.uint8)


def gf_pow(a: int, e: int) -> int:
    r = 1
    a = int(a)
    while e:
        if e & 1:
            r = int(gf_mul(r, a))
        a = int(gf_mul(a, a))
        e >>= 1
    return r


@functools.cache
def bitmatrices() -> np.ndarray:
    """(256, 8, 8) uint8: BITMAT[c][p][q] = bit p of (c * 2^q).

    Column q of BITMAT[c] is the image of basis element 2^q under
    multiplication by c — applying BITMAT[c] to the 8 bit-planes of a chunk
    multiplies all 512 elements by c (the linear map the reference's XOR-chain
    programs in ec-gf8.c implement).
    """
    c = np.arange(256, dtype=np.int32)[:, None]
    q = (1 << np.arange(8, dtype=np.int32))[None, :]
    prod = gf_mul(c, q).astype(np.int32)  # (256, 8): c * 2^q
    p = np.arange(8, dtype=np.int32)[None, :, None]
    return ((prod[:, None, :] >> p) & 1).astype(np.uint8)  # (256, p, q)


def encode_matrix(k: int, n: int) -> np.ndarray:
    """(n, k) non-systematic Vandermonde: A[i][j] = (i+1)^(k-1-j)."""
    if k > MAX_FRAGMENTS:
        raise ValueError(f"at most {MAX_FRAGMENTS} data fragments supported")
    if n > 255:
        raise ValueError("at most 255 fragments representable in GF(256)")
    v = np.arange(1, n + 1, dtype=np.int32)
    exps = np.arange(k - 1, -1, -1, dtype=np.int64)
    out = np.empty((n, k), dtype=np.uint8)
    for j, e in enumerate(exps):
        out[:, j] = [gf_pow(int(val), int(e)) for val in v]
    return out


@functools.lru_cache(maxsize=64)
def systematic_matrix(k: int, n: int) -> np.ndarray:
    """Systematic generator: ``V @ inv(V[:k])`` for the Vandermonde V of
    :func:`encode_matrix` — rows 0..k-1 are the identity (data fragments
    ARE the raw stripe chunks), rows k.. are parity.  Any k rows stay
    invertible (each is ``V[rows] @ inv(V[:k])`` with both factors
    invertible).

    The reference's code is non-systematic (every fragment is a codeword;
    reads always decode, ec-method.c:393-433) — fine when decode is a
    cheap local AVX pass.  With the codec on a card behind a host link
    the systematic form is the device-first layout: healthy reads touch no
    device at all, encode ships back only the parity rows, degraded
    reads reconstruct only the missing rows.  Selected per volume via
    ``disperse.systematic``."""
    v = encode_matrix(k, n).astype(np.int64)
    inv = invert_matrix(encode_matrix(k, k)).astype(np.int64)
    out = np.zeros((n, k), dtype=np.uint8)
    for i in range(n):
        for j in range(k):
            acc = 0
            for t in range(k):
                acc ^= gf_mul(int(v[i, t]), int(inv[t, j]))
            out[i, j] = acc
    return out


def generator_matrix(k: int, n: int, systematic: bool = False) -> np.ndarray:
    return systematic_matrix(k, n) if systematic else encode_matrix(k, n)


def invert_matrix(a: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over GF(256)."""
    a = a.astype(np.int32)
    k = a.shape[0]
    if a.shape != (k, k):
        raise ValueError("square matrix required")
    inv = np.eye(k, dtype=np.int32)
    for col in range(k):
        piv = col
        while piv < k and a[piv, col] == 0:
            piv += 1
        if piv == k:
            raise np.linalg.LinAlgError("singular matrix over GF(256)")
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        d = int(a[col, col])
        a[col] = gf_div(a[col], d)
        inv[col] = gf_div(inv[col], d)
        for r in range(k):
            if r == col or a[r, col] == 0:
                continue
            f = int(a[r, col])
            a[r] ^= gf_mul(f, a[col]).astype(np.int32)
            inv[r] ^= gf_mul(f, inv[col]).astype(np.int32)
    return inv.astype(np.uint8)


def decode_matrix(k: int, rows: np.ndarray | list[int],
                  systematic: bool = False) -> np.ndarray:
    """Inverse of the generator-matrix rows `rows` (surviving indices)."""
    rows = np.asarray(rows, dtype=np.int64)
    if len(rows) != k:
        raise ValueError(f"need exactly {k} surviving fragments, got {len(rows)}")
    sub = generator_matrix(k, int(rows.max()) + 1, systematic)[rows]
    return invert_matrix(sub)


@functools.lru_cache(maxsize=256)
def decode_bits_cached(k: int, rows: tuple[int, ...],
                       systematic: bool = False) -> np.ndarray:
    """Per-surviving-mask cached decode bit-matrix — the one LRU shared by
    every backend (the reference keeps an equivalent LRU of inverted
    matrices keyed by fragment bitmask, ec-method.c:200-245)."""
    return expand_bitmatrix(decode_matrix(k, list(rows), systematic))


@functools.lru_cache(maxsize=64)
def parity_bits_cached(k: int, n: int) -> np.ndarray:
    """Bit-matrix of the systematic generator's parity rows only
    ((n-k)*8, k*8): the device work of a systematic encode."""
    return expand_bitmatrix(systematic_matrix(k, n)[k:])


@functools.lru_cache(maxsize=256)
def reconstruct_bits_cached(k: int, rows: tuple[int, ...],
                            wanted: tuple[int, ...]) -> np.ndarray:
    """Bit-matrix mapping k systematic survivors (indices ``rows``) to
    just the ``wanted`` data rows (len(wanted)*8, k*8): a degraded
    systematic read reconstructs ONLY what is missing."""
    m = decode_matrix(k, list(rows), systematic=True)
    return expand_bitmatrix(m[list(wanted)])


def expand_bitmatrix(coeff: np.ndarray) -> np.ndarray:
    """Expand an (R, C) GF(256) coefficient matrix into its (R*8, C*8) GF(2)
    bit-matrix: block (i, j) is BITMAT[coeff[i, j]].

    ``Y_bits = (Abits @ X_bits) % 2`` computes ``Y = coeff (*) X`` on
    bit-sliced chunk data.
    """
    bm = bitmatrices()[coeff.astype(np.int32)]  # (R, C, 8, 8)
    r, c = coeff.shape
    return bm.transpose(0, 2, 1, 3).reshape(r * 8, c * 8)


# ---------------------------------------------------------------------------
# Bit-exact NumPy reference codec (the `cpu-extensions=none` oracle).
# ---------------------------------------------------------------------------


def _to_planes(data: np.ndarray, k: int) -> np.ndarray:
    """(S*k*512,) bytes -> (S, k*8, 64) plane words (stripe-major)."""
    s = data.size // (k * CHUNK_SIZE)
    return data.reshape(s, k * GF_BITS, WORD_SIZE)


def _xor_matmul_planes(abits: np.ndarray, x: np.ndarray) -> np.ndarray:
    """XOR-matmul: y[s, i, :] = XOR_j { x[s, j, :] : abits[i, j] == 1 }.

    x: (S, C, 64) uint8 plane words; abits: (R, C) in {0,1}.
    Bitwise XOR accumulation over bytes == GF(2) matmul applied to each of
    the 8 bit positions in parallel (no unpacking needed host-side).
    """
    r = abits.shape[0]
    s = x.shape[0]
    out = np.zeros((s, r, WORD_SIZE), dtype=np.uint8)
    for i in range(r):
        sel = np.nonzero(abits[i])[0]
        if sel.size:
            out[:, i, :] = np.bitwise_xor.reduce(x[:, sel, :], axis=1)
    return out


def ref_encode(data: np.ndarray, k: int, n: int,
               systematic: bool = False) -> np.ndarray:
    """Encode `data` (length multiple of k*512) into n fragments.

    Returns (n, S*512) uint8 — fragment i is the concatenation of its chunk
    from every stripe (matching ec_method_encode's output layout,
    ec-method.c:393-408).
    """
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    if data.size % (k * CHUNK_SIZE):
        raise ValueError("data length must be a multiple of k*512")
    abits = expand_bitmatrix(generator_matrix(k, n, systematic))
    x = _to_planes(data, k)  # (S, k*8, 64)
    y = _xor_matmul_planes(abits, x)  # (S, n*8, 64)
    s = x.shape[0]
    # (S, n, 8, 64) -> fragment-major (n, S, 512)
    return (
        y.reshape(s, n, GF_BITS * WORD_SIZE)
        .transpose(1, 0, 2)
        .reshape(n, s * CHUNK_SIZE)
        .copy()
    )


def ref_parity(data: np.ndarray, k: int, n: int) -> np.ndarray:
    """Parity rows ONLY of the systematic code: ((n-k), S*512) for
    stripe-major bytes (length multiple of k*512).

    This is the delta-encode primitive of the parity-delta write plane
    (the classic RAID parity-logging result): the code is linear, so
    ``frag_i(old ⊕ Δ) = frag_i(old) ⊕ frag_i(Δ)`` — a sub-stripe write
    ships the overwritten data bytes verbatim (systematic data rows ARE
    the stripe chunks) plus ``parity(Δ)`` applied brick-side as an XOR
    (the ``xorv`` fop), never re-encoding the untouched rows."""
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    if data.size % (k * CHUNK_SIZE):
        raise ValueError("data length must be a multiple of k*512")
    pbits = parity_bits_cached(k, n)
    x = _to_planes(data, k)  # (S, k*8, 64)
    y = _xor_matmul_planes(pbits, x)  # (S, (n-k)*8, 64)
    m = n - k
    s = x.shape[0]
    return (
        y.reshape(s, m, GF_BITS * WORD_SIZE)
        .transpose(1, 0, 2)
        .reshape(m, s * CHUNK_SIZE)
        .copy()
    )


def frags_to_planes(frags: np.ndarray, k: int) -> np.ndarray:
    """Fragment-major (k, S*512) -> stripe-major plane words (S, k*8, 64)
    (inverse of ref_encode's output transform)."""
    frags = np.ascontiguousarray(frags, dtype=np.uint8)
    if frags.shape[0] != k:
        raise ValueError(f"need exactly {k} fragments, got {frags.shape[0]}")
    if frags.shape[1] % CHUNK_SIZE:
        raise ValueError("fragment length must be a multiple of 512")
    s = frags.shape[1] // CHUNK_SIZE
    return (
        frags.reshape(k, s, GF_BITS, WORD_SIZE)
        .transpose(1, 0, 2, 3)
        .reshape(s, k * GF_BITS, WORD_SIZE)
    )


def ref_decode(frags: np.ndarray, rows, k: int,
               systematic: bool = False) -> np.ndarray:
    """Decode k fragments (k, S*512) given their indices `rows` -> (S*k*512,)."""
    bbits = expand_bitmatrix(decode_matrix(k, rows, systematic))
    x = frags_to_planes(frags, k)  # (S, k*8, 64)
    y = _xor_matmul_planes(bbits, x)  # (S, k*8, 64)
    return y.reshape(x.shape[0] * k * CHUNK_SIZE).copy()
