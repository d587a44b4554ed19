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
import threading
from collections import OrderedDict
from typing import NamedTuple

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


class XorProgram(NamedTuple):
    """A compiled straight-line XOR program computing ``y = abits @ x mod 2``.

    ``ops`` is a tuple of ``(dst, a, b)`` meaning ``t[dst] = t[a] ^ t[b]``
    (``t[0..n_inputs-1]`` are the input planes, new ids are dense from
    ``n_inputs`` up — ``dst == n_inputs + op_index`` always holds);
    ``outs[r]`` is the tuple of var ids whose XOR is output row r (often
    a single shared id).  This tuple IS the compiled artifact a
    program-consuming backend takes: the native kernel walks it directly
    (gf_decode_prog), after :func:`schedule_program`.
    """

    ops: tuple[tuple[int, int, int], ...]
    outs: tuple[tuple[int, ...], ...]
    n_inputs: int

    @property
    def xor_count(self) -> int:
        """Total 64-byte-word XORs per stripe the program costs."""
        return len(self.ops) + sum(max(len(o) - 1, 0) for o in self.outs)


def schedule_program(prog: XorProgram) -> tuple[np.ndarray, int]:
    """Register-allocate a program for the native block walker: returns
    ``(code, n_slots)`` — a flat int32 instruction stream over a slab of
    ``n_slots`` reusable variable slots.

    The naive walk keeps every op's result live to the end, so the var
    slab at 16+4 is ~550 KiB per 8-stripe block — it thrashes L2 and
    LOSES to the row-select kernel despite 2.8x fewer word-XORs (the
    row-select scratch is 8 KiB and lives in L1).  Keeping results live
    until their output rows assemble doesn't fix it either (Paar's
    greedy op order finishes most rows late: peak live measured 874 of
    1067 vars at 16+4).  So the schedule is TRANSPOSED, like the fused
    kernels' stripe-major walk: every output row gets a fixed
    accumulator slot, each value is scattered (XOR) into its rows'
    accumulators the moment it is computed and freed at its last use —
    the live set becomes accumulators + inputs + in-flight CSE chains,
    small enough to stay cache-resident.

    Instructions (opcode-first):
    ``[0, dst, a, b]``      slot dst = slot a ^ slot b
    ``[1, row, nv, v...]``  emit output row = XOR of nv slots (0 -> zeros)
    ``[2, slot, f, p]``     load plane p of input fragment f into slot
    ``[3, src, n, s...]``   acc: slot s_i ^= slot src, for n slots
    ``[4, src, n, s...]``   init: slot s_i = copy of slot src (first touch)

    Accumulator for output row r is slot r (ids below ``len(outs)`` are
    reserved); rows emit as ``[1, r, 1, r]`` at the end, empty rows as
    ``[1, r, 0]``.
    """
    c = prog.n_inputs
    n_rows = len(prog.outs)
    n_vars = c + len(prog.ops)
    rows_of: dict[int, list[int]] = {}
    for r, o in enumerate(prog.outs):
        for v in o:
            rows_of.setdefault(v, []).append(r)
    op_uses = [0] * n_vars  # uses as an OPERAND of later ops
    for _d, a, b in prog.ops:
        op_uses[a] += 1
        op_uses[b] += 1
    slot = [-1] * n_vars
    free: list[int] = []
    code: list[int] = []
    touched = [False] * n_rows
    n_slots = n_rows

    def alloc() -> int:
        nonlocal n_slots
        if free:
            return free.pop()
        n_slots += 1
        return n_slots - 1

    def scatter(v: int) -> None:
        """XOR var v's value into every output accumulator that uses it
        directly (copy on a row's first contribution)."""
        init = [r for r in rows_of.get(v, ()) if not touched[r]]
        accum = [r for r in rows_of.get(v, ()) if touched[r]]
        if init:
            code.extend((4, slot[v], len(init), *init))
            for r in init:
                touched[r] = True
        if accum:
            code.extend((3, slot[v], len(accum), *accum))

    def release(v: int) -> None:
        if op_uses[v] == 0 and slot[v] >= 0:
            free.append(slot[v])
            slot[v] = -1

    # inputs: load each used plane once, scatter its direct out
    # contributions immediately; it stays live only while later ops
    # still consume it
    for v in range(c):
        if op_uses[v] == 0 and v not in rows_of:
            continue
        slot[v] = alloc()
        f, p = divmod(v, GF_BITS)
        code.extend((2, slot[v], f, p))
        scatter(v)
        release(v)
    for dst, a, b in prog.ops:
        # dst gets its slot BEFORE the operands are released: the C
        # walker's xor2_w promises (__restrict) dst aliases neither
        d = alloc()
        code.extend((0, d, slot[a], slot[b]))
        slot[dst] = d
        op_uses[a] -= 1
        op_uses[b] -= 1
        release(a)
        release(b)
        scatter(dst)
        release(dst)
    for r in range(n_rows):
        code.extend((1, r, 1, r) if touched[r] else (1, r, 0))
    return np.asarray(code, dtype=np.int32), n_slots


def build_xor_program(abits: np.ndarray) -> XorProgram:
    """Greedy common-subexpression elimination over a GF(2) bit-matrix
    (Paar's algorithm): returns a straight-line XOR program computing
    ``y = abits @ x mod 2`` with shared intermediates.

    Reed-Solomon bit-matrices are dense (tens of terms per output
    plane) but massively share pair subexpressions; the raw per-row
    XOR chains the reference JITs (ec-code-avx.c unrolled chains) redo
    each shared pair per row.  The returned program cuts total XOR
    count ~2-3x, which is the whole game for XOR-bound wide-k
    kernels.  Uncached — callers go through :func:`encode_program` /
    :func:`decode_program` etc., which hold the compiled artifacts in
    per-mask LRUs.
    """
    a = np.ascontiguousarray(abits, dtype=np.uint8)
    r, c = a.shape
    # incidence (rows, vars), preallocated for intermediates; the pair
    # co-occurrence matrix M is maintained INCREMENTALLY — extracting
    # pair (i, j) only changes M's rows/columns i, j and the new var's
    # (other pairs' co-occurrence is untouched), so each iteration
    # recomputes 3 mat-vecs instead of the full C^2 matmul (which made
    # the 16+4 build take minutes)
    cap = c + int(a.sum())
    cols = np.zeros((r, cap), dtype=bool)
    cols[:, :c] = a.astype(bool)
    m = np.zeros((cap, cap), dtype=np.int32)
    live = c
    m[:c, :c] = cols[:, :c].T.astype(np.int32) @ \
        cols[:, :c].astype(np.int32)
    np.fill_diagonal(m, 0)
    ops: list[tuple[int, int, int]] = []
    while True:
        sub = m[:live, :live]
        best = int(sub.argmax())
        i, j = divmod(best, live)
        if sub[i, j] < 2:
            break  # no pair shared by 2+ rows: chains are optimal now
        new = live
        both = cols[:, i] & cols[:, j]
        cols[both, i] = False
        cols[both, j] = False
        cols[:, new] = both
        live += 1
        ci = cols[:, :live].astype(np.int32)
        for v in (i, j, new):
            mv = ci.T @ ci[:, v]
            mv[v] = 0
            m[v, :live] = mv
            m[:live, v] = mv
        ops.append((new, int(i), int(j)))
    outs = tuple(tuple(int(v) for v in np.nonzero(row[:live])[0])
                 for row in cols)
    return XorProgram(tuple(ops), outs, c)


class ProgramLRU:
    """Per-key LRU of compiled :class:`XorProgram` artifacts.

    The reference keeps an LRU of inverted matrices keyed by the
    surviving-fragment bitmask (ec-method.c:200-245); caching only the
    bit-matrix leaves every backend to redo CSE (seconds at k=16) and
    recompile per request.  This cache holds the COMPILED program per
    mask instead — the mask key is ``(k, rows, ...)``, exactly the
    reference's keying with the geometry made explicit.

    Thread-safe (decode flushes run in batch.py's worker pool).  A miss
    builds outside the lock, so concurrent first requests for distinct
    masks don't serialize behind one k=16 CSE pass; duplicate concurrent
    builds of the same mask are wasted work, never wrong.  ``maxsize``
    is a plain attribute so tests can shrink it to force eviction.
    """

    def __init__(self, builder, maxsize: int = 128):
        self._builder = builder
        self.maxsize = maxsize
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, XorProgram] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __call__(self, *key) -> XorProgram:
        with self._lock:
            prog = self._entries.get(key)
            if prog is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return prog
            self.misses += 1
        prog = self._builder(*key)
        with self._lock:
            self._entries[key] = prog
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.evictions += 1
        return prog

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._entries

    def cache_clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def cache_info(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "size": len(self._entries), "maxsize": self.maxsize}


@functools.lru_cache(maxsize=64)
def encode_program(k: int, n: int, systematic: bool = False) -> XorProgram:
    """CSE'd XOR program of the full (n, k) generator — one per geometry
    (plain lru_cache: the key space is tiny, unlike decode masks)."""
    return build_xor_program(
        expand_bitmatrix(generator_matrix(k, n, systematic)))


@functools.lru_cache(maxsize=64)
def parity_program(k: int, n: int) -> XorProgram:
    """Program of the systematic generator's parity rows only."""
    return build_xor_program(parity_bits_cached(k, n))


def _build_decode_program(k: int, rows: tuple[int, ...],
                          systematic: bool = False) -> XorProgram:
    return build_xor_program(decode_bits_cached(k, rows, systematic))


def _build_reconstruct_program(k: int, rows: tuple[int, ...],
                               wanted: tuple[int, ...]) -> XorProgram:
    return build_xor_program(reconstruct_bits_cached(k, rows, wanted))


#: Per-surviving-mask LRU of compiled decode programs — THE decode-side
#: analog of the reference's inverted-matrix LRU, shared by every
#: backend.  Key: ``(k, rows_tuple, systematic)``.
DECODE_PROGRAMS = ProgramLRU(_build_decode_program, maxsize=128)

#: Per-(mask, wanted) LRU of systematic partial-decode programs — a
#: degraded systematic read compiles (and caches) ONLY the missing data
#: rows' program.  Key: ``(k, rows_tuple, wanted_tuple)``.
RECONSTRUCT_PROGRAMS = ProgramLRU(_build_reconstruct_program, maxsize=128)


def decode_program(k: int, rows, systematic: bool = False) -> XorProgram:
    """Compiled decode program for the surviving-fragment mask ``rows``."""
    return DECODE_PROGRAMS(k, tuple(int(x) for x in rows), systematic)


def reconstruct_program(k: int, rows, wanted) -> XorProgram:
    """Compiled systematic partial-decode program: k survivors ``rows``
    -> only the ``wanted`` missing data rows."""
    return RECONSTRUCT_PROGRAMS(k, tuple(int(x) for x in rows),
                                tuple(int(x) for x in wanted))


def run_xor_program(prog: XorProgram, x: np.ndarray) -> np.ndarray:
    """Execute a program on stripe-major plane words (S, C, 64) ->
    (S, R, 64): the NumPy oracle for program-consuming backends (tests
    cross-check every backend's program execution against plain
    ``_xor_matmul_planes`` on the same matrix)."""
    s = x.shape[0]
    if x.shape[1] != prog.n_inputs:
        raise ValueError(f"plane rows {x.shape[1]} != program inputs "
                         f"{prog.n_inputs}")
    t = list(np.swapaxes(x, 0, 1))  # C views of (S, 64)
    for _dst, a, b in prog.ops:
        t.append(t[a] ^ t[b])
    out = np.zeros((s, len(prog.outs), WORD_SIZE), dtype=np.uint8)
    for r, o in enumerate(prog.outs):
        if not o:
            continue
        acc = t[o[0]]
        for v in o[1:]:
            acc = acc ^ t[v]
        out[:, r, :] = acc
    return out
