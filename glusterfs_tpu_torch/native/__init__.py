"""The host codec: C++ AVX2 GF(2^8) kernels, built at first use and bound
with ``ctypes``.

The port's copy of the JAX package's native codec (the same sources in
``src/``), the analog of the reference's fastest CPU backend
(``ec_code_detect``, reference ec-code.c:977-1059).  The library is
compiled with ``g++ -O3 -mavx2`` into the package's git-ignored
``_build/`` as ``libgf256_native_<hash>.so`` (the hash covers the
sources and the flags), beside the CUDA kernels' ``libgf256_<hash>.so``.

There is no fallback: a host without ``avx2``, a missing compiler, a
failed build or a failed load raises :class:`RuntimeError` carrying the
reason (the compiler's stderr for a failed build), and every later call
raises the same error.  :func:`available` only asks.

The wire codec's C form (``src/wirec.c``) is built here too, by
:func:`wirec_module`, with ``gcc`` and the same rule.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(sorted(
    (Path(__file__).resolve().parent / "src").glob("*.cpp")))
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-mavx2", "-funroll-loops", "-fPIC", "-shared",
             "-std=c++17")

WORD = 64
BITS = 8
CHUNK = WORD * BITS
MAX_K = 16  # RowSel.idx capacity in the C++ kernel is 16*8 columns

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None


def _has_avx2() -> bool:
    try:
        with open("/proc/cpuinfo") as f:
            return any(line.startswith("flags") and "avx2" in line.split()
                       for line in f)
    except OSError:
        return False


def build() -> Path:
    """Compile ``src/*.cpp`` into ``_build/`` (once per sources and
    flags).  Raises if the host lacks avx2 or ``g++`` fails."""
    if not _has_avx2():
        raise RuntimeError("native codec: this host's CPU lacks avx2 "
                           "(/proc/cpuinfo flags)")
    key = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        key.update(src.read_bytes())
    out = BUILD_DIR / f"libgf256_native_{key.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")  # concurrent builds race
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, *map(str, SOURCES),
                              "-o", str(tmp)], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native codec: cannot run g++: {e}") from e
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native codec: g++ failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """Build (once per process) and load the library; raises the build's
    or the load's error, the same one on every later call."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _error = str(e)
            raise RuntimeError(_error) from e
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.gf_apply_bitmatrix.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, u8p, u8p, ctypes.c_size_t]
        lib.gf_encode.argtypes = [
            u8p, u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_size_t]
        lib.gf_decode.argtypes = [u8p, u8p, u8p, ctypes.c_int,
                                  ctypes.c_size_t]
        lib.gf_decode_prog.argtypes = [
            u8p, u8p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_size_t]
        lib.adler32_batch.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint32)]
        for fn in (lib.gf_apply_bitmatrix, lib.gf_encode, lib.gf_decode,
                   lib.gf_decode_prog, lib.adler32_batch):
            fn.restype = None
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here (never raises)."""
    try:
        library()
        return True
    except RuntimeError:
        return False


WIREC_SOURCE = Path(__file__).resolve().parent / "src" / "wirec.c"
WIREC_FLAGS = ("-O2", "-fPIC", "-shared")

_wirec = None
_wirec_error: str | None = None


def wirec_module():
    """The wire codec's C form (``src/wirec.c``, a CPython extension),
    compiled with ``gcc`` at first use into ``_build/`` as
    ``_wirec_<hash>.so`` (the hash covers the source, the flags and the
    interpreter's extension suffix) and loaded once per process.

    A missing compiler, a failed build or a failed load raises
    :class:`RuntimeError` (gcc's stderr for a failed build), and every
    later call raises the same error: ``rpc/wire.py`` has no silent
    fallback to its Python codec."""
    global _wirec, _wirec_error
    with _lock:
        if _wirec is not None:
            return _wirec
        if _wirec_error is not None:
            raise RuntimeError(_wirec_error)
        try:
            _wirec = _load_wirec()
        except RuntimeError as e:
            _wirec_error = str(e)
            raise
        return _wirec


def _load_wirec():
    import importlib.machinery
    import importlib.util
    import sysconfig

    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    key = hashlib.sha256(" ".join(WIREC_FLAGS + (suffix,)).encode())
    key.update(WIREC_SOURCE.read_bytes())
    out = BUILD_DIR / f"_wirec_{key.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["gcc", *WIREC_FLAGS, "-I", sysconfig.get_paths()["include"],
               str(WIREC_SOURCE), "-o", str(tmp)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"wire codec: cannot run gcc: {e}") from e
        if res.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"wire codec: gcc failed ({res.returncode}):"
                               f"\n{res.stderr}")
        os.replace(tmp, out)
    try:
        loader = importlib.machinery.ExtensionFileLoader("_wirec", str(out))
        spec = importlib.util.spec_from_loader("_wirec", loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
    except (ImportError, OSError) as e:
        raise RuntimeError(f"wire codec: cannot load {out}: {e}") from e
    return mod


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}]")


def encode(data: np.ndarray, k: int, n: int, abits: np.ndarray) -> np.ndarray:
    """Stripe-major bytes (S*k*512) + (n*8, k*8) bitmatrix -> (n, S*512)."""
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    _check_k(k)
    if data.size % (k * CHUNK):
        raise ValueError("data length must be a multiple of k*512")
    abits = np.ascontiguousarray(abits, dtype=np.uint8)
    if abits.shape != (n * BITS, k * BITS):
        raise ValueError(f"bit-matrix {abits.shape} is not ({n * BITS}, "
                         f"{k * BITS})")
    s = data.size // (k * CHUNK)
    out = np.empty((n, s * CHUNK), dtype=np.uint8)
    library().gf_encode(_u8p(data), _u8p(out), _u8p(abits), k, n, s)
    return out


def _check_frags(frags: np.ndarray, k: int) -> np.ndarray:
    frags = np.ascontiguousarray(frags, dtype=np.uint8)
    _check_k(k)
    if frags.ndim != 2 or frags.shape[0] != k or frags.shape[1] % CHUNK:
        raise ValueError("need (k, S*512) fragments")
    return frags


def decode(frags: np.ndarray, k: int, bbits: np.ndarray) -> np.ndarray:
    """Fragment-major (k, S*512) + (k*8, k*8) bitmatrix -> bytes (S*k*512)."""
    frags = _check_frags(frags, k)
    bbits = np.ascontiguousarray(bbits, dtype=np.uint8)
    if bbits.shape != (k * BITS, k * BITS):
        raise ValueError(f"bit-matrix {bbits.shape} is not ({k * BITS}, "
                         f"{k * BITS})")
    s = frags.shape[1] // CHUNK
    out = np.empty(s * k * CHUNK, dtype=np.uint8)
    library().gf_decode(_u8p(frags), _u8p(out), _u8p(bbits), k, s)
    return out


@functools.lru_cache(maxsize=256)
def _prog_schedule(prog):
    """Register-allocated instruction stream of an XorProgram (hashable
    NamedTuple): one scheduling pass per cached program instead of one
    per decode call."""
    from ..ops import gf256

    return gf256.schedule_program(prog)


def decode_program(frags: np.ndarray, k: int, prog) -> np.ndarray:
    """Fragment-major (k, S*512) + a gf256.XorProgram (the per-mask
    compiled decode schedule) -> bytes (S*k*512).  The CSE'd schedule
    cuts the word-XOR count ~2-3x vs :func:`decode`'s row-select walk;
    the slot-reusing schedule keeps its working set cache-resident."""
    frags = _check_frags(frags, k)
    if prog.n_inputs != k * BITS or len(prog.outs) != k * BITS:
        raise ValueError(
            f"program shape {prog.n_inputs}->{len(prog.outs)} does not "
            f"match a k={k} decode")
    s = frags.shape[1] // CHUNK
    code, n_slots = _prog_schedule(prog)
    # 8-stripe blocks amortize per-instruction dispatch (the JAX
    # package's block scan: 8 wins or ties at every geometry)
    out = np.empty(s * k * CHUNK, dtype=np.uint8)
    library().gf_decode_prog(_u8p(frags), _u8p(out), _i32p(code),
                             len(code), n_slots, 8, k, s)
    return out


def adler32_batch(blocks: np.ndarray) -> np.ndarray:
    """[n, b] uint8 -> [n] uint32 zlib-compatible adler32."""
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    if blocks.ndim != 2:
        raise ValueError("blocks must be (n, b)")
    n, b = blocks.shape
    out = np.empty(n, dtype=np.uint32)
    library().adler32_batch(_u8p(blocks), n, b,
                            out.ctypes.data_as(
                                ctypes.POINTER(ctypes.c_uint32)))
    return out


def apply_bitmatrix(abits: np.ndarray, x: np.ndarray) -> np.ndarray:
    """(R, C) bitmatrix applied to plane-major (C, W) bytes -> (R, W)."""
    abits = np.ascontiguousarray(abits, dtype=np.uint8)
    x = np.ascontiguousarray(x, dtype=np.uint8)
    r, c = abits.shape
    if c > MAX_K * BITS:
        raise ValueError(f"at most {MAX_K * BITS} input planes supported")
    if x.ndim != 2 or x.shape[0] != c or x.shape[1] % WORD:
        raise ValueError("x must be (C, W) with W a multiple of 64")
    out = np.empty((r, x.shape[1]), dtype=np.uint8)
    library().gf_apply_bitmatrix(_u8p(abits), r, c, _u8p(x), _u8p(out),
                                 x.shape[1])
    return out
