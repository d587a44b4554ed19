"""GF(2^8) codec kernels on the card, with their plain PyTorch versions.

Seven kernels written by hand in CUDA C++ for Hopper
(``csrc/gf256_kernels.cu``, built with ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes``).  Each replaces one
Pallas kernel of the JAX package's ``ops/gf256_pallas.py``:

=====================  ===============================  =================
wrapper                layouts (in -> out)              bit-matrix
=====================  ===============================  =================
``fused_encode``       stripes (S*k*512,) -> (n, S*512)  encode_matrix
``fused_decode``       (k, S*512) -> stripes (S*k*512,)  decode_bits_cached
``fused_parity``       stripes (S*k*512,) -> (n-k, ..)   parity_bits_cached
``fused_reconstruct``  (k, S*512) -> (len(wanted), ..)   reconstruct_bits
``apply_bitmatrix``    plane-major (C, W) -> (R, W)      any (R, C <= 128)
=====================  ===============================  =================

``apply_bitmatrix`` takes ``formulation`` ``"xor"`` (kernel
``xor_apply``), ``"xor3"`` (``xor3_apply``, the same kernel on widths
that are multiples of 32 KiB) or ``"mxu"`` (``mxu_apply``, the
tensor-core int8 product mod 2).  The four fused kernels, ``xor_apply``
and ``xor3_apply`` launch one CUDA body, ``layout_xor``, which reads and
writes all three layouts (stripe-major, fragment-major, plane-major);
they differ only in the layout pair they pass it.
``encode`` and ``decode`` are the stripe-major entry points: ``"fused"``
runs the fused kernels, the other three the transpose sandwich around
``apply_bitmatrix``, as ``gf256_pallas.encode/decode`` do.

A wrapper given a CUDA tensor launches its kernel (building the library
on first use) and counts the launch in :data:`LAUNCHES`; a CPU tensor
goes to the kernel's plain version (``*_plain``).  There is no other
route: any other device raises, and a failed build or launch raises.
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
import torch

from . import gf256

CHUNK = gf256.CHUNK_SIZE
WORD = gf256.WORD_SIZE

FUSED = ("fused_encode", "fused_decode", "fused_parity",
         "fused_reconstruct")
FORMULATIONS = ("xor", "xor3", "mxu")
KERNELS = FUSED + tuple(f"{f}_apply" for f in FORMULATIONS)

#: kernel launches per wrapper (CUDA path only; plain versions never count)
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)

# plane-major widths (bytes of each plane row) the formulations take, as
# in gf256_pallas: W % 8 KiB for xor and mxu, W % 32 KiB for xor3
TILE_W = 8192
TILE3_W = 32768

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "gf256_kernels.cu"
BUILD_DIR = _PKG / "_build"
# --split-compile=0 optimizes the kernels' instantiations on every core:
# the build takes a third of the time on the H100's host (PERF.md)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--split-compile=0", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    with _lock:
        for name in KERNELS:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"no nvcc at {nvcc}: the CUDA kernels are built "
                           "from source with the CUDA toolkit")
    return str(nvcc)


def build() -> Path:
    """Compile ``csrc/gf256_kernels.cu`` into ``_build/`` (once per
    source and flags: the library's name carries their hash).  Raises
    if ``nvcc`` fails."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libgf256_{key.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """Build (once per process) and load the kernels' library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp = ctypes.c_void_p
            for name in KERNELS:
                fn = getattr(lib, f"gf256_{name}")
                fn.argtypes = [vp, vp, vp, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, vp]
                fn.restype = ctypes.c_int
            lib.gf256_xor_blocks.argtypes = [ctypes.c_int] * 2
            lib.gf256_xor_blocks.restype = ctypes.c_int
            lib.gf256_error_string.argtypes = [ctypes.c_int]
            lib.gf256_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def xor_blocks_per_sm(r: int, device: int = 0) -> int:
    """Blocks per SM of the body of the six XOR kernels for ``r`` output
    planes (the occupancy calculator's count; the grid is that many
    blocks per SM)."""
    lib = library()
    n = lib.gf256_xor_blocks(r, device)
    if n < 0:
        raise RuntimeError(f"layout_xor occupancy: CUDA error {-n} "
                           f"({lib.gf256_error_string(-n).decode()})")
    return n


# -- bit-matrices and their device operands ----------------------------------


@functools.lru_cache(maxsize=64)
def _encode_bits(k: int, n: int) -> np.ndarray:
    return gf256.expand_bitmatrix(gf256.encode_matrix(k, n))


def _bits(kind: str, k: int, key: tuple) -> np.ndarray:
    """(R, k*8) GF(2) bit-matrix of one kernel call."""
    if kind == "encode":
        return _encode_bits(k, key[0])
    if kind == "parity":
        return gf256.parity_bits_cached(k, key[0])
    if kind == "decode":
        return gf256.decode_bits_cached(k, key[0])
    return gf256.reconstruct_bits_cached(k, key[0], key[1])


def masks_of(abits: np.ndarray) -> np.ndarray:
    """(R, C <= 128) bit-matrix -> (R, 2) int64: bit j of row i's mask
    (word j // 64, bit j % 64) is ``abits[i, j]``."""
    r, c = abits.shape
    if c > 128:
        raise ValueError(f"at most 128 input planes, got {c}")
    padded = np.zeros((r, 128), dtype=np.uint64)
    padded[:, :c] = abits
    weights = np.uint64(1) << np.arange(64, dtype=np.uint64)
    words = (padded.reshape(r, 2, 64) * weights).sum(axis=2,
                                                     dtype=np.uint64)
    return words.view(np.int64)


def _operand(abits: np.ndarray, formulation: str,
             device: torch.device) -> torch.Tensor:
    """The bit-matrix as its kernel reads it: (R, C) int8 for ``mxu``,
    (R, 2) int64 masks for the XOR kernels."""
    if formulation == "mxu":
        if abits.shape[1] > 128:
            raise ValueError(f"at most 128 input planes, got "
                             f"{abits.shape[1]}")
        host = np.ascontiguousarray(abits, dtype=np.int8)
    else:
        host = masks_of(abits)
    return torch.from_numpy(host).to(device)


@functools.lru_cache(maxsize=256)
def _device_operand(formulation: str, kind: str, k: int, key: tuple,
                    device: torch.device) -> torch.Tensor:
    """Uploaded bit-matrix per (formulation, kind, k, n | rows[, wanted],
    device) — the device-side counterpart of gf256's per-mask bit-matrix
    LRUs.  The upload is waited for once: every codec stream may read the
    cached tensor, not only the one it was copied on."""
    t = _operand(_bits(kind, k, key), formulation, device)
    torch.cuda.current_stream(device).synchronize()
    return t


# -- plain versions ----------------------------------------------------------


def xor_matmul_planes(abits: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """y[s, i, :] = XOR_j { x[s, j, :] : abits[i, j] == 1 }.

    x: (S, C, 64) uint8 plane words; abits: (R, C) in {0, 1}.  The
    tensor twin of ``gf256._xor_matmul_planes``."""
    s = x.shape[0]
    out = torch.zeros((s, abits.shape[0], WORD), dtype=torch.uint8,
                      device=x.device)
    for i, row in enumerate(abits):
        sel = np.nonzero(row)[0]
        if sel.size:
            acc = x[:, int(sel[0])].clone()
            for j in sel[1:]:
                acc ^= x[:, int(j)]
            out[:, i] = acc
    return out


def _stripes_to_planes(flat: torch.Tensor, k: int) -> torch.Tensor:
    return flat.view(-1, k * 8, WORD)


def _frags_to_planes(frags: torch.Tensor, k: int) -> torch.Tensor:
    s = frags.shape[1] // CHUNK
    return frags.view(k, s, 8, WORD).permute(1, 0, 2, 3).reshape(
        s, k * 8, WORD)


def _planes_to_frags(y: torch.Tensor) -> torch.Tensor:
    s, r = y.shape[0], y.shape[1] // 8
    return y.view(s, r, CHUNK).permute(1, 0, 2).reshape(r, s * CHUNK)


def encode_plain(flat: torch.Tensor, k: int, n: int) -> torch.Tensor:
    return _planes_to_frags(xor_matmul_planes(
        _encode_bits(k, n), _stripes_to_planes(flat, k)))


def decode_plain(frags: torch.Tensor, k: int, rows) -> torch.Tensor:
    y = xor_matmul_planes(gf256.decode_bits_cached(k, _tup(rows)),
                          _frags_to_planes(frags, k))
    return y.reshape(-1)


def parity_plain(flat: torch.Tensor, k: int, n: int) -> torch.Tensor:
    return _planes_to_frags(xor_matmul_planes(
        gf256.parity_bits_cached(k, n), _stripes_to_planes(flat, k)))


def reconstruct_plain(frags: torch.Tensor, k: int, rows,
                      wanted) -> torch.Tensor:
    abits = gf256.reconstruct_bits_cached(k, _tup(rows), _tup(wanted))
    return _planes_to_frags(xor_matmul_planes(abits,
                                              _frags_to_planes(frags, k)))


def xor_apply_plain(abits: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``xor_apply`` and ``xor3_apply``: plane-major
    (C, W) -> (R, W) through :func:`xor_matmul_planes` on the (S, C, 64)
    view of the word columns."""
    c, w = x.shape
    y = xor_matmul_planes(abits, x.view(c, w // WORD, WORD).permute(1, 0, 2))
    return y.permute(1, 0, 2).reshape(abits.shape[0], w)


# columns of x per step of the mxu plain version: its float32 bits take
# 32*C*step bytes, 64 MiB whatever C is
_MXU_PLAIN_STEP_BITS = 1 << 21


def mxu_apply_plain(abits: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``mxu_apply``, the TPU kernel's arithmetic: unpack
    (C, w) bytes to (C, 8*w) bits in the grouped order b*w + j, a float32
    product (exact: every sum is at most C <= 128), & 1, pack.  In column
    steps, so that a wide input allocates no more than about 64 MiB of
    bits at a time."""
    r, c = abits.shape
    w = x.shape[1]
    a = torch.from_numpy(np.asarray(abits, dtype=np.float32)).to(x.device)
    shifts = torch.arange(8, dtype=torch.uint8,
                          device=x.device).view(1, 8, 1)
    y = torch.empty((r, w), dtype=torch.uint8, device=x.device)
    step = max(WORD, _MXU_PLAIN_STEP_BITS // c // WORD * WORD)
    for lo in range(0, w, step):
        xs = x[:, lo:lo + step].unsqueeze(1)  # (C, 1, step)
        bits = ((xs >> shifts) & 1).to(torch.float32).reshape(c, -1)
        prod = (a @ bits).to(torch.int32) & 1  # (R, 8*step)
        packed = (prod.view(r, 8, -1) << shifts.int()).sum(1)
        y[:, lo:lo + step] = packed.to(torch.uint8)
    return y


_PLAIN = {"xor": xor_apply_plain, "xor3": xor_apply_plain,
          "mxu": mxu_apply_plain}


# -- wrappers ------------------------------------------------------------------


def _tup(xs) -> tuple[int, ...]:
    return tuple(int(x) for x in xs)


def _check(t: torch.Tensor, shape_ok: bool, what: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a torch.Tensor")
    if t.dtype != torch.uint8:
        raise TypeError(f"{what}: expected uint8, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if not shape_ok:
        raise ValueError(f"{what}: bad shape {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")


def _call(name: str, x: torch.Tensor, out: torch.Tensor,
          operand: torch.Tensor, extent: int, c: int, r: int) -> None:
    """Launch kernel ``name`` on the current stream of ``x``'s card and
    count it; raises on a refused launch."""
    dev = x.device
    for t, what in ((x, "input"), (out, "output")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
    if out.device != dev or operand.device != dev:
        raise ValueError(f"{name}: input, output and bit-matrix must be "
                         "on one device")
    lib = library()
    err = getattr(lib, f"gf256_{name}")(
        x.data_ptr(), out.data_ptr(), operand.data_ptr(), extent, c, r,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({lib.gf256_error_string(err).decode()})")
    _count(name)


def _launch(name: str, kind: str, x: torch.Tensor, k: int, key: tuple,
            out_shape: tuple[int, int] | tuple[int], s: int,
            r_planes: int) -> torch.Tensor:
    masks = _device_operand("xor", kind, k, key, x.device)
    out = torch.empty(out_shape, dtype=torch.uint8, device=x.device)
    if s:
        _call(name, x, out, masks, s, k * 8, r_planes)
    return out


def fused_encode(flat: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Non-systematic encode: stripe-major bytes (S*k*512,) ->
    fragments (n, S*512)."""
    _check(flat, flat.dim() == 1 and flat.numel() % (k * CHUNK) == 0,
           "fused_encode")
    if flat.device.type == "cpu":
        return encode_plain(flat, k, n)
    s = flat.numel() // (k * CHUNK)
    return _launch("fused_encode", "encode", flat, k, (n,),
                   (n, s * CHUNK), s, n * 8)


def fused_decode(frags: torch.Tensor, k: int, rows) -> torch.Tensor:
    """Non-systematic decode: the k survivors ``rows`` (k, S*512) ->
    stripe-major bytes (S*k*512,)."""
    rows = _tup(rows)
    _check(frags, frags.dim() == 2 and frags.shape[0] == k == len(rows)
           and frags.shape[1] % CHUNK == 0, "fused_decode")
    if frags.device.type == "cpu":
        return decode_plain(frags, k, rows)
    s = frags.shape[1] // CHUNK
    return _launch("fused_decode", "decode", frags, k, (rows,),
                   (s * k * CHUNK,), s, k * 8)


def fused_parity(flat: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Systematic parity rows only: stripe-major bytes (S*k*512,) ->
    ((n-k), S*512)."""
    _check(flat, flat.dim() == 1 and flat.numel() % (k * CHUNK) == 0
           and n > k, "fused_parity")
    if flat.device.type == "cpu":
        return parity_plain(flat, k, n)
    s = flat.numel() // (k * CHUNK)
    return _launch("fused_parity", "parity", flat, k, (n,),
                   (n - k, s * CHUNK), s, (n - k) * 8)


def fused_reconstruct(frags: torch.Tensor, k: int, rows,
                      wanted) -> torch.Tensor:
    """Systematic degraded read: k survivors ``rows`` (k, S*512) ->
    only the ``wanted`` data rows (len(wanted), S*512)."""
    rows, wanted = _tup(rows), _tup(wanted)
    _check(frags, frags.dim() == 2 and frags.shape[0] == k == len(rows)
           and frags.shape[1] % CHUNK == 0 and len(wanted) > 0,
           "fused_reconstruct")
    if frags.device.type == "cpu":
        return reconstruct_plain(frags, k, rows, wanted)
    s = frags.shape[1] // CHUNK
    return _launch("fused_reconstruct", "reconstruct", frags, k,
                   (rows, wanted), (len(wanted), s * CHUNK), s,
                   len(wanted) * 8)


# -- plane-major kernels and the stripe-major entry points -------------------


def _check_planes(abits: np.ndarray, x: torch.Tensor,
                  formulation: str) -> None:
    """The contract of ``gf256_pallas.apply_bitmatrix``."""
    if formulation not in FORMULATIONS:
        raise ValueError(f"formulation must be 'xor', 'xor3' or 'mxu', "
                         f"got {formulation!r}")
    _check(x, x.dim() == 2, "apply_bitmatrix")
    if x.shape[0] != abits.shape[1]:
        raise ValueError(f"plane rows {x.shape[0]} != bitmatrix columns "
                         f"{abits.shape[1]}")
    if x.shape[1] % TILE_W:
        raise ValueError(f"W must be a multiple of {TILE_W}")
    if formulation == "xor3" and x.shape[1] % TILE3_W:
        raise ValueError(f"W must be a multiple of {TILE3_W} for xor3")


def _planes(formulation: str, x: torch.Tensor, abits: np.ndarray,
            operand) -> torch.Tensor:
    """Run one formulation on plane-major ``x``; ``operand()`` gives the
    bit-matrix on the card."""
    if x.device.type == "cpu":
        return _PLAIN[formulation](abits, x)
    r, c = abits.shape
    out = torch.empty((r, x.shape[1]), dtype=torch.uint8, device=x.device)
    if x.shape[1]:
        _call(f"{formulation}_apply", x, out, operand(), x.shape[1], c, r)
    return out


def apply_bitmatrix(abits: np.ndarray, x: torch.Tensor,
                    formulation: str = "xor") -> torch.Tensor:
    """Apply an (R, C) GF(2) bit-matrix to plane-major bytes (C, W) ->
    (R, W); W a multiple of 8 KiB (32 KiB for ``xor3``)."""
    abits = np.asarray(abits)
    _check_planes(abits, x, formulation)
    return _planes(formulation, x, abits,
                   lambda: _operand(abits, formulation, x.device))


def _apply_cached(formulation: str, x: torch.Tensor, kind: str, k: int,
                  key: tuple) -> torch.Tensor:
    """``apply_bitmatrix`` with a codec bit-matrix, uploaded once per
    mask and device."""
    abits = _bits(kind, k, key)
    _check_planes(abits, x, formulation)
    return _planes(formulation, x, abits, lambda: _device_operand(
        formulation, kind, k, key, x.device))


def _pad_w(s: int) -> int:
    """Stripes padded so the plane width S*64 is a multiple of every
    formulation's tile (32 KiB covers 8 KiB too): ``gf256_pallas._pad_w``."""
    per = TILE3_W // WORD
    return (s + per - 1) // per * per


def encode(flat: torch.Tensor, k: int, n: int,
           formulation: str = "fused") -> torch.Tensor:
    """Stripe-major bytes (S*k*512,) -> fragments (n, S*512).  ``fused``
    is :func:`fused_encode`; ``xor``, ``xor3`` and ``mxu`` transpose to
    plane-major (k*8, S_pad*64), apply the encode matrix, and transpose
    back, trimming the padding."""
    _check(flat, flat.dim() == 1 and flat.numel() % (k * CHUNK) == 0,
           "encode")
    if formulation == "fused":
        return fused_encode(flat, k, n)
    s = flat.numel() // (k * CHUNK)
    sp = _pad_w(s)
    xt = torch.empty((k * 8, sp * WORD), dtype=torch.uint8,
                     device=flat.device)
    v = xt.view(k * 8, sp, WORD)
    v[:, s:] = 0
    v[:, :s] = flat.view(s, k * 8, WORD).permute(1, 0, 2)
    yt = _apply_cached(formulation, xt, "encode", k, (n,))
    return yt.view(n, 8, sp, WORD)[:, :, :s].permute(0, 2, 1, 3).reshape(
        n, s * CHUNK)


def decode(frags: torch.Tensor, rows, k: int,
           formulation: str = "fused") -> torch.Tensor:
    """The k survivors ``rows`` (k, S*512) -> stripe-major bytes
    (S*k*512,), by the same formulations as :func:`encode`."""
    rows = _tup(rows)
    if formulation == "fused":
        return fused_decode(frags, k, rows)
    _check(frags, frags.dim() == 2 and frags.shape[0] == k == len(rows)
           and frags.shape[1] % CHUNK == 0, "decode")
    s = frags.shape[1] // CHUNK
    sp = _pad_w(s)
    xt = torch.empty((k * 8, sp * WORD), dtype=torch.uint8,
                     device=frags.device)
    v = xt.view(k, 8, sp, WORD)
    v[:, :, s:] = 0
    v[:, :, :s] = frags.view(k, s, 8, WORD).permute(0, 2, 1, 3)
    yt = _apply_cached(formulation, xt, "decode", k, (rows,))
    # plane rows are chunk-major within the stripe: chunk j of the
    # stripe is rows 8j..8j+7
    return yt.view(k, 8, sp, WORD)[:, :, :s].permute(2, 0, 1, 3).reshape(
        s * k * CHUNK)
