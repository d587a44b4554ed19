"""GF(2^8) codec kernels on the card, with their plain PyTorch versions.

The four fused kernels of the served disperse path, written by hand in
CUDA C++ for Hopper (``csrc/gf256_kernels.cu``, bound by
``csrc/gf256_binding.cpp``).  Each replaces one Pallas kernel of the
JAX package's ``ops/gf256_pallas.py``:

=====================  ===============================  =================
wrapper                layouts (in -> out)              bit-matrix
=====================  ===============================  =================
``fused_encode``       stripes (S*k*512,) -> (n, S*512)  encode_matrix
``fused_decode``       (k, S*512) -> stripes (S*k*512,)  decode_bits_cached
``fused_parity``       stripes (S*k*512,) -> (n-k, ..)   parity_bits_cached
``fused_reconstruct``  (k, S*512) -> (len(wanted), ..)   reconstruct_bits
=====================  ===============================  =================

A wrapper given a CUDA tensor launches its kernel (building the
extension on first use) and counts the launch in :data:`LAUNCHES`; a
CPU tensor goes to the kernel's plain version (``*_plain``), the
tensor analog of ``gf256._xor_matmul_planes``.  There is no other
route: any other device raises, and a failed build or launch raises.
"""

from __future__ import annotations

import functools
import threading
from pathlib import Path

import numpy as np
import torch

from . import gf256

CHUNK = gf256.CHUNK_SIZE
WORD = gf256.WORD_SIZE

KERNELS = ("fused_encode", "fused_decode", "fused_parity",
           "fused_reconstruct")

#: kernel launches per wrapper (CUDA path only; plain versions never count)
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)

_PKG = Path(__file__).resolve().parents[1]
_SOURCES = (_PKG / "csrc" / "gf256_kernels.cu",
            _PKG / "csrc" / "gf256_binding.cpp")
BUILD_DIR = _PKG / "_build"

_lock = threading.Lock()
_ext = None


def reset_launches() -> None:
    with _lock:
        for name in KERNELS:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def extension():
    """Build (once per process) and load the CUDA extension from the
    package's sources into ``_build/``.  Raises if the build fails."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load

            BUILD_DIR.mkdir(exist_ok=True)  # load() needs it for its lock
            _ext = load(
                name="gf256_kernels", sources=[str(p) for p in _SOURCES],
                build_directory=str(BUILD_DIR),
                extra_cflags=["-O3"],
                extra_cuda_cflags=["-O3",
                                   "-gencode=arch=compute_90a,code=sm_90a"],
                verbose=False)
        return _ext


# -- bit-matrices and their device masks -----------------------------------


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


@functools.lru_cache(maxsize=256)
def _device_masks(kind: str, k: int, key: tuple,
                  device: torch.device) -> torch.Tensor:
    """Uploaded masks per (kind, k, n | rows[, wanted], device) — the
    device-side counterpart of gf256's per-mask bit-matrix LRUs.  The
    upload is waited for once: every codec stream may read the cached
    tensor, not only the one it was copied on."""
    masks = torch.from_numpy(masks_of(_bits(kind, k, key))).to(device)
    torch.cuda.current_stream(device).synchronize()
    return masks


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


def _launch(name: str, kind: str, x: torch.Tensor, k: int, key: tuple,
            out_shape: tuple[int, int] | tuple[int], s: int,
            r_planes: int) -> torch.Tensor:
    masks = _device_masks(kind, k, key, x.device)
    out = torch.empty(out_shape, dtype=torch.uint8, device=x.device)
    if s:
        getattr(extension(), name)(x, out, masks, s, k * 8, r_planes)
        _count(name)
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
