"""Unified erasure codec with explicit backend and device.

The analog of the reference's ``disperse.cpu-extensions`` option
(reference xlators/cluster/ec/src/ec-code.c:59-69, 977-1059): the
option values become

=============  =====================================================
backend        implementation
=============  =====================================================
``cuda``       the hand-written CUDA kernels of ops/gf256_cuda.py on
               the card (fused encode, decode, parity, reconstruct)
``cuda-mma``   the counterpart of the JAX package's ``pallas-mxu``:
               non-systematic encode and decode through the
               tensor-core kernel (``gf256_cuda.encode/decode(...,
               "mxu")``); systematic parity, ``encode_delta`` and
               degraded reads stay on the fused kernels
``torch``      the ``cuda`` wrappers on CPU tensors, i.e. the kernels'
               plain PyTorch versions; only with ``device="cpu"``
``torch-mma``  the ``cuda-mma`` routes on CPU tensors; only with
               ``device="cpu"``
``native``     the host's C++ AVX2 XOR kernels (``native/``, built
               with ``g++`` at first use); encode walks the bit-matrix
               rows, decode the CSE'd XOR program of its mask
               (``gf256.DECODE_PROGRAMS``); raises when it does not
               build (never becomes ``ref``)
``ref``        pure-NumPy bit-sliced oracle (ops/gf256.py)
``auto``       ``cuda``; raises when there is no card (it never falls
               back to the CPU, nor to ``native``: the batching codec's
               measured ladder is a route inside ops/batch.py, never
               what ``auto`` resolves to)
=============  =====================================================

All backends are byte-exact against ``ref``.  The codec takes and
returns NumPy arrays (the EC layer's host buffers); the ``cuda``
backend stages them through pinned host memory, runs its kernel on the
codec's own stream and waits for the result.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from . import gf256, gf256_cuda

BACKENDS = ("cuda", "cuda-mma", "torch", "torch-mma", "native", "ref")

# -- unified-registry scrape (core/metrics.py): which backends the
# live codecs resolved to ------------------------------------------------
import weakref as _weakref  # noqa: E402

from ..core import metrics as _metrics  # noqa: E402

_LIVE_CODECS: "_weakref.WeakSet" = _weakref.WeakSet()


def _codec_backend_samples():
    from collections import Counter as _Counter

    counts = _Counter(c.backend for c in list(_LIVE_CODECS))
    return [({"backend": b}, n) for b, n in counts.items()]


_metrics.REGISTRY.register(
    "gftpu_codec_instances", "gauge",
    "live Codec objects by resolved backend", _codec_backend_samples)


def detect(requested: str = "auto") -> str:
    """Resolve a requested backend name: ``auto`` is ``cuda``; an
    unknown name raises, and so does ``native`` when its library does
    not build here.  Whether a card is present is checked where the
    device is resolved, and its absence raises there."""
    if requested == "auto":
        return "cuda"
    if requested not in BACKENDS:
        raise ValueError(f"unknown backend {requested!r}; one of "
                         f"{BACKENDS + ('auto',)}")
    if requested == "native":
        from .. import native

        native.library()  # raises the build's error
    return requested


@functools.cache
def _encode_bits(k: int, n: int, systematic: bool) -> np.ndarray:
    return gf256.expand_bitmatrix(gf256.generator_matrix(k, n, systematic))


def resolve_device(backend: str, device=None) -> torch.device | None:
    """The device a backend runs on: ``native`` and ``ref`` none (NumPy
    on the host), ``torch`` and ``torch-mma`` the CPU (and only when
    asked for), ``cuda`` and ``cuda-mma`` a card (raises when there is
    none)."""
    dev = None if device is None else torch.device(device)
    if backend in ("native", "ref"):
        if dev is not None and dev.type != "cpu":
            raise ValueError(f"the {backend} backend runs on the host only")
        return None
    if backend.startswith("torch"):
        if dev is None or dev.type != "cpu":
            raise ValueError(f"the {backend} backend runs the kernels' "
                             "plain versions on the CPU: pass device='cpu'")
        return dev
    dev = dev or torch.device("cuda")
    if dev.type != "cuda":
        raise ValueError(f"the {backend} backend needs a CUDA device, "
                         f"got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device: the {backend} backend (like "
                           "auto) never falls back to the CPU; ask for "
                           "backend='torch', device='cpu' explicitly")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Codec:
    """Erasure codec for a (k data + r redundancy) dispersal.

    ``encode`` takes stripe-aligned bytes (length a multiple of
    ``stripe_size = k*512``) and returns ``(n, len/k)`` fragments;
    ``decode`` takes any k fragments + their indices and returns the bytes.
    Padding/RMW of unaligned user I/O belongs to the EC layer above
    (cluster/ec), not the codec — same split as ec-method.c vs
    ec-inode-write.c in the reference.
    """

    def __init__(self, k: int, r: int, backend: str = "auto",
                 systematic: bool = False, device=None):
        if k < 1 or r < 0 or k > gf256.MAX_FRAGMENTS:
            raise ValueError(f"bad k={k}, r={r} (k <= {gf256.MAX_FRAGMENTS})")
        self.k = k
        self.r = r
        self.n = k + r
        if self.n > 255:
            raise ValueError("k + r must be <= 255")
        self.fragment_chunk = gf256.CHUNK_SIZE
        self.stripe_size = k * gf256.CHUNK_SIZE
        self.backend = detect(backend)
        self.device = resolve_device(self.backend, device)
        # the card's work runs on the codec's own stream, entered by
        # whichever thread calls (the batching flush pool included)
        self._stream = torch.cuda.Stream(device=self.device) \
            if self.backend.startswith("cuda") else None
        # non-systematic encode/decode formulation (gf256_cuda.encode)
        self._form = "mxu" if self.backend.endswith("-mma") else "fused"
        # systematic generator (gf256.systematic_matrix): data rows are
        # raw stripe chunks — healthy reads need no math, encode ships
        # only parity off-device, degraded reads reconstruct only the
        # missing rows.  Incompatible fragment format with the default
        # (reference-parity) code: fixed per volume at create.
        self.systematic = systematic
        _LIVE_CODECS.add(self)  # unified-registry scrape target

    # -- host <-> device -----------------------------------------------------

    @contextlib.contextmanager
    def _placed(self):
        """Run on the codec's device and stream (no-op on the CPU)."""
        if self._stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            yield

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        if self._stream is None:
            return torch.from_numpy(arr if arr.flags.writeable
                                    else arr.copy())
        staging = torch.empty(arr.shape, dtype=torch.uint8, pin_memory=True)
        staging.numpy()[...] = arr
        return staging.to(self.device, non_blocking=True)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        if self._stream is None:
            return t.numpy()
        host = torch.empty(t.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(t, non_blocking=True)
        self._stream.synchronize()
        return host.numpy()

    # -- encode ------------------------------------------------------------

    def encode(self, data: np.ndarray) -> np.ndarray:
        data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
        if data.size % self.stripe_size:
            raise ValueError(
                f"data length {data.size} not a multiple of stripe "
                f"{self.stripe_size}")
        if self.systematic:
            return self._encode_systematic(data)
        if self.backend == "ref":
            return gf256.ref_encode(data, self.k, self.n)
        if self.backend == "native":
            from .. import native

            return native.encode(data, self.k, self.n,
                                 _encode_bits(self.k, self.n, False))
        with self._placed():
            return self._to_host(gf256_cuda.encode(
                self._to_dev(data), self.k, self.n, self._form))

    # -- decode ------------------------------------------------------------

    def decode(self, frags: np.ndarray, rows) -> np.ndarray:
        """Reconstruct from the k fragments ``frags`` with indices ``rows``."""
        rows = [int(x) for x in rows]
        if len(rows) != self.k or len(set(rows)) != self.k:
            raise ValueError(f"need {self.k} distinct fragment indices")
        if any(x < 0 or x >= self.n for x in rows):
            raise ValueError("fragment index out of range")
        frags = np.ascontiguousarray(frags, dtype=np.uint8)
        if self.systematic:
            return self._decode_systematic(frags, rows)
        if self.backend == "ref":
            return gf256.ref_decode(frags, rows, self.k)
        if self.backend == "native":
            from .. import native

            return native.decode_program(
                frags, self.k, gf256.decode_program(self.k, rows))
        with self._placed():
            return self._to_host(gf256_cuda.decode(
                self._to_dev(frags), rows, self.k, self._form))

    # -- systematic paths (disperse.systematic) ----------------------------

    def _data_rows(self, data: np.ndarray) -> np.ndarray:
        """Data fragments of the systematic code: a pure host reshape of
        the stripe-major bytes (fragment j = chunk j of every stripe)."""
        s = data.size // self.stripe_size
        c = self.fragment_chunk
        return np.ascontiguousarray(
            data.reshape(s, self.k, c).transpose(1, 0, 2)).reshape(
                self.k, s * c)

    def _parity(self, data: np.ndarray) -> np.ndarray:
        with self._placed():
            return self._to_host(gf256_cuda.fused_parity(
                self._to_dev(data), self.k, self.n))

    def _encode_systematic(self, data: np.ndarray) -> np.ndarray:
        if self.backend == "ref":
            return gf256.ref_encode(data, self.k, self.n, systematic=True)
        if self.backend == "native":
            from .. import native

            return native.encode(data, self.k, self.n,
                                 _encode_bits(self.k, self.n, True))
        # the device computes (and the link carries) ONLY parity
        s = data.size // self.stripe_size
        out = np.empty((self.n, s * self.fragment_chunk), dtype=np.uint8)
        out[: self.k] = self._data_rows(data)
        out[self.k:] = self._parity(data)
        return out

    def encode_delta(self, delta: np.ndarray) -> np.ndarray:
        """Parity-fragment deltas ((n-k), len/k) of a stripe-aligned
        XOR delta — the sub-stripe write primitive (parity-delta /
        parity-logging): linearity gives ``frag_i(old ⊕ Δ) =
        frag_i(old) ⊕ frag_i(Δ)``, and on a systematic volume the data
        rows of Δ are the overwritten bytes themselves, so a small
        write ships only the touched data slices plus these parity
        deltas (brick-side ``xorv`` applies them in place).  Only the
        parity submatrix of the generator is applied — no backend
        touches the k identity rows."""
        if not self.systematic:
            raise ValueError("delta encode needs the systematic layout "
                             "(non-systematic fragments are all "
                             "codewords; there is no verbatim data row "
                             "to delta against)")
        delta = np.ascontiguousarray(delta, dtype=np.uint8).ravel()
        if delta.size % self.stripe_size:
            raise ValueError(
                f"delta length {delta.size} not a multiple of stripe "
                f"{self.stripe_size}")
        if self.backend == "ref":
            return gf256.ref_parity(delta, self.k, self.n)
        if self.backend == "native":
            from .. import native

            # gf_encode walks whatever (rows, k*8) bit-matrix it is
            # handed: the parity submatrix with n-k output fragments
            return native.encode(delta, self.k, self.n - self.k,
                                 gf256.parity_bits_cached(self.k, self.n))
        return self._parity(delta)

    def reassemble(self, bufs, rows, frag_len: int) -> np.ndarray | None:
        """Healthy systematic fast path straight from fragment BUFFERS
        (the zero-staging lane of the read fan-out): when every
        data row survived, the answer is a pure interleave — each
        received buffer is written once, directly into its chunk
        positions of the output, with no intermediate ``frags`` staging
        array.  Buffers shorter than ``frag_len`` zero-fill (sparse
        tails, mirroring the EC layer's staging semantics).

        Returns the assembled stripe-major bytes, or None when this
        codec/row-set doesn't qualify (non-systematic, or a data row is
        missing) — the caller then stages and decodes."""
        if not self.systematic or sorted(int(r) for r in rows) != \
                list(range(self.k)):
            return None
        k, c = self.k, self.fragment_chunk
        if frag_len % c:
            raise ValueError(f"frag_len {frag_len} not a multiple of {c}")
        s = frag_len // c
        out = np.empty((s, k, c), dtype=np.uint8)
        for row, buf in zip(rows, bufs):
            a = np.frombuffer(buf, dtype=np.uint8)
            dst = out[:, int(row), :]
            whole = a.size // c
            rem = a.size % c
            if whole:
                dst[:whole] = a[: whole * c].reshape(whole, c)
            if rem:
                dst[whole, :rem] = a[whole * c:]
                dst[whole, rem:] = 0
            dst[whole + (1 if rem else 0):] = 0
        return out.reshape(-1)

    def _decode_systematic(self, frags: np.ndarray, rows) -> np.ndarray:
        k, c = self.k, self.fragment_chunk
        s = frags.shape[1] // c
        missing = [j for j in range(k) if j not in rows]
        if not missing:
            # healthy read: every data row survived — pure host assembly
            out = np.empty((s, k, c), dtype=np.uint8)
            for idx, row in enumerate(rows):
                out[:, row, :] = frags[idx].reshape(s, c)
            return out.reshape(-1)
        if self.backend == "ref":
            return gf256.ref_decode(frags, rows, k, systematic=True)
        if self.backend == "native":
            from .. import native

            return native.decode_program(
                frags, k, gf256.decode_program(k, rows, True))
        # degraded: reconstruct ONLY the missing data rows on the device
        with self._placed():
            rec = self._to_host(gf256_cuda.fused_reconstruct(
                self._to_dev(frags), k, rows, missing))
        out = np.empty((s, k, c), dtype=np.uint8)
        for idx, row in enumerate(rows):
            if row < k:
                out[:, row, :] = frags[idx].reshape(s, c)
        for i, j in enumerate(missing):
            out[:, j, :] = rec[i].reshape(s, c)
        return out.reshape(-1)

    # -- convenience -------------------------------------------------------

    def pad_length(self, nbytes: int) -> int:
        """Bytes after zero-padding up to a whole stripe (reference pads
        the tail stripe with zeros, ec-inode-write.c)."""
        s = self.stripe_size
        return (nbytes + s - 1) // s * s

    def encode_padded(self, data: np.ndarray) -> tuple[np.ndarray, int]:
        """Zero-pad to a stripe multiple and encode; returns (frags, nbytes)."""
        data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
        orig = data.size
        padded = self.pad_length(orig)
        if padded != orig:
            data = np.concatenate(
                [data, np.zeros(padded - orig, dtype=np.uint8)])
        return self.encode(data), orig

    def decode_padded(self, frags: np.ndarray, rows, nbytes: int) -> np.ndarray:
        """Decode and trim zero-padding back to ``nbytes``."""
        return self.decode(frags, rows)[:nbytes]
