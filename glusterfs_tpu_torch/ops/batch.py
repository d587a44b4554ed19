"""Batching codec: coalesce concurrent fop codec work into one device batch.

The reference amortizes per-write stripe work with a stripe-cache
(reference xlators/cluster/ec/src/ec.c:286 option ``stripe-cache``); the
device analog — "stripe fragments from concurrent fops coalesced into
device-resident batches" — is a batching window:

* concurrent ``encode_async``/``decode_async`` calls within one event-loop
  tick (plus ``window`` seconds) queue into a pending list;
* one flush concatenates the queued stripe-aligned payloads and makes ONE
  kernel launch for the whole batch (encode; decodes group by surviving
  mask — one launch per mask, the same ``(k, rows)`` keying as the
  per-mask device-mask cache of ops/gf256_cuda.py and the compiled XOR
  programs of gf256.DECODE_PROGRAMS that the native codec walks);
* flushes run OFF the event loop in a small thread pool, so batch N+1
  keeps filling (and can dispatch) while batch N is on the device — fop
  latency never serializes on a device round trip;
* routing between the device and the CPU ladder (the ``native`` AVX2
  codec) is MEASURED, not assumed: a background calibration times the
  device at two sizes (fitting ``t = overhead + bytes/rate``) and the
  native codec on the same data; each flush at or above ``min_batch``
  then goes to whichever path predicts faster for its size, and flushes
  below it to the CPU.  Until calibration completes, flushes at or above
  ``min_batch`` take the device path.  All three queues route: encode,
  decode and parity delta.

This is the JAX package's ladder (glusterfs_tpu/ops/batch.py) without
its mesh tier, with seven deliberate differences:

(a) A calibration that fails raises.  The JAX package records
    ``"failed"`` and keeps every flush on the CPU for good, which hides
    a broken card behind the host codec.  Here the exception is kept
    and raised from :meth:`BatchingCodec.ensure_calibrated` and from
    every routed flush after it (the flush's fops get the error).  A
    native codec that does not build raises the same way: it never
    becomes ``ref``.
(b) No power-of-two bucketing.  The JAX package pads each device batch
    to a power-of-two stripe count to bound XLA recompiles; the port's
    kernels take any stripe count, so a flush launches its own bytes and
    the device model predicts (and observes) the unpadded bytes.
(c) Which backends are the device path: ``cuda`` and ``cuda-mma``, and
    also ``torch`` and ``torch-mma``, the kernels' plain versions on the
    CPU, so the routing runs in CPU tests as the JAX package's does on
    ``xla``.  ``native`` and ``ref`` codecs alias themselves as the CPU
    ladder: their route is always "cpu".  ``min_batch=0`` pins every
    flush to the device path without building the native codec at all.
(d) Device timing ends at the host copy back: :meth:`Codec.encode`
    returns NumPy, so a device sample runs from the call until the
    result is on the host, copies included — the same clock in
    calibration and in every counted flush.  Calibration also gives
    the native codec an untimed first call at each size, as it gives
    the device: unwarmed, the first native call measured 1.16 ms of
    overhead against 0.10 ms on a warm one (PERF.md), which put
    the break-even at 0 bytes.  And it keeps the fastest of
    ``_CAL_REPS`` timed calls at each size, not one: a calibration
    that starts at a quiet gap can still share the card with the
    flushes that end it.
(e) No models, no CPU: until calibration is done, a flush at or above
    ``min_batch`` takes the device path.  The JAX package sends it to
    the CPU ladder, and since calibration waits for a quiet gap of
    ``_CAL_IDLE_S``, a volume under steady traffic (or a heal of a
    large file, window after window) never reached the card at all.
(f) Production flushes do not move the models.  The JAX package folds
    each flush's time into its path's model (EMA).  On the H100's host,
    device flushes timed under load (two flush workers on the codec's
    one stream, a calibration beside them, the first flushes at a size
    paying pinned allocations) dragged the device model below the
    native codec's at every size, and a path the models reject gets no
    more samples to recover: a heal ran 2040 of its 2050 flushes on the
    native codec, and 64 MiB reads went there too (PERF.md).  The
    models are the calibration's; each flush only adds to its route's
    counts in ``dump_stats()["routed"]``.
(g) A background calibration that a flush ran beside is dropped and
    tried again at the next quiet gap.  On the H100's host, one timed
    beside a heal's windows put the break-even at 1.13 MB (quiet ones:
    0.33-0.80 MB) and sent the heal's 1 MiB windows to the native
    codec.  :meth:`ensure_calibrated` keeps its result regardless.

Correctness leans on fragment-stream concatenation: fragment ``f`` of
``concat(stripes_a, stripes_b)`` is ``concat(frag_f(a), frag_f(b))`` —
stripes are independent (ec-method.c:393-408 loops stripes).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading
import time

import numpy as np

from .codec import Codec

_DEVICE_BACKENDS = ("cuda", "cuda-mma", "torch", "torch-mma")

# Calibration sizes (in stripes): a small and a large point to fit
# t(n) = overhead + n / rate.  The large point also warms the kernels.
_CAL_SMALL = 64
_CAL_LARGE = 2048
# timed calls per calibration point; the fastest counts, so a call that
# shared the card or the host with production flushes does not
_CAL_REPS = 3


def _fastest(fn, data: np.ndarray) -> float:
    """Host-clock seconds of the fastest of ``_CAL_REPS`` calls of
    ``fn(data)``, after one untimed call."""
    fn(data)
    best = float("inf")
    for _ in range(_CAL_REPS):
        t0 = time.perf_counter()
        fn(data)
        best = min(best, time.perf_counter() - t0)
    return best


class _PathModel:
    """Calibrated ``t(bytes) = overhead + bytes / rate`` timing model."""

    def __init__(self) -> None:
        self.overhead = 0.0
        self.rate = 0.0  # bytes/s; 0 -> uncalibrated

    @property
    def ready(self) -> bool:
        return self.rate > 0.0

    def fit_two_points(self, n1: int, t1: float, n2: int, t2: float) -> None:
        """Exact fit from calibration at two sizes (n2 > n1)."""
        slope = max((t2 - t1) / max(n2 - n1, 1), 1e-15)
        self.rate = 1.0 / slope
        self.overhead = max(t1 - n1 * slope, 0.0)

    def predict(self, nbytes: int) -> float:
        if not self.ready:
            return float("inf")
        return self.overhead + nbytes / self.rate


class BatchingCodec(Codec):
    """Codec with an async batching window for the served data path.

    The sync ``encode``/``decode`` API stays available (heal tooling,
    tests); the data path awaits ``encode_async``/``decode_async``.

    Stats: ``launches`` counts device-path launches (one per flush routed
    there, sync calls included), ``cpu_launches`` flushes routed to the
    CPU ladder, ``batched_fops`` total fops served, ``max_batch`` the
    largest coalesced batch in fops, ``routed`` the flushes, bytes and
    host-clock seconds of the finished async flushes per route.

    ``min_batch`` is a hard floor below which flushes never go to the
    device; ``min_batch=0`` disables routing (every flush takes the
    device path).  At or above the floor, the calibrated models decide
    per flush, and the device path takes the flush while there are no
    models yet.  The floor is not the break-even: it is the one rule
    that holds before calibration, and it bounds a poor fit (a cold
    first native call read as overhead put the break-even at 0 bytes,
    PERF.md), which would otherwise send flushes of a few stripes over
    the link.  The default, 256 KiB, lies below every break-even that a
    warm calibration measured on the H100's host, so it moves no flush
    that such a fit would send to the device.
    """

    def __init__(self, k: int, r: int, backend: str = "auto", *,
                 window: float = 0.0, min_batch: int = 256 * 1024,
                 max_batch_bytes: int = 256 << 20,
                 systematic: bool = False, device=None, name: str = ""):
        super().__init__(k, r, backend, systematic=systematic, device=device)
        # instance label: the owning layer's name (a distribute-over-
        # disperse volume has one codec PER group)
        self.name = name or f"{k}+{r}"
        self.window = window
        self.min_batch = min_batch
        self.max_batch_bytes = max_batch_bytes
        self._enc_q: list[tuple] = []  # (data, fut)
        self._enc_task: asyncio.Task | None = None
        self._dec_q: dict[tuple[int, ...], list[tuple]] = {}
        self._dec_task: asyncio.Task | None = None
        # parity-delta queue: coalesced sub-stripe write deltas ride the
        # same flush ladder as full encodes — one parity-rows-only launch
        # per flush
        self._delta_q: list[tuple] = []
        self._delta_task: asyncio.Task | None = None
        # lazy small-batch codec; CPU-ladder backends alias self HERE
        # (pre-publication, against self.backend as RESOLVED by the
        # base init) so _small()'s lazy build is the only
        # cross-context write left — and that one is lock-serialized
        self._cpu = None if self.backend in _DEVICE_BACKENDS else self
        self.launches = 0
        self.cpu_launches = 0
        # per route: [flushes, bytes, host-clock seconds] of finished
        # async flushes
        self.routed = {"device": [0, 0, 0.0], "cpu": [0, 0, 0.0]}
        self.batched_fops = 0
        self.max_batch = 0
        # two workers: batch N's device round trip overlaps batch N+1's
        # host work (staging, concatenation); each enters the codec's
        # device and stream itself (Codec._placed)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix=f"ec-codec-{k}+{r}")
        self._lock = threading.Lock()
        self._dev = _PathModel()
        self._nat = _PathModel()
        self._cal_state = "idle"  # idle -> running -> done/failed
        self._cal_error: BaseException | None = None
        # set by ensure_calibrated(): keep the result even if flushes ran
        # beside it
        self._cal_forced = False
        # calibration is DEFERRED to an idle gap: the first device
        # encode pays the kernels' build and the allocator's growth —
        # run that while production flushes are arriving and every
        # in-flight fop stalls behind it.  Flushes stamp _last_flush; a
        # debounce task starts calibrating only after _CAL_IDLE_S of
        # quiet.  ensure_calibrated() still forces it NOW.  Seeded with
        # NOW, not 0: a zero seed would make the first flush see an
        # "infinite" idle gap and fire calibration under the cold-start
        # burst.
        self._last_flush = time.monotonic()
        self._cal_timer: asyncio.Task | None = None

    _CAL_IDLE_S = 0.3

    # -- stats hooks (count every device launch, sync path included) ------

    def encode(self, data: np.ndarray) -> np.ndarray:
        with self._lock:
            self.launches += 1
        return super().encode(data)

    def decode(self, frags: np.ndarray, rows) -> np.ndarray:
        with self._lock:
            self.launches += 1
        return super().decode(frags, rows)

    def encode_delta(self, delta: np.ndarray) -> np.ndarray:
        with self._lock:
            self.launches += 1
        return super().encode_delta(delta)

    def _small(self) -> Codec:
        # double-checked under the codec lock: _route (loop) and
        # _calibrate (flush-pool thread) race the first call, and an
        # unserialized lazy build constructs the native codec twice.
        # A native codec that does not build raises (no ref fallback).
        if self._cpu is None:
            with self._lock:
                if self._cpu is None:
                    self._cpu = Codec(self.k, self.r, "native",
                                      systematic=self.systematic)
        return self._cpu

    # -- measured break-even routing --------------------------------------

    def _calibrate(self) -> None:
        """Time device + native at two sizes; fit both models.

        Runs in the pool.  Each size gets a warmup device launch (pays
        the kernels' build and the allocator's growth) and the fastest
        of ``_CAL_REPS`` timed ones, then the same for native encodes of
        the same data.  An exception is kept, and raised by
        ensure_calibrated() and routed flushes.  A background
        calibration that a flush ran beside is dropped (back to "idle",
        tried again at the next quiet gap): it timed a busy card and
        host, not the paths.
        """
        seen = self.batched_fops
        try:
            small = self._small()
            pts_dev, pts_nat = [], []
            for stripes in (_CAL_SMALL, _CAL_LARGE):
                data = np.frombuffer(
                    np.random.default_rng(stripes).bytes(
                        stripes * self.stripe_size), dtype=np.uint8)
                pts_dev.append((data.size, _fastest(super().encode, data)))
                pts_nat.append((data.size, _fastest(small.encode, data)))
            with self._lock:
                if self.batched_fops != seen and not self._cal_forced:
                    self._cal_state = "idle"
                    return
                self._dev.fit_two_points(*pts_dev[0], *pts_dev[1])
                self._nat.fit_two_points(*pts_nat[0], *pts_nat[1])
                self._cal_state = "done"
        except Exception as e:
            with self._lock:
                self._cal_error = e
                self._cal_state = "failed"

    def _calibration_failed(self) -> RuntimeError:
        return RuntimeError(f"{self.name}: codec calibration on "
                            f"{self.backend} failed: {self._cal_error!r}")

    def _maybe_start_calibration(self) -> None:
        with self._lock:
            if self._cal_state != "idle":
                return
            self._cal_state = "running"
        if self._cal_timer is not None:
            self._cal_timer.cancel()
            self._cal_timer = None
        self._pool.submit(self._calibrate)

    def _maybe_schedule_calibration(self) -> None:
        """Debounced: start calibration after an idle gap, not under load."""
        # _cal_state is written by the pool thread (_calibrate) under
        # the lock; this loop-side read takes it too (an unlocked read
        # beside a cross-context writer) — one uncontended acquire on a
        # path that already locks in _route
        with self._lock:
            if self._cal_state != "idle" or self._cal_timer is not None:
                return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return

        async def when_idle():
            while True:
                gap = time.monotonic() - self._last_flush
                if gap >= self._CAL_IDLE_S:
                    break
                await asyncio.sleep(self._CAL_IDLE_S - gap)
            self._cal_timer = None
            self._maybe_start_calibration()

        self._cal_timer = loop.create_task(when_idle())

    async def ensure_calibrated(self) -> bool:
        """Run (or await) calibration; True once the models are fitted,
        False for a CPU-ladder backend (nothing to route).  Raises the
        calibration's error, or the native codec's build error.

        Benches call this so routing decisions in the measured window are
        model-driven rather than 'no models -> device'.  Daemons never
        wait.
        """
        if self._cpu is self:
            return False
        self._small()
        with self._lock:
            self._cal_forced = True
        while True:
            self._maybe_start_calibration()  # no-op unless "idle"
            with self._lock:
                st = self._cal_state
            if st == "done":
                return True
            if st == "failed":
                raise self._calibration_failed()
            await asyncio.sleep(0.01)

    def _route(self, total: int) -> tuple[Codec, str]:
        """Pick the path for a flush of ``total`` bytes ->
        ``(codec, kind)`` with kind in {"device", "cpu"}; raises when
        calibration failed or the native codec does not build."""
        if self._cpu is self:
            return self, "cpu"  # CPU-ladder backend: nothing to route
        if self.min_batch <= 0:
            return self, "device"  # routing disabled: force the device
        small = self._small()
        if total < self.min_batch:
            return small, "cpu"
        with self._lock:
            st, dev, nat = self._cal_state, self._dev, self._nat
            if st == "done":
                if dev.predict(total) <= nat.predict(total):
                    return self, "device"
                return small, "cpu"
        if st == "failed":
            raise self._calibration_failed()
        self._maybe_schedule_calibration()
        return self, "device"  # no models yet: the device is the default

    def break_even_bytes(self) -> int | None:
        """Bytes past which the device model predicts a win (None if flat)."""
        with self._lock:
            if not (self._dev.ready and self._nat.ready):
                return None
            inv = 1.0 / self._nat.rate - 1.0 / self._dev.rate
            if inv <= 0:
                return None
            # 0 when the device model wins at every size (overhead
            # below native's): never report a negative byte count
            return max(0, int((self._dev.overhead - self._nat.overhead)
                              / inv))

    def _observe(self, device: bool, nbytes: int, secs: float) -> None:
        """Count a finished flush on its route (the models stay the
        calibration's: difference (f))."""
        with self._lock:
            row = self.routed["device" if device else "cpu"]
            row[0] += 1
            row[1] += nbytes
            row[2] += secs

    # -- flushing ------------------------------------------------------------

    def _take(self, batch: list, total: int):
        """Count a flush and route it -> ``(codec, kind)``, or None after
        resolving the batch with the routing error."""
        self._last_flush = time.monotonic()
        self.batched_fops += len(batch)
        self.max_batch = max(self.max_batch, len(batch))
        try:
            codec, kind = self._route(total)
        except Exception as e:
            self._resolve(batch, None, e)
            return None
        if kind == "cpu" and codec is not self:
            self.cpu_launches += 1
        return codec, kind

    def _submit(self, fn, loop, *args) -> None:
        """Pool submit with an inline fallback: a batch still pending in
        the window when close() shuts the pool (live reconfigure swaps
        the codec) must NOT strand its awaiting fops — run the flush on
        the loop thread instead."""
        try:
            self._pool.submit(fn, loop, *args)
        except RuntimeError:  # pool shut down after close()
            fn(loop, *args)

    @staticmethod
    def _resolve(batch, results, err) -> None:
        for i, (_d, fut) in enumerate(batch):
            if fut.done() or fut.cancelled():
                continue
            if err is not None:
                fut.set_exception(err)
            else:
                fut.set_result(results[i])

    # -- encode ------------------------------------------------------------

    async def encode_async(self, data: np.ndarray,
                           origin: str = "serve") -> np.ndarray:
        """Encode stripe-aligned bytes; coalesced with concurrent calls.

        ``origin`` names the traffic source ("serve" = fop data path,
        "heal" = shd re-encode); it is accepted for the EC layer's call
        sites and not counted separately here."""
        data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
        if data.size % self.stripe_size:
            raise ValueError("data length not a multiple of the stripe")
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._enc_q.append((data, fut))
        if sum(d.size for d, _ in self._enc_q) >= self.max_batch_bytes:
            self._flush_encodes()
        elif self._enc_task is None:
            self._enc_task = asyncio.ensure_future(self._enc_timer())
        return await fut

    async def _enc_timer(self):
        # window 0 = same-tick coalescing: sleep(0) runs after every
        # already-scheduled callback, so fops made concurrent in this
        # loop pass still land in one batch, while a lone sequential
        # writer pays no idle wait
        await asyncio.sleep(self.window)
        self._flush_encodes()

    def _flush_encodes(self) -> None:
        if self._enc_task is not None:
            self._enc_task.cancel()
            self._enc_task = None
        batch, self._enc_q = self._enc_q, []
        if not batch:
            return
        total = sum(d.size for d, _ in batch)
        routed = self._take(batch, total)
        if routed is not None:
            self._submit(self._run_stripes, asyncio.get_running_loop(),
                         batch, *routed, total, "encode")

    def _run_stripes(self, loop, batch, codec: Codec, kind: str,
                     total: int, op: str) -> None:
        """Executes in the pool: concatenate stripe-major payloads, one
        launch (encode or parity delta), split the fragment columns back
        per fop, resolve."""
        try:
            t0 = time.perf_counter()
            cat = batch[0][0] if len(batch) == 1 else \
                np.concatenate([d for d, _ in batch])
            frags = codec.encode(cat) if op == "encode" else \
                codec.encode_delta(cat)
            self._observe(kind == "device", total, time.perf_counter() - t0)
            results, off = [], 0
            for d, _ in batch:
                flen = d.size // self.k
                results.append(frags[:, off:off + flen].copy()
                               if len(batch) > 1 else frags)
                off += flen
            loop.call_soon_threadsafe(self._resolve, batch, results, None)
        except Exception as e:
            loop.call_soon_threadsafe(self._resolve, batch, None, e)

    # -- parity-delta encode -----------------------------------------------

    async def encode_delta_async(self, delta: np.ndarray,
                                 origin: str = "serve") -> np.ndarray:
        """Parity deltas for a stripe-aligned XOR delta; coalesced with
        concurrent calls exactly like ``encode_async`` (fragment-stream
        concatenation holds for the parity submatrix too — stripes are
        independent), and routed on the same ladder."""
        delta = np.ascontiguousarray(delta, dtype=np.uint8).ravel()
        if delta.size % self.stripe_size:
            raise ValueError("delta length not a multiple of the stripe")
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._delta_q.append((delta, fut))
        if sum(d.size for d, _ in self._delta_q) >= self.max_batch_bytes:
            self._flush_deltas()
        elif self._delta_task is None:
            self._delta_task = asyncio.ensure_future(self._delta_timer())
        return await fut

    async def _delta_timer(self):
        await asyncio.sleep(self.window)
        self._flush_deltas()

    def _flush_deltas(self) -> None:
        if self._delta_task is not None:
            self._delta_task.cancel()
            self._delta_task = None
        batch, self._delta_q = self._delta_q, []
        if not batch:
            return
        total = sum(d.size for d, _ in batch)
        routed = self._take(batch, total)
        if routed is not None:
            self._submit(self._run_stripes, asyncio.get_running_loop(),
                         batch, *routed, total, "delta")

    # -- decode ------------------------------------------------------------

    async def decode_async(self, frags: np.ndarray, rows,
                           origin: str = "serve") -> np.ndarray:
        """Decode k fragments; coalesced with concurrent same-mask calls."""
        rows = tuple(int(x) for x in rows)
        frags = np.ascontiguousarray(frags, dtype=np.uint8)
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        q = self._dec_q.setdefault(rows, [])
        q.append((frags, fut))
        if sum(f.size for f, _ in q) >= self.max_batch_bytes:
            self._flush_decodes()  # same blow-up guard as the encode path
        elif self._dec_task is None:
            self._dec_task = asyncio.ensure_future(self._dec_timer())
        return await fut

    async def _dec_timer(self):
        await asyncio.sleep(self.window)
        self._flush_decodes()

    def _flush_decodes(self) -> None:
        if self._dec_task is not None:
            self._dec_task.cancel()
            self._dec_task = None
        queues, self._dec_q = self._dec_q, {}
        loop = asyncio.get_running_loop()
        for rows, batch in queues.items():
            total = sum(f.size for f, _ in batch)
            routed = self._take(batch, total)
            if routed is not None:
                self._submit(self._run_decode, loop, rows, batch, *routed,
                             total)

    def _run_decode(self, loop, rows, batch, codec: Codec, kind: str,
                    total: int) -> None:
        try:
            t0 = time.perf_counter()
            cat = batch[0][0] if len(batch) == 1 else \
                np.concatenate([f for f, _ in batch], axis=1)
            out = codec.decode(cat, rows)
            self._observe(kind == "device", total, time.perf_counter() - t0)
            results, off = [], 0
            for f, _ in batch:
                nbytes = f.shape[1] * self.k
                results.append(out[off:off + nbytes].copy()
                               if len(batch) > 1 else out)
                off += nbytes
            loop.call_soon_threadsafe(self._resolve, batch, results, None)
        except Exception as e:
            loop.call_soon_threadsafe(self._resolve, batch, None, e)

    def close(self) -> None:
        """Release the flush pool.  The EC layer calls this when a
        reconfigure replaces the codec and at graph fini — without it
        every rebuild leaks the two worker threads.  Queued flushes
        still run (their awaiters must resolve); threads exit after."""
        if self._cal_timer is not None:
            self._cal_timer.cancel()
            self._cal_timer = None
        self._pool.shutdown(wait=False)

    def dump_stats(self) -> dict:
        with self._lock:
            launches = self.launches
            dev, nat = (
                {"overhead_s": m.overhead, "rate_MiB_s": m.rate / 2**20}
                if m.ready else None for m in (self._dev, self._nat))
            cal = self._cal_state
            routed = {route: {"flushes": n, "bytes": b, "secs": t}
                      for route, (n, b, t) in self.routed.items()}
        return {
            "backend": self.backend,
            "device": str(self.device) if self.device is not None else "host",
            "launches": launches,
            "cpu_launches": self.cpu_launches,
            "batched_fops": self.batched_fops,
            "max_batch": self.max_batch,
            "window_s": self.window,
            "min_batch_bytes": self.min_batch,
            "calibration": cal,
            "device_model": dev,
            "native_model": nat,
            "break_even_bytes": self.break_even_bytes(),
            "routed": routed,
        }
