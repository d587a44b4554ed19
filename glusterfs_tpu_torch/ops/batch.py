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
  per-mask device-mask cache of ops/gf256_cuda.py);
* flushes run OFF the event loop in a small thread pool, so batch N+1
  keeps filling (and can dispatch) while batch N is on the device — fop
  latency never serializes on a device round trip;
* every flush takes the codec's device, whatever its size: there is no
  CPU ladder to route small batches to, and no shape bucketing (the
  kernels take any stripe count).

Correctness leans on fragment-stream concatenation: fragment ``f`` of
``concat(stripes_a, stripes_b)`` is ``concat(frag_f(a), frag_f(b))`` —
stripes are independent (ec-method.c:393-408 loops stripes).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading

import numpy as np

from .codec import Codec


class BatchingCodec(Codec):
    """Codec with an async batching window for the served data path.

    The sync ``encode``/``decode`` API stays available (heal tooling,
    tests); the data path awaits ``encode_async``/``decode_async``.

    Stats: ``launches`` counts codec launches (one per flush, sync calls
    included), ``batched_fops`` total fops served, ``max_batch`` the
    largest coalesced batch in fops.
    """

    def __init__(self, k: int, r: int, backend: str = "auto", *,
                 window: float = 0.0, max_batch_bytes: int = 256 << 20,
                 systematic: bool = False, device=None, name: str = ""):
        super().__init__(k, r, backend, systematic=systematic, device=device)
        # instance label: the owning layer's name (a distribute-over-
        # disperse volume has one codec PER group)
        self.name = name or f"{k}+{r}"
        self.window = window
        self.max_batch_bytes = max_batch_bytes
        self._enc_q: list[tuple] = []  # (data, fut)
        self._enc_task: asyncio.Task | None = None
        self._dec_q: dict[tuple[int, ...], list[tuple]] = {}
        self._dec_task: asyncio.Task | None = None
        # parity-delta queue: coalesced sub-stripe write deltas ride the
        # same flush path as full encodes — one parity-rows-only launch
        # per flush
        self._delta_q: list[tuple] = []
        self._delta_task: asyncio.Task | None = None
        self.launches = 0
        self.batched_fops = 0
        self.max_batch = 0
        # two workers: batch N's device round trip overlaps batch N+1's
        # host work (staging, concatenation); each enters the codec's
        # device and stream itself (Codec._placed)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix=f"ec-codec-{k}+{r}")
        self._lock = threading.Lock()

    # -- stats hooks (count every launch, sync path included) -------------

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

    def _take(self, batch: list) -> None:
        self.batched_fops += len(batch)
        self.max_batch = max(self.max_batch, len(batch))

    def _flush_encodes(self) -> None:
        if self._enc_task is not None:
            self._enc_task.cancel()
            self._enc_task = None
        batch, self._enc_q = self._enc_q, []
        if not batch:
            return
        self._take(batch)
        self._submit(self._run_stripes, asyncio.get_running_loop(), batch,
                     self.encode)

    def _submit(self, fn, loop, *args) -> None:
        """Pool submit with an inline fallback: a batch still pending in
        the window when close() shuts the pool (live reconfigure swaps
        the codec) must NOT strand its awaiting fops — run the flush on
        the loop thread instead."""
        try:
            self._pool.submit(fn, loop, *args)
        except RuntimeError:  # pool shut down after close()
            fn(loop, *args)

    def _run_stripes(self, loop, batch, launch) -> None:
        """Executes in the pool: concatenate stripe-major payloads, one
        launch (encode or parity delta), split the fragment columns back
        per fop, resolve."""
        try:
            cat = batch[0][0] if len(batch) == 1 else \
                np.concatenate([d for d, _ in batch])
            frags = launch(cat)
            results, off = [], 0
            for d, _ in batch:
                flen = d.size // self.k
                results.append(frags[:, off:off + flen].copy()
                               if len(batch) > 1 else frags)
                off += flen
            loop.call_soon_threadsafe(self._resolve, batch, results, None)
        except Exception as e:
            loop.call_soon_threadsafe(self._resolve, batch, None, e)

    @staticmethod
    def _resolve(batch, results, err) -> None:
        for i, (_d, fut) in enumerate(batch):
            if fut.done() or fut.cancelled():
                continue
            if err is not None:
                fut.set_exception(err)
            else:
                fut.set_result(results[i])

    # -- parity-delta encode -----------------------------------------------

    async def encode_delta_async(self, delta: np.ndarray,
                                 origin: str = "serve") -> np.ndarray:
        """Parity deltas for a stripe-aligned XOR delta; coalesced with
        concurrent calls exactly like ``encode_async`` (fragment-stream
        concatenation holds for the parity submatrix too — stripes are
        independent)."""
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
        self._take(batch)
        self._submit(self._run_stripes, asyncio.get_running_loop(), batch,
                     self.encode_delta)

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
            self._take(batch)
            self._submit(self._run_decode, loop, rows, batch)

    def _run_decode(self, loop, rows, batch) -> None:
        try:
            cat = batch[0][0] if len(batch) == 1 else \
                np.concatenate([f for f, _ in batch], axis=1)
            out = self.decode(cat, rows)
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
        self._pool.shutdown(wait=False)

    def dump_stats(self) -> dict:
        with self._lock:
            launches = self.launches
        return {
            "backend": self.backend,
            "device": str(self.device) if self.device is not None else "host",
            "launches": launches,
            "batched_fops": self.batched_fops,
            "max_batch": self.max_batch,
            "window_s": self.window,
        }
