"""The port's batching codec with its measured CPU ladder
(glusterfs_tpu_torch.ops.batch): the cases of tests/test_batch_codec.py
on backend ``torch`` (the kernels' plain versions, device ``cpu``) with
the ``native`` AVX2 codec as the CPU route — coalescing, routing by the
calibrated models, calibration, the two race regressions — plus the
port's own rules: a failing calibration raises, a native codec that does
not build raises (never ``ref``), and the EC layer's
``stripe-cache-min-batch``.  Every result is held against the JAX
package's ``ref`` codec.  Tolerance: exact byte equality."""

import asyncio
import contextlib
import sys
import threading
import time

import numpy as np
import pytest

from glusterfs_tpu.ops.codec import Codec as JaxCodec
from glusterfs_tpu_torch import native
from glusterfs_tpu_torch.api.glfs import Client
from glusterfs_tpu_torch.core.graph import Graph
from glusterfs_tpu_torch.ops import gf256_cuda
from glusterfs_tpu_torch.ops.batch import BatchingCodec
from glusterfs_tpu_torch.utils.volspec import ec_volfile

K, R = 4, 2
N = K + R
STRIPE = K * 512
REF = JaxCodec(K, R, "ref")
REF_SYS = JaxCodec(K, R, "ref", systematic=True)


def _rand(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _codec(**kw):
    return BatchingCodec(K, R, "torch", device="cpu", **kw)


def test_concurrent_encodes_one_launch():
    codec = _codec(window=0.005, min_batch=0)

    async def run():
        datas = [_rand(STRIPE * (i + 1), i) for i in range(8)]
        return datas, await asyncio.gather(
            *(codec.encode_async(d) for d in datas))

    datas, outs = asyncio.run(run())
    assert codec.launches == 1, "8 concurrent encodes must share 1 launch"
    assert codec.max_batch == 8 and codec.cpu_launches == 0
    assert codec._cpu is None, "min_batch=0 never builds the CPU codec"
    for d, o in zip(datas, outs):
        assert np.array_equal(o, REF.encode(d))
    codec.close()


def test_concurrent_decodes_group_by_mask():
    codec = _codec(window=0.005, min_batch=0)
    masks = [(0, 1, 2, 3), (1, 3, 4, 5), (0, 1, 2, 3)]
    datas = [_rand(STRIPE * 2, 10 + i) for i in range(3)]
    frag_sets = [REF.encode(d) for d in datas]

    async def run():
        return await asyncio.gather(*(
            codec.decode_async(fr[list(rows)], rows)
            for fr, rows in zip(frag_sets, masks)))

    outs = asyncio.run(run())
    assert codec.launches == 2  # two distinct masks
    for d, o in zip(datas, outs):
        assert np.array_equal(o, d)
    codec.close()


def test_small_batch_falls_back_to_cpu_ladder():
    codec = _codec(window=0.002, min_batch=1 << 20)  # everything is small
    gf256_cuda.reset_launches()

    async def run():
        d = _rand(STRIPE, 3)
        return d, await codec.encode_async(d)

    d, out = asyncio.run(run())
    assert codec.launches == 0, "small batch must not hit the device path"
    assert codec.cpu_launches == 1
    assert codec._small().backend == "native"
    assert np.array_equal(out, REF.encode(d))
    codec.close()


@pytest.mark.parametrize("systematic", [False, True])
def test_every_queue_routes_to_the_cpu_ladder(systematic):
    """Encode, decode and (systematic) delta flushes below min_batch all
    run on the native codec and match the JAX package's ref."""
    codec = _codec(window=0.002, min_batch=1 << 20, systematic=systematic)
    ref = REF_SYS if systematic else REF
    d = _rand(3 * STRIPE, 4)
    rows = (1, 2, 4, 5)  # a data fragment lost: a real decode

    async def run():
        frags = await codec.encode_async(d)
        out = await codec.decode_async(frags[list(rows)], rows)
        delta = await codec.encode_delta_async(d) if systematic else None
        return frags, out, delta

    frags, out, delta = asyncio.run(run())
    assert np.array_equal(frags, ref.encode(d))
    assert np.array_equal(out, d)
    if systematic:
        assert np.array_equal(delta, ref.encode_delta(d))
    assert codec.launches == 0
    assert codec.cpu_launches == (3 if systematic else 2)
    codec.close()


def test_sequential_calls_do_not_starve():
    codec = _codec(window=0.001, min_batch=0)

    async def run():
        outs = []
        for i in range(3):  # strictly sequential: each waits its window
            d = _rand(STRIPE, 20 + i)
            outs.append((d, await codec.encode_async(d)))
        return outs

    for d, o in asyncio.run(run()):
        assert np.array_equal(o, REF.encode(d))
    codec.close()


class _SlowDeviceCodec(BatchingCodec):
    """Device launches take a fixed wall time (a slow-link stand-in)."""

    DELAY = 0.25

    def encode(self, data):
        time.sleep(self.DELAY)
        return super().encode(data)


def test_flushes_pipeline_do_not_serialize():
    """Batch N+1 fills and dispatches while batch N is on the device: two
    flushes with a 0.25 s device round trip finish in well under the
    0.5 s of a serialized flush, and the event loop keeps ticking."""
    codec = _SlowDeviceCodec(K, R, "torch", device="cpu", window=0.001,
                             min_batch=0)
    ticks = 0

    async def ticker():
        nonlocal ticks
        while True:
            await asyncio.sleep(0.01)
            ticks += 1

    async def run():
        d = _rand(STRIPE * 4, 1)
        await codec.encode_async(d)  # warm off the clock
        tick_task = asyncio.ensure_future(ticker())
        t0 = time.perf_counter()
        wave_a = [asyncio.ensure_future(codec.encode_async(d))
                  for _ in range(4)]
        await asyncio.sleep(0.005)  # window expires -> flush A in flight
        wave_b = [asyncio.ensure_future(codec.encode_async(d))
                  for _ in range(4)]
        outs = await asyncio.gather(*wave_a, *wave_b)
        dt = time.perf_counter() - t0
        tick_task.cancel()
        return outs, dt

    outs, dt = asyncio.run(run())
    assert codec.launches == 3, "warmup + two timed flushes expected"
    assert dt < 2 * _SlowDeviceCodec.DELAY * 0.9, (
        f"flushes serialized: {dt:.3f}s for two overlappable "
        f"{_SlowDeviceCodec.DELAY}s launches")
    assert ticks >= 10, f"event loop starved during flushes ({ticks} ticks)"
    want = REF.encode(_rand(STRIPE * 4, 1))
    for o in outs:
        assert np.array_equal(o, want)
    codec.close()


def test_measured_break_even_routing():
    """With calibrated models, each flush goes to the predicted-faster
    path: a high-overhead device model routes small flushes to the CPU
    ladder; a near-zero-overhead device model routes them to the device."""
    codec = _codec(window=0.001, min_batch=1)
    # hand-calibrate: device = 1 s overhead + fast rate; native = fast
    codec._dev.overhead, codec._dev.rate = 1.0, 1e12
    codec._nat.overhead, codec._nat.rate = 0.0, 1e9
    codec._cal_state = "done"

    async def one(d):
        return await codec.encode_async(d)

    d = _rand(STRIPE * 2, 7)
    out = asyncio.run(one(d))
    assert np.array_equal(out, REF.encode(d))
    assert codec.cpu_launches == 1 and codec.launches == 0, \
        "slow-device model must route to the CPU ladder"
    be = codec.break_even_bytes()
    assert be is not None and be > STRIPE * 2

    # flip: device is effectively free -> device path wins
    codec._dev.overhead, codec._dev.rate = 0.0, 1e12
    codec._nat.rate = 1e6
    out = asyncio.run(one(d))
    assert np.array_equal(out, REF.encode(d))
    assert codec.launches == 1, "fast-device model must route to the device"
    assert codec.break_even_bytes() == 0  # the device wins at every size
    codec.close()


def test_ensure_calibrated_measures_both_paths():
    codec = _codec(window=0.001)

    async def run():
        return await codec.ensure_calibrated()

    assert asyncio.run(run()) is True
    stats = codec.dump_stats()
    assert stats["calibration"] == "done"
    assert stats["device_model"]["rate_MiB_s"] > 0
    assert stats["native_model"]["rate_MiB_s"] > 0
    assert all(r["flushes"] == 0 for r in stats["routed"].values())
    assert stats["min_batch_bytes"] == 256 * 1024
    assert set(stats) >= {"launches", "cpu_launches", "break_even_bytes"}
    assert codec.launches == 0, "calibration is not a served launch"
    codec.close()


def test_routed_flushes_follow_and_update_the_models():
    """After calibration, a flush at or above min_batch goes where the
    models say (device or CPU), its bytes are right, and its timing is
    counted on its route; the models stay the calibration's (a slow
    flush must not exile a path that then gets no samples)."""
    codec = _codec(window=0.001, min_batch=STRIPE)

    async def run():
        await codec.ensure_calibrated()
        models = [(m.overhead, m.rate) for m in (codec._dev, codec._nat)]
        d = _rand(64 * STRIPE, 8)
        frags = await codec.encode_async(d)
        out = await codec.decode_async(frags[[1, 2, 4, 5]], (1, 2, 4, 5))
        return d, frags, out, models

    d, frags, out, models = asyncio.run(run())
    assert np.array_equal(frags, REF.encode(d)) and np.array_equal(out, d)
    assert codec.launches + codec.cpu_launches == 2
    routed = codec.dump_stats()["routed"]
    assert routed["device"]["flushes"] == codec.launches
    assert routed["cpu"]["flushes"] == codec.cpu_launches
    assert sum(r["bytes"] for r in routed.values()) == 2 * d.size
    assert all(r["secs"] > 0 for r in routed.values() if r["flushes"])
    assert [(m.overhead, m.rate) for m in (codec._dev, codec._nat)] == models
    codec.close()


def test_slow_device_flushes_do_not_exile_the_device():
    """Flushes that take long on the device (a loaded host, a first
    pinned allocation) leave the calibrated models as they are: the next
    flush that the models give the device still goes there.  Folding
    each flush's time into the device model moved it under the CPU
    ladder's within these eight flushes, and a path the models reject
    gets no sample to recover with."""
    codec = _SlowDeviceCodec(K, R, "torch", device="cpu", window=0.001,
                             min_batch=STRIPE)
    codec.DELAY = 0.01
    codec._dev.overhead, codec._dev.rate = 0.0, 1e10
    codec._nat.overhead, codec._nat.rate = 0.0, 1e9
    codec._cal_state = "done"
    d = _rand(8 * STRIPE, 13)

    async def run():
        return [await codec.encode_async(d) for _ in range(9)]

    outs = asyncio.run(run())
    assert all(np.array_equal(o, REF.encode(d)) for o in outs)
    assert codec.launches == 9 and codec.cpu_launches == 0
    assert codec.dump_stats()["routed"]["device"]["flushes"] == 9
    codec.close()


class _BusyDeviceCodec(BatchingCodec):
    """Every device call takes a little wall time, so a flush can land
    while a calibration runs."""

    @contextlib.contextmanager
    def _placed(self):
        time.sleep(0.02)
        yield


def test_a_flush_beside_calibration_drops_it():
    """A background calibration that a flush ran beside timed a busy
    card: it is dropped (no models, state back to "idle", the device
    path meanwhile) and tried again at the next quiet gap.
    ensure_calibrated() keeps its result."""
    codec = _BusyDeviceCodec(K, R, "torch", device="cpu", window=0.001,
                             min_batch=STRIPE)
    codec._CAL_IDLE_S = 3600  # no background retry inside the test
    d = _rand(4 * STRIPE, 14)

    async def run():
        codec._maybe_start_calibration()
        out = await codec.encode_async(d)  # lands while it runs
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            with codec._lock:
                if codec._cal_state != "running":
                    break
            await asyncio.sleep(0.01)
        dropped = codec.dump_stats()
        forced = await codec.ensure_calibrated()
        return out, dropped, forced

    out, dropped, forced = asyncio.run(run())
    assert np.array_equal(out, REF.encode(d))
    assert dropped["calibration"] == "idle"
    assert dropped["device_model"] is None and dropped["native_model"] is None
    assert codec.launches == 1 and codec.cpu_launches == 0
    assert forced is True and codec.dump_stats()["calibration"] == "done"
    codec.close()


class _BrokenDeviceCodec(BatchingCodec):
    """The device path fails (a card that errors on launch)."""

    def _placed(self):
        raise RuntimeError("device launch failed")


def test_failing_calibration_raises():
    """The JAX package parks a codec whose calibration failed on the CPU
    for good; the port raises, from ensure_calibrated() and from every
    routed flush after it.  Flushes below min_batch stay on the CPU."""
    codec = _BrokenDeviceCodec(K, R, "torch", device="cpu", window=0.001,
                               min_batch=STRIPE * 4)

    async def run():
        with pytest.raises(RuntimeError, match="calibration") as e:
            await codec.ensure_calibrated()
        assert "device launch failed" in str(e.value)
        assert codec.dump_stats()["calibration"] == "failed"
        with pytest.raises(RuntimeError, match="calibration"):
            await codec.encode_async(_rand(STRIPE * 8, 1))
        with pytest.raises(RuntimeError, match="calibration"):
            f = REF.encode(_rand(STRIPE * 8, 2))
            await codec.decode_async(f[:4], (0, 1, 2, 3))
        small = _rand(STRIPE, 3)  # below the floor: the CPU ladder
        return small, await codec.encode_async(small)

    small, out = asyncio.run(run())
    assert np.array_equal(out, REF.encode(small))
    assert codec.launches == 0 and codec.cpu_launches == 1
    codec.close()


def test_native_build_failure_raises_never_ref(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("#error no native codec here\n")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    codec = _codec(window=0.001, min_batch=1 << 20)

    async def run():
        with pytest.raises(RuntimeError, match="no native codec here"):
            await codec.encode_async(_rand(STRIPE, 5))
        with pytest.raises(RuntimeError, match="no native codec here"):
            await codec.ensure_calibrated()

    asyncio.run(run())
    assert codec._cpu is None and codec.launches == 0
    # min_batch=0 pins the kernels and never needs the native codec
    pinned = _codec(window=0.001, min_batch=0)
    d = _rand(STRIPE, 6)

    async def pin():
        return await pinned.encode_async(d)

    assert np.array_equal(asyncio.run(pin()), REF.encode(d))
    codec.close()
    pinned.close()


def test_host_backends_alias_the_cpu_ladder():
    codec = BatchingCodec(K, R, "native", window=0.001)
    assert codec._cpu is codec and codec.device is None

    async def run():
        assert await codec.ensure_calibrated() is False
        d = _rand(2 * STRIPE, 9)
        return d, await codec.encode_async(d)

    d, out = asyncio.run(run())
    assert np.array_equal(out, REF.encode(d))
    assert codec.launches == 1 and codec.cpu_launches == 0
    codec.close()


def test_small_codec_lazy_build_is_race_free():
    """_small()'s lazy native codec: the routing path (event loop) races
    the calibration path (flush-pool thread) into it; racers must
    converge on ONE codec instance, built under the codec lock."""
    codec = _codec(min_batch=1 << 20)
    assert codec._cpu is None  # device-path backend: still lazy
    built = []
    start = threading.Barrier(16)

    def race():
        start.wait()
        built.append(codec._small())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=race) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 16
    assert all(b is built[0] for b in built), \
        "racing _small() calls built more than one small codec"
    assert built[0] is not codec and built[0].backend == "native"
    cpu = BatchingCodec(K, R, "native", min_batch=1 << 20)
    assert cpu._cpu is cpu
    codec.close()
    cpu.close()


def test_calibration_schedule_check_is_locked():
    """The debounce check reads _cal_state under the lock while
    _calibrate (pool thread) writes it under the lock: exactly one timer
    per idle gap, and a non-idle state schedules nothing."""
    codec = _codec(min_batch=1 << 20)

    async def run():
        codec._maybe_schedule_calibration()
        t1 = codec._cal_timer
        codec._maybe_schedule_calibration()  # debounced: same timer
        t2 = codec._cal_timer
        with codec._lock:
            codec._cal_state = "done"
        t1.cancel()
        codec._cal_timer = None
        codec._maybe_schedule_calibration()  # non-idle: no new timer
        return t1, t2, codec._cal_timer

    t1, t2, t3 = asyncio.run(run())
    assert t1 is t2 and t1 is not None
    assert t3 is None
    codec.close()


def test_calibration_starts_after_an_idle_gap():
    """A routed flush before calibration takes the device path and
    schedules a calibration, which starts once flushes have been quiet
    _CAL_IDLE_S."""
    codec = _codec(window=0.001, min_batch=STRIPE)

    async def run():
        d = _rand(4 * STRIPE, 11)
        out = await codec.encode_async(d)
        assert codec.launches == 1 and codec.cpu_launches == 0
        assert codec._cal_timer is not None
        deadline = time.monotonic() + 120  # the CPU plain encodes
        while time.monotonic() < deadline:
            with codec._lock:
                if codec._cal_state in ("done", "failed"):
                    break
            await asyncio.sleep(0.01)
        return d, out

    d, out = asyncio.run(run())
    assert np.array_equal(out, REF.encode(d))
    assert codec.dump_stats()["calibration"] == "done"
    codec.close()


@pytest.mark.parametrize("systematic", [False, True])
def test_uncalibrated_flushes_take_the_device_path(systematic):
    """With no models yet (no quiet gap has come), encode, decode and
    (systematic) delta flushes at or above min_batch take the device
    path, never the CPU ladder; one below it takes the native codec."""
    codec = _codec(window=0.001, min_batch=2 * STRIPE, systematic=systematic)
    codec._CAL_IDLE_S = 3600  # steady traffic: calibration never starts
    ref = REF_SYS if systematic else REF
    d = _rand(3 * STRIPE, 12)
    rows = (1, 2, 4, 5)

    async def run():
        frags = await codec.encode_async(d)
        out = await codec.decode_async(frags[list(rows)], rows)
        delta = await codec.encode_delta_async(d) if systematic else None
        on_device = codec.launches
        small = await codec.encode_async(d[:STRIPE])
        return frags, out, delta, on_device, small

    frags, out, delta, on_device, small = asyncio.run(run())
    assert np.array_equal(frags, ref.encode(d)) and np.array_equal(out, d)
    if systematic:
        assert np.array_equal(delta, ref.encode_delta(d))
    assert np.array_equal(small, ref.encode(d[:STRIPE]))
    assert on_device == (3 if systematic else 2)
    assert codec.launches == on_device and codec.cpu_launches == 1
    assert codec.dump_stats()["calibration"] == "idle"
    codec.close()


def _volume(base, **options):
    return ec_volfile(base, N, R, options={
        "cpu-extensions": "torch", "stripe-cache": "on",
        "stripe-cache-window": 2000, **options})


def test_ec_volume_concurrent_writes_coalesce(tmp_path):
    """N concurrent client writes on an EC volume are served by fewer
    codec launches than fops, and every byte round-trips."""
    datas = {f"/f{i}": bytes(_rand(4 * STRIPE, 40 + i)) for i in range(12)}

    async def run():
        c = Client(Graph.construct(_volume(tmp_path,
                                           **{"stripe-cache-min-batch": 0})))
        await c.mount()
        ec = c.graph.top
        await asyncio.gather(*(c.write_file(p, d) for p, d in datas.items()))
        wl = ec.codec.launches
        reads = await asyncio.gather(*(c.read_file(p) for p in datas))
        await c.unmount()
        return wl, reads

    wl, reads = asyncio.run(run())
    assert wl < 12, f"12 concurrent writes took {wl} launches (no coalescing)"
    for (p, d), got in zip(datas.items(), reads):
        assert got == d, p


def test_ec_volume_min_batch_option_routes_and_reconfigures(tmp_path):
    """The volume's stripe-cache-min-batch reaches the codec (default
    256KB: small writes take the native codec), and a live change
    rebuilds the codec with the new floor."""
    data = bytes(_rand(3 * STRIPE + 5, 50))

    async def run():
        c = Client(Graph.construct(_volume(tmp_path)))
        await c.mount()
        ec = c.graph.top
        assert ec.codec.min_batch == 256 * 1024
        await c.write_file("/a", data)
        routed = (ec.codec.launches, ec.codec.cpu_launches)
        old = ec.codec
        ec.reconfigure({"cpu-extensions": "torch", "stripe-cache": "on",
                        "stripe-cache-window": 2000,
                        "stripe-cache-min-batch": "0"})
        assert ec.codec is not old and ec.codec.min_batch == 0
        await c.write_file("/b", data)
        pinned = (ec.codec.launches, ec.codec.cpu_launches)
        got = [await c.read_file("/a"), await c.read_file("/b")]
        await c.unmount()
        return routed, pinned, got

    routed, pinned, got = asyncio.run(run())
    assert routed[0] == 0 and routed[1] >= 1
    assert pinned[0] >= 1 and pinned[1] == 0
    assert got == [data, data]


def test_ec_volume_default_options_take_the_card_path(tmp_path):
    """At the volume's default options, with no calibration run, a write
    and a read whose flushes reach the floor take the device path (the
    kernels' plain versions here); a small write takes the native
    codec; every byte round-trips."""
    big = bytes(_rand(512 << 10, 51))
    small = bytes(_rand(3 * STRIPE + 5, 52))

    async def run():
        c = Client(Graph.construct(_volume(tmp_path)))
        await c.mount()
        ec = c.graph.top
        ec.codec._CAL_IDLE_S = 3600  # steady traffic: no quiet gap
        await c.write_file("/big", big)
        written = (ec.codec.launches, ec.codec.cpu_launches)
        got_big = await c.read_file("/big")
        read = (ec.codec.launches, ec.codec.cpu_launches)
        await c.write_file("/small", small)
        got_small = await c.read_file("/small")
        stats = ec.codec.dump_stats()
        await c.unmount()
        return written, read, stats, got_big, got_small

    written, read, stats, got_big, got_small = asyncio.run(run())
    assert stats["min_batch_bytes"] == 256 * 1024
    assert stats["calibration"] == "idle"
    assert written[0] >= 1 and written[1] == 0
    assert read[0] > written[0] and read[1] == 0
    assert stats["cpu_launches"] >= 1
    assert got_big == big and got_small == small
