#!/usr/bin/env python3
"""Smoke run of glusterfs_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py            # the whole run (one card)
    python3 chip_smoke.py --profile  # the whole run, the served phases
                                     # under torch.profiler (device share)

Phases, one JSON line each; any failure raises and exits non-zero:

1. build the CUDA kernels from ``glusterfs_tpu_torch/csrc`` and report
   the card (``nvidia-smi``'s name and power limit) and the build time;
2. each of the four codec kernels against its plain PyTorch version on
   the card, byte-exact: 4+2 (all 15 decode masks), 8+4 and 16+4 at
   256 MiB of stripe data (the batching codec's largest batch), and
   unaligned stripe counts 1, 3, 127, 129; with each kernel's time,
   the time of a device copy moving the same bytes, and its bound;
3. a served 4+2 disperse volume (``cpu-extensions auto``, which is the
   card, ``stripe-cache on``) through ``Graph.construct`` + ``Client``:
   64 concurrent 1 MiB writes and a 1 GiB file in 64 MiB writes, read
   back healthy and with 2 bricks down;
4. a served systematic 4+2 volume, the same writes and an unaligned
   overwrite (the parity kernel through ``encode_delta``), read back
   healthy and with a data and a parity brick down (the reconstruct
   kernel).

The launch counters are set to 0 just before each served phase and read
just after it; a kernel of the path that was never launched fails the
run.  The line before the last is the ``kernels`` summary, the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from glusterfs_tpu_torch.ops import gf256_cuda as gc  # noqa: E402

MiB = 1 << 20
SMALL_FILES = 64  # concurrent 1 MiB writes (the north-star writev)
BIG_BYTES = 1 << 30  # the large file, written in 64 MiB writes
# published H100 SXM HBM3 rate (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12
# 32-bit bitwise ops (LOP3) per clock per SM on compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput table);
# the peak op rate is this times the SM count times the card's maximum
# SM clock, both read from the card
LOP3_PER_CLK_SM = 64

REPLACES = {
    "fused_encode": "glusterfs_tpu/ops/gf256_pallas.py:342",
    "fused_decode": "glusterfs_tpu/ops/gf256_pallas.py:378",
    "fused_parity": "glusterfs_tpu/ops/gf256_pallas.py:444",
    "fused_reconstruct": "glusterfs_tpu/ops/gf256_pallas.py:477",
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def peak_ops_s() -> float:
    """32-bit bitwise operations per second of card 0."""
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return LOP3_PER_CLK_SM * sms * mhz * 1e6


def time_ms(fn, iters: int, loops: int = 3) -> float:
    """Device time of one ``fn()`` in ms: ``iters`` calls back to back
    between one pair of CUDA events, so the host's work before each
    launch overlaps the previous call; the median of ``loops`` such
    loops.  Every operand exceeds the 50 MB L2, so each call finds its
    inputs cold."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(loops):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return float(np.median(times))


# -- phase 2: kernels vs their plain versions --------------------------------


def _case(g, name, k, r, s, rows=None, wanted=None):
    """(kernel call, plain call, input, output bytes, bit-matrix) of one
    kernel at s stripes; inputs made on the card from the generator."""
    n = k + r
    data = torch.randint(0, 256, (s * k * 512,), dtype=torch.uint8,
                         device="cuda", generator=g)
    if name in ("fused_encode", "fused_parity"):
        x = data
    else:
        frags = gc.encode_plain(data, k, n) if name == "fused_decode" \
            else torch.cat([data.view(s, k, 512).permute(1, 0, 2).reshape(
                k, s * 512), gc.parity_plain(data, k, n)])
        x = frags[list(rows)].contiguous()
    if name == "fused_encode":
        return (lambda: gc.fused_encode(x, k, n),
                lambda: gc.encode_plain(x, k, n), x, gc._bits("encode", k, (n,)))
    if name == "fused_parity":
        return (lambda: gc.fused_parity(x, k, n),
                lambda: gc.parity_plain(x, k, n), x,
                gc._bits("parity", k, (n,)))
    if name == "fused_decode":
        return (lambda: gc.fused_decode(x, k, rows),
                lambda: gc.decode_plain(x, k, rows), x,
                gc._bits("decode", k, (tuple(rows),)))
    return (lambda: gc.fused_reconstruct(x, k, rows, wanted),
            lambda: gc.reconstruct_plain(x, k, rows, wanted), x,
            gc._bits("reconstruct", k, (tuple(rows), tuple(wanted))))


def check(g, name, k, r, s, rows=None, wanted=None, ops_s=None):
    kern, plain, x, abits = _case(g, name, k, r, s, rows, wanted)
    y, ref = kern(), plain()
    torch.cuda.synchronize()
    if y.shape != ref.shape or not torch.equal(y, ref):
        raise AssertionError(f"{name} {k}+{r} S={s} rows={rows}: kernel "
                             "disagrees with its plain version")
    err = int((y.int() - ref.int()).abs().max()) if y.numel() else 0
    if ops_s is None:
        return None
    nbytes = x.numel() + y.numel()
    # byte-XORs the bit-matrix asks for: each output plane XORs its
    # selected input planes (ones - 1 per row, 64 bytes each, per stripe);
    # one LOP3 XORs three 32-bit words, so it does two of them
    ones = int(abits.sum())
    xors = max(ones - abits.shape[0], 0) * 64 * s
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = xors / 4 / 2 / ops_s * 1e3
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = time_ms(kern, 10)
    plain_ms = time_ms(plain, 1)
    copy_ms = time_ms(lambda: dst.copy_(src), 10)
    return {"name": name, "config": f"{k}+{r}", "stripes": s,
            "rows": list(rows) if rows else None,
            "in_bytes": x.numel(), "out_bytes": y.numel(),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "gib_s": nbytes / (1 << 30) / (ms / 1e3),
            "copy_ms": copy_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def phase_kernels(card: str) -> dict:
    ops_s = peak_ops_s()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    configs = [(4, 2), (8, 4), (16, 4)]
    for k, r in configs:  # unaligned stripe counts, every kernel
        n = k + r
        rows = tuple(range(r, n))
        wanted = tuple(range(r))
        for s in (1, 3, 127, 129):
            for name in gc.KERNELS:
                check(g, name, k, r, s, rows, wanted)
    emit("kernels-unaligned", ok=True, stripes=[1, 3, 127, 129],
         configs=[f"{k}+{r}" for k, r in configs], kernels=list(gc.KERNELS))
    timed = {}
    for k, r in configs:
        n = k + r
        s = 256 * MiB // (k * 512)
        rows = tuple(range(r, n))  # every parity row stands in
        wanted = tuple(range(r))
        for name in gc.KERNELS:
            res = check(g, name, k, r, s, rows, wanted, ops_s)
            res["card"] = card
            res["peak_ops_s"] = ops_s
            emit("kernel", **res)
            if (k, r) == (4, 2):
                timed[name] = res
        if (k, r) == (4, 2):
            masks = list(itertools.combinations(range(n), k))
            for m in masks:
                check(g, "fused_decode", k, r, s, m)
                miss = tuple(j for j in range(k) if j not in m)
                if miss:
                    check(g, "fused_reconstruct", k, r, s, m, miss)
            emit("kernels-4+2-masks", ok=True, masks=len(masks),
                 stripes=s)
        torch.cuda.empty_cache()
    emit("kernels", ok=True, kernels=list(gc.KERNELS), card=card)
    return timed


# -- phases 3 and 4: served volumes ------------------------------------------


def _payload(g, nbytes: int) -> bytes:
    return torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                         device=g.device, generator=g).cpu().numpy().tobytes()


async def _mount(base: Path, options: dict, fresh: bool):
    from glusterfs_tpu_torch.api.glfs import Client
    from glusterfs_tpu_torch.core.graph import Graph
    from glusterfs_tpu_torch.utils.volspec import ec_volfile

    if fresh:
        shutil.rmtree(base, ignore_errors=True)
        base.mkdir(parents=True)
    c = Client(Graph.construct(ec_volfile(base, 6, 2, options={
        "cpu-extensions": "auto", "stripe-cache": "on",
        "stripe-cache-window": 2000, **options})))
    await c.mount()
    return c, c.graph.top


async def _write_big(c, path: str, data: bytes, piece: int) -> None:
    f = await c.create(path)
    try:
        for off in range(0, len(data), piece):
            await f.write(data[off:off + piece], off)
    finally:
        await f.close()


async def _read_all(c, files: dict) -> float:
    """Read every file back (the small ones concurrently), check the
    bytes, return MiB/s."""
    t0 = time.perf_counter()
    small = [p for p in files if len(files[p]) <= MiB]
    got = await asyncio.gather(*(c.read_file(p) for p in small))
    got += [await c.read_file(p) for p in files if p not in small]
    for p, b in zip(small + [p for p in files if p not in small], got):
        if b != files[p]:
            raise AssertionError(f"{p}: read back differs")
    return sum(map(len, files.values())) / MiB / (time.perf_counter() - t0)


def _spoil(base: Path, bricks) -> None:
    """Invert the head of every fragment file on ``bricks``: a read that
    still used one of them would return wrong bytes."""
    for i in bricks:
        for e in os.scandir(base / f"brick{i}"):
            if e.is_file() and not e.name.startswith("."):
                with open(e.path, "r+b") as f:
                    head = np.frombuffer(f.read(4 * MiB), dtype=np.uint8)
                    f.seek(0)
                    f.write((~head).tobytes())


async def _serve(base: Path, g, options: dict,
                 down: tuple[int, ...]) -> dict:
    """Write 64 concurrent 1 MiB files and a 1 GiB file in 64 MiB
    writes (on a systematic volume also an unaligned overwrite),
    read everything back; then spoil the ``down`` bricks, remount with
    them down and read everything again."""
    c, ec = await _mount(base, options, fresh=True)
    try:
        files = {f"/f{i}": _payload(g, MiB) for i in range(SMALL_FILES)}
        big = _payload(g, BIG_BYTES)
        t0 = time.perf_counter()
        await asyncio.gather(*(c.write_file(p, d) for p, d in files.items()))
        await _write_big(c, "/big", big, 64 * MiB)
        write = (SMALL_FILES * MiB + len(big)) / MiB / (
            time.perf_counter() - t0)
        files["/big"] = big
        if options.get("systematic") == "on":
            # unaligned overwrite inside a healthy file: the parity delta
            patch = _payload(g, 3001)
            f = await c.open("/f5")
            await f.write(patch, 777)
            await f.close()
            b = bytearray(files["/f5"])
            b[777:777 + len(patch)] = patch
            files["/f5"] = bytes(b)
            if ec.write_path["delta"] < 1:
                raise AssertionError(f"no parity-delta write: "
                                     f"{ec.write_path}")
        healthy = await _read_all(c, files)
        stats = ec.codec.dump_stats()
        write_path = dict(ec.write_path)
    finally:
        await c.unmount()
    if not (stats["launches"] > 0 and stats["max_batch"] > 1):
        raise AssertionError(f"codec did not batch: {stats}")
    if stats["backend"] != "cuda":
        raise AssertionError(f"volume codec is {stats['backend']}")
    _spoil(base, down)
    c, ec = await _mount(base, options, fresh=False)
    try:
        for i in down:
            ec.set_child_up(i, False)
        degraded = await _read_all(c, files)
        dstats = ec.codec.dump_stats()
    finally:
        await c.unmount()
    return {"write_mib_s": write, "healthy_read_mib_s": healthy,
            "degraded_read_mib_s": degraded, "bricks_down": list(down),
            "write_path": write_path, "codec": stats,
            "degraded_codec": dstats}


async def served_plain(base: Path, g) -> dict:
    return await _serve(base, g, {}, down=(0, 3))


async def served_systematic(base: Path, g) -> dict:
    # a data brick and a parity brick down: reads reconstruct row 1
    return await _serve(base, g, {"systematic": "on"}, down=(1, 5))


def _device_share(prof, wall_s: float) -> dict:
    """Device time of a profiled phase by kind, and the idle share of
    its wall time (kernels and copies of one stream do not overlap, so
    their sum is the busy time)."""
    ms = {"codec_kernels": 0.0, "copies": 0.0, "other": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if not us:
            continue
        kind = "codec_kernels" if "xor_apply" in e.key else \
            "copies" if "memcpy" in e.key.lower() else "other"
        ms[kind] += us / 1e3
    busy = sum(ms.values())
    return {"wall_s": wall_s, "device_ms": ms,
            "idle_share": 1 - busy / 1e3 / wall_s if busy else None}


def served(name: str, coro_fn, base: Path, g, card: str,
           profile: bool = False) -> dict:
    """Drive one served path with the launch counters zeroed just before
    and read just after (under the profiler with ``profile``)."""
    gc.reset_launches()
    t0 = time.perf_counter()
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = asyncio.run(coro_fn(base, g))
            torch.cuda.synchronize()
        res["profile"] = _device_share(prof, time.perf_counter() - t0)
    else:
        res = asyncio.run(coro_fn(base, g))
        torch.cuda.synchronize()
    launches = dict(gc.LAUNCHES)
    emit(name, ok=True, launches=launches, card=card, **res)
    return launches


def main() -> int:
    profile = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this run needs one card",
              file=sys.stderr)
        return 1
    card = nvidia_smi()
    t0 = time.perf_counter()
    gc.extension()
    emit("build", ok=True, card=card, build_s=time.perf_counter() - t0,
         torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0))
    timed = phase_kernels(card)

    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    base = ROOT / "_smoke_bricks"
    try:
        plain = served("served-4+2", served_plain, base / "plain", g, card,
                       profile)
        syst = served("served-4+2-systematic", served_systematic,
                      base / "systematic", g, card, profile)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    path = {"fused_encode": plain, "fused_decode": plain,
            "fused_parity": syst, "fused_reconstruct": syst}
    kernels = []
    for name in gc.KERNELS:
        launches = path[name][name]
        if launches < 1:
            raise AssertionError(f"{name} was never launched on its path")
        t = timed[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "glusterfs_tpu_torch/csrc/gf256_kernels.cu",
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "copy_ms": t["copy_ms"], "shape": "4+2, 256 MiB of stripes"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
