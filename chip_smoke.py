#!/usr/bin/env python3
"""Smoke run of glusterfs_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py            # the whole run (one card)
    python3 chip_smoke.py --profile  # the whole run, the served phases
                                     # under torch.profiler (device share),
                                     # served-4+2 and served-4+2-wire also
                                     # under cProfile (top 25 functions)
    python3 chip_smoke.py --ladder-ab  # only served-4+2 and
                                     # served-4+2-ladder, in the order
                                     # pinned, ladder, ladder, pinned

Phases, one JSON line each; any failure raises and exits non-zero:

1. build the CUDA kernels from ``glusterfs_tpu_torch/csrc`` with
   ``nvcc`` and report the card (``nvidia-smi``'s name and power limit)
   and the build time;
2. each of the four fused codec kernels against its plain PyTorch
   version on the card, byte-exact: 4+2 (all 15 decode masks), 8+4 and
   16+4 at 256 MiB of stripe data (the batching codec's largest batch),
   and the card tests' stripe counts and configurations
   (``FUSED_STRIPES``, ``FUSED_CONFIGS``: partial tiles, k = 1, 3, 5,
   16+8 with its two passes, a grid that walks several tiles); with each
   kernel's time, the time of a device copy moving the same bytes, and
   its bound;
3. the three plane-major kernels (``xor_apply``, ``xor3_apply``,
   ``mxu_apply``) the same way: 4+2, 8+4 and 16+4 with the encode
   matrix and a decode mask at 256 MiB of plane data, every 4+2 decode
   mask on all three, ``mxu_apply`` at odd shapes (C of 1, 3, 5 and
   16 fragments, R not a multiple of 16, random matrices) and at row
   sums each side of 16, 32, 64 and 128 up to the largest (all-ones at
   C = 128 on 0xFF planes), ``xor_apply`` and ``xor3_apply`` at the same
   odd shapes (one tile and 13 x 32 KiB, a tile count that no grid
   divides), on all-ones, all-zero and single-one rows and past 160
   output planes, and their refusal of widths their tiling cannot cover,
   and ``encode``/``decode`` at stripe counts 1, 3, 127, 129; beside
   ``mxu_apply`` the time of ``torch._int_mm`` on the already unpacked
   operand (the product alone, a yardstick the port never calls);
4. ``entry-plane-major``: ``encode`` then ``decode`` (2 of 6 fragments
   lost) of a 256 MiB payload at 4+2 through each of ``xor``, ``xor3``
   and ``mxu``;
5. a served 4+2 disperse volume (``cpu-extensions auto``, which is the
   card, ``stripe-cache on``) through ``Graph.construct`` + ``Client``:
   64 concurrent 1 MiB writes and a 1 GiB file in 64 MiB writes, read
   back healthy and with 2 bricks down;
6. a served systematic 4+2 volume, the same writes and an unaligned
   overwrite (the parity kernel through ``encode_delta``), read back
   healthy and with a data and a parity brick down (the reconstruct
   kernel);
7. ``served-2x(4+2)-mma``: a distributed-disperse volume, one
   ``cluster/distribute`` over two 4+2 groups on ``cpu-extensions
   cuda-mma`` (the tensor-core kernel), the same writes, read back
   healthy and with 2 bricks of each group down;
8. ``served-8+4``: a non-systematic 8+4 disperse volume (12 bricks,
   ``cpu-extensions auto``), the same writes, read back healthy and with
   4 bricks down (fused encode and decode at k = 8);
9. ``served-4+2-heal``: self-heal after a brick replacement
   (``BASELINE.json`` config 4): the same writes on a 4+2 volume, bricks
   0 and 3 wiped under the live volume and rebuilt by ``heal_file``
   (fused decode then encode); then on a systematic 4+2 volume with
   bricks 1 and 5 wiped (fused reconstruct then parity).  Every healed
   fragment file must hash as before the wipe, carry the good bricks'
   ``trusted.ec.version`` and ``size``, ``heal_info`` must report no bad
   brick, and with two other bricks spoiled and down every file must
   read back exactly.  Both volumes keep every default option: no
   calibration is forced, and the heal must launch the kernels;
10. ``served-4+2-ladder``: the same traffic on a 4+2 volume with the
   default ``stripe-cache-min-batch`` (256KB), its codecs calibrated
   (``ensure_calibrated()``) before the timed window: both fitted
   models, the break-even and the flushes per route (card or the native
   AVX2 codec), each window's flushes by size and route;
11. ``native-vs-card``: ``Codec(4, 2, "native")`` against
   ``Codec(4, 2, "cuda")`` on 4+2 encode and decode of 1 MiB and 64 MiB
   (host clock, copies included), beside the host's CPU model;
12. ``served-4+2-wire``: a plain and a systematic 4+2 volume whose six
   bricks are the port's brick daemons (``python -m
   glusterfs_tpu_torch.daemon``, the default brick stack, one process
   each, no card), the client over ``protocol/client`` with
   ``served-4+2``'s options: the same writes (and the systematic
   overwrite, ``xorv`` over the wire), read back; the down bricks'
   fragments spoiled, the volume remounted and two daemons SIGKILLed
   (bricks 0 and 3, then 1 and 5), their disconnect awaited as
   CHILD_DOWN, everything read again.  Each window's rates, launches,
   flushes, RPC round trips and shm lane bytes are reported, whether each
   connection armed the shm lane, and how long each unmount took.

Phases 5-8 and 12 pin ``stripe-cache-min-batch 0`` (every flush on the
card);
the heal and ladder phases keep the volume's default.  Every served
phase reports its windows' flushes: count, bytes and seconds per route,
and the flush sizes.  The launch counters are set to 0 just before
each path (phases 4-10 and 12) and read just after it (the ladder phase takes
its calibration's launches back out); a kernel of the path that was
never launched fails the run.  The line before the last is the
``kernels`` summary, then the card's name and power limit, and the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import collections
import hashlib
import itertools
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from glusterfs_tpu_torch.core.layer import Loc  # noqa: E402
from glusterfs_tpu_torch.ops import gf256_cuda as gc  # noqa: E402
from tests.test_torch_cuda import (FUSED_CONFIGS,  # noqa: E402
                                   FUSED_STRIPES, XOR_EDGE_CASES,
                                   XOR_REFUSALS, XOR_WIDTHS, xor_edge_case)

MiB = 1 << 20
SMALL_FILES = 64  # concurrent 1 MiB writes (the north-star writev)
BIG_BYTES = 1 << 30  # the large file, written in 64 MiB writes
PLANE_BYTES = 256 * MiB  # plane data of the plane-major kernel rows
CONFIGS = [(4, 2), (8, 4), (16, 4)]
STRIPES = (1, 3, 127, 129)
# the plane-major kernels' odd shapes: input planes (k = 1, 3, 5, 16),
# output planes, plane-row bytes (mxu_apply; the XOR kernels take the
# card tests' XOR_WIDTHS)
MXU_ODD_C = (8, 24, 40, 128)
MXU_ODD_R = (8, 16, 24, 160)
MXU_ODD_W = (8192, 3 * 32768)
# largest row sums N (even rows; odd rows N - 1) each side of the powers
# of two where mxu_apply's bit pairing changes, at C = 128 on 0xFF planes
MXU_SUMS = (15, 16, 31, 32, 63, 64, 127, 128)
# published H100 SXM HBM3 rate (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12
# published H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
PEAK_INT8_OPS_S = 1979e12
# 32-bit bitwise ops (LOP3) per clock per SM on compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput table);
# the peak op rate is this times the SM count times the card's maximum
# SM clock, both read from the card
LOP3_PER_CLK_SM = 64
# the port's kernels are the functions of namespace gf256 in
# csrc/gf256_kernels.cu (profiler names are demangled)
CODEC_SYMBOLS = ("gf256::layout_xor<", "gf256::mxu_apply<")

REPLACES = {
    "fused_encode": "glusterfs_tpu/ops/gf256_pallas.py:342",
    "fused_decode": "glusterfs_tpu/ops/gf256_pallas.py:378",
    "fused_parity": "glusterfs_tpu/ops/gf256_pallas.py:444",
    "fused_reconstruct": "glusterfs_tpu/ops/gf256_pallas.py:477",
    "xor_apply": "glusterfs_tpu/ops/gf256_pallas.py:161",
    "xor3_apply": "glusterfs_tpu/ops/gf256_pallas.py:134",
    "mxu_apply": "glusterfs_tpu/ops/gf256_pallas.py:187",
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def resources(lib: Path, pattern: str, key: str) -> dict | None:
    """Registers, spill (local) bytes and stack of each instantiation of
    one kernel template in the built library, from ``cuobjdump
    --dump-resource-usage``: ``pattern`` matches its mangled name,
    ``key`` formats its template arguments.  None where the toolkit has
    no cuobjdump."""
    tool = Path(gc._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    run = subprocess.run([str(tool), "--dump-resource-usage", str(lib)],
                         capture_output=True, text=True, timeout=120)
    if run.returncode:
        return None
    out = run.stdout.splitlines()
    res = {}
    for name, usage in zip(out, out[1:]):
        m = re.search(pattern, name)
        if m and "REG:" in usage:
            fields = dict(f.split(":", 1) for f in usage.split()
                          if f.split(":", 1)[0] in ("REG", "STACK", "LOCAL"))
            res[key.format(*m.groups())] = {k.lower(): int(v)
                                            for k, v in fields.items()}
    return res


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


def copy_ms(nbytes: int) -> float:
    """A device copy moving ``nbytes`` (half read, half written)."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    return time_ms(lambda: dst.copy_(src), 10)


def xor_ops_ms(abits: np.ndarray, columns: int, ops_s: float) -> float:
    """Least time of the XORs the bit-matrix asks for: each output plane
    XORs its selected input planes (ones - 1 per row, 64 bytes each, per
    word column); one LOP3 XORs three 32-bit words, so it does two."""
    xors = max(int(abits.sum()) - abits.shape[0], 0) * 64 * columns
    return xors / 4 / 2 / ops_s * 1e3


def mxu_ops_ms(abits: np.ndarray, w: int) -> float:
    """Least time of the int8 products ``mxu_apply`` does: 2*R*C
    operations per product column, and per plane byte as many products
    as the bits of the bit-matrix's largest row sum, at least 4 (it reads
    two bits of a byte in one product while the sums allow)."""
    products = max(4, int(abits.sum(axis=1).max()).bit_length())
    return 2 * abits.size * products * w / PEAK_INT8_OPS_S * 1e3


def timing(kern, plain, nbytes: int, ops_ms: float) -> dict:
    """Kernel, plain version and device copy times with the bound."""
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ms = time_ms(kern, 10)
    return {"ms": ms, "plain_ms": time_ms(plain, 1),
            "gib_s": nbytes / (1 << 30) / (ms / 1e3),
            "copy_ms": copy_ms(nbytes), "bound_ms": max(bytes_ms, ops_ms),
            "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def same(name: str, y: torch.Tensor, ref: torch.Tensor, what: str) -> int:
    torch.cuda.synchronize()
    if y.shape != ref.shape or not torch.equal(y, ref):
        raise AssertionError(f"{name} {what}: kernel disagrees with its "
                             "plain version")
    return int((y.int() - ref.int()).abs().max()) if y.numel() else 0


# -- phase 2: fused kernels vs their plain versions --------------------------


def _case(g, name, k, r, s, rows=None, wanted=None):
    """(kernel call, plain call, input, bit-matrix) of one fused kernel at
    s stripes; inputs made on the card from the generator."""
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
    y = kern()
    err = same(name, y, plain(), f"{k}+{r} S={s} rows={rows}")
    if ops_s is None:
        return None
    nbytes = x.numel() + y.numel()
    return {"name": name, "config": f"{k}+{r}", "stripes": s,
            "rows": list(rows) if rows else None,
            "in_bytes": x.numel(), "out_bytes": y.numel(),
            "max_abs_err": err,
            **timing(kern, plain, nbytes, xor_ops_ms(abits, s, ops_s))}


def phase_kernels(card: str, ops_s: float) -> dict:
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    for k, r in FUSED_CONFIGS:  # the card tests' tails, every kernel
        n = k + r
        rows = tuple(range(r, n))
        wanted = tuple(range(r))
        for s in FUSED_STRIPES:
            for name in gc.FUSED:
                check(g, name, k, r, s, rows, wanted)
    emit("kernels-unaligned", ok=True, stripes=FUSED_STRIPES,
         configs=[f"{k}+{r}" for k, r in FUSED_CONFIGS],
         kernels=list(gc.FUSED))
    timed = {}
    for k, r in CONFIGS:
        n = k + r
        s = 256 * MiB // (k * 512)
        rows = tuple(range(r, n))  # every parity row stands in
        wanted = tuple(range(r))
        for name in gc.FUSED:
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
    emit("kernels", ok=True, kernels=list(gc.FUSED), card=card)
    return timed


# -- phase 3: plane-major kernels vs their plain versions --------------------


def _plane_case(k: int, r: int, matrix: str):
    """(kind, key, rows or None) of the encode matrix or a decode mask
    (the last k fragments survive: every parity row stands in)."""
    if matrix == "encode":
        return "encode", (k + r,), None
    rows = tuple(range(r, k + r))
    return "decode", (rows,), rows


def int_mm_ms(abits: np.ndarray, x: torch.Tensor) -> tuple[float, int]:
    """``torch._int_mm`` of the bit-matrix with the unpacked bits of the
    widest leading slice of ``x`` whose int32 product stays under 4 GiB:
    the tensor-core product alone, without unpack, mod 2 or pack.
    Returns (ms, plane-row bytes of the slice)."""
    r, c = abits.shape
    w = min(x.shape[1], ((1 << 32) // (4 * r * 8) - 1) // gc.TILE_W
            * gc.TILE_W)
    a = torch.from_numpy(np.ascontiguousarray(abits, np.int8)).cuda()
    shifts = torch.arange(8, dtype=torch.uint8, device="cuda").view(1, 8, 1)
    bits = ((x[:, :w].unsqueeze(1) >> shifts) & 1).view(torch.int8)
    # cuBLASLt takes int8 B column-major: (8w, C) row-major, transposed
    b = bits.reshape(c, 8 * w).t().contiguous().t()
    del bits
    ms = time_ms(lambda: torch._int_mm(a, b), 10)
    return ms, w


def check_plane(g, forms, k: int, r: int, matrix: str,
                ops_s: float) -> dict:
    """The plane-major kernels ``forms`` on one input of 256 MiB of plane
    data, each against its plain version, and timed."""
    kind, key, rows = _plane_case(k, r, matrix)
    abits = gc._bits(kind, k, key)
    c = abits.shape[1]
    w = PLANE_BYTES // c
    x = torch.randint(0, 256, (c, w), dtype=torch.uint8, device="cuda",
                      generator=g)
    out = {}
    for f in forms:
        def kern(f=f):
            return gc._apply_cached(f, x, kind, k, key)

        def plain_fn(f=f):
            return gc.mxu_apply_plain(abits, x) if f == "mxu" else \
                gc.xor_apply_plain(abits, x)
        name = f"{f}_apply"
        err = same(name, kern(), plain_fn(),
                   f"{k}+{r} {matrix} rows={rows} W={w}")
        nbytes = x.numel() + abits.shape[0] * w
        ops_ms = (mxu_ops_ms(abits, w) if f == "mxu"
                  else xor_ops_ms(abits, w // 64, ops_s))
        res = {"name": name, "config": f"{k}+{r}", "matrix": matrix,
               "rows": list(rows) if rows else None, "plane_w": w,
               "in_bytes": x.numel(), "out_bytes": abits.shape[0] * w,
               "max_abs_err": err, **timing(kern, plain_fn, nbytes, ops_ms)}
        if f == "mxu":
            res["product_ms"], res["product_w"] = int_mm_ms(abits, x)
        else:
            res["blocks_per_sm"] = gc.xor_blocks_per_sm(abits.shape[0])
        out[f] = res
    return out


def phase_plane_kernels(card: str, ops_s: float) -> dict:
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    for k, r in CONFIGS:  # through the entry points at unaligned S
        n = k + r
        rows = tuple(range(r, n))
        for s in STRIPES:
            data = torch.randint(0, 256, (s * k * 512,), dtype=torch.uint8,
                                 device="cuda", generator=g)
            want = gc.encode_plain(data, k, n)
            for f in gc.FORMULATIONS:
                frags = gc.encode(data, k, n, f)
                same(f"{f}_apply", frags, want, f"encode {k}+{r} S={s}")
                same(f"{f}_apply", gc.decode(frags[list(rows)].contiguous(),
                                             rows, k, f), data,
                     f"decode {k}+{r} S={s}")
    emit("plane-kernels-unaligned", ok=True, stripes=list(STRIPES),
         configs=[f"{k}+{r}" for k, r in CONFIGS],
         kernels=[f"{f}_apply" for f in gc.FORMULATIONS])
    timed = {}
    for k, r in CONFIGS:
        for matrix in ("encode", "decode"):
            res = check_plane(g, gc.FORMULATIONS, k, r, matrix, ops_s)
            for f, row in res.items():
                row["card"] = card
                emit("kernel", **row)
                if (k, r, matrix) == (4, 2, "encode"):
                    timed[row["name"]] = row
            torch.cuda.empty_cache()
    # every 4+2 decode mask on each plane-major kernel
    k, r = 4, 2
    masks = list(itertools.combinations(range(k + r), k))
    x = torch.randint(0, 256, (k * 8, PLANE_BYTES // (k * 8)),
                      dtype=torch.uint8, device="cuda", generator=g)
    for m in masks:
        abits = gc._bits("decode", k, (m,))
        want = {"mxu": gc.mxu_apply_plain(abits, x),
                "xor": gc.xor_apply_plain(abits, x)}
        for f in gc.FORMULATIONS:
            same(f"{f}_apply", gc._apply_cached(f, x, "decode", k, (m,)),
                 want["mxu" if f == "mxu" else "xor"],
                 f"4+2 decode rows={m}")
        del want
    emit("plane-4+2-masks", ok=True, masks=len(masks), plane_w=x.shape[1],
         kernels=[f"{f}_apply" for f in gc.FORMULATIONS])
    del x
    phase_mxu_odd(g)
    phase_xor_odd(g)
    torch.cuda.empty_cache()
    emit("plane-kernels", ok=True,
         kernels=[f"{f}_apply" for f in gc.FORMULATIONS], card=card)
    return timed


def phase_mxu_odd(g) -> None:
    """``mxu_apply`` against its plain version at shapes the codec's
    matrices do not reach: C of 1, 3, 5 and 16 fragments, R not a
    multiple of 16, one and twelve 8 KiB tiles, random bit-matrices; then
    on all-0xFF planes at C = 128, row sums each side of the powers of two
    where the kernel changes how it pairs bits (N ones in the even rows,
    N - 1 in the odd ones), and every sum at its largest (an all-ones
    matrix, sum 128)."""
    shapes = []
    for c, r, w in itertools.product(MXU_ODD_C, MXU_ODD_R, MXU_ODD_W):
        abits = torch.randint(0, 2, (r, c), dtype=torch.uint8, device="cuda",
                              generator=g).cpu().numpy()
        x = torch.randint(0, 256, (c, w), dtype=torch.uint8, device="cuda",
                          generator=g)
        same("mxu_apply", gc.apply_bitmatrix(abits, x, "mxu"),
             gc.mxu_apply_plain(abits, x), f"R={r} C={c} W={w}")
        shapes.append([r, c, w])
    x = torch.full((128, 3 * gc.TILE3_W), 0xFF, dtype=torch.uint8,
                   device="cuda")
    sums = [(n, n - 1) for n in MXU_SUMS] + [(128, 128)]  # last: all ones
    for even, odd in sums:
        abits = np.zeros((160, 128), dtype=np.uint8)
        abits[0::2, :even] = 1
        abits[1::2, :odd] = 1
        y = gc.apply_bitmatrix(abits, x, "mxu")
        same("mxu_apply", y, gc.mxu_apply_plain(abits, x),
             f"row sums {even} and {odd}, 0xFF planes")
        if (int(y[0, 0]), int(y[1, 0])) != (0xFF * (even % 2),
                                            0xFF * (odd % 2)):
            raise AssertionError(f"mxu_apply: wrong parity at row sums "
                                 f"{even} and {odd}")
    emit("mxu-odd-shapes", ok=True, shapes=shapes, row_sums=sums)


def xor_refusals() -> dict:
    """The raw C entry points of the XOR kernels, given a width or a
    plane count their tiling cannot cover (the card tests'
    XOR_REFUSALS): each must return cudaErrorInvalidValue (1) and launch
    nothing."""
    lib = gc.library()
    x = torch.zeros((129, 65536), dtype=torch.uint8, device="cuda")
    y = torch.zeros_like(x)
    masks = torch.zeros((129, 2), dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for f, w, c, r in XOR_REFUSALS:
        err = getattr(lib, f"gf256_{f}_apply")(
            x.data_ptr(), y.data_ptr(), masks.data_ptr(), w, c, r, 0, stream)
        if err != 1:
            raise AssertionError(f"{f}_apply took W={w} C={c} R={r} "
                                 f"(error {err}, not 1)")
        out.setdefault(f, []).append([w, c, r])
    torch.cuda.synchronize()
    if int(y.count_nonzero()):
        raise AssertionError("a refused XOR launch wrote its output")
    return out


def phase_xor_odd(g) -> None:
    """``xor_apply`` and ``xor3_apply`` against their plain version at the
    odd shapes of ``mxu_apply`` (one tile, and 13 x 32 KiB), then on the
    card tests' edge cases (XOR_EDGE_CASES), then their refusals."""
    shapes = []
    for c, r in itertools.product(MXU_ODD_C, MXU_ODD_R):
        abits = torch.randint(0, 2, (r, c), dtype=torch.uint8, device="cuda",
                              generator=g).cpu().numpy()
        for f, widths in XOR_WIDTHS.items():
            for w in widths:
                x = torch.randint(0, 256, (c, w), dtype=torch.uint8,
                                  device="cuda", generator=g)
                same(f"{f}_apply", gc.apply_bitmatrix(abits, x, f),
                     gc.xor_apply_plain(abits, x), f"R={r} C={c} W={w}")
                shapes.append([f, r, c, w])
    cases = []
    for name in XOR_EDGE_CASES:
        abits, x = xor_edge_case(name)
        x = torch.from_numpy(x).cuda()
        want = gc.xor_apply_plain(abits, x)
        for f in ("xor", "xor3"):
            same(f"{f}_apply", gc.apply_bitmatrix(abits, x, f), want, name)
        if name.startswith("ones") and (
                int(want[0, 0]), int(want[1, 0])) != (
                0, 0xFF if name == "ones-odd" else 0):
            raise AssertionError(f"xor plain version: wrong parity, {name}")
        cases.append([name, *abits.shape])
    emit("xor-odd-shapes", ok=True, shapes=shapes, cases=cases,
         refused=xor_refusals())


# -- phase 4: the plane-major entry points -----------------------------------


def phase_entry(card: str) -> dict:
    """4+2 encode then decode (fragments 0 and 3 lost) of a 256 MiB
    payload through each plane-major formulation, after one untimed
    round trip each (operand uploads, allocator growth); the launch
    counters are zeroed just before the timed pass and read just
    after."""
    k, n, rows = 4, 6, (1, 2, 4, 5)
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    data = torch.randint(0, 256, (256 * MiB,), dtype=torch.uint8,
                         device="cuda", generator=g)
    for f in gc.FORMULATIONS:
        gc.decode(gc.encode(data, k, n, f)[list(rows)].contiguous(), rows,
                  k, f)
    torch.cuda.synchronize()
    gc.reset_launches()
    rates = {}
    for f in gc.FORMULATIONS:
        t0 = time.perf_counter()
        frags = gc.encode(data, k, n, f)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = gc.decode(frags[list(rows)].contiguous(), rows, k, f)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not torch.equal(out, data):
            raise AssertionError(f"entry point {f}: round trip differs")
        rates[f] = {"encode_mib_s": 256 / (t1 - t0),
                    "decode_mib_s": 256 / (t2 - t1)}
        del frags, out
    launches = dict(gc.LAUNCHES)
    for f in gc.FORMULATIONS:
        if launches[f"{f}_apply"] < 1:
            raise AssertionError(f"{f}_apply was never launched")
    emit("entry-plane-major", ok=True, config="4+2", payload_bytes=256 * MiB,
         rows=list(rows), launches=launches, rates=rates, card=card)
    del data
    torch.cuda.empty_cache()
    return launches


# -- phases 5-7: served volumes ----------------------------------------------


def _payload(g, nbytes: int) -> bytes:
    return torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                         device=g.device, generator=g).cpu().numpy().tobytes()


async def _mount(base: Path, options: dict, fresh: bool, groups: int,
                 n: int, r: int):
    """Mount the volume of ``groups`` (n, r) disperse groups; returns the
    client and its disperse layers (one per group).  An option given as
    None keeps the volume's default."""
    from glusterfs_tpu_torch.api.glfs import Client
    from glusterfs_tpu_torch.core.graph import Graph
    from glusterfs_tpu_torch.utils.volspec import ec_volfile

    if fresh:
        shutil.rmtree(base, ignore_errors=True)
        base.mkdir(parents=True)
    options = {"cpu-extensions": "auto", "stripe-cache": "on",
               "stripe-cache-window": 2000, "stripe-cache-min-batch": 0,
               **options}
    c = Client(Graph.construct(ec_volfile(
        base, n, r, groups=groups,
        options={k: v for k, v in options.items() if v is not None})))
    await c.mount()
    top = c.graph.top
    return c, [top] if groups == 1 else list(top.children)


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


def _flush_log(ecs) -> list:
    """Log every async flush of the ``ecs`` codecs as (bytes, route,
    seconds): each codec's ``_observe``, which every flush calls once
    with its route and host-clock time, is wrapped on the instance."""
    log = []
    for ec in ecs:
        def logged(device, nbytes, secs, observe=ec.codec._observe):
            log.append((nbytes, "device" if device else "cpu", secs))
            observe(device, nbytes, secs)
        ec.codec._observe = logged
    return log


def _flush_split(log) -> dict:
    """Per route: flushes, bytes, summed seconds and flush sizes
    (bytes: count)."""
    out = {}
    for route in ("device", "cpu"):
        rows = [(b, t) for b, r, t in log if r == route]
        out[route] = {"flushes": len(rows), "bytes": sum(b for b, _ in rows),
                      "secs": sum(t for _, t in rows),
                      "sizes": dict(sorted(collections.Counter(
                          b for b, _ in rows).items()))}
    return out


async def _settled(ecs) -> None:
    """After an unmount, wait for a background calibration of the
    ``ecs`` codecs to end, so that none of its launches lands in a later
    phase's counts."""
    deadline = time.monotonic() + 60
    while any(ec.codec.dump_stats()["calibration"] == "running"
              for ec in ecs):
        if time.monotonic() > deadline:
            raise AssertionError("a calibration did not end")
        await asyncio.sleep(0.01)


def _since(before: dict) -> dict:
    return {n: gc.LAUNCHES[n] - before.get(n, 0) for n in gc.KERNELS}


async def _calibrate(ecs) -> list[dict]:
    """``ensure_calibrated()`` on each codec (raises if a calibration
    failed; it must reach "done"), then the calibration's kernel launches
    are taken back out of the counters: they are not the served path's.
    Returns each codec's fitted models."""
    kept = dict(gc.LAUNCHES)
    models = []
    for ec in ecs:
        st = None
        if await ec.codec.ensure_calibrated():
            st = ec.codec.dump_stats()
        if st is None or st["calibration"] != "done":
            raise AssertionError(f"{ec.name}: calibration did not finish: "
                                 f"{ec.codec.dump_stats()}")
        models.append({key: st[key] for key in (
            "device_model", "native_model", "break_even_bytes")})
    torch.cuda.synchronize()
    gc.LAUNCHES.update(kept)
    return models


async def _write_files(c, g) -> tuple[dict, float]:
    """64 concurrent 1 MiB files and a 1 GiB file in 64 MiB writes;
    returns the files and the write MiB/s."""
    files = {f"/f{i}": _payload(g, MiB) for i in range(SMALL_FILES)}
    big = _payload(g, BIG_BYTES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    await asyncio.gather(*(c.write_file(p, d) for p, d in files.items()))
    await _write_big(c, "/big", big, 64 * MiB)
    write = (SMALL_FILES * MiB + len(big)) / MiB / (time.perf_counter() - t0)
    files["/big"] = big
    return files, write


async def _overwrite(c, g, files: dict, ec) -> None:
    """An unaligned overwrite inside a healthy file of a systematic
    volume: it must take the parity delta."""
    patch = _payload(g, 3001)
    f = await c.open("/f5")
    await f.write(patch, 777)
    await f.close()
    b = bytearray(files["/f5"])
    b[777:777 + len(patch)] = patch
    files["/f5"] = bytes(b)
    if ec.write_path["delta"] < 1:
        raise AssertionError(f"no parity-delta write: {ec.write_path}")


async def _serve(base: Path, g, options: dict, down: tuple[int, ...],
                 groups: int = 1, n: int = 6, r: int = 2,
                 calibrate: bool = False) -> dict:
    """Write 64 concurrent 1 MiB files and a 1 GiB file in 64 MiB
    writes (on a systematic volume also an unaligned overwrite) to
    ``groups`` (n, r) disperse groups, read everything back; then spoil
    the ``down`` bricks (global indices: brick i is child i % n of group
    i // n), remount with them down and read everything again.  With
    ``calibrate``, each mount's codecs are calibrated before its timed
    window (:func:`_calibrate`).  Each window's flushes are reported per
    route (:func:`_flush_split`)."""
    backend = options.get("cpu-extensions", "auto").replace("auto", "cuda")
    c, ecs = await _mount(base, options, fresh=True, groups=groups, n=n,
                          r=r)
    try:
        models = await _calibrate(ecs) if calibrate else None
        log = _flush_log(ecs)
        at_start = dict(gc.LAUNCHES)
        files, write = await _write_files(c, g)
        if options.get("systematic") == "on":
            await _overwrite(c, g, files, ecs[0])
        on_write = _since(at_start)
        written = len(log)
        at_read = dict(gc.LAUNCHES)
        healthy = await _read_all(c, files)
        on_read = _since(at_read)
        flushes = {"write": _flush_split(log[:written]),
                   "healthy_read": _flush_split(log[written:])}
        stats = [ec.codec.dump_stats() for ec in ecs]
        write_path = [dict(ec.write_path) for ec in ecs]
    finally:
        await c.unmount()
    for st in stats:
        if not (st["launches"] + st["cpu_launches"] > 0
                and st["max_batch"] > 1):
            raise AssertionError(f"codec did not batch: {stats}")
        if st["min_batch_bytes"] == 0 and st["cpu_launches"]:
            raise AssertionError(f"a pinned codec took the CPU: {stats}")
        if st["backend"] != backend:
            raise AssertionError(f"volume codec is {st['backend']}, "
                                 f"not {backend}")
    # which group each small file landed on (its fragments on the
    # group's first brick)
    placed = [sum((base / f"brick{gi * n}" / f"f{i}").is_file()
                  for i in range(SMALL_FILES)) for gi in range(groups)]
    if groups > 1 and (min(placed) < 1 or sum(placed) != SMALL_FILES):
        raise AssertionError(f"small files per group: {placed}")
    _spoil(base, down)
    c, ecs = await _mount(base, options, fresh=False, groups=groups, n=n,
                          r=r)
    try:
        for i in down:
            ecs[i // n].set_child_up(i % n, False)
        degraded_models = await _calibrate(ecs) if calibrate else None
        log = _flush_log(ecs)
        at_degraded = dict(gc.LAUNCHES)
        degraded = await _read_all(c, files)
        on_degraded = _since(at_degraded)
        flushes["degraded_read"] = _flush_split(log)
        dstats = [ec.codec.dump_stats() for ec in ecs]
    finally:
        await c.unmount()
    return {"write_mib_s": write, "healthy_read_mib_s": healthy,
            "degraded_read_mib_s": degraded, "bricks_down": list(down),
            "config": f"{n - r}+{r}", "groups": groups,
            "small_files_per_group": placed,
            "write_path": write_path, "codec": stats,
            "degraded_codec": dstats, "launches_write": on_write,
            "launches_healthy_read": on_read,
            "launches_degraded_read": on_degraded, "flushes": flushes,
            **({"models": models, "degraded_models": degraded_models}
               if calibrate else {})}


async def served_plain(base: Path, g) -> dict:
    return await _serve(base, g, {}, down=(0, 3))


async def served_systematic(base: Path, g) -> dict:
    # a data brick and a parity brick down: reads reconstruct row 1
    return await _serve(base, g, {"systematic": "on"}, down=(1, 5))


async def served_dist_mma(base: Path, g) -> dict:
    """2x(4+2) on the tensor-core backend: every encode and decode of
    both groups goes through mxu_apply, on the write and on the read."""
    res = await _serve(base, g, {"cpu-extensions": "cuda-mma",
                                 "systematic": "off"},
                       down=(0, 3, 7, 10), groups=2)
    for phase in ("launches_write", "launches_healthy_read",
                  "launches_degraded_read"):
        if res[phase]["mxu_apply"] < 1:
            raise AssertionError(f"mxu_apply not launched on {phase}: "
                                 f"{res[phase]}")
    return res


async def served_8p4(base: Path, g) -> dict:
    """A non-systematic 8+4 volume (``BASELINE.json`` config 2): fused
    encode on the write, fused decode on the healthy read and, with
    bricks 0, 4, 8 and 11 down, on the degraded read."""
    res = await _serve(base, g, {"systematic": "off"}, down=(0, 4, 8, 11),
                       n=12, r=4)
    for name, phases in (("fused_encode", ("launches_write",)),
                         ("fused_decode", ("launches_healthy_read",
                                           "launches_degraded_read"))):
        for phase in phases:
            if res[phase][name] < 1:
                raise AssertionError(f"{name} not launched on {phase}: "
                                     f"{res[phase]}")
    return res


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(16 * MiB):
            h.update(chunk)
    return h.hexdigest()


def _wipe(base: Path, ec, i: int) -> None:
    """Replace brick i under the live volume: ``rmtree`` it, recreate
    the sidecar skeleton a respawned brick would make, and have the live
    brick layer drop its cached state (tests/test_index_shd.py)."""
    shutil.rmtree(base / f"brick{i}")
    for sub in ("gfid", "xattr", "handle", os.path.join("indices",
                                                         "xattrop")):
        os.makedirs(base / f"brick{i}" / ".glusterfs_tpu" / sub)
    ec.children[i].drop_caches()


async def _ec_xattrs(ec, i: int, path: str) -> tuple:
    xa = await ec.children[i].getxattr(Loc(path), None)
    return tuple(bytes(xa[name]) for name in ("trusted.ec.version",
                                              "trusted.ec.size"))


async def _heal_volume(base: Path, g, systematic: str,
                       wiped: tuple[int, ...],
                       down: tuple[int, ...]) -> dict:
    """Write the served traffic to a 4+2 volume, keep a SHA-256 of the
    ``wiped`` bricks' fragment files, remount, wipe those bricks under
    the live volume and heal every file (the small ones concurrently,
    the big one alone).  Then every healed fragment file must hash as
    before, carry the good bricks' version and size, ``heal_info`` must
    report no bad brick, and with the ``down`` bricks spoiled and down
    every file must read back exactly.  The volume keeps every default
    option (``stripe-cache-min-batch`` 256KB) and no calibration is
    forced: the path a volume takes as created."""
    options = {"systematic": systematic, "stripe-cache-min-batch": None}
    c, ecs = await _mount(base, options, fresh=True, groups=1, n=6, r=2)
    try:
        files, write = await _write_files(c, g)
    finally:
        await c.unmount()
    await _settled(ecs)
    names = [p.lstrip("/") for p in files]
    before = {(i, nm): _sha256(base / f"brick{i}" / nm)
              for i in wiped for nm in names}
    c, (ec,) = await _mount(base, options, fresh=False, groups=1, n=6, r=2)
    try:
        for i in wiped:
            _wipe(base, ec, i)
        infos = await asyncio.gather(*(ec.heal_info(Loc(p)) for p in files))
        for p, info in zip(files, infos):
            if sorted(info["bad"]) != sorted(wiped):
                raise AssertionError(f"{p}: heal_info before the heal: "
                                     f"{info}")
        small = [p for p in files if p != "/big"]
        log = _flush_log([ec])
        torch.cuda.synchronize()
        at_heal = dict(gc.LAUNCHES)
        t0 = time.perf_counter()
        res = await asyncio.gather(*(ec.heal_file(p) for p in small))
        res.append(await ec.heal_file("/big"))
        torch.cuda.synchronize()
        heal_s = time.perf_counter() - t0
        on_heal = _since(at_heal)
        heal_flushes = _flush_split(log)
        for p, rr in zip(small + ["/big"], res):
            if sorted(rr["healed"]) != sorted(wiped) or not rr["stable"]:
                raise AssertionError(f"{p}: heal_file {rr}")
        for p in files:
            bad = (await ec.heal_info(Loc(p)))["bad"]
            if bad:
                raise AssertionError(f"{p}: still bad after heal: {bad}")
            good = [i for i in range(6) if i not in wiped]
            want = await _ec_xattrs(ec, good[0], p)
            for i in wiped:
                if await _ec_xattrs(ec, i, p) != want:
                    raise AssertionError(f"{p}: brick {i}'s version or size "
                                         "differs from the good bricks'")
        stats = ec.codec.dump_stats()
    finally:
        await c.unmount()
    await _settled([ec])
    if stats["min_batch_bytes"] != 256 * 1024:
        raise AssertionError(f"not the default min-batch: {stats}")
    after = {(i, nm): _sha256(base / f"brick{i}" / nm)
             for i in wiped for nm in names}
    if after != before:
        raise AssertionError("healed fragments differ from before the wipe: "
                             f"{[k for k in before if after[k] != before[k]]}")
    _spoil(base, down)
    c, (ec,) = await _mount(base, options, fresh=False, groups=1, n=6, r=2)
    try:
        for i in down:
            ec.set_child_up(i, False)
        degraded = await _read_all(c, files)
    finally:
        await c.unmount()
    await _settled([ec])
    healed_mib = sum(map(len, files.values())) / MiB
    return {"systematic": systematic, "bricks_wiped": list(wiped),
            "bricks_down_after": list(down), "files": len(files),
            "healed_mib": healed_mib, "heal_s": heal_s,
            "heal_mib_s": healed_mib / heal_s, "write_mib_s": write,
            "degraded_read_mib_s": degraded, "launches_heal": on_heal,
            "heal_flushes": heal_flushes, "fragments_hashed": len(before),
            "codec": stats}


async def served_heal(base: Path, g) -> dict:
    """Self-heal after a brick replacement (``BASELINE.json`` config 4,
    tests/basic/ec/ec-heal.t): a plain 4+2 volume (bricks 0 and 3 wiped;
    heal decodes then encodes) and a systematic one (bricks 1 and 5; heal
    reconstructs the lost data row, then computes parity), each at the
    volume's default options: the heal must launch the kernels without a
    forced calibration."""
    plain = await _heal_volume(base / "plain", g, "off", (0, 3), (1, 4))
    syst = await _heal_volume(base / "systematic", g, "on", (1, 5), (0, 4))
    for vol, names in ((plain, ("fused_decode", "fused_encode")),
                       (syst, ("fused_reconstruct", "fused_parity"))):
        for name in names:
            if vol["launches_heal"][name] < 1:
                raise AssertionError(f"{name} not launched by the "
                                     f"{vol['systematic']} heal: "
                                     f"{vol['launches_heal']}")
    return {"config": "4+2", "plain": plain, "systematic_vol": syst}


async def served_ladder(base: Path, g) -> dict:
    """The served traffic on a 4+2 volume with the default
    ``stripe-cache-min-batch`` (256KB): each flush takes the card or the
    native codec by the calibrated models.  The route split is reported,
    not asserted."""
    res = await _serve(base, g, {"systematic": "off",
                                 "stripe-cache-min-batch": None},
                       down=(0, 3), calibrate=True)
    if res["codec"][0]["min_batch_bytes"] != 256 * 1024:
        raise AssertionError(f"not the default min-batch: {res['codec']}")
    res["routes"] = {
        "write_and_healthy_read": {k: res["codec"][0][k] for k in (
            "launches", "cpu_launches", "batched_fops")},
        "degraded_read": {k: res["degraded_codec"][0][k] for k in (
            "launches", "cpu_launches", "batched_fops")}}
    return res


class _BrickDaemons:
    """The port's brick daemons, ``python -m glusterfs_tpu_torch.daemon``
    with the default brick stack, one process each with no card
    (``CUDA_VISIBLE_DEVICES=""``), as tests/harness.py starts the JAX
    package's.  Reaped by recorded PID, never by a name pattern."""

    def __init__(self, base: Path, n: int):
        from glusterfs_tpu_torch.utils.volspec import brick_volfile

        self.base, self.n = base, n
        self.procs: list[subprocess.Popen] = []
        self.ports: list[int] = []
        for i in range(n):
            (base / f"brick{i}.vol").write_text(
                brick_volfile(f"v-brick-{i}", base / f"brick{i}"))

    def start(self, timeout: float = 120.0) -> list[int]:
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=str(ROOT))
        for i in range(self.n):
            (self.base / f"brick{i}.port").unlink(missing_ok=True)
            with open(self.base / f"brick{i}.log", "wb") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "glusterfs_tpu_torch.daemon",
                     "--volfile", str(self.base / f"brick{i}.vol"),
                     "--listen", "0",
                     "--portfile", str(self.base / f"brick{i}.port")],
                    cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                    stderr=log))
        deadline = time.monotonic() + timeout
        for i, proc in enumerate(self.procs):
            portfile = self.base / f"brick{i}.port"
            while not portfile.exists():
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(
                        f"brick daemon {i} did not start: " +
                        (self.base / f"brick{i}.log").read_text()[-2000:])
                time.sleep(0.02)
            self.ports.append(int(portfile.read_text()))
        return self.ports

    def kill(self, i: int) -> None:
        os.kill(self.procs[i].pid, signal.SIGKILL)
        self.procs[i].wait()

    def stop(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in self.procs:
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


async def _mount_wire(ports: list[int], options: dict):
    """Mount a 4+2 client over served bricks, as ``_mount`` does over
    local ones, and wait for every brick's handshake."""
    from glusterfs_tpu_torch.api.glfs import Client, wait_connected
    from glusterfs_tpu_torch.core.graph import Graph
    from glusterfs_tpu_torch.utils.volspec import client_volfile

    c = Client(Graph.construct(client_volfile("v", ports, 2, {
        "cpu-extensions": "auto", "stripe-cache": "on",
        "stripe-cache-window": 2000, "stripe-cache-min-batch": 0,
        **options})))
    await c.mount()
    if not await wait_connected(c.graph, timeout=60):
        raise AssertionError("a brick daemon did not answer the handshake")
    return c, c.graph.top


def _wire_counters(ec) -> dict:
    """The client's RPC round trips, wire bytes and shm lane bytes."""
    from glusterfs_tpu_torch.rpc import shm

    return {"rpc_roundtrips": sum(ch.rpc_roundtrips for ch in ec.children),
            "bytes_tx": sum(ch.bytes_tx for ch in ec.children),
            "bytes_rx": sum(ch.bytes_rx for ch in ec.children),
            "shm_tx_bytes": shm.shm_stats["tx_bytes"],
            "shm_rx_bytes": shm.shm_stats["rx_bytes"],
            "shm_fallbacks": sum(shm.fallback_stats.values())}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


async def _serve_wire(base: Path, g, systematic: str,
                      down: tuple[int, int]) -> dict:
    """The served traffic on a 4+2 volume whose six bricks are daemon
    processes: write, read back; spoil the ``down`` bricks' fragments,
    remount, SIGKILL those two daemons, wait until the EC layer has
    seen each as CHILD_DOWN (the transport's EOF, not a timer), read
    everything again.  Reports each window's rates, launches, flushes,
    RPC round trips and shm lane bytes."""
    from glusterfs_tpu_torch.rpc import shm

    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    bricks = _BrickDaemons(base, 6)
    fallbacks0 = dict(shm.fallback_stats)
    try:
        ports = bricks.start()
        options = {"systematic": systematic}
        c, ec = await _mount_wire(ports, options)
        try:
            shm_armed = [ch._peer_shm for ch in ec.children]
            log = _flush_log([ec])
            at_start, wire0 = dict(gc.LAUNCHES), _wire_counters(ec)
            files, write = await _write_files(c, g)
            if systematic == "on":
                await _overwrite(c, g, files, ec)
            on_write = _since(at_start)
            wire_write = _delta(_wire_counters(ec), wire0)
            written = len(log)
            at_read, wire0 = dict(gc.LAUNCHES), _wire_counters(ec)
            healthy = await _read_all(c, files)
            on_read = _since(at_read)
            wire_read = _delta(_wire_counters(ec), wire0)
            flushes = {"write": _flush_split(log[:written]),
                       "healthy_read": _flush_split(log[written:])}
            stats = ec.codec.dump_stats()
            write_path = dict(ec.write_path)
        finally:
            t0 = time.perf_counter()
            await c.unmount()
            unmount_s = [time.perf_counter() - t0]
        _spoil(base, down)
        c, ec = await _mount_wire(ports, options)
        try:
            for i in down:
                bricks.kill(i)
            deadline = time.monotonic() + 30
            while any(ec.up[i] for i in down):
                if time.monotonic() > deadline:
                    raise AssertionError(f"killed bricks still up: {ec.up}")
                await asyncio.sleep(0.01)
            log = _flush_log([ec])
            at_degraded, wire0 = dict(gc.LAUNCHES), _wire_counters(ec)
            degraded = await _read_all(c, files)
            on_degraded = _since(at_degraded)
            wire_degraded = _delta(_wire_counters(ec), wire0)
            flushes["degraded_read"] = _flush_split(log)
            dstats = ec.codec.dump_stats()
        finally:
            t0 = time.perf_counter()
            await c.unmount()
            unmount_s.append(time.perf_counter() - t0)
    finally:
        bricks.stop()
    if not (stats["launches"] > 0 and stats["max_batch"] > 1) or \
            stats["cpu_launches"] or stats["backend"] != "cuda":
        raise AssertionError(f"codec did not batch on the card: {stats}")
    return {"systematic": systematic, "bricks_killed": list(down),
            "brick_pids": [p.pid for p in bricks.procs],
            "write_mib_s": write, "healthy_read_mib_s": healthy,
            "degraded_read_mib_s": degraded, "shm_armed": shm_armed,
            "shm_fallbacks": {k: v - fallbacks0.get(k, 0)
                              for k, v in shm.fallback_stats.items()},
            "wire_write": wire_write, "wire_healthy_read": wire_read,
            "wire_degraded_read": wire_degraded, "write_path": write_path,
            "codec": stats, "degraded_codec": dstats,
            "launches_write": on_write, "launches_healthy_read": on_read,
            "launches_degraded_read": on_degraded, "flushes": flushes,
            "unmount_s": unmount_s}


async def served_wire(base: Path, g) -> dict:
    """``served-4+2-wire``: the served traffic on a plain and a
    systematic 4+2 volume whose bricks are the port's daemons over TCP
    (``BASELINE.json`` configs 1 and 3, not cut), two daemons SIGKILLed
    per volume: bricks 0 and 3 of the plain one (fused encode, decode),
    1 and 5 of the systematic one (fused parity, also through the
    ``xorv`` overwrite, and reconstruct)."""
    plain = await _serve_wire(base / "plain", g, "off", (0, 3))
    shutil.rmtree(base / "plain", ignore_errors=True)
    syst = await _serve_wire(base / "systematic", g, "on", (1, 5))
    for vol, checks in (
            (plain, (("fused_encode", "launches_write"),
                     ("fused_decode", "launches_healthy_read"),
                     ("fused_decode", "launches_degraded_read"))),
            (syst, (("fused_parity", "launches_write"),
                    ("fused_reconstruct", "launches_degraded_read")))):
        for name, window in checks:
            if vol[window][name] < 1:
                raise AssertionError(
                    f"{name} not launched over the wire on {window} "
                    f"(systematic {vol['systematic']}): {vol[window]}")
    if syst["write_path"]["delta"] < 1:
        raise AssertionError(f"no xorv over the wire: {syst['write_path']}")
    return {"config": "4+2", "plain": plain, "systematic_vol": syst}


def _host_cpu() -> dict:
    """The first processor's identity in /proc/cpuinfo (where a kernel
    leaves the model name out, vendor, family and model stand in),
    whether it has avx2, and the CPU count."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, val = line.partition(":")
            if not key.strip():
                break  # the first processor only
            info.setdefault(key.strip(), val.strip())
    return {**{k: info.get(k) for k in ("model name", "vendor_id",
                                         "cpu family", "model", "cpu MHz")},
            "avx2": "avx2" in info.get("flags", "").split(),
            "cpus": os.cpu_count()}


def phase_native_vs_card(card: str) -> dict:
    """4+2 encode and decode (fragments 0 and 3 lost) of 1 MiB and
    64 MiB through ``Codec(4, 2, "native")`` and ``Codec(4, 2, "cuda")``:
    the host clock around each call, copies to and from the card
    included; the median of several calls after one untimed call.  The
    ratio is the card's rate over the native codec's."""
    from glusterfs_tpu_torch.ops.codec import Codec

    rows = (1, 2, 4, 5)
    codecs = {b: Codec(4, 2, b) for b in ("native", "cuda")}
    rng = np.random.default_rng(4)
    out = {}
    for size, reps in ((MiB, 21), (64 * MiB, 5)):
        data = rng.integers(0, 256, size, dtype=np.uint8)
        frags = codecs["native"].encode(data)
        sub = np.ascontiguousarray(frags[list(rows)])
        row = {}
        for b, codec in codecs.items():
            if not np.array_equal(codec.encode(data), frags) or \
                    not np.array_equal(codec.decode(sub, rows), data):
                raise AssertionError(f"{b} codec disagrees at {size} bytes")
            for op, fn in (("encode", lambda c=codec: c.encode(data)),
                           ("decode", lambda c=codec: c.decode(sub, rows))):
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    fn()
                    times.append(time.perf_counter() - t0)
                s = float(np.median(times))
                row[f"{b}_{op}_s"] = s
                row[f"{b}_{op}_mib_s"] = size / MiB / s
        for op in ("encode", "decode"):
            row[f"{op}_card_over_native"] = \
                row[f"cuda_{op}_mib_s"] / row[f"native_{op}_mib_s"]
        out[f"{size // MiB}MiB"] = row
    emit("native-vs-card", ok=True, config="4+2", rows=list(rows),
         host_cpu=_host_cpu(), card=card, sizes=out)
    return out


def _device_share(prof, wall_s: float) -> dict:
    """Device time of a profiled phase by kind, and the idle share of
    its wall time (kernels and copies of one stream do not overlap, so
    their sum is the busy time).  Codec kernels are the port's own
    (``CODEC_SYMBOLS``); the mma sandwich's transposes and fills count
    as other."""
    ms = {"codec_kernels": 0.0, "copies": 0.0, "other": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if not us:
            continue
        kind = "codec_kernels" if any(s in e.key for s in CODEC_SYMBOLS) \
            else "copies" if "memcpy" in e.key.lower() else "other"
        ms[kind] += us / 1e3
    busy = sum(ms.values())
    return {"wall_s": wall_s, "device_ms": ms,
            "idle_share": 1 - busy / 1e3 / wall_s if busy else None}


def _cprofile_top(prof, n: int = 25) -> dict:
    """The ``n`` functions with the most cumulative time, and the ``n``
    with the most time of their own, in a cProfile of the client process
    (from Python 3.12 it also sees the threads the profiled one starts:
    the batchers' flush pools, the event pool, the default executor, so
    cumulative times of different threads overlap)."""
    import pstats

    st = pstats.Stats(prof)
    out = {}
    for key, order in (("by_cumulative", "cumulative"),
                       ("by_self", "tottime")):
        rows = []
        for func in st.sort_stats(order).fcn_list[:n]:
            _, nc, tt, ct, _ = st.stats[func]
            path, line, fn = func
            if path.startswith(str(ROOT)):
                path = os.path.relpath(path, ROOT)
            rows.append({"function": f"{path}:{line}({fn})", "ncalls": nc,
                         "tottime_s": tt, "cumtime_s": ct})
        out[key] = rows
    return out


def served(name: str, coro_fn, base: Path, g, card: str,
           profile: bool = False, cprofile: bool = False) -> dict:
    """Drive one served path with the launch counters zeroed just before
    and read just after (under the profiler with ``profile``; with
    ``cprofile`` also under cProfile, whose top 25 functions by
    cumulative and by own time are printed on a line of their own)."""
    import cProfile

    py_prof = cProfile.Profile() if cprofile else None

    def drive():
        if py_prof is None:
            return asyncio.run(coro_fn(base, g))
        return py_prof.runcall(asyncio.run, coro_fn(base, g))

    gc.reset_launches()
    t0 = time.perf_counter()
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = drive()
            torch.cuda.synchronize()
        res["profile"] = _device_share(prof, time.perf_counter() - t0)
    else:
        res = drive()
        torch.cuda.synchronize()
    launches = dict(gc.LAUNCHES)
    emit(name, ok=True, launches=launches, card=card,
         wall_s=time.perf_counter() - t0, **res)
    if py_prof is not None:
        emit("cprofile", of=name, **_cprofile_top(py_prof))
    return launches, res


def ladder_ab(card: str) -> int:
    """``--ladder-ab``: ``served-4+2`` (every flush pinned to the card)
    and ``served-4+2-ladder`` in the order pinned, ladder, ladder,
    pinned, in one process: the ladder's rates against the card alone's,
    each at both ends of the run.  Prints a summary line and no kernel
    checks."""
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    base = ROOT / "_smoke_bricks"
    runs = []
    try:
        for name, fn in (("served-4+2", served_plain),
                         ("served-4+2-ladder", served_ladder),
                         ("served-4+2-ladder", served_ladder),
                         ("served-4+2", served_plain)):
            _, res = served(name, fn, base / "ab", g, card)
            runs.append({"phase": name, **{k: res[k] for k in (
                "write_mib_s", "healthy_read_mib_s", "degraded_read_mib_s")}})
    finally:
        shutil.rmtree(base, ignore_errors=True)
    emit("ladder-ab", ok=True, card=card, runs=runs)
    return 0


def main() -> int:
    profile = "--profile" in sys.argv[1:]
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this run needs one card",
              file=sys.stderr)
        return 1
    card = nvidia_smi()
    t0 = time.perf_counter()
    gc.library()
    lib = gc.build()
    emit("build", ok=True, card=card, build_s=time.perf_counter() - t0,
         torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         mxu_resources=resources(lib, r"mxu_applyILi(\d)ELi(\d)E",
                                 "KS={},MB={}"),
         xor_resources=resources(lib, r"layout_xorILi(\d+)E", "RB={}"),
         xor_blocks_per_sm={r: gc.xor_blocks_per_sm(r)
                            for r in (8, 32, 48, 64, 96, 128, 160)})
    if "--ladder-ab" in sys.argv[1:]:
        return ladder_ab(card)
    ops_s = peak_ops_s()
    timed = phase_kernels(card, ops_s)
    timed.update(phase_plane_kernels(card, ops_s))
    entry = phase_entry(card)

    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    base = ROOT / "_smoke_bricks"
    try:
        plain, _ = served("served-4+2", served_plain, base / "plain", g,
                          card, profile, cprofile=profile)
        syst, _ = served("served-4+2-systematic", served_systematic,
                         base / "systematic", g, card, profile)
        mma, _ = served("served-2x(4+2)-mma", served_dist_mma, base / "dist",
                        g, card, profile)
        wide, _ = served("served-8+4", served_8p4, base / "wide", g, card,
                         profile)
        shutil.rmtree(base, ignore_errors=True)
        _, heal = served("served-4+2-heal", served_heal, base / "heal", g,
                         card, profile)
        shutil.rmtree(base, ignore_errors=True)
        ladder, _ = served("served-4+2-ladder", served_ladder,
                           base / "ladder", g, card, profile)
        shutil.rmtree(base, ignore_errors=True)
        wire, _ = served("served-4+2-wire", served_wire, base / "wire", g,
                         card, profile, cprofile=profile)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    phase_native_vs_card(card)
    healed = {name: heal["plain"]["launches_heal"][name]
              + heal["systematic_vol"]["launches_heal"][name]
              for name in gc.FUSED}
    path = {"fused_encode": ("served-4+2", plain),
            "fused_decode": ("served-4+2", plain),
            "fused_parity": ("served-4+2-systematic", syst),
            "fused_reconstruct": ("served-4+2-systematic", syst),
            "xor_apply": ("entry-plane-major", entry),
            "xor3_apply": ("entry-plane-major", entry),
            "mxu_apply": ("served-2x(4+2)-mma", mma)}
    kernels = []
    for name in gc.KERNELS:
        phase, counts = path[name]
        if counts[name] < 1:
            raise AssertionError(f"{name} was never launched on {phase}")
        t = timed[name]
        shape = "4+2, 256 MiB of stripes" if name in gc.FUSED else \
            "4+2 encode matrix, 256 MiB of plane data"
        row = {"name": name, "route": "cuda",
               "source": "glusterfs_tpu_torch/csrc/gf256_kernels.cu",
               "replaces": REPLACES[name], "launches": counts[name],
               "max_abs_err": t["max_abs_err"], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"],
               "copy_ms": t["copy_ms"], "path": phase, "shape": shape}
        if name in gc.FUSED:  # launches on each served path
            row["launches_by_path"] = {"served-4+2": plain[name],
                                       "served-4+2-systematic": syst[name],
                                       "served-8+4": wide[name],
                                       "served-4+2-heal": healed[name],
                                       "served-4+2-ladder": ladder[name],
                                       "served-4+2-wire": wire[name]}
        if name == "mxu_apply":
            row["product_ms"] = t["product_ms"]
            row["product_w"] = t["product_w"]
        elif "blocks_per_sm" in t:
            row["blocks_per_sm"] = t["blocks_per_sm"]
        kernels.append(row)
    emit("done", ok=True, total_s=time.perf_counter() - started)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
