"""EC self-heal in the port (``heal_info`` and ``heal_file`` of
glusterfs_tpu_torch.cluster.ec) against the JAX package's heal of the
same bricks.

A volume is written with the port and its brick tree copied twice
(``snapshot_copy`` + ``rebuild_identity``, the store-level copy).  The
same bricks are wiped in both copies, the way tests/test_index_shd.py
wipes one (``rmtree``, the sidecar skeleton recreated, the live brick
layer's ``drop_caches()``), then one copy is healed by the port
(``cpu-extensions torch``, ``torch-mma`` or ``native``) and the other by
the JAX package (``cpu-extensions ref``).  Every fragment file and every
``trusted.ec.{version,size,dirty}`` of every brick must be equal between
the two and equal to the bricks before the wipe, ``heal_info`` must then
report no bad brick, and the healed bricks must serve reads with other
bricks down.  Cases: 4+2 with ``systematic`` off and on, 1 and 2 bricks
wiped; 8+4 with 4 wiped; and the stale-brick case of
tests/test_systematic.py (a brick down during an overwrite, back up,
healed).  Tolerance: exact byte equality."""

import asyncio
import os
import shutil

import numpy as np
import pytest

from glusterfs_tpu.api.glfs import Client as JaxClient
from glusterfs_tpu.core.graph import Graph as JaxGraph
from glusterfs_tpu.core.layer import Loc as JaxLoc
from glusterfs_tpu.ops import gf256 as jgf
from glusterfs_tpu.utils.volspec import ec_volfile as jax_volfile
from glusterfs_tpu_torch.api.glfs import Client
from glusterfs_tpu_torch.core.graph import Graph
from glusterfs_tpu_torch.core.layer import Loc
from glusterfs_tpu_torch.ops import gf256_cuda
from glusterfs_tpu_torch.storage.posix import rebuild_identity, snapshot_copy
from glusterfs_tpu_torch.utils.volspec import ec_volfile

EC_XATTRS = ("trusted.ec.version", "trusted.ec.size", "trusted.ec.dirty")
WINDOW = "8KB"  # several heal windows per file at these sizes


def _rand(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _files(k):
    stripe = k * 512
    return {f"/f{i}": _rand(size, seed=100 + i) for i, size in enumerate(
        [1, 511, stripe + 1, 3 * stripe + 100, 40 << 10])}


def _options(backend, systematic):
    opts = {"cpu-extensions": backend, "systematic": systematic,
            "self-heal-window-size": WINDOW}
    if backend.startswith("torch"):
        # pin every flush to the kernels' plain versions (the native
        # route is the backend="native" case)
        opts["stripe-cache-min-batch"] = 0
    return opts


class _Pkg:
    """One package's client, graph, Loc and volfile builder."""

    def __init__(self, client, graph, loc, volfile):
        self.client, self.graph, self.loc, self.volfile = \
            client, graph, loc, volfile


PORT = _Pkg(Client, Graph, Loc, ec_volfile)
JAX = _Pkg(JaxClient, JaxGraph, JaxLoc, jax_volfile)


async def _mount(pkg, base, n, r, options):
    c = pkg.client(pkg.graph.construct(pkg.volfile(base, n, r,
                                                   options=options)))
    await c.mount()
    return c, c.graph.top


def _wipe(base, brick_layer, i):
    """rmtree the brick and recreate its sidecar skeleton (a respawned
    replacement brick); the live layer forgets its cached state."""
    shutil.rmtree(base / f"brick{i}")
    for sub in ("gfid", "xattr", "handle",
                os.path.join("indices", "xattrop")):
        os.makedirs(base / f"brick{i}" / ".glusterfs_tpu" / sub)
    brick_layer.drop_caches()


async def _xattrs(pkg, ec, paths):
    out = {}
    for i, child in enumerate(ec.children):
        for p in paths:
            xa = await child.getxattr(pkg.loc(p), None)
            out[(i, p)] = {name: bytes(xa[name]) for name in EC_XATTRS
                           if name in xa}
    return out


def _fragments(base, n, paths):
    return {(i, p): (base / f"brick{i}" / p.lstrip("/")).read_bytes()
            for i in range(n) for p in paths}


async def _state(pkg, base, n, r, options, paths):
    """Fragment files and EC xattrs of every brick, through a fresh
    mount (its reads change nothing on the bricks)."""
    c, ec = await _mount(pkg, base, n, r, options)
    try:
        xa = await _xattrs(pkg, ec, paths)
    finally:
        await c.unmount()
    return _fragments(base, n, paths), xa


async def _heal(pkg, base, n, r, options, wiped, paths):
    """Mount, wipe ``wiped`` under the live layer, heal every file;
    returns per-file heal_info after the heal."""
    c, ec = await _mount(pkg, base, n, r, options)
    try:
        for i in wiped:
            _wipe(base, ec.children[i], i)
        for p in paths:
            info = await ec.heal_info(pkg.loc(p))
            assert set(info["bad"]) == set(wiped), (p, info)
            res = await ec.heal_file(p)
            assert sorted(res["healed"]) == sorted(wiped), (p, res)
            assert res["stable"]
        return {p: (await ec.heal_info(pkg.loc(p)))["bad"] for p in paths}
    finally:
        await c.unmount()


async def _read_degraded(pkg, base, n, r, options, down, files):
    c, ec = await _mount(pkg, base, n, r, options)
    try:
        for i in down:
            ec.set_child_up(i, False)
        return {p: await c.read_file(p) for p in files}
    finally:
        await c.unmount()


def _spoil(base, bricks, paths):
    for i in bricks:
        for p in paths:
            f = base / f"brick{i}" / p.lstrip("/")
            f.write_bytes(bytes(b ^ 0xFF for b in f.read_bytes()))


def _copy(src, dst, n):
    for i in range(n):
        snapshot_copy(str(src / f"brick{i}"), str(dst / f"brick{i}"))
        rebuild_identity(str(dst / f"brick{i}"))


# (k, r, systematic, wiped bricks, other bricks spoiled and down after)
CASES = [(4, 2, "off", (1,), (0, 4)), (4, 2, "off", (0, 3), (1, 5)),
         (4, 2, "on", (2,), (1, 5)), (4, 2, "on", (1, 5), (0, 4)),
         (8, 4, "off", (0, 4, 8, 11), (1, 2, 6, 9))]


def _case_id(case):
    k, r, sysm, wiped, _ = case
    return f"{k}+{r}-sys{sysm}-wipe{''.join(map(str, wiped))}"


@pytest.mark.parametrize("backend", ["torch", "torch-mma", "native"])
@pytest.mark.parametrize("k,r,systematic,wiped,down", CASES, ids=map(
    _case_id, CASES))
def test_heal_matches_jax_heal(tmp_path, k, r, systematic, wiped, down,
                               backend):
    n = k + r
    files = _files(k)
    paths = list(files)
    popts = _options(backend, systematic)
    jopts = _options("ref", systematic)
    orig, pdir, jdir = tmp_path / "orig", tmp_path / "port", tmp_path / "jax"

    async def run():
        c, _ = await _mount(PORT, orig, n, r, popts)
        try:
            await asyncio.gather(*(c.write_file(p, d)
                                   for p, d in files.items()))
        finally:
            await c.unmount()
        before = await _state(PORT, orig, n, r, popts, paths)
        _copy(orig, pdir, n)
        _copy(orig, jdir, n)
        gf256_cuda.reset_launches()
        port_after = await _heal(PORT, pdir, n, r, popts, wiped, paths)
        jax_after = await _heal(JAX, jdir, n, r, jopts, wiped, paths)
        healed_port = await _state(PORT, pdir, n, r, popts, paths)
        healed_jax = await _state(JAX, jdir, n, r, jopts, paths)
        _spoil(pdir, down, paths)
        reads = await _read_degraded(PORT, pdir, n, r, popts, down, files)
        return before, port_after, jax_after, healed_port, healed_jax, reads

    before, port_after, jax_after, healed_port, healed_jax, reads = \
        asyncio.run(run())
    assert all(bad == [] for bad in port_after.values()), port_after
    assert all(bad == [] for bad in jax_after.values()), jax_after
    frag_p, xa_p = healed_port
    frag_j, xa_j = healed_jax
    assert frag_p == frag_j, "port heal and JAX heal left different bytes"
    assert frag_p == before[0], "healed fragments differ from before the wipe"
    assert xa_p == xa_j
    assert xa_p == before[1]
    assert all(len(v) == len(EC_XATTRS) for v in xa_p.values())
    assert reads == files, "healed bricks do not serve"
    assert sum(gf256_cuda.LAUNCHES.values()) == 0  # the CPU ran it all


def test_default_options_heal_matches_jax_heal(tmp_path):
    """At the volume's default ``stripe-cache-min-batch`` (256KB) and
    heal window (1 MiB), with no calibration forced, a heal's flushes at
    or above the floor take the kernels' path (their plain versions
    here) and those below it the native codec; the healed bricks equal
    the JAX package's heal of the same bricks and the bricks before the
    wipe."""
    k, r, wiped = 4, 2, (0, 3)
    n = k + r
    # /a heals in a 1 MiB and a 512 KiB window, /b in one past the floor,
    # /c in one below it
    files = {"/a": _rand(3 << 19, seed=31), "/b": _rand(300 << 10, seed=32),
             "/c": _rand(40 << 10, seed=33)}
    paths = list(files)
    popts = {"cpu-extensions": "torch", "systematic": "off"}
    jopts = {"cpu-extensions": "ref", "systematic": "off"}
    orig, pdir, jdir = tmp_path / "orig", tmp_path / "port", tmp_path / "jax"

    async def run():
        c, _ = await _mount(PORT, orig, n, r, popts)
        try:
            await asyncio.gather(*(c.write_file(p, d)
                                   for p, d in files.items()))
        finally:
            await c.unmount()
        before = await _state(PORT, orig, n, r, popts, paths)
        _copy(orig, pdir, n)
        _copy(orig, jdir, n)
        c, ec = await _mount(PORT, pdir, n, r, popts)
        try:
            for i in wiped:
                _wipe(pdir, ec.children[i], i)
            for p in paths:
                res = await ec.heal_file(p)
                assert sorted(res["healed"]) == sorted(wiped), (p, res)
            stats = ec.codec.dump_stats()
        finally:
            await c.unmount()
        jax_after = await _heal(JAX, jdir, n, r, jopts, wiped, paths)
        return (before, stats, jax_after,
                await _state(PORT, pdir, n, r, popts, paths),
                await _state(JAX, jdir, n, r, jopts, paths))

    before, stats, jax_after, healed_port, healed_jax = asyncio.run(run())
    assert stats["min_batch_bytes"] == 256 * 1024
    assert stats["launches"] >= 1, f"no heal flush took the card: {stats}"
    assert stats["cpu_launches"] >= 1, stats
    assert all(bad == [] for bad in jax_after.values()), jax_after
    assert healed_port == healed_jax
    assert healed_port == before


@pytest.mark.parametrize("systematic", ["off", "on"])
def test_stale_brick_heal_matches_jax(tmp_path, systematic):
    """tests/test_systematic.py's case: a brick down during an
    overwrite, back up, healed — by the port on one copy and by the JAX
    package on the other; both equal the oracle's fragments of the new
    content."""
    k, r = 4, 2
    n = k + r
    stripe = k * 512
    data1, data2 = _rand(2 * stripe, seed=14), _rand(2 * stripe, seed=15)
    popts = _options("torch", systematic)
    jopts = _options("ref", systematic)
    orig = tmp_path / "orig"

    async def overwrite_and_heal(pkg, base, opts):
        c, ec = await _mount(pkg, base, n, r, opts)
        try:
            ec.set_child_up(2, False)
            await c.write_file("/z", data2)
            ec.set_child_up(2, True)
            info = await ec.heal_info(pkg.loc("/z"))
            assert info["bad"] == [2], info
            res = await ec.heal_file("/z")
            assert res["healed"] == [2]
            assert (await ec.heal_info(pkg.loc("/z")))["bad"] == []
            assert await c.read_file("/z") == data2
        finally:
            await c.unmount()
        return await _state(pkg, base, n, r, opts, ["/z"])

    async def run():
        c, _ = await _mount(PORT, orig, n, r, popts)
        try:
            await c.write_file("/z", data1)
        finally:
            await c.unmount()
        _copy(orig, tmp_path / "port", n)
        _copy(orig, tmp_path / "jax", n)
        return (await overwrite_and_heal(PORT, tmp_path / "port", popts),
                await overwrite_and_heal(JAX, tmp_path / "jax", jopts))

    (frag_p, xa_p), (frag_j, xa_j) = asyncio.run(run())
    assert frag_p == frag_j and xa_p == xa_j
    oracle = jgf.ref_encode(np.frombuffer(data2, dtype=np.uint8), k, n,
                            systematic=systematic == "on")
    for i in range(n):
        assert frag_p[(i, "/z")] == oracle[i].tobytes(), f"brick {i}"
