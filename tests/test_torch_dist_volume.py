"""A distributed-disperse 2x(4+2) volume served by the port
(glusterfs_tpu_torch: ``cluster/distribute`` over two 4+2 disperse
groups, ``cpu-extensions torch-mma`` on the CPU) against the same volume
served by the JAX package (``cpu-extensions ref``): the same writes
leave byte-identical fragment files, every file lands on the same group
in both packages, each package mounts and reads the bricks the other
wrote, healthy and with two bricks of each group down and spoiled.
Tolerance: exact byte equality."""

import asyncio

import numpy as np
import pytest

from glusterfs_tpu.api.glfs import SyncClient as JaxClient
from glusterfs_tpu.core.graph import Graph as JaxGraph
from glusterfs_tpu.utils.volspec import ec_volfile as jax_volfile
from glusterfs_tpu_torch.api.glfs import SyncClient
from glusterfs_tpu_torch.cluster.dht import DistributeLayer
from glusterfs_tpu_torch.cluster.ec import DisperseLayer
from glusterfs_tpu_torch.core.graph import Graph
from glusterfs_tpu_torch.core.layer import lookup_type
from glusterfs_tpu_torch.ops import gf256_cuda
from glusterfs_tpu_torch.utils.volspec import ec_volfile

K, R, GROUPS = 4, 2, 2
N = K + R
STRIPE = K * 512


def _rand(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _down(top, bricks):
    """Take global brick indices down: brick i is child i % N of group
    i // N."""
    for i in bricks:
        top.children[i // N].set_child_up(i % N, False)


def _port(base, down=()):
    g = Graph.construct(ec_volfile(base, N, R, groups=GROUPS, options={
        "cpu-extensions": "torch-mma", "stripe-cache-min-batch": 0}))
    c = SyncClient(g)
    c.mount()
    assert isinstance(g.top, DistributeLayer)
    assert all(isinstance(ch, DisperseLayer) for ch in g.top.children)
    _down(g.top, down)
    return c, g.top


def _jax(base, down=()):
    g = JaxGraph.construct(jax_volfile(base, N, R, groups=GROUPS, options={
        "cpu-extensions": "ref"}))
    c = JaxClient(g)
    c.mount()
    _down(g.top, down)
    return c, g.top


def _spoil(base, bricks):
    """Invert every fragment file on ``bricks`` (down from the next mount
    on): a read that still used one would return wrong bytes."""
    for i in bricks:
        for p in (base / f"brick{i}").rglob("*"):
            if p.is_file() and not p.name.startswith(".") and \
                    ".glusterfs" not in p.parts:
                p.write_bytes(bytes(b ^ 0xFF for b in p.read_bytes()))


SIZES = [1, 511, STRIPE - 1, STRIPE + 1, 3 * STRIPE + 100, 64 << 10,
         777, 5000, 12345, 2 * STRIPE, 33333, 4096]
FILES = {f"/f{i}": _rand(size, seed=i) for i, size in enumerate(SIZES)}
FILES.update({f"/d/g{i}": _rand(1000 + 97 * i, seed=50 + i)
              for i in range(6)})
PATCH = (1800, _rand(700, seed=99))
DOWN = (0, 3, 7, 10)  # two bricks of each group


def _write_all(c):
    c.mkdir("/d")
    for path, data in FILES.items():
        c.write_file(path, data)
    f = c.open("/f4")
    f.write(PATCH[1], PATCH[0])  # unaligned read-modify-write
    f.close()


def _expected():
    want = dict(FILES)
    b = bytearray(want["/f4"])
    b[PATCH[0]:PATCH[0] + len(PATCH[1])] = PATCH[1]
    want["/f4"] = bytes(b)
    return want


def _read_all(c):
    return {p: c.read_file(p) for p in FILES}


def _group_of(base, path):
    """Which group's bricks hold the fragments of ``path``."""
    held = [g for g in range(GROUPS)
            if (base / f"brick{g * N}" / path.lstrip("/")).is_file()]
    assert len(held) == 1, (path, held)
    return held[0]


def test_fragments_identical_placement_equal_and_cross_readable(tmp_path):
    want = _expected()
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    c, top = _port(pdir)
    _write_all(c)
    assert _read_all(c) == want
    assert sorted(c.listdir("/")) == sorted(
        ["d"] + [p[1:] for p in FILES if p.count("/") == 1])
    assert sorted(c.listdir("/d")) == sorted(
        p[3:] for p in FILES if p.startswith("/d/"))
    for ch in top.children:
        assert ch.codec.dump_stats()["backend"] == "torch-mma"
    c.close()
    c, _ = _jax(jdir)
    _write_all(c)
    c.close()

    groups = {p: _group_of(pdir, p) for p in FILES}
    assert set(groups.values()) == set(range(GROUPS))  # both groups used
    for path, g in groups.items():
        assert _group_of(jdir, path) == g, path
        rel = path.lstrip("/")
        for i in range(g * N, (g + 1) * N):
            assert (pdir / f"brick{i}" / rel).read_bytes() == \
                (jdir / f"brick{i}" / rel).read_bytes(), (i, path)

    # each package mounts the bricks the other wrote, healthy and then
    # with two bricks of each group down (their fragments spoiled)
    c, _ = _port(jdir)
    assert _read_all(c) == want
    c.close()
    c, _ = _jax(pdir)
    assert _read_all(c) == want
    c.close()
    _spoil(jdir, DOWN)
    _spoil(pdir, DOWN)
    c, _ = _port(jdir, down=DOWN)
    assert _read_all(c) == want
    c.close()
    c, _ = _jax(pdir, down=DOWN)
    assert _read_all(c) == want
    c.close()


def test_degraded_write_and_read_on_both_groups(tmp_path):
    c, top = _port(tmp_path)
    data = {f"/w{i}": _rand(5 * STRIPE + 123 * i, seed=70 + i)
            for i in range(8)}
    for p, d in data.items():
        c.write_file(p, d)
    c.close()
    _spoil(tmp_path, DOWN)
    c, top = _port(tmp_path, down=DOWN)
    for p, d in data.items():
        assert c.read_file(p) == d, p
    # unaligned writes with two bricks of each group down, read back
    for i, p in enumerate(data):
        f = c.open(p)
        f.write(b"Z" * 999, 2047 + i)
        f.close()
        exp = bytearray(data[p])
        exp[2047 + i:3046 + i] = b"Z" * 999
        assert c.read_file(p) == bytes(exp), p
    launched = [ch.codec.dump_stats()["launches"] for ch in top.children]
    assert all(n > 0 for n in launched), launched
    c.close()


def test_rename_leaves_a_linkto_both_packages_follow(tmp_path):
    """A rename whose new name hashes to the other group keeps the data
    where it was and leaves a linkto pointer; both packages follow it."""
    c, top = _port(tmp_path)
    data = _rand(3 * STRIPE + 5, seed=3)
    c.write_file("/src", data)
    src_group = top.hashed_idx("src")
    new = next(f"dst{i}" for i in range(100)
               if top.hashed_idx(f"dst{i}") != src_group)
    c.rename("/src", f"/{new}")
    assert c.read_file(f"/{new}") == data
    assert sorted(c.listdir("/")) == [new]
    c.close()
    c, _ = _jax(tmp_path)
    assert c.read_file(f"/{new}") == data
    c.close()


def test_registry_resolves_distribute_and_rebalance_is_refused(tmp_path):
    assert lookup_type("cluster/distribute") is DistributeLayer
    c, top = _port(tmp_path)
    with pytest.raises(NotImplementedError, match="rebalance"):
        asyncio.run(top.rebalance("/"))
    c.close()


def test_cpu_volume_counts_no_kernel_launches(tmp_path):
    gf256_cuda.reset_launches()
    c, _ = _port(tmp_path)
    c.write_file("/x", _rand(2 * STRIPE, seed=1))
    assert c.read_file("/x") == _rand(2 * STRIPE, seed=1)
    c.close()
    assert sum(gf256_cuda.LAUNCHES.values()) == 0
