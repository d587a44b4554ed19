"""4+2 and 8+4 disperse volumes served by the port (glusterfs_tpu_torch,
``cpu-extensions torch`` on the CPU) against the same volumes served by
the JAX package (``cpu-extensions ref``): the same writes leave
byte-identical fragment files on the bricks, each package mounts and
reads the bricks the other wrote, and degraded reads and the systematic
layout work in the port.  Tolerance: exact byte equality."""

import numpy as np
import pytest

from glusterfs_tpu.api.glfs import SyncClient as JaxClient
from glusterfs_tpu.core.graph import Graph as JaxGraph
from glusterfs_tpu.utils.volspec import ec_volfile as jax_volfile
from glusterfs_tpu_torch.api.glfs import SyncClient
from glusterfs_tpu_torch.cluster.ec import DisperseLayer
from glusterfs_tpu_torch.core.graph import Graph
from glusterfs_tpu_torch.utils.volspec import ec_volfile

K, R = 4, 2
N = K + R
STRIPE = K * 512


def _rand(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _port(base, systematic="off", down=(), k=K, r=R, backend="torch"):
    # min-batch 0 pins every flush to the kernels' plain versions (the
    # native CPU ladder is held in test_torch_batch.py)
    g = Graph.construct(ec_volfile(base, k + r, r, options={
        "cpu-extensions": backend, "systematic": systematic,
        "stripe-cache-min-batch": 0}))
    c = SyncClient(g)
    c.mount()
    assert isinstance(g.top, DisperseLayer)
    for i in down:
        g.top.set_child_up(i, False)
    return c, g.top


def _jax(base, systematic="off", down=(), k=K, r=R):
    g = JaxGraph.construct(jax_volfile(base, k + r, r, options={
        "cpu-extensions": "ref", "systematic": systematic}))
    c = JaxClient(g)
    c.mount()
    for i in down:
        g.top.set_child_up(i, False)
    return c, g.top


def _spoil(base, bricks):
    """Invert every fragment file on ``bricks`` (down from the next mount
    on): a read that still used one would return wrong bytes."""
    for i in bricks:
        for p in (base / f"brick{i}").iterdir():
            if p.is_file() and not p.name.startswith("."):
                p.write_bytes(bytes(b ^ 0xFF for b in p.read_bytes()))


def _files(k):
    """File sizes across a stripe of k fragments: under one chunk, a
    stripe less and more one byte, an unaligned multi-stripe tail."""
    stripe = k * 512
    return {f"/f{i}": _rand(size, seed=i) for i, size in enumerate(
        [1, 511, stripe - 1, stripe + 1, 3 * stripe + 100, 64 << 10])}


PATCH = (1800, _rand(700, seed=99))


def _write_all(c, files):
    for path, data in files.items():
        c.write_file(path, data)
    f = c.open("/f4")
    f.write(PATCH[1], PATCH[0])  # unaligned read-modify-write
    f.close()


def _expected(files):
    want = dict(files)
    b = bytearray(want["/f4"])
    b[PATCH[0]:PATCH[0] + len(PATCH[1])] = PATCH[1]
    want["/f4"] = bytes(b)
    return want


def _read_all(c, files):
    return {p: c.read_file(p) for p in files}


# (systematic, k, r, bricks down on the JAX package's bricks, on the
# port's): r bricks down, spoiled
CROSS = [("off", 4, 2, (0, 3), (1, 4)), ("on", 4, 2, (0, 3), (1, 4)),
         ("off", 8, 4, (0, 4, 8, 11), (1, 5, 9, 10)),
         ("on", 8, 4, (0, 4, 8, 11), (1, 5, 9, 10))]


@pytest.mark.parametrize(
    "systematic,k,r,jax_down,port_down",
    [pytest.param(*case, id=case[0] if case[1:3] == (4, 2)
                  else f"{case[0]}-{case[1]}+{case[2]}") for case in CROSS])
def test_fragments_identical_and_bricks_cross_readable(
        tmp_path, systematic, k, r, jax_down, port_down):
    files = _files(k)
    want = _expected(files)
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    c, _ = _port(pdir, systematic, k=k, r=r)
    _write_all(c, files)
    assert _read_all(c, files) == want
    c.close()
    c, _ = _jax(jdir, systematic, k=k, r=r)
    _write_all(c, files)
    c.close()

    for i in range(k + r):
        for path in files:
            name = path.lstrip("/")
            assert (pdir / f"brick{i}" / name).read_bytes() == \
                (jdir / f"brick{i}" / name).read_bytes(), (i, path)

    # each package mounts the bricks the other wrote, healthy and then
    # with r bricks down (their fragments spoiled)
    c, _ = _port(jdir, systematic, k=k, r=r)
    assert _read_all(c, files) == want
    c.close()
    c, _ = _jax(pdir, systematic, k=k, r=r)
    assert _read_all(c, files) == want
    c.close()
    _spoil(jdir, jax_down)
    _spoil(pdir, port_down)
    c, _ = _port(jdir, systematic, down=jax_down, k=k, r=r)
    assert _read_all(c, files) == want
    c.close()
    c, _ = _jax(pdir, systematic, down=port_down, k=k, r=r)
    assert _read_all(c, files) == want
    c.close()


@pytest.mark.parametrize("systematic", ["off", "on"])
def test_native_volume_bricks_identical_to_jax(tmp_path, systematic):
    """A volume on ``cpu-extensions native`` (the host's AVX2 codec)
    leaves the JAX package's bricks, and reads them back degraded."""
    files = _files(K)
    want = _expected(files)
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    c, ec = _port(pdir, systematic, backend="native")
    assert ec.codec.backend == "native" and ec.codec.device is None
    _write_all(c, files)
    assert _read_all(c, files) == want
    c.close()
    c, _ = _jax(jdir, systematic)
    _write_all(c, files)
    c.close()
    for i in range(N):
        for path in files:
            name = path.lstrip("/")
            assert (pdir / f"brick{i}" / name).read_bytes() == \
                (jdir / f"brick{i}" / name).read_bytes(), (i, path)
    _spoil(pdir, (0, 3))
    c, _ = _port(pdir, systematic, down=(0, 3), backend="native")
    assert _read_all(c, files) == want
    c.close()


def test_port_degraded_read_and_write(tmp_path):
    c, _ = _port(tmp_path)
    data = _rand(5 * STRIPE + 123, seed=5)
    c.write_file("/deg", data)
    c.close()
    _spoil(tmp_path, (0, 3))
    c, ec = _port(tmp_path, down=(0, 3))
    assert c.read_file("/deg") == data
    # an unaligned write with two bricks down, read back degraded
    f = c.open("/deg")
    f.write(b"Z" * 999, 2047)
    f.close()
    exp = bytearray(data)
    exp[2047:3046] = b"Z" * 999
    assert c.read_file("/deg") == bytes(exp)
    stats = ec.codec.dump_stats()
    assert stats["backend"] == "torch" and stats["launches"] > 0
    c.close()


def test_port_systematic_degraded_and_delta_write(tmp_path):
    c, ec = _port(tmp_path, "on")
    data = _rand(4 * STRIPE, seed=12)
    c.write_file("/g", data)
    f = c.open("/g")
    f.write(b"Q" * 777, 100)  # healthy sub-stripe write: parity delta
    f.close()
    assert ec.write_path["delta"] == 1
    exp = bytearray(data)
    exp[100:877] = b"Q" * 777
    c.close()
    _spoil(tmp_path, (0,))
    c, ec = _port(tmp_path, "on", down=(0,))  # reads reconstruct row 0
    assert c.read_file("/g") == bytes(exp)
    assert ec.read_fanout["staged"] >= 1
    f = c.open("/g")
    f.write(b"W" * 300, 5000)  # degraded sub-stripe write: full RMW
    f.close()
    exp[5000:5300] = b"W" * 300
    assert c.read_file("/g") == bytes(exp)
    c.close()


def test_port_rejects_the_mesh_tier(tmp_path):
    with pytest.raises(Exception, match="mesh-codec"):
        Graph.construct(ec_volfile(tmp_path, N, R, options={
            "cpu-extensions": "torch", "mesh-codec": "on"}))
