"""The wire of the port (glusterfs_tpu_torch.rpc.wire with its C codec,
protocol/client, protocol/server, the default brick stack and the brick
daemon) against the JAX package's.

* Frames: the same values framed by both packages (``pack``,
  ``pack_frames``, ``pack_z``) are the same bytes; the port's C codec
  equals its Python codec and the JAX package's Python codec, on the
  cases of tests/test_wirec.py and tests/test_protocol.py and on seeded
  random trees.  A failed gcc build of ``wirec.c`` raises.
* Serving across packages, on loopback TCP in one process: a port
  client (``cpu-extensions torch``) over six JAX-package bricks and a
  JAX-package client (``ref``) over six port bricks, both with the
  default brick stack, write the same seeded files; fragment files and
  ``trusted.ec.{version,size,dirty}`` are identical, and each package
  reads what the other wrote.
* A systematic 4+2 volume over port bricks takes an unaligned overwrite
  over the wire as ``xorv`` and reads degraded, a data and a parity
  brick's servers stopped, the bytes the JAX package reads.
* The brick daemon runs in a subprocess and imports neither jax nor the
  JAX package.

Tolerance: exact byte equality everywhere."""

import asyncio
import errno
import os
import random
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import pytest

from glusterfs_tpu.api.glfs import Client as JaxClient
from glusterfs_tpu.core import fops as jfops
from glusterfs_tpu.core import iatt as jiatt
from glusterfs_tpu.core import layer as jlayer
from glusterfs_tpu.core.graph import Graph as JaxGraph
from glusterfs_tpu.daemon import serve_brick as jax_serve_brick
from glusterfs_tpu.mgmt import volgen as jax_volgen
from glusterfs_tpu.rpc import wire as jwire
from glusterfs_tpu_torch import daemon
from glusterfs_tpu_torch import native
from glusterfs_tpu_torch.api.glfs import Client, wait_connected
from glusterfs_tpu_torch.core import fops as pfops
from glusterfs_tpu_torch.core import iatt as piatt
from glusterfs_tpu_torch.core import layer as players
from glusterfs_tpu_torch.core.graph import Graph
from glusterfs_tpu_torch.protocol.client import ClientLayer
from glusterfs_tpu_torch.rpc import wire as pwire
from glusterfs_tpu_torch.utils import volspec

REPO = Path(__file__).resolve().parents[1]
EC_XATTRS = ("trusted.ec.version", "trusted.ec.size", "trusted.ec.dirty")
K, R = 4, 2
N = K + R


# -- frames ----------------------------------------------------------------

class _Pkg:
    """One package's wire value types."""

    def __init__(self, fops, iatt, layer, wire):
        self.FopError, self.Iatt, self.IAType = \
            fops.FopError, iatt.Iatt, iatt.IAType
        self.Loc, self.wire = layer.Loc, wire


PORT = _Pkg(pfops, piatt, players, pwire)
JAX = _Pkg(jfops, jiatt, jlayer, jwire)


def _cases(p):
    """The cases of tests/test_wirec.py and tests/test_protocol.py, built
    from one package's types."""
    w = p.wire
    return [
        None, True, False, 0, 1, -5, 2 ** 40, -(2 ** 40), 3.25, -0.0,
        b"", b"\x00\xff" * 100, "héllo", "", "\x7f",
        b"caf\xe9".decode("utf-8", "surrogateescape"),
        [1, [2, b"x"], "y"], {"a": 1, "b": [True, None], "": {}},
        p.Iatt(gfid=b"\x01" * 16, ia_type=p.IAType.REG, size=42, mtime=1.5),
        p.Loc("/a/b", gfid=b"\x02" * 16, parent=b"\x03" * 16),
        w.FdHandle(7, b"\x04" * 16, "/f"),
        p.FopError(2, "gone"),
        p.FopError(errno.EAGAIN, "revoked", {"lock-revoked": {"kind": "x"}}),
        ["writev", (w.FdHandle(3, b"\x05" * 16, "/x"), b"d" * 512, 4096),
         {"xdata": {"pre-xattrop": {"trusted.ec.dirty": b"\0" * 16}}}],
        {"data": w.Blob(b"Z" * 4096), "n": 1},
        ["writev", [w.FdHandle(9, b"\x06" * 16, "/y"),
                    w.Blob(bytes(range(256)) * 40), 1 << 20], {}],
        {w.SG_KEY: [w.Blob(b"a" * 5000), b"tail", w.Blob(b"b" * 4096)]},
    ]


def _tree(rnd, p, d=0):
    """A seeded random value tree of one package's types."""
    t = rnd.randrange(11 if d < 3 else 6)
    if t == 0:
        return None
    if t == 1:
        return rnd.choice([True, False])
    if t == 2:
        return rnd.randrange(-2 ** 50, 2 ** 50)
    if t == 3:
        return rnd.random()
    if t == 4:
        return bytes(rnd.randrange(256) for _ in range(rnd.randrange(20)))
    if t == 5:
        return "".join(chr(rnd.choice([rnd.randrange(32, 0xD800),
                                       rnd.randrange(0xE000, 0x2FFFF)]))
                       for _ in range(rnd.randrange(10)))
    if t == 6:
        return [_tree(rnd, p, d + 1) for _ in range(rnd.randrange(5))]
    if t == 7:
        return {str(i): _tree(rnd, p, d + 1) for i in range(rnd.randrange(5))}
    if t == 8:
        return p.Iatt(gfid=bytes(rnd.randrange(256) for _ in range(16)),
                      ia_type=p.IAType.DIR, size=rnd.randrange(1 << 40),
                      mtime=rnd.random())
    if t == 9:
        return p.Loc(f"/d{rnd.randrange(99)}", gfid=b"\x07" * 16)
    return p.wire.Blob(bytes([rnd.randrange(256)]) * rnd.randrange(1, 9000))


def _py_encode(wire, v, blobs=None):
    out = bytearray()
    wire.encode_value(v, out, blobs)
    return bytes(out)


def _frames_of(wire, v):
    """Every framing of ``v``: pack, pack_frames joined (blobs after the
    body), pack_z at two levels."""
    return {"pack": wire.pack(5, wire.MT_CALL, v),
            "pack_frames": b"".join(bytes(f) for f in
                                    wire.pack_frames(6, wire.MT_REPLY, v)),
            "pack_z": wire.pack_z(7, wire.MT_CALL, v, 64, 1),
            "pack_z9": wire.pack_z(8, wire.MT_ERROR, v, 0, 9)}


def _canon(p, v):
    """Identity-compared wire classes -> comparable tuples."""
    w = p.wire
    if isinstance(v, w.FdHandle):
        return ("fd", v.fdid, v.gfid, v.path)
    if isinstance(v, p.Loc):
        return ("loc", v.path, v.gfid, v.parent, v.name)
    if isinstance(v, p.Iatt):
        return ("iatt", v.gfid, v.ia_type.value, v.size, v.mode, v.mtime)
    if isinstance(v, p.FopError):
        return ("err", v.err, v.args[1] if len(v.args) > 1 else "",
                getattr(v, "xdata", None))
    if isinstance(v, memoryview):
        return ("bytes", bytes(v))
    if isinstance(v, w.Blob):
        return ("bytes", bytes(v.view))
    if isinstance(v, bytes):
        return ("bytes", v)
    if isinstance(v, (list, tuple)):
        return [_canon(p, x) for x in v]
    if isinstance(v, dict):
        return {k: _canon(p, x) for k, x in v.items()}
    return v


def _check_value(pv, jv):
    """The port's frames and encodings of ``pv`` equal the JAX package's
    of ``jv`` (the same value in its types), and both decode back."""
    assert _frames_of(pwire, pv) == _frames_of(jwire, jv)
    for lane in (False, True):  # without and with the blob lane
        cb, pb, jb = ([], [], []) if lane else (None, None, None)
        assert pwire._c().encode(pv, cb) == _py_encode(pwire, pv, pb) == \
            _py_encode(jwire, jv, jb)
        if lane:
            assert [bytes(b) for b in cb] == [bytes(b) for b in pb] == \
                [bytes(b) for b in jb]
    for frame in _frames_of(pwire, pv).values():
        _, _, out = pwire.unpack(frame[4:])
        _, _, ref = jwire.unpack(frame[4:])
        assert _canon(PORT, out) == _canon(JAX, ref) == _canon(PORT, pv)
    c = pwire._c().encode(pv, None)
    got_c, pos_c = pwire._c().decode(c, 0, None)
    got_p, pos_p = pwire.decode_value(memoryview(c), 0, None)
    assert pos_c == pos_p == len(c)
    assert _canon(PORT, got_c) == _canon(PORT, got_p)


@pytest.mark.parametrize("idx", range(len(_cases(PORT))))
def test_frames_equal_jax(idx):
    _check_value(_cases(PORT)[idx], _cases(JAX)[idx])


def test_seeded_trees_frame_equal_jax():
    prnd, jrnd = random.Random(11), random.Random(11)
    for _ in range(200):
        _check_value(_tree(prnd, PORT), _tree(jrnd, JAX))


def test_large_blob_frames_and_zlib_cap():
    """A 16 MiB fragment (a 64 MiB write's share of a 4+2 brick) frames
    identically; a compressed frame past the 256 MiB inflation cap is
    refused by both packages."""
    frag = np.random.default_rng(3).integers(0, 256, 16 << 20,
                                             np.uint8).tobytes()
    pv = ["writev", [pwire.FdHandle(1, b"\x01" * 16, "/big"),
                     pwire.Blob(frag), 0], {}]
    jv = ["writev", [jwire.FdHandle(1, b"\x01" * 16, "/big"),
                     jwire.Blob(frag), 0], {}]
    pf = pwire.pack_frames(3, pwire.MT_CALL, pv)
    jf = jwire.pack_frames(3, jwire.MT_CALL, jv)
    assert [bytes(f) for f in pf] == [bytes(f) for f in jf]
    deflate, mib = zlib.compressobj(1), b"\0" * (1 << 20)
    bomb = pwire._HDR.pack(1, pwire.MT_ZLIB, 0) + b"".join(
        deflate.compress(mib) for _ in range(257)) + deflate.flush()
    for wire in (pwire, jwire):
        with pytest.raises(wire.WireError, match="inflation cap"):
            wire.unpack(bomb)


def test_unencodable_type_raises_in_both_codecs():
    with pytest.raises(pwire.WireError):
        pwire.pack(1, pwire.MT_CALL, object())
    with pytest.raises(pwire.WireError):
        pwire.encode_value(object(), bytearray())


def test_failed_wirec_build_raises_with_gcc_stderr(tmp_path, monkeypatch):
    bad = tmp_path / "wirec.c"
    bad.write_text("#include <Python.h>\nthis is not C;\n")
    monkeypatch.setattr(native, "WIREC_SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_wirec", None)
    monkeypatch.setattr(native, "_wirec_error", None)
    with pytest.raises(RuntimeError, match="gcc failed") as exc:
        native.wirec_module()
    assert "error" in str(exc.value)
    # the same error on every later call, and the wire does not fall
    # back to its Python codec
    monkeypatch.setattr(pwire, "_wirec", None)
    with pytest.raises(RuntimeError, match="gcc failed"):
        pwire.pack(1, pwire.MT_CALL, [1, 2])


# -- serving ---------------------------------------------------------------

def _rand(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


STRIPE = K * 512
FILES = {f"/f{i}": _rand(size, seed=200 + i) for i, size in enumerate(
    [1, 511, STRIPE - 1, STRIPE + 1, 3 * STRIPE + 100, (1 << 20) + 3,
     3 * (1 << 20) + 777])}
PATCH = ("/f6", 777, _rand(3001, seed=299))  # unaligned overwrite


def _expected():
    want = dict(FILES)
    path, off, data = PATCH
    b = bytearray(want[path])
    b[off:off + len(data)] = data
    want[path] = bytes(b)
    return want


def _jax_brick_volfile(name, directory):
    return jax_volgen.build_brick_volfile(
        {"options": {}, "bricks": [{}], "type": "disperse"},
        {"name": name, "path": str(directory), "index": 0})


async def _serve(pkg, base):
    """Six brick servers of one package with the default brick stack."""
    out = []
    for i in range(N):
        name, d = f"v-brick-{i}", base / f"brick{i}"
        if pkg == "jax":
            out.append(await jax_serve_brick(_jax_brick_volfile(name, d)))
        else:
            out.append(await daemon.serve_brick(
                volspec.brick_volfile(name, d)))
    return out


async def _mount(pkg, servers, systematic, down=()):
    """A 4+2 client of one package over ``servers``; ``down`` are
    servers already stopped (never connected, marked down)."""
    opts = {"systematic": systematic}
    opts.update({"cpu-extensions": "ref"} if pkg == "jax" else
                {"cpu-extensions": "torch", "stripe-cache-min-batch": 0})
    vf = volspec.client_volfile("v", [s.port for s in servers], R, opts)
    c = (JaxClient(JaxGraph.construct(vf)) if pkg == "jax"
         else Client(Graph.construct(vf)))
    await c.mount()
    ec = c.graph.top
    live = [ch for i, ch in enumerate(ec.children) if i not in down]
    for _ in range(300):
        if all(ch.connected for ch in live):
            break
        await asyncio.sleep(0.02)
    assert all(ch.connected for ch in live)
    for i in down:
        ec.set_child_up(i, False)
    return c, ec


async def _write(c):
    for path, data in FILES.items():
        await c.write_file(path, data)
    path, off, data = PATCH
    f = await c.open(path, os.O_RDWR)
    await f.write(data, off)
    await f.close()


async def _read(c):
    return {p: await c.read_file(p) for p in FILES}


async def _xattrs(pkg_loc, ec):
    out = {}
    for i, child in enumerate(ec.children):
        for p in FILES:
            xa = await child.getxattr(pkg_loc(p), None)
            out[(i, p)] = {k: bytes(xa[k]) for k in EC_XATTRS if k in xa}
    return out


def _fragments(base):
    return {(i, p): (base / f"brick{i}" / p.lstrip("/")).read_bytes()
            for i in range(N) for p in FILES}


def _single_client(port):
    """A client graph of one protocol/client, no cluster layer."""
    return Graph.construct(
        "volume c0\n    type protocol/client\n"
        "    option remote-host 127.0.0.1\n"
        f"    option remote-port {port}\n"
        "    option remote-subvolume v-brick-0\nend-volume\n")


async def _stop(servers):
    for s in servers:
        await s.stop()


def test_default_brick_volfile_is_the_jax_volgen_text(tmp_path):
    assert volspec.brick_volfile("v-brick-3", tmp_path / "b3") == \
        _jax_brick_volfile("v-brick-3", tmp_path / "b3")


@pytest.mark.parametrize("groups", [1, 2])
def test_client_volfile_disperse_or_distribute_over_groups(groups):
    from glusterfs_tpu_torch.cluster.dht import DistributeLayer
    from glusterfs_tpu_torch.cluster.ec import DisperseLayer

    ports = list(range(24001, 24001 + N * groups))
    g = Graph.construct(volspec.client_volfile(
        "v", ports, R, {"cpu-extensions": "torch"}, group_size=N))
    ecs = [g.top] if groups == 1 else g.top.children
    assert isinstance(g.top, DisperseLayer if groups == 1
                      else DistributeLayer)
    assert [type(ec) for ec in ecs] == [DisperseLayer] * groups
    wires = [ch for ec in ecs for ch in ec.children]
    assert all(isinstance(ch, ClientLayer) for ch in wires)
    assert [(ch.opts["remote-port"], ch.opts["remote-subvolume"])
            for ch in wires] == [(p, f"v-brick-{i}")
                                 for i, p in enumerate(ports)]


@pytest.mark.parametrize("systematic", ["off", "on"])
def test_port_client_over_jax_bricks_equals_jax_client_over_port_bricks(
        tmp_path, systematic):
    want = _expected()
    adir, bdir = tmp_path / "jax-bricks", tmp_path / "port-bricks"

    async def run():
        jax_bricks = await _serve("jax", adir)
        port_bricks = await _serve("port", bdir)
        try:
            # arrangement A: the port's client over the JAX bricks
            pc, pec = await _mount("port", jax_bricks, systematic)
            await _write(pc)
            assert await _read(pc) == want
            # arrangement B: the JAX client over the port's bricks
            jc, jec = await _mount("jax", port_bricks, systematic)
            await _write(jc)
            assert await _read(jc) == want
            if systematic == "on":
                assert pec.write_path["delta"] >= 1
            # unmounting ends the eager locks' delayed post-ops, so the
            # xattrs below are final
            await pc.unmount()
            await jc.unmount()
            assert _fragments(adir) == _fragments(bdir)
            # each package mounts what the other wrote: the EC xattrs
            # it sees are the same, and so are the bytes it reads
            pc, pec = await _mount("port", port_bricks, systematic)
            jc, jec = await _mount("jax", jax_bricks, systematic)
            assert await _xattrs(players.Loc, pec) == \
                await _xattrs(jlayer.Loc, jec)
            assert await _read(pc) == want
            assert await _read(jc) == want
            await pc.unmount()
            await jc.unmount()
        finally:
            await _stop(jax_bricks + port_bricks)

    asyncio.run(run())


def test_systematic_over_port_bricks_xorv_and_degraded(tmp_path):
    want = _expected()
    down = (1, 5)  # a data brick and a parity brick

    async def run():
        servers = await _serve("port", tmp_path)
        try:
            c, ec = await _mount("port", servers, "on")
            await _write(c)
            assert ec.write_path["delta"] >= 1
            served = {}
            for s in servers:
                for conn in s.connections:
                    for fop, n in conn.fop_counts.items():
                        served[fop] = served.get(fop, 0) + n
            assert served.get("xorv", 0) >= 1
            for i in down:
                await servers[i].stop()
            wire_layers = [ch for ch in ec.children
                           if isinstance(ch, ClientLayer)]
            for _ in range(300):
                if not any(wire_layers[i].connected for i in down):
                    break
                await asyncio.sleep(0.02)
            assert [ec.up[i] for i in range(N)] == \
                [i not in down for i in range(N)]
            got = await _read(c)
            assert got == want
            await c.unmount()
            jc, _ = await _mount("jax", servers, "on", down=down)
            assert await _read(jc) == got
            await jc.unmount()
        finally:
            await _stop(servers)

    asyncio.run(run())


def test_trimmed_calls_answer_eopnotsupp_and_qos_is_refused(tmp_path):
    async def run():
        server = await daemon.serve_brick(
            volspec.brick_volfile("v-brick-0", tmp_path / "b0"))
        try:
            g = _single_client(server.port)
            c = Client(g)
            await c.mount()
            assert await wait_connected(g)
            wl = g.top
            for call, needs in (("__history__", "core/history"),
                                ("__alerts__", "core/slo"),
                                ("__attach__", "brick multiplexing"),
                                ("__detach__", "brick multiplexing")):
                with pytest.raises(pfops.FopError) as exc:
                    await wl._call(call, ("x",), {})
                assert exc.value.err == errno.EOPNOTSUPP
                assert needs in str(exc.value)
            bundle = await wl._call("__incident__", (), {})
            assert "records" in bundle and "clients" in bundle
            await c.unmount()
        finally:
            await server.stop()
        qos = volspec.brick_volfile(
            "v-brick-1", tmp_path / "b1",
            {"protocol/server": {"qos": "on", "qos-fops-per-sec": 10}})
        with pytest.raises(RuntimeError, match="features/qos"):
            await daemon.serve_brick(qos)

    asyncio.run(run())
    for flag in (["--metrics-port", "9"], ["--eventsd", "127.0.0.1:1"]):
        with pytest.raises(SystemExit) as exc:
            daemon.main(["--volfile", "unused.vol", *flag])
        assert exc.value.code == 2


def test_brick_daemon_subprocess_imports_no_jax(tmp_path):
    """``python -m glusterfs_tpu_torch.daemon`` serves one brick over
    TCP; ``-X importtime`` lists every module the daemon imported."""
    vol = tmp_path / "brick.vol"
    vol.write_text(volspec.brick_volfile("v-brick-0", tmp_path / "b0"))
    portfile = tmp_path / "port"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m",
         "glusterfs_tpu_torch.daemon", "--volfile", str(vol),
         "--listen", "0", "--portfile", str(portfile)],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 60
        while not portfile.exists():
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            assert time.time() < deadline
            time.sleep(0.05)
        port = int(portfile.read_text())

        async def run():
            g = _single_client(port)
            c = Client(g)
            await c.mount()
            assert await wait_connected(g)
            await c.write_file("/x", FILES["/f5"])
            assert await c.read_file("/x") == FILES["/f5"]
            await c.unmount()

        asyncio.run(run())
    finally:
        proc.terminate()
        _, err = proc.communicate(timeout=30)
    assert proc.returncode == 0, err[-2000:]
    mods = [line.rsplit("|", 1)[1].strip() for line in err.splitlines()
            if line.startswith("import time:") and line.count("|") == 2]
    assert "glusterfs_tpu_torch.protocol.server" in mods
    leaked = [m for m in mods if m.split(".")[0] in
              ("jax", "jaxlib", "glusterfs_tpu")]
    assert leaked == []
    assert (tmp_path / "b0" / "x").exists()


# -- lookup_type -----------------------------------------------------------

def test_lookup_type_propagates_import_errors_inside_the_module(
        tmp_path, monkeypatch):
    (tmp_path / "wire_test_broken_layer.py").write_text(
        "import wire_test_no_such_dependency\n")
    (tmp_path / "wire_test_bad_name_layer.py").write_text(
        "from os import wire_test_no_such_name\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setitem(players._TYPE_MODULES, "test/broken",
                        "wire_test_broken_layer")
    monkeypatch.setitem(players._TYPE_MODULES, "test/bad-name",
                        "wire_test_bad_name_layer")
    monkeypatch.setitem(players._TYPE_MODULES, "test/missing",
                        "wire_test_missing_layer")
    with pytest.raises(ModuleNotFoundError,
                       match="wire_test_no_such_dependency"):
        players.lookup_type("test/broken")
    with pytest.raises(ImportError, match="wire_test_no_such_name"):
        players.lookup_type("test/bad-name")
    with pytest.raises(ValueError, match="unknown layer type"):
        players.lookup_type("test/missing")
    with pytest.raises(ValueError, match="unknown layer type"):
        players.lookup_type("features/no-such-layer")
    with pytest.raises(ValueError, match="unknown layer type"):
        players.lookup_type("nosuchcategory/x")
