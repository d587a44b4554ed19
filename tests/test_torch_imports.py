"""The port stands alone: importing every module of glusterfs_tpu_torch
pulls in neither jax nor the JAX package, the layer registry resolves
volfile types to the port's own layers, and the codec never drops to
the CPU on a host without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import glusterfs_tpu_torch as pkg

mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in mods:
    importlib.import_module(name)

from glusterfs_tpu_torch.core.layer import lookup_type
from glusterfs_tpu_torch.ops.codec import Codec

ec = lookup_type("cluster/disperse")
dht = lookup_type("cluster/distribute")
posix = lookup_type("storage/posix")
# the default brick stack and the wire client resolve inside the port
stack = {t: lookup_type(t).__module__ for t in (
    "storage/posix", "features/locks", "features/index", "features/upcall",
    "performance/io-threads", "features/barrier", "debug/io-stats",
    "protocol/server", "protocol/client")}
codec = {}
for backend in ("auto", "cuda-mma"):
    try:
        Codec(4, 2, backend)
        codec[backend] = "ran"
    except RuntimeError as e:
        codec[backend] = "raised: " + str(e)
# the measured ladder: a small flush routes to the native codec
import asyncio
import numpy as np
from glusterfs_tpu_torch.ops.batch import BatchingCodec

ladder = BatchingCodec(4, 2, "torch", device="cpu", min_batch=1 << 20)
frags = asyncio.run(ladder.encode_async(np.zeros(4 * 512, np.uint8)))
routed = {"cpu_launches": ladder.cpu_launches, "launches": ladder.launches,
          "small": ladder._small().backend, "shape": list(frags.shape)}
ladder.close()
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                or m.startswith("jaxlib.") or m == "glusterfs_tpu"
                or m.startswith("glusterfs_tpu."))
print(json.dumps({"modules": mods, "leaked": leaked, "codec": codec,
                  "routed": routed,
                  "ec": ec.__module__ + "." + ec.__name__,
                  "dht": dht.__module__ + "." + dht.__name__,
                  "posix": posix.__module__, "stack": stack}))
"""


def test_port_imports_no_jax_and_never_runs_on_cpu_implicitly():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""  # a host with no card
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "glusterfs_tpu_torch.cluster.ec" in res["modules"]
    assert "glusterfs_tpu_torch.ops.gf256_cuda" in res["modules"]
    assert "glusterfs_tpu_torch.cluster.dht" in res["modules"]
    assert "glusterfs_tpu_torch.native" in res["modules"]
    for mod in ("protocol.client", "protocol.server", "rpc.wire",
                "rpc.shm", "rpc.event_pool", "rpc.socktune", "rpc.tls",
                "rpc.compound", "features.locks", "features.index",
                "features.upcall", "features.barrier",
                "performance.io_threads", "debug.io_stats", "core.flight",
                "daemon"):
        assert "glusterfs_tpu_torch." + mod in res["modules"], mod
    assert res["stack"] == {
        "storage/posix": "glusterfs_tpu_torch.storage.posix",
        "features/locks": "glusterfs_tpu_torch.features.locks",
        "features/index": "glusterfs_tpu_torch.features.index",
        "features/upcall": "glusterfs_tpu_torch.features.upcall",
        "performance/io-threads": "glusterfs_tpu_torch.performance.io_threads",
        "features/barrier": "glusterfs_tpu_torch.features.barrier",
        "debug/io-stats": "glusterfs_tpu_torch.debug.io_stats",
        "protocol/server": "glusterfs_tpu_torch.protocol.server",
        "protocol/client": "glusterfs_tpu_torch.protocol.client"}
    assert res["routed"] == {"cpu_launches": 1, "launches": 0,
                             "small": "native", "shape": [6, 512]}
    assert res["leaked"] == []
    assert res["ec"] == "glusterfs_tpu_torch.cluster.ec.DisperseLayer"
    assert res["dht"] == "glusterfs_tpu_torch.cluster.dht.DistributeLayer"
    assert res["posix"] == "glusterfs_tpu_torch.storage.posix"
    for backend, outcome in res["codec"].items():
        assert outcome.startswith("raised: "), (backend, outcome)
