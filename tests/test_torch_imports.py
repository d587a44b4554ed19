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
posix = lookup_type("storage/posix")
try:
    Codec(4, 2)
    codec = "ran"
except RuntimeError as e:
    codec = "raised: " + str(e)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                or m.startswith("jaxlib.") or m == "glusterfs_tpu"
                or m.startswith("glusterfs_tpu."))
print(json.dumps({"modules": mods, "leaked": leaked, "codec": codec,
                  "ec": ec.__module__ + "." + ec.__name__,
                  "posix": posix.__module__}))
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
    assert res["leaked"] == []
    assert res["ec"] == "glusterfs_tpu_torch.cluster.ec.DisperseLayer"
    assert res["posix"] == "glusterfs_tpu_torch.storage.posix"
    assert res["codec"].startswith("raised: "), res["codec"]
