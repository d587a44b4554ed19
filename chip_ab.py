"""Time ``mxu_apply`` as built from several versions of
``glusterfs_tpu_torch/csrc/gf256_kernels.cu`` on one card, at the six
plane-major shapes that ``chip_smoke.py`` times (4+2, 8+4 and 16+4, the
encode matrix and a decode mask, 256 MiB of plane data):

    python3 chip_ab.py OTHER.cu [OTHER.cu ...]

The checkout's own source is always one of the versions (``tree``); each
other is named by its file's stem, e.g. the source of a commit:

    git show REV:glusterfs_tpu_torch/csrc/gf256_kernels.cu > _archive/rev.cu

Every version must keep the C entry point ``gf256_mxu_apply``.  All are
built with ``nvcc`` at once (``-Xptxas -v`` gives each ``mxu_apply``
instantiation's registers and spill bytes), each is held byte-exact
against ``mxu_apply_plain`` at every shape, and each is timed as
``chip_smoke.py`` times a kernel, in order and then in reverse order at
every shape, so that a drift of the card shows as a spread between one
version's two times.  One JSON line per build and per shape, then the
card's name and power limit; exits non-zero on a failed build or a
mismatch.  Needs one card."""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from glusterfs_tpu_torch.ops import gf256_cuda as gc

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_MXU = re.compile(r"mxu_applyILi(\d)ELi(\d)E")


def _start(name: str, src: Path, out: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [gc._nvcc(), *gc.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out / f"lib{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _resources(log: str) -> dict:
    """{"KS=..,MB=..": {"reg": n, "spill": bytes}} of each mxu_apply
    kernel in one ptxas log."""
    res, kernel = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            kernel = _MXU.search(m[1])
            continue
        if kernel is None:
            continue
        key = f"KS={kernel[1]},MB={kernel[2]}"
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill:
            res.setdefault(key, {})["spill"] = int(spill[1])
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            res.setdefault(key, {})["reg"] = int(regs[1])
            kernel = None
    return res


def build(sources: dict[str, Path]) -> dict:
    out = gc.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: _start(name, src, out) for name, src in sources.items()}
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        print(json.dumps({"build": name, "rc": proc.returncode,
                          "mxu_resources": _resources(log)}), flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).gf256_mxu_apply
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def compare(fns: dict) -> None:
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    stream = torch.cuda.current_stream().cuda_stream
    order = list(fns) + list(fns)[::-1]
    for k, r in cs.CONFIGS:
        for matrix in ("encode", "decode"):
            kind, key, _ = cs._plane_case(k, r, matrix)
            abits = gc._bits(kind, k, key)
            rows, c = abits.shape
            w = cs.PLANE_BYTES // c
            x = torch.randint(0, 256, (c, w), dtype=torch.uint8,
                              device="cuda", generator=g)
            op = gc._operand(abits, "mxu", x.device)
            want = gc.mxu_apply_plain(abits, x)
            y = torch.empty((rows, w), dtype=torch.uint8, device="cuda")
            ms = {}
            for name in order:
                def call(fn=fns[name]):
                    err = fn(x.data_ptr(), y.data_ptr(), op.data_ptr(), w,
                             c, rows, 0, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                y.zero_()
                call()
                torch.cuda.synchronize()
                if not torch.equal(y, want):
                    raise AssertionError(f"{name} differs from the plain "
                                         f"version at {k}+{r} {matrix}")
                ms.setdefault(name, []).append(cs.time_ms(call, 10))
            print(json.dumps({"shape": f"{k}+{r} {matrix}", "plane_w": w,
                              "ms": ms}), flush=True)
            del x, y, want
            torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_ab.py: no CUDA card", file=sys.stderr)
        return 1
    sources = {"tree": gc.SOURCE}
    for arg in argv:
        sources[Path(arg).stem] = Path(arg).resolve()
    compare(build(sources))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
