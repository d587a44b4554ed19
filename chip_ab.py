"""Time one plane-major kernel (``mxu_apply``, ``xor_apply`` or
``xor3_apply``) as built from several versions of
``glusterfs_tpu_torch/csrc/gf256_kernels.cu`` on one card, at the six
plane-major shapes that ``chip_smoke.py`` times (4+2, 8+4 and 16+4, the
encode matrix and a decode mask, 256 MiB of plane data):

    python3 chip_ab.py [--kernel mxu|xor|xor3] OTHER.cu [OTHER.cu ...]

(``--kernel`` defaults to ``mxu``.)  The checkout's own source is
always one of the versions (``tree``); each other is named by its
file's stem, e.g. the source of a commit:

    git show REV:glusterfs_tpu_torch/csrc/gf256_kernels.cu > _archive/rev.cu

Every version must keep the kernel's C entry point (``gf256_mxu_apply``,
``gf256_xor_apply``, ``gf256_xor3_apply``).  All are built with ``nvcc``
at once (``-Xptxas -v`` gives the registers and spill bytes of each
instantiation of the kernel's body: ``mxu_apply<KS, MB>``, or for the
XOR kernels ``plane_xor`` and the plane-major ``xor_apply<2, 2, T>`` of
older versions), each is held byte-exact against ``mxu_apply_plain`` or
``xor_apply_plain`` at every shape, and each is timed as
``chip_smoke.py`` times a kernel, in order and then in reverse order at
every shape, so that a drift of the card shows as a spread between one
version's two times.  One JSON line per build and per shape, then the
card's name and power limit; exits non-zero on a failed build or a
mismatch.  Needs one card."""

from __future__ import annotations

import argparse
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
# (mangled-name pattern, key of its template arguments) of the kernel
# bodies whose ptxas lines are reported, per kernel
_BODIES = {
    "mxu": [(re.compile(r"mxu_applyILi(\d)ELi(\d)E"), "KS={},MB={}")],
    "xor": [(re.compile(r"plane_xorILi(\d+)ELi(\d+)E"), "RB={},STAGES={}"),
            (re.compile(r"plane_xorILi(\d+)E"), "RB={}"),
            (re.compile(r"plane_xorEPK"), "plane_xor"),
            (re.compile(r"xor_applyILi2ELi2ELi(\d+)E"), "T={}")],
}
_BODIES["xor3"] = _BODIES["xor"]


def _start(name: str, src: Path, out: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [gc._nvcc(), *gc.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out / f"lib{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _body_key(name: str, kernel: str) -> str | None:
    for pattern, key in _BODIES[kernel]:
        m = pattern.search(name)
        if m:
            return key.format(*m.groups())
    return None


def _resources(log: str, kernel: str) -> dict:
    """{"KS=..,MB=..": {"reg": n, "spill": bytes}} of each instantiation
    of the kernel's body in one ptxas log."""
    res, key = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            key = _body_key(m[1], kernel)
            continue
        if key is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill:
            res.setdefault(key, {})["spill"] = int(spill[1])
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            res.setdefault(key, {})["reg"] = int(regs[1])
            key = None
    return res


def build(sources: dict[str, Path], kernel: str) -> dict:
    out = gc.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: _start(name, src, out) for name, src in sources.items()}
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        print(json.dumps({"build": name, "rc": proc.returncode,
                          "kernel": kernel,
                          "resources": _resources(log, kernel)}), flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")),
                     f"gf256_{kernel}_apply")
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def compare(fns: dict, kernel: str) -> None:
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
            op = gc._operand(abits, kernel, x.device)
            want = (gc.mxu_apply_plain if kernel == "mxu"
                    else gc.xor_apply_plain)(abits, x)
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
            print(json.dumps({"kernel": kernel,
                              "shape": f"{k}+{r} {matrix}", "plane_w": w,
                              "ms": ms}), flush=True)
            del x, y, want
            torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("mxu", "xor", "xor3"),
                    default="mxu")
    ap.add_argument("sources", nargs="*", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_ab.py: no CUDA card", file=sys.stderr)
        return 1
    sources = {"tree": gc.SOURCE}
    for src in args.sources:
        sources[src.stem] = src.resolve()
    compare(build(sources, args.kernel), args.kernel)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
