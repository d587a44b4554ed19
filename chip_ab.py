"""Time one codec kernel as built from several versions of
``glusterfs_tpu_torch/csrc/gf256_kernels.cu`` on one card: a plane-major
kernel (``mxu_apply``, ``xor_apply`` or ``xor3_apply``) at the six
plane-major shapes that ``chip_smoke.py`` times (4+2, 8+4 and 16+4, the
encode matrix and a decode mask, 256 MiB of plane data), or the four
fused kernels (``fused``) at 4+2, 8+4 and 16+4 on 256 MiB of stripes:

    python3 chip_ab.py [--kernel mxu|xor|xor3|fused] OTHER.cu [OTHER.cu ...]

(``--kernel`` defaults to ``mxu``.)  The checkout's own source is
always one of the versions (``tree``); each other is named by its
file's stem, e.g. the source of a commit:

    git show REV:glusterfs_tpu_torch/csrc/gf256_kernels.cu > _archive/rev.cu

Every version must keep the kernels' C entry points (``gf256_mxu_apply``,
``gf256_xor_apply``, ``gf256_xor3_apply``, ``gf256_fused_*``).  All are
built with ``nvcc`` at once (``-Xptxas -v`` gives the registers and
spill bytes of each instantiation of the kernel's body: ``mxu_apply<KS,
MB>``, or for the XOR kernels ``layout_xor<RB>`` and the ``plane_xor``
and ``xor_apply<IN, OUT, T>`` of older versions), each is held
byte-exact against its plain version at every shape, and each is timed
as ``chip_smoke.py`` times a kernel, in order and then in reverse order
at every shape, so that a drift of the card shows as a spread between
one version's two times.  One JSON line per build and per shape (the
fused lines with their bound), then the card's name and power limit;
exits non-zero on a failed build or a mismatch.  Needs one card."""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from glusterfs_tpu_torch.ops import gf256_cuda as gc

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
# (mangled-name pattern, key of its template arguments) of the kernel
# bodies whose ptxas lines are reported, per kernel
_BODIES = {
    "mxu": [(re.compile(r"mxu_applyILi(\d)ELi(\d)E"), "KS={},MB={}")],
    "xor": [(re.compile(r"layout_xorILi(\d+)E"), "RB={}"),
            (re.compile(r"plane_xorILi(\d+)ELi(\d+)E"), "RB={},STAGES={}"),
            (re.compile(r"plane_xorILi(\d+)E"), "RB={}"),
            (re.compile(r"plane_xorEPK"), "plane_xor"),
            (re.compile(r"xor_applyILi(\d)ELi(\d)ELi(\d+)E"),
             "IN={},OUT={},T={}")],
}
_BODIES["xor3"] = _BODIES["fused"] = _BODIES["xor"]
# the C entry points each --kernel times
_ENTRIES = {"mxu": ("mxu_apply",), "xor": ("xor_apply",),
            "xor3": ("xor3_apply",), "fused": gc.FUSED}


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
    t0 = time.perf_counter()
    procs = {name: _start(name, src, out) for name, src in sources.items()}
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        # the builds run side by side, so each time is an upper bound
        print(json.dumps({"build": name, "rc": proc.returncode,
                          "kernel": kernel,
                          "build_s": time.perf_counter() - t0,
                          "resources": _resources(log, kernel)}), flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        vp = ctypes.c_void_p
        fns[name] = {}
        for entry in _ENTRIES[kernel]:
            fn = getattr(lib, f"gf256_{entry}")
            fn.argtypes = [vp, vp, vp, ctypes.c_int64, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, vp]
            fn.restype = ctypes.c_int
            fns[name][entry] = fn
    return fns


def _timed(fns: dict, entry: str, x: torch.Tensor, y: torch.Tensor,
           op: torch.Tensor, extent: int, c: int, rows: int,
           want: torch.Tensor, what: str) -> dict:
    """{version: [ms in order, ms reversed]} of one C entry point, each
    version first held byte-exact against ``want``."""
    stream = torch.cuda.current_stream().cuda_stream
    ms = {}
    for name in list(fns) + list(fns)[::-1]:
        def call(fn=fns[name][entry]):
            err = fn(x.data_ptr(), y.data_ptr(), op.data_ptr(), extent, c,
                     rows, 0, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        y.zero_()
        call()
        torch.cuda.synchronize()
        if not torch.equal(y, want):
            raise AssertionError(f"{name} {entry} differs from the plain "
                                 f"version at {what}")
        ms.setdefault(name, []).append(cs.time_ms(call, 10))
    return ms


def compare(fns: dict, kernel: str) -> None:
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
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
            ms = _timed(fns, f"{kernel}_apply", x, y, op, w, c, rows, want,
                        f"{k}+{r} {matrix}")
            print(json.dumps({"kernel": kernel,
                              "shape": f"{k}+{r} {matrix}", "plane_w": w,
                              "ms": ms}), flush=True)
            del x, y, want
            torch.cuda.empty_cache()


def compare_fused(fns: dict) -> None:
    """The four fused entry points at 4+2, 8+4 and 16+4 on 256 MiB of
    stripes (the last k fragments survive; reconstruct wants the first r
    data rows), as ``chip_smoke.py`` checks them, with their bounds."""
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    ops_s = cs.peak_ops_s()
    for k, r in cs.CONFIGS:
        n = k + r
        s = cs.PLANE_BYTES // (k * 512)
        rows, wanted = tuple(range(r, n)), tuple(range(r))
        for entry in gc.FUSED:
            _, plain, x, abits = cs._case(g, entry, k, r, s, rows, wanted)
            want = plain()
            y = torch.empty_like(want)
            op = gc._operand(abits, "xor", x.device)
            ms = _timed(fns, entry, x, y, op, s, k * 8, abits.shape[0],
                        want, f"{k}+{r}")
            nbytes = x.numel() + y.numel()
            bytes_ms = nbytes / cs.PEAK_BYTES_S * 1e3
            ops_ms = cs.xor_ops_ms(abits, s, ops_s)
            print(json.dumps({
                "kernel": entry, "shape": f"{k}+{r}", "stripes": s,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "ms": ms}), flush=True)
            del x, y, want
            torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=tuple(_ENTRIES), default="mxu")
    ap.add_argument("sources", nargs="*", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_ab.py: no CUDA card", file=sys.stderr)
        return 1
    sources = {"tree": gc.SOURCE}
    for src in args.sources:
        sources[src.stem] = src.resolve()
    fns = build(sources, args.kernel)
    if args.kernel == "fused":
        compare_fused(fns)
    else:
        compare(fns, args.kernel)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
