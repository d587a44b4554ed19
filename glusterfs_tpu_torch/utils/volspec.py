"""Volfile-spec builders shared by benches and tests.

The analog of the reference's volgen templates for the common shapes
(reference xlators/mgmt/glusterd/src/glusterd-volgen.c); tests and
bench.py previously each hand-rolled the same brick+disperse string.
"""

from __future__ import annotations


def brick_volumes(base, n: int, layers: list[tuple[str, dict]] | None = None,
                  name: str = "b") -> tuple[list[str], list[str]]:
    """N posix bricks under ``base``; each optionally wrapped bottom-up by
    ``layers`` [(type, options), ...].  The top volume of brick i is named
    ``<name><i>``.  Returns (volfile chunks, top names)."""
    out, tops = [], []
    layers = list(layers or [])
    for i in range(n):
        stack = [("storage/posix", {"directory": f"{base}/brick{i}"})] + layers
        prev = None
        for j, (ltype, opts) in enumerate(stack):
            vname = f"{name}{i}" if j == len(stack) - 1 else f"{name}{i}_{j}"
            body = "".join(f"    option {k} {v}\n" for k, v in opts.items())
            subs = f"    subvolumes {prev}\n" if prev else ""
            out.append(f"volume {vname}\n    type {ltype}\n{body}{subs}"
                       f"end-volume\n")
            prev = vname
        tops.append(prev)
    return out, tops


def ec_volfile(base, n: int, r: int, options: dict | None = None,
               brick_layers: list[tuple[str, dict]] | None = None,
               top: str = "disp", groups: int = 1) -> str:
    """A disperse (n = k+r) volume over n local posix bricks; with
    ``groups`` > 1, a distributed-disperse volume of ``groups``
    (n, r) groups under a dht top (the 2x(4+2) bench shape)."""
    chunks, tops = brick_volumes(base, n * groups, brick_layers)
    body = "".join(f"    option {k} {v}\n"
                   for k, v in (options or {}).items())
    if groups == 1:
        chunks.append(f"volume {top}\n    type cluster/disperse\n"
                      f"    option redundancy {r}\n{body}"
                      f"    subvolumes {' '.join(tops)}\nend-volume\n")
    else:
        subs = []
        for g in range(groups):
            gname = f"{top}-g{g}"
            gt = tops[g * n:(g + 1) * n]
            chunks.append(f"volume {gname}\n    type cluster/disperse\n"
                          f"    option redundancy {r}\n{body}"
                          f"    subvolumes {' '.join(gt)}\nend-volume\n")
            subs.append(gname)
        chunks.append(f"volume {top}\n    type cluster/distribute\n"
                      f"    subvolumes {' '.join(subs)}\nend-volume\n")
    return "\n".join(chunks)
