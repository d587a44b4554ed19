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


def _emit(name: str, type_name: str, options: dict, subvols: list) -> str:
    out = [f"volume {name}", f"    type {type_name}"]
    out += [f"    option {k} {v}" for k, v in options.items()]
    if subvols:
        out.append(f"    subvolumes {' '.join(subvols)}")
    out.append("end-volume\n")
    return "\n".join(out)


#: the default brick stack, bottom up: (volume-name suffix, type)
BRICK_STACK = (("-posix", "storage/posix"), ("-locks", "features/locks"),
               ("-index", "features/index"), ("-upcall", "features/upcall"),
               ("-io-threads", "performance/io-threads"),
               ("-barrier", "features/barrier"), ("", "debug/io-stats"),
               ("-server", "protocol/server"))


def brick_volfile(name: str, directory, options: dict | None = None) -> str:
    """The brick volfile of a managed volume: storage/posix -> locks ->
    index -> upcall -> io-threads -> barrier -> io-stats ->
    protocol/server, each layer at its default options unless
    ``options`` ({type: {option: value}}) sets some.  The layers are
    named ``<name>-posix`` ... ``<name>`` (io-stats, what clients name
    as remote-subvolume) and ``<name>-server``.

    Source: the JAX package's ``mgmt/volgen.py`` ``build_brick_volfile``
    (:925-1073) with every optional layer off, itself the reference's
    ``server_graph_table`` order (glusterd-volgen.c); the same text for
    the same inputs."""
    options = options or {}
    out, prev = [], []
    for suffix, ltype in BRICK_STACK:
        opts = ({"directory": directory} if ltype == "storage/posix"
                else {})
        opts.update(options.get(ltype, {}))
        out.append(_emit(name + suffix, ltype, opts, prev))
        prev = [name + suffix]
    return "\n".join(out)


def client_volfile(name: str, ports: list[int], redundancy: int,
                   options: dict | None = None, *,
                   host: str = "127.0.0.1",
                   group_size: int | None = None) -> str:
    """The client volfile over served bricks: one protocol/client per
    brick (``<name>-client-<i>``, remote-subvolume ``<name>-brick-<i>``,
    the :func:`brick_volfile` name), a cluster/disperse of redundancy
    ``redundancy`` over each ``group_size`` of them (default: all) with
    ``options``, and a cluster/distribute on top when there are several
    groups.

    Source: ``tests/harness.py`` ``Cluster.client_volfile`` (:91-110)
    for the shape and the JAX package's ``mgmt/volgen.py``
    ``build_client_volfile`` for the names."""
    group = group_size or len(ports)
    out, names = [], []
    for i, port in enumerate(ports):
        cname = f"{name}-client-{i}"
        out.append(_emit(cname, "protocol/client",
                         {"remote-host": host, "remote-port": port,
                          "remote-subvolume": f"{name}-brick-{i}"}, []))
        names.append(cname)
    groups = []
    for g in range(0, len(names), group):
        gname = f"{name}-disperse-{g // group}"
        out.append(_emit(gname, "cluster/disperse",
                         {"redundancy": redundancy, **(options or {})},
                         names[g:g + group]))
        groups.append(gname)
    if len(groups) > 1:
        out.append(_emit(f"{name}-dht", "cluster/distribute", {}, groups))
    return "\n".join(out)
