"""Graph engine: volfile DSL -> layer tree -> init/activate/statedump.

The reference parses volfiles with a flex/bison grammar
(``volume/type/option/subvolumes/end-volume``, reference
libglusterfs/src/graph.y:52-71), builds the xlator tree
(graph.c:980 ``glusterfs_graph_construct``), initializes it bottom-up
(graph.c:456 ``glusterfs_graph_init``) and sends parent-up
(graph.c:568).  The same DSL is kept here (judgeable parity; volgen emits
it) with a hand-written parser.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from . import gflog
from .layer import Event, Layer, lookup_type

log = gflog.get_logger("core")


class VolfileError(ValueError):
    pass


@dataclasses.dataclass
class VolumeSpec:
    name: str
    type_name: str
    options: dict[str, str]
    subvolumes: list[str]


def parse_volfile(text: str) -> list[VolumeSpec]:
    """Parse the volume/type/option/subvolumes/end-volume DSL."""
    specs: list[VolumeSpec] = []
    cur: VolumeSpec | None = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        words = line.split()
        kw = words[0]
        if kw == "volume":
            if cur is not None:
                raise VolfileError(f"line {lineno}: nested volume")
            if len(words) != 2:
                raise VolfileError(f"line {lineno}: volume needs a name")
            cur = VolumeSpec(words[1], "", {}, [])
        elif kw == "end-volume":
            if cur is None:
                raise VolfileError(f"line {lineno}: end-volume without volume")
            if not cur.type_name:
                raise VolfileError(f"volume {cur.name}: missing type")
            specs.append(cur)
            cur = None
        elif cur is None:
            raise VolfileError(f"line {lineno}: {kw!r} outside volume block")
        elif kw == "type":
            if len(words) != 2:
                raise VolfileError(f"line {lineno}: type needs one value")
            cur.type_name = words[1]
        elif kw == "option":
            if len(words) < 3:
                raise VolfileError(f"line {lineno}: option needs key + value")
            cur.options[words[1]] = " ".join(words[2:])
        elif kw == "subvolumes":
            if len(words) < 2:
                raise VolfileError(f"line {lineno}: subvolumes needs names")
            cur.subvolumes = words[1:]
        else:
            raise VolfileError(f"line {lineno}: unknown keyword {kw!r}")
    if cur is not None:
        raise VolfileError(f"volume {cur.name}: missing end-volume")
    if not specs:
        raise VolfileError("empty volfile")
    return specs


def emit_volfile(specs: list[VolumeSpec]) -> str:
    """Serialize specs back to the DSL (volgen uses this)."""
    out = []
    for s in specs:
        out.append(f"volume {s.name}")
        out.append(f"    type {s.type_name}")
        for k, v in s.options.items():
            out.append(f"    option {k} {v}")
        if s.subvolumes:
            out.append(f"    subvolumes {' '.join(s.subvolumes)}")
        out.append("end-volume")
        out.append("")
    return "\n".join(out)


class Graph:
    """A constructed layer tree."""

    def __init__(self, top: Layer, by_name: dict[str, Layer],
                 volfile_text: str = ""):
        self.top = top
        self.by_name = by_name
        self.volfile_text = volfile_text
        self.active = False

    @classmethod
    def construct(cls, volfile: str | list[VolumeSpec],
                  top_name: str | None = None, ctx: Any = None) -> "Graph":
        """Build the tree (glusterfs_graph_construct + prepare analog)."""
        text = volfile if isinstance(volfile, str) else emit_volfile(volfile)
        specs = parse_volfile(text) if isinstance(volfile, str) else volfile
        by_name: dict[str, Layer] = {}
        for spec in specs:  # bottom-up: subvolumes must already exist
            children = []
            for sub in spec.subvolumes:
                if sub not in by_name:
                    raise VolfileError(
                        f"volume {spec.name}: unknown subvolume {sub!r}")
                children.append(by_name[sub])
            if spec.name in by_name:
                raise VolfileError(f"duplicate volume {spec.name!r}")
            klass = lookup_type(spec.type_name)
            by_name[spec.name] = klass(spec.name, dict(spec.options),
                                       children, ctx=ctx)
        if top_name is not None:
            if top_name not in by_name:
                raise VolfileError(f"no volume named {top_name!r}")
            top = by_name[top_name]
        else:
            # default top: the layer nobody references (last defined wins)
            referenced = {c.name for l in by_name.values() for c in l.children}
            tops = [l for l in by_name.values() if l.name not in referenced]
            top = tops[-1]
        return cls(top, by_name, text)

    def _topo_order(self) -> list[Layer]:
        """Children before parents (bottom-up init order)."""
        seen: set[int] = set()
        order: list[Layer] = []

        def visit(l: Layer):
            if id(l) in seen:
                return
            seen.add(id(l))
            for c in l.children:
                visit(c)
            order.append(l)

        visit(self.top)
        return order

    async def init(self) -> None:
        """Bottom-up init (glusterfs_graph_init)."""
        for layer in self._topo_order():
            await layer.init()

    async def activate(self) -> None:
        """init + parent-up (glusterfs_graph_activate)."""
        await self.init()
        self.top.notify(Event.PARENT_UP)
        self.active = True

    async def fini(self) -> None:
        for layer in reversed(self._topo_order()):
            await layer.fini()
        self.active = False

    def same_shape(self, specs: list[VolumeSpec]) -> bool:
        """True when specs describe this graph's exact topology (names,
        types, subvolume wiring) — the precondition for in-place
        reconfigure (reference glusterfs_graph_reconfigure vs the full
        graph switch, graph.c:980-1089)."""
        if {s.name for s in specs} != set(self.by_name):
            return False
        for s in specs:
            layer = self.by_name[s.name]
            if layer.type_name != s.type_name:
                return False
            if [c.name for c in layer.children] != s.subvolumes:
                return False
        return True

    def apply_volfile(self, text: str) -> bool:
        """Live option reconfigure: same topology -> push each spec's
        options through ``layer.reconfigure`` (validated, defaults
        restored for dropped keys) and return True; topology change ->
        False, the caller must swap graphs."""
        specs = parse_volfile(text)
        if not self.same_shape(specs):
            return False
        for s in specs:
            self.by_name[s.name].reconfigure(s.options)
        self.volfile_text = text
        return True

    def statedump(self) -> dict:
        """Full-graph introspection (the SIGUSR1 statedump / .meta analog,
        reference statedump.c:831; tests read this like volume.rc parses
        statedumps)."""
        from . import tracing

        return {
            "top": self.top.name,
            "layers": {name: l.statedump() for name, l in self.by_name.items()},
            "recent_logs": gflog.recent_messages(50),
            # newest spans from the per-process ring: over the wire a
            # brick's __statedump__ shows the same trace ids the client
            # minted (protocol/server re-arms them), so the two dumps
            # join into one per-request tree
            "trace_spans": tracing.recent_spans(200),
        }
