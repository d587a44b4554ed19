"""Layer engine: the translator (xlator) stack, accelerator-build style.

The reference's xlator model (reference libglusterfs/src/xlator.c,
glusterfs/xlator.h:545,749) is a dlopen plugin tree where every fop is
propagated by continuation-passing ``STACK_WIND``/``STACK_UNWIND`` macros
(stack.h:283,346).  Here the same graph-of-layers architecture is expressed
idiomatically: a :class:`Layer` is a Python class registered by type name
("cluster/disperse", "storage/posix", ...); each fop is an async method;
winding is ``await child.fop(...)``; unwinding is the return value or a
raised :class:`FopError`.  The 59-fop default-passthrough boilerplate the
reference generates with generator.py:745 is installed by
``__init_subclass__``.

Lifecycle mirrors xlator_init/reconfigure/notify/fini (xlator.h:852-919):
graphs init bottom-up, events (CHILD_UP/DOWN...) propagate up by default.
Per-fop call/latency counters (xlator_t.stats, xlator.h:812-818) are kept
on every layer and exposed via statedump.
"""

from __future__ import annotations

import dataclasses
import enum
import errno as _errno
import time
from typing import Any, Callable, ClassVar

from .fops import Fop, FopError
from .iatt import Iatt
from .metrics import REGISTRY, LogHistogram
from .options import Option, validate_options
from . import gflog, tracing

log = gflog.get_logger("core")

# Per-fop latency histograms on every layer (io-stats
# `latency-measurement`, applied process-wide by IoStatsLayer
# init/reconfigure; GFTPU_NO_OBSERVABILITY pre-darkens subprocesses
# for the bench's metrics-off pair).  The count/avg/max accounting is
# NOT gated — it predates the histograms and `volume profile` always
# carried it.
import os as _os  # noqa: E402

HISTOGRAMS_ENABLED = _os.environ.get("GFTPU_NO_OBSERVABILITY", "") != "1"


class Event(enum.Enum):
    """Graph notifications (reference glusterfs.h GF_EVENT_*)."""

    PARENT_UP = "parent-up"
    PARENT_DOWN = "parent-down"
    CHILD_UP = "child-up"
    CHILD_DOWN = "child-down"
    CHILD_CONNECTING = "child-connecting"
    SOME_DESCENDENT_DOWN = "some-descendent-down"
    SOME_DESCENDENT_UP = "some-descendent-up"
    UPCALL = "upcall"
    TRANSLATOR_INFO = "translator-info"
    VOLFILE_MODIFIED = "volfile-modified"


@dataclasses.dataclass
class Loc:
    """A file location (reference loc_t): path plus resolved identity."""

    path: str
    gfid: bytes | None = None
    parent: bytes | None = None
    name: str | None = None

    def __post_init__(self):
        if self.name is None and self.path:
            self.name = self.path.rstrip("/").rsplit("/", 1)[-1] or "/"


class FdObj:
    """An open file handle flowing down the stack (reference fd_t): carries
    the inode identity plus per-layer private context slots."""

    __slots__ = ("gfid", "flags", "pid", "path", "anonymous", "_ctx")

    def __init__(self, gfid: bytes, flags: int = 0, pid: int = 0,
                 path: str = "", anonymous: bool = False):
        self.gfid = gfid
        self.flags = flags
        self.pid = pid
        self.path = path
        self.anonymous = anonymous
        self._ctx: dict[int, Any] = {}

    # per-layer ctx (reference fd_ctx_set/get keyed by xlator)
    def ctx_set(self, layer: "Layer", value: Any) -> None:
        self._ctx[id(layer)] = value

    def ctx_get(self, layer: "Layer", default: Any = None) -> Any:
        return self._ctx.get(id(layer), default)

    def ctx_del(self, layer: "Layer") -> Any:
        return self._ctx.pop(id(layer), None)


class _FopStats:
    __slots__ = ("count", "errors", "latency_sum", "latency_max", "hist")

    def __init__(self):
        self.count = 0
        self.errors = 0
        self.latency_sum = 0.0
        self.latency_max = 0.0
        # preallocated log2 buckets: the record path is two int ops and
        # a list increment — nothing allocates per fop
        self.hist = LogHistogram()

    def to_dict(self) -> dict:
        out = {
            "count": self.count, "errors": self.errors,
            "latency_avg": self.latency_sum / self.count if self.count else 0.0,
            "latency_max": self.latency_max,
        }
        if self.hist.total:
            # percentiles are DERIVED on read (profile/statedump/.meta
            # are cold paths); conservative bucket upper bounds
            out["latency_p50"] = self.hist.percentile(50)
            out["latency_p90"] = self.hist.percentile(90)
            out["latency_p99"] = self.hist.percentile(99)
        return out


def _timed(op_name: str, fn: Callable) -> Callable:
    """Wrap a fop coroutine with per-layer count/latency accounting."""

    async def wrapper(self, *args, **kwargs):
        st = self.stats.setdefault(op_name, _FopStats())
        # span bracket: the outermost timed call on a graph mints the
        # trace id, nested layers join it (core/tracing.py); one gate
        # check keeps the dark path at a single global read
        span = tracing.enter(self.name, op_name) if tracing.ENABLED \
            else None
        err = False
        t0 = time.perf_counter()
        try:
            return await fn(self, *args, **kwargs)
        except FopError:
            st.errors += 1
            err = True
            raise
        finally:
            dt = time.perf_counter() - t0
            st.count += 1
            st.latency_sum += dt
            if dt > st.latency_max:
                st.latency_max = dt
            if HISTOGRAMS_ENABLED:
                st.hist.record(dt)
            if span is not None:
                tracing.exit_span(span, dt, err)

    wrapper.__name__ = fn.__name__
    wrapper.__qualname__ = fn.__qualname__
    wrapper.__doc__ = fn.__doc__
    # keep the real signature reachable: inspect.signature follows
    # __wrapped__, and virtfs.extract_xdata needs the true parameter
    # list to find a caller's xdata (else identity-gated layers above
    # a timed fop silently skip their checks)
    wrapper.__wrapped__ = fn  # type: ignore[attr-defined]
    wrapper._gf_timed = True  # type: ignore[attr-defined]
    return wrapper


def _make_default(op_name: str) -> Callable:
    """Default fop: wind to the first child (reference defaults-tmpl.c)."""

    async def default(self, *args, **kwargs):
        if not self.children:
            raise FopError(_errno.EOPNOTSUPP,
                           f"{self.name}: no child to wind {op_name}")
        return await getattr(self.children[0], op_name)(*args, **kwargs)

    default.__name__ = op_name
    default.__doc__ = f"Default {op_name}: pass through to first child."
    # rpc/compound.py keys chain transparency off this mark: a layer
    # serving a fop with the generated default adds no behavior to it
    default._gf_default = True  # type: ignore[attr-defined]
    return default


def walk(root: "Layer"):
    """Yield ``root`` and every descendant exactly once (cycle-safe DFS)
    — the graph-traversal primitive behind hook injection (io-threads
    executor, upcall sink) and per-client cleanup."""
    stack, seen = [root], set()
    while stack:
        layer = stack.pop()
        if id(layer) in seen:
            continue
        seen.add(id(layer))
        yield layer
        stack.extend(layer.children)


# Live-layer fop accounting families (ISSUE 20): the per-layer
# count/error counters _timed already maintains, aggregated by
# (layer-name, op) across live instances — the SLO engine's error-ratio
# source (errors/total over a history window).  Aggregation collapses
# same-named layers from sibling graphs in one process (a test mounting
# three "c0" clients) into one monotonic series instead of three
# colliding label sets.
import weakref as _weakref  # noqa: E402 - after the class machinery above

_LIVE_LAYERS: "_weakref.WeakSet" = _weakref.WeakSet()


def _fop_samples(attr: str) -> list:
    agg: dict[tuple[str, str], int] = {}
    for layer in list(_LIVE_LAYERS):
        for op, st in list(layer.stats.items()):
            v = getattr(st, attr)
            if v:
                key = (layer.name, op)
                agg[key] = agg.get(key, 0) + v
    return [({"layer": ln, "op": op}, v)
            for (ln, op), v in sorted(agg.items())]


REGISTRY.register(
    "gftpu_fops_total", "counter",
    "fop dispatches per live layer instance (aggregated by name)",
    lambda: _fop_samples("count"))
REGISTRY.register(
    "gftpu_fop_errors_total", "counter",
    "fop failures (FopError) per live layer instance",
    lambda: _fop_samples("errors"))


# Registry of layer types: "cluster/disperse" -> class (the dlopen analog,
# reference xlator_dynload xlator.c:369).
_REGISTRY: dict[str, type["Layer"]] = {}


def register(type_name: str):
    def deco(cls):
        cls.type_name = type_name
        _REGISTRY[type_name] = cls
        return cls
    return deco


# type-name -> module path overrides (where the module name differs from
# the type suffix); everything else resolves by convention.
_TYPE_MODULES = {
    "cluster/disperse": "glusterfs_tpu_torch.cluster.ec",
}


def lookup_type(type_name: str) -> type["Layer"]:
    """Resolve a type name, importing its module on demand (the dlopen
    analog: the reference resolves 'cluster/disperse' to ec.so and dlsym's
    xlator_api; we import glusterfs_tpu_torch.<category>.<name> and expect a
    @register decoration at module scope)."""
    if type_name not in _REGISTRY:
        import importlib

        mod = _TYPE_MODULES.get(type_name)
        if mod is None and "/" in type_name:
            category, _, leaf = type_name.partition("/")
            mod = f"glusterfs_tpu_torch.{category}.{leaf.replace('-', '_')}"
        if mod is not None:
            try:
                importlib.import_module(mod)
            except ImportError:
                pass
    try:
        return _REGISTRY[type_name]
    except KeyError:
        raise ValueError(f"unknown layer type {type_name!r} "
                         f"(known: {sorted(_REGISTRY)})") from None


class Layer:
    """Base translator layer."""

    type_name: ClassVar[str] = "abstract"
    OPTIONS: ClassVar[tuple[Option, ...]] = ()

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        for fop in Fop:
            meth = getattr(cls, fop.value, None)
            if meth is None:
                setattr(cls, fop.value, _timed(fop.value,
                                               _make_default(fop.value)))
            elif not getattr(meth, "_gf_timed", False) and \
                    fop.value in cls.__dict__:
                setattr(cls, fop.value, _timed(fop.value, meth))

    def __init__(self, name: str, options: dict | None = None,
                 children: list["Layer"] | None = None, ctx: Any = None):
        self.name = name
        self.children: list[Layer] = children or []
        self.parents: list[Layer] = []
        for c in self.children:
            c.parents.append(self)
        self.ctx = ctx
        self.opts = validate_options(self.OPTIONS, options or {})
        self.stats: dict[str, _FopStats] = {}
        self.initialized = False
        _LIVE_LAYERS.add(self)

    # -- lifecycle ---------------------------------------------------------

    async def init(self) -> None:
        """Called bottom-up after construction (xlator init)."""
        self.initialized = True

    async def fini(self) -> None:
        """Called top-down at teardown (xlator fini)."""
        self.initialized = False

    def reconfigure(self, options: dict) -> None:
        """Apply new option values at runtime (xlator reconfigure)."""
        self.opts.update(validate_options(self.OPTIONS, options))

    def notify(self, event: Event, source: "Layer | None" = None,
               data: Any = None) -> None:
        """Default: propagate up to all parents (reference default_notify)."""
        for p in self.parents:
            p.notify(event, self, data)

    async def release(self, fd: "FdObj") -> None:
        """Close a file handle (not a wire fop in the reference either —
        fd_destroy cascades through the graph); default: pass down."""
        if self.children:
            rel = getattr(self.children[0], "release", None)
            if rel is not None:
                await rel(fd)

    async def compound(self, links, xdata: dict | None = None) -> list:
        """Compound fop (rpc/compound.py): forward the chain intact when
        this layer adds no behavior to any fop it contains, otherwise
        decompose — each link then runs through this layer's own fop
        methods, preserving its exact per-fop semantics.  Returns the
        per-link reply vector (never raises for link failures)."""
        from ..rpc import compound as _compound

        if self.children and _compound.transparent_for(type(self), links):
            return await self.children[0].compound(links, xdata)
        return await _compound.decompose(self, links, xdata)

    # -- introspection -----------------------------------------------------

    def dump_private(self) -> dict:
        """Layer-specific state for statedump (xlator dumpops priv)."""
        return {}

    def statedump(self) -> dict:
        return {
            "name": self.name,
            "type": self.type_name,
            "options": {k: (v.hex() if isinstance(v, bytes) else v)
                        for k, v in self.opts.items()},
            "stats": {op: st.to_dict() for op, st in self.stats.items()},
            "private": self.dump_private(),
            "subvolumes": [c.name for c in self.children],
        }


# Install timed defaults on the base class itself.
for _fop in Fop:
    if not hasattr(Layer, _fop.value):
        setattr(Layer, _fop.value, _timed(_fop.value, _make_default(_fop.value)))


__all__ = [
    "Layer", "Loc", "FdObj", "Event", "Fop", "FopError", "Iatt",
    "register", "lookup_type", "walk",
]
