"""features/barrier — quiesce mutating fops for snapshots.

Reference: xlators/features/barrier/src/barrier.c:104-256: when enabled
(by glusterd around a snapshot), the brick holds every acknowledgement-
class fop in a queue; disable (or the barrier timeout) releases them.
The snapshot then captures a store that no in-flight mutation is
touching.

Here the gate is an asyncio.Event awaited by every WRITE fop before it
winds; flipping the ``barrier`` option through live reconfigure arms or
releases it, and ``barrier-timeout`` auto-releases a forgotten barrier
(barrier.c barrier_timeout semantics).
"""

from __future__ import annotations

import asyncio
import time

from ..core.fops import Fop, WRITE_FOPS
from ..core.layer import Layer, register
from ..core.options import Option
from ..core import gflog

log = gflog.get_logger("barrier")

# The gated classes: everything that mutates, plus fsync — EXCEPT the
# xattrop settle ops.  The reference barriers only un-redoable acks
# (barrier.c fops table) because its snapshot device (LVM) is atomic;
# our snapshot is a store COPY, so data mutations must quiesce.  But
# the eager-window settle wave (xattrop post-op + compound unlock) must
# flow THROUGH an armed barrier: the snapshot path first fires
# contention upcalls so clients commit their delayed post-ops
# (_quiesce_client_locks), and that commit would otherwise park on the
# very barrier waiting for it.  xattrop is absent from the reference's
# barrier set too.
_GATED = (WRITE_FOPS | {Fop.FSYNC, Fop.FSYNCDIR}) \
    - {Fop.XATTROP, Fop.FXATTROP}
_GATED_NAMES = {f.value for f in _GATED}


@register("features/barrier")
class BarrierLayer(Layer):
    OPTIONS = (
        Option("barrier", "bool", default="off"),
        Option("barrier-timeout", "time", default="120"),
    )

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._release: asyncio.Event | None = None
        self._armed_at = 0.0
        self.held_peak = 0
        self._held = 0
        self._inflight = 0  # gated fops past the gate, still executing
        if self.opts["barrier"]:  # volfile arrived with barrier=on
            self._arm()

    def _armed(self) -> bool:
        return self._release is not None and not self._release.is_set()

    def _arm(self) -> None:
        self._release = asyncio.Event()
        self._armed_at = time.monotonic()
        log.info(2, "%s: barrier armed (timeout %.0fs)", self.name,
                 self.opts["barrier-timeout"])

    def reconfigure(self, options: dict) -> None:
        super().reconfigure(options)
        now = self.opts["barrier"]
        if self._armed() and not now:
            self._release.set()
            log.info(1, "%s: barrier released", self.name)
        elif now and not self._armed():
            self._arm()

    async def _gate(self) -> None:
        if not self.opts["barrier"] or self._release is None:
            return
        left = self.opts["barrier-timeout"] - (time.monotonic()
                                               - self._armed_at)
        self._held += 1
        self.held_peak = max(self.held_peak, self._held)
        try:
            if left > 0:
                try:
                    await asyncio.wait_for(
                        asyncio.shield(self._release.wait()), left)
                    return
                except asyncio.TimeoutError:
                    pass
            # timeout: a forgotten barrier must not wedge the brick
            log.warning(3, "%s: barrier timed out, auto-releasing",
                        self.name)
            self.opts["barrier"] = False
            self._release.set()
        finally:
            self._held -= 1

    async def compound(self, links, xdata: dict | None = None) -> list:
        """A chain carrying any gated fop waits at the barrier ONCE as a
        unit, then forwards intact — identical quiesce semantics to its
        links arriving singly (all-or-nothing past the gate), and the
        in-flight count covers the whole chain so a snapshot still
        waits for it."""
        if any(f in _GATED_NAMES for f, _a, _k in links):
            await self._gate()
            self._inflight += 1
            try:
                return await self.children[0].compound(links, xdata)
            finally:
                self._inflight -= 1
        return await self.children[0].compound(links, xdata)

    def dump_private(self) -> dict:
        return {"barrier": self.opts["barrier"], "held": self._held,
                "held_peak": self.held_peak, "inflight": self._inflight}


def _gated_fop(fop: Fop):
    name = fop.value

    async def impl(self, *args, **kwargs):
        await self._gate()
        self._inflight += 1
        try:
            return await getattr(self.children[0], name)(*args, **kwargs)
        finally:
            self._inflight -= 1

    impl.__name__ = name
    return impl


for _f in _GATED:
    setattr(BarrierLayer, _f.value, _gated_fop(_f))

