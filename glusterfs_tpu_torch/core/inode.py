"""Inode & dentry table: GFID-keyed identity cache with LRU.

Reference: libglusterfs/src/inode.c (inode_table_new/inode_link,
inode.c:983,1098,1564-1605) — a per-graph table mapping GFID -> inode with
a dentry hash ((parent gfid, basename) -> inode) and an LRU of unreferenced
inodes.  Per-layer inode ctx slots mirror inode_ctx_set/get.
"""

from __future__ import annotations

import collections
import threading
from typing import Any

from .iatt import IAType, Iatt, ROOT_GFID


class Inode:
    __slots__ = ("gfid", "ia_type", "table", "nlookup", "_ctx", "iatt")

    def __init__(self, gfid: bytes, ia_type: IAType, table: "InodeTable"):
        self.gfid = gfid
        self.ia_type = ia_type
        self.table = table
        self.nlookup = 0
        self.iatt: Iatt | None = None
        self._ctx: dict[int, Any] = {}

    def ctx_set(self, layer, value: Any) -> None:
        self._ctx[id(layer)] = value

    def ctx_get(self, layer, default: Any = None) -> Any:
        return self._ctx.get(id(layer), default)

    def ctx_del(self, layer) -> Any:
        return self._ctx.pop(id(layer), None)

    def is_dir(self) -> bool:
        return self.ia_type is IAType.DIR


class InodeTable:
    def __init__(self, lru_limit: int = 16384):
        self._lock = threading.RLock()
        self._by_gfid: dict[bytes, Inode] = {}
        self._dentries: dict[tuple[bytes, str], bytes] = {}
        self._rdentries: dict[bytes, set[tuple[bytes, str]]] = {}
        self._lru: collections.OrderedDict[bytes, None] = collections.OrderedDict()
        self.lru_limit = lru_limit
        self.root = self._new(ROOT_GFID, IAType.DIR)
        self.root.nlookup = 1  # root is pinned

    def _new(self, gfid: bytes, ia_type: IAType) -> Inode:
        ino = Inode(gfid, ia_type, self)
        self._by_gfid[gfid] = ino
        return ino

    def get(self, gfid: bytes) -> Inode | None:
        with self._lock:
            ino = self._by_gfid.get(gfid)
            if ino is not None and gfid in self._lru:
                self._lru.move_to_end(gfid)
            return ino

    def find_dentry(self, parent: bytes, name: str) -> Inode | None:
        with self._lock:
            gfid = self._dentries.get((parent, name))
            return self._by_gfid.get(gfid) if gfid else None

    def link(self, parent: bytes, name: str, gfid: bytes,
             ia_type: IAType, iatt: Iatt | None = None) -> Inode:
        """Record identity + dentry after a successful lookup/create
        (reference __inode_link, inode.c:983)."""
        with self._lock:
            ino = self._by_gfid.get(gfid)
            if ino is None:
                ino = self._new(gfid, ia_type)
            ino.nlookup += 1
            if iatt is not None:
                ino.iatt = iatt
            key = (parent, name)
            old = self._dentries.get(key)
            if old is not None and old != gfid:
                self._rdentries.get(old, set()).discard(key)
            self._dentries[key] = gfid
            self._rdentries.setdefault(gfid, set()).add(key)
            self._lru.pop(gfid, None)
            return ino

    def unlink(self, parent: bytes, name: str) -> None:
        with self._lock:
            key = (parent, name)
            gfid = self._dentries.pop(key, None)
            if gfid is not None:
                self._rdentries.get(gfid, set()).discard(key)

    def forget(self, gfid: bytes, nlookup: int = 1) -> None:
        """Drop lookups; unreferenced inodes go to the LRU (inode.c lru)."""
        with self._lock:
            ino = self._by_gfid.get(gfid)
            if ino is None or gfid == ROOT_GFID:
                return
            ino.nlookup = max(0, ino.nlookup - nlookup)
            if ino.nlookup == 0:
                self._lru[gfid] = None
                self._lru.move_to_end(gfid)
                while len(self._lru) > self.lru_limit:
                    evict, _ = self._lru.popitem(last=False)
                    self._purge(evict)

    def _purge(self, gfid: bytes) -> None:
        self._by_gfid.pop(gfid, None)
        for key in self._rdentries.pop(gfid, set()):
            self._dentries.pop(key, None)

    def invalidate(self, gfid: bytes) -> None:
        """Forcibly drop an inode + its dentries (upcall invalidation)."""
        with self._lock:
            self._lru.pop(gfid, None)
            if gfid != ROOT_GFID:
                self._purge(gfid)

    def dump(self) -> dict:
        with self._lock:
            # active = referenced (nlookup > 0) inodes; everything in
            # the LRU is by construction unreferenced (the reference's
            # itable dump splits active/lru the same way, inode.c
            # inode_table_dump)
            return {
                "inodes": len(self._by_gfid),
                "active": len(self._by_gfid) - len(self._lru),
                "dentries": len(self._dentries),
                "lru": len(self._lru),
                "lru_limit": self.lru_limit,
            }
