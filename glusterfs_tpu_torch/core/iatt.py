"""Inode attributes (stat) — the wire/stack representation of file metadata.

Reference: ``gf_iatt`` in rpc/xdr/src/glusterfs4-xdr.x:31 and
libglusterfs/src/glusterfs/iatt.h.  GFIDs are uuid4 bytes; ia_type uses the
same file-type vocabulary.
"""

from __future__ import annotations

import dataclasses
import enum
import stat as _stat
import time
import uuid


class IAType(enum.Enum):
    INVAL = 0
    REG = 1
    DIR = 2
    LNK = 3
    BLK = 4
    CHR = 5
    FIFO = 6
    SOCK = 7


def gfid_new() -> bytes:
    return uuid.uuid4().bytes


#: The root of every volume has the fixed GFID 00..01 (reference
#: libglusterfs: inode table root; tests address it directly).
ROOT_GFID = b"\x00" * 15 + b"\x01"


@dataclasses.dataclass
class Iatt:
    gfid: bytes = b"\x00" * 16
    ia_type: IAType = IAType.INVAL
    mode: int = 0
    nlink: int = 1
    uid: int = 0
    gid: int = 0
    size: int = 0
    blocks: int = 0
    atime: float = 0.0
    mtime: float = 0.0
    ctime: float = 0.0
    rdev: int = 0
    blksize: int = 4096

    @classmethod
    def from_stat(cls, st, gfid: bytes) -> "Iatt":
        mode = st.st_mode
        if _stat.S_ISDIR(mode):
            t = IAType.DIR
        elif _stat.S_ISLNK(mode):
            t = IAType.LNK
        elif _stat.S_ISREG(mode):
            t = IAType.REG
        elif _stat.S_ISBLK(mode):
            t = IAType.BLK
        elif _stat.S_ISCHR(mode):
            t = IAType.CHR
        elif _stat.S_ISFIFO(mode):
            t = IAType.FIFO
        elif _stat.S_ISSOCK(mode):
            t = IAType.SOCK
        else:
            t = IAType.INVAL
        return cls(
            gfid=gfid, ia_type=t, mode=_stat.S_IMODE(mode),
            nlink=st.st_nlink, uid=st.st_uid, gid=st.st_gid,
            size=st.st_size, blocks=st.st_blocks,
            atime=st.st_atime, mtime=st.st_mtime, ctime=st.st_ctime)

    def touch(self, *, m: bool = False, c: bool = True, a: bool = False):
        now = time.time()
        if a:
            self.atime = now
        if m:
            self.mtime = now
        if c:
            self.ctime = now

    def is_dir(self) -> bool:
        return self.ia_type is IAType.DIR

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["gfid"] = self.gfid.hex()
        d["ia_type"] = self.ia_type.name
        return d
