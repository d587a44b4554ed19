"""File-operation model: the framework's fop vocabulary.

The reference defines 59 fops as an enum (reference
libglusterfs/src/glusterfs/glusterfs-fops.h:17-76) and every xlator
implements a subset of them via a fops vtable (xlator.h:545).  Here the
vocabulary is the same, but the mechanism is idiomatic Python: each fop is
an async method on :class:`glusterfs_tpu_torch.core.layer.Layer`, winding is an
``await`` into the child, unwinding is the return (or raised
:class:`FopError`).
"""

from __future__ import annotations

import enum
import errno as _errno


class Fop(enum.Enum):
    """Fop vocabulary (reference glusterfs-fops.h:17-76, same set minus
    the getspec RPC-internal entry).  COMPOUND (the reference's
    GF_FOP_COMPOUND fused-chain carrier) is a real member here: its
    argument is an ordered link chain executed brick-side in one round
    trip (rpc/compound.py defines the envelope and the graph
    semantics)."""

    STAT = "stat"
    READLINK = "readlink"
    MKNOD = "mknod"
    MKDIR = "mkdir"
    UNLINK = "unlink"
    RMDIR = "rmdir"
    SYMLINK = "symlink"
    RENAME = "rename"
    LINK = "link"
    TRUNCATE = "truncate"
    OPEN = "open"
    READV = "readv"
    WRITEV = "writev"
    STATFS = "statfs"
    FLUSH = "flush"
    FSYNC = "fsync"
    SETXATTR = "setxattr"
    GETXATTR = "getxattr"
    REMOVEXATTR = "removexattr"
    OPENDIR = "opendir"
    FSYNCDIR = "fsyncdir"
    ACCESS = "access"
    CREATE = "create"
    FTRUNCATE = "ftruncate"
    FSTAT = "fstat"
    LK = "lk"
    LOOKUP = "lookup"
    READDIR = "readdir"
    INODELK = "inodelk"
    FINODELK = "finodelk"
    ENTRYLK = "entrylk"
    FENTRYLK = "fentrylk"
    XATTROP = "xattrop"
    FXATTROP = "fxattrop"
    FGETXATTR = "fgetxattr"
    FSETXATTR = "fsetxattr"
    RCHECKSUM = "rchecksum"
    SETATTR = "setattr"
    FSETATTR = "fsetattr"
    READDIRP = "readdirp"
    FREMOVEXATTR = "fremovexattr"
    FALLOCATE = "fallocate"
    DISCARD = "discard"
    ZEROFILL = "zerofill"
    IPC = "ipc"
    SEEK = "seek"
    LEASE = "lease"
    GETACTIVELK = "getactivelk"
    SETACTIVELK = "setactivelk"
    PUT = "put"
    ICREATE = "icreate"
    NAMELINK = "namelink"
    COPY_FILE_RANGE = "copy_file_range"
    COMPOUND = "compound"
    # parity-delta write plane (ISSUE 10): read-xor-write at a fragment
    # offset, served by storage/posix in one journal-batched pass.  A
    # write-class fop that must NEVER be blindly retried: XOR is an
    # involution, so a double-applied delta self-cancels (the client's
    # idempotent-retry allowlist is read-class only and excludes it).
    XORV = "xorv"


#: Fops that modify data or metadata (drive version/dirty accounting in the
#: EC/AFR transaction engines; reference ec-common.h fop classification).
WRITE_FOPS = frozenset({
    Fop.MKNOD, Fop.MKDIR, Fop.UNLINK, Fop.RMDIR, Fop.SYMLINK, Fop.RENAME,
    Fop.LINK, Fop.TRUNCATE, Fop.WRITEV, Fop.SETXATTR, Fop.REMOVEXATTR,
    Fop.CREATE, Fop.FTRUNCATE, Fop.XATTROP, Fop.FXATTROP, Fop.FSETXATTR,
    Fop.SETATTR, Fop.FSETATTR, Fop.FREMOVEXATTR, Fop.FALLOCATE, Fop.DISCARD,
    Fop.ZEROFILL, Fop.PUT, Fop.ICREATE, Fop.NAMELINK, Fop.COPY_FILE_RANGE,
    Fop.XORV,
})


class FopError(OSError):
    """A fop failure carrying a POSIX errno (the reference's op_errno;
    unwinding with op_ret=-1 maps to raising this).

    ``xdata`` is the error-path reply dict (the reference unwinds
    op_errno WITH an xdata dict — e.g. the lock-revocation notice of
    features/locks rides the EAGAIN it causes).  Optional: most errors
    carry none, and both wire codecs keep the two-field shape for
    those."""

    def __init__(self, err: int, msg: str = "", xdata: dict | None = None):
        super().__init__(err, msg or _errno.errorcode.get(err, str(err)))
        self.err = err
        self.xdata = xdata

    def __repr__(self) -> str:  # pragma: no cover
        return f"FopError({_errno.errorcode.get(self.err, self.err)})"
