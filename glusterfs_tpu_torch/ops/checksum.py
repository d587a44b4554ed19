"""Block checksums — the libglusterfs checksum.c (gf_rchecksum) analog.

The reference computes a weak rolling checksum + a strong digest per
block so AFR data heal can skip byte-identical regions
(afr-self-heal-data.c).  The weak sum here is Adler-32 (zlib.adler32
byte-compatible); strong digests are sha256 (md5 with fips off).  Only
the host path lives here: the posix ``rchecksum`` fop checksums one
block at a time.
"""

from __future__ import annotations

import zlib


def adler32_ref(block: bytes) -> int:
    """zlib oracle."""
    return zlib.adler32(block) & 0xFFFFFFFF


def rchecksum(data: bytes, fips: bool = True) -> dict:
    """One block's weak+strong checksum (the posix rchecksum fop
    payload).  fips (storage.fips-mode-rchecksum): sha256; off = the
    reference's legacy md5 strong sum."""
    import hashlib

    strong = hashlib.sha256(data) if fips else hashlib.md5(data)
    return {"weak": adler32_ref(data), "strong": strong.hexdigest()}
