"""Adler-32 (RFC 1950) and CRC-32 (RFC 1952) checksums.

Adler-32 is the reference's running ``adler1/adler2`` pair
(/root/reference/deflate.py:381-383,828-831); here it is reformulated as a
vectorizable weighted sum so the device can compute it in one pass, plus the
standard combine rule so independently-checksummed shards can be merged
after a data-parallel encode (this replaces the reference's byte-serial
CHECKSUM state, deflate.py:884-897).

  a(n) = 1 + sum(d)                       (mod 65521)
  b(n) = n + sum((n - i) * d[i])          (mod 65521)

combine((a1,b1,len1), (a2,b2,len2)) for concatenated streams:
  a = a1 + a2 - 1
  b = b1 + b2 + (a1 - 1) * len2 - ... (see adler32_combine in zlib)
"""

from __future__ import annotations

import zlib

import numpy as np

ADLER_MOD = 65521
_CHUNK = 2048  # 2048^2 * 255 < 2^31, safe for int64 regardless; int32-safe per chunk


def adler32(data: bytes | np.ndarray, value: int = 1) -> int:
    """Reference implementation (delegates arithmetic to numpy)."""
    d = np.frombuffer(bytes(data), dtype=np.uint8).astype(np.int64)
    n = len(d)
    a0 = value & 0xFFFF
    b0 = (value >> 16) & 0xFFFF
    a = (a0 + int(d.sum())) % ADLER_MOD
    # b = b0 + n*a0 + sum((n - i) * d[i])
    w = np.arange(n, 0, -1, dtype=np.int64)
    b = (b0 + n * a0 + int((w * d).sum())) % ADLER_MOD
    return (b << 16) | a


def adler32_combine(ad1: int, ad2: int, len2: int) -> int:
    """Checksum of concat(s1, s2) given adler32(s1), adler32(s2), len(s2)."""
    a1, b1 = ad1 & 0xFFFF, (ad1 >> 16) & 0xFFFF
    a2, b2 = ad2 & 0xFFFF, (ad2 >> 16) & 0xFFFF
    # Derivation: b(concat) = b1 + b2 + len2 * (a1 - 1)  (mod m), because the
    # n2 trailing bytes each pick up an extra weight of sum(s1) = a1 - 1.
    rem = len2 % ADLER_MOD
    a = (a1 + a2 - 1) % ADLER_MOD
    b = (b1 + b2 + rem * (a1 - 1)) % ADLER_MOD
    return (b << 16) | a


def crc32(data: bytes, value: int = 0) -> int:
    return zlib.crc32(data, value) & 0xFFFFFFFF


# --- table for the jax / native implementations -----------------------------

def make_crc32_table() -> np.ndarray:
    """Standard reflected CRC-32 (poly 0xEDB88320) byte table."""
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0xEDB88320 if (c & 1) else 0)
        table[i] = c
    return table


CRC32_TABLE = make_crc32_table()
