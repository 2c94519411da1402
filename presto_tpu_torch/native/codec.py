"""Page codec: the native block compression + checksum, with a zlib
fallback (reference: presto_tpu/native/codec.py; PagesSerde's LZ4 +
xxhash framing in Presto).

Frame layout, byte-identical to the reference's for the same bytes
(the codec byte selects the decoder, so mixed clusters interoperate):
    1 byte  codec: b'P' (native) | b'Z' (zlib, level 1)
    8 bytes little-endian uncompressed size
    8 bytes little-endian splitmix checksum of the UNCOMPRESSED payload
    body
"""

from __future__ import annotations

import ctypes
import zlib

from presto_tpu_torch.native import load_pageserde

#: cap on one page's uncompressed size: the size field comes off the
#: wire and is allocated before the checksum is validated
MAX_PAGE_BYTES = 1 << 31
#: the block scheme's best case is ~255 bytes out per byte in
_MAX_EXPANSION = 256

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _ro_buf(data: bytes):
    """Read-only uint8* view of a bytes object (the C side never writes
    through it)."""
    return ctypes.cast(ctypes.c_char_p(data), _u8p)


class PageCorruption(Exception):
    """Checksum or format mismatch on decode."""


def _checksum_py(data: bytes) -> int:
    """pt_checksum in Python, bit for bit: a splitmix64 finalizer over
    8-byte little-endian lanes, then the tail."""
    m1, m2 = 0xbf58476d1ce4e5b9, 0x94d049bb133111eb
    mask = (1 << 64) - 1

    def mix(h: int) -> int:
        h ^= h >> 30
        h = (h * m1) & mask
        h ^= h >> 27
        h = (h * m2) & mask
        return h ^ (h >> 31)

    h = (0x9e3779b97f4a7c15 ^ len(data)) & mask
    n8 = len(data) // 8
    for i in range(n8):
        h = mix(h ^ int.from_bytes(data[i * 8:i * 8 + 8], "little"))
    return mix(h ^ int.from_bytes(data[n8 * 8:], "little"))


def checksum(data: bytes) -> int:
    lib = load_pageserde()
    if lib is None:
        return _checksum_py(data)
    return int(lib.pt_checksum(_ro_buf(data), len(data)))


def native_available() -> bool:
    """True when the native codec library is loaded."""
    return load_pageserde() is not None


def encode(data: bytes) -> bytes:
    lib = load_pageserde()
    head = len(data).to_bytes(8, "little") \
        + checksum(data).to_bytes(8, "little")
    if lib is not None:
        cap = int(lib.pt_compress_bound(len(data)))
        dst = (ctypes.c_uint8 * cap)()
        n = int(lib.pt_compress(_ro_buf(data), len(data), dst, cap))
        if n > 0:
            return b"P" + head + ctypes.string_at(dst, n)
    return b"Z" + head + zlib.compress(data, 1)


def decode(frame: bytes) -> bytes:
    if len(frame) < 17:
        raise PageCorruption("frame too short")
    codec = frame[0:1]
    size = int.from_bytes(frame[1:9], "little")
    csum = int.from_bytes(frame[9:17], "little")
    body = frame[17:]
    if size > MAX_PAGE_BYTES or size > len(body) * _MAX_EXPANSION + 64:
        raise PageCorruption(f"implausible page size {size}")
    if codec == b"Z":
        try:
            data = zlib.decompress(body)
        except zlib.error as e:
            raise PageCorruption(f"zlib: {e}") from e
    elif codec == b"P":
        lib = load_pageserde()
        if lib is None:
            raise PageCorruption(
                "native-coded page received but the native codec is "
                "unavailable on this node")
        dst = (ctypes.c_uint8 * size)()
        n = int(lib.pt_decompress(_ro_buf(body), len(body), dst, size))
        if n != size:
            raise PageCorruption(f"decompressed {n} != header {size}")
        data = ctypes.string_at(dst, size)
    else:
        raise PageCorruption(f"unknown codec {codec!r}")
    if len(data) != size:
        raise PageCorruption(f"size {len(data)} != header {size}")
    if checksum(data) != csum:
        raise PageCorruption("checksum mismatch")
    return data
