"""Pure-python TFRecord reading and writing (GZIP too), without TensorFlow,
for the reference's coordinate files (build_coordinates.py:100-112,
inputs.py:66-91): record := uint64 length | uint32 masked_crc32c(length)
| data | uint32 masked_crc32c(data); CRC32C by a slicing-by-8 numpy table.
"""

from __future__ import annotations

import gzip
import struct
from typing import Iterator, Optional

import numpy as np

_CRC_POLY = 0x82F63B78


def _make_table() -> np.ndarray:
    table = np.zeros((8, 256), dtype=np.uint32)
    for n in range(256):
        crc = n
        for _ in range(8):
            crc = (crc >> 1) ^ (_CRC_POLY if crc & 1 else 0)
        table[0, n] = crc
    for k in range(1, 8):
        for n in range(256):
            prev = table[k - 1, n]
            table[k, n] = (prev >> 8) ^ table[0, prev & 0xFF]
    return table


_TABLE = _make_table()
_T0, _T1, _T2, _T3, _T4, _T5, _T6, _T7 = (_TABLE[i] for i in range(8))


def crc32c(data: bytes) -> int:
    """CRC32C of a byte string (slicing-by-8, numpy table lookups)."""
    crc = np.uint32(0xFFFFFFFF)
    buf = np.frombuffer(data, dtype=np.uint8)
    n8 = len(buf) // 8 * 8
    i = 0
    # Process 8 bytes at a time.
    while i < n8:
        b = buf[i:i + 8].astype(np.uint32)
        crc ^= b[0] | (b[1] << np.uint32(8)) | (b[2] << np.uint32(16)) \
            | (b[3] << np.uint32(24))
        crc = (_T7[crc & np.uint32(0xFF)]
               ^ _T6[(crc >> np.uint32(8)) & np.uint32(0xFF)]
               ^ _T5[(crc >> np.uint32(16)) & np.uint32(0xFF)]
               ^ _T4[(crc >> np.uint32(24)) & np.uint32(0xFF)]
               ^ _T3[b[4]] ^ _T2[b[5]] ^ _T1[b[6]] ^ _T0[b[7]])
        i += 8
    while i < len(buf):
        crc = (crc >> np.uint32(8)) ^ _T0[(crc ^ buf[i]) & np.uint32(0xFF)]
        i += 1
    return int(crc ^ np.uint32(0xFFFFFFFF))


_MASK_DELTA = 0xA282EAD8


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF)


class RecordWriter:
    """Writes TFRecord files (optionally gzip-compressed)."""

    def __init__(self, path: str, compression: Optional[str] = None):
        if compression == "GZIP" or (compression is None
                                     and path.endswith(".gz")):
            self._f = gzip.open(path, "wb")
        else:
            self._f = open(path, "wb")

    def write(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", masked_crc32c(data)))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, compression: Optional[str] = None,
                 verify_crc: bool = False) -> Iterator[bytes]:
    """Yields record payloads from a TFRecord file."""
    is_gzip = compression == "GZIP"
    if compression is None:
        with open(path, "rb") as probe:
            is_gzip = probe.read(2) == b"\x1f\x8b"
    opener = gzip.open if is_gzip else open
    with opener(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) < 8:
                raise IOError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", header)
            (len_crc,) = struct.unpack("<I", f.read(4))
            if verify_crc and masked_crc32c(header) != len_crc:
                raise IOError(f"corrupt length crc in {path}")
            data = f.read(length)
            if len(data) < length:
                raise IOError(f"truncated TFRecord data in {path}")
            (data_crc,) = struct.unpack("<I", f.read(4))
            if verify_crc and masked_crc32c(data) != data_crc:
                raise IOError(f"corrupt data crc in {path}")
            yield data
