"""The port's own copy of ``icebin_tpu/io/zarray.py``; it imports nothing of
the reference package.  It carries the numpy codec only: the reference's
C++ twin writes byte-identical streams, so files interchange either way.

zarray: compressed sparse-matrix storage (delta-varint + zlib).

Reference: ibmisc ``zarray``/``linear::Weighted_Compressed`` store huge
global elevation-class matrices as run-length-encoded, zlib-deflated index
and value streams so ``global_ec`` output fits in ModelE input files
(reference: ``ibmisc:slib/ibmisc/zarray.*`` [U]; SURVEY.md section 5.4).

TPU-native codec (same goal, fresh format): entries are sorted row-major, so
delta-encoding rows gives mostly-zero varints and delta-encoding cols
(zigzag, deltas run straight across row boundaries) gives small varints;
values stay raw f64.  All three streams are zlib-deflated.  Layout:

    'IBZ1' | nnz u64 | 3 x (u64 byte length + zlib stream):
    varint(row deltas), varint(zigzag col deltas), raw f64 vals
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["encode_zarray", "decode_zarray"]

_MAGIC = b"IBZ1"


def _varint_encode(a: np.ndarray) -> bytes:
    """LEB128 varint stream of a uint64 array, vectorized by byte position."""
    a = a.astype(np.uint64)
    n = len(a)
    if n == 0:
        return b""
    # bytes per value: ceil(bit_length/7), min 1
    bits = np.zeros(n, dtype=np.int64)
    tmp = a.copy()
    while (tmp > 0).any():
        bits += (tmp > 0).astype(np.int64)
        tmp = tmp >> np.uint64(7)
    nb = np.maximum(bits, 1)
    pos = np.concatenate([[0], np.cumsum(nb)[:-1]])
    buf = np.zeros(int(nb.sum()), dtype=np.uint8)
    tmp = a.copy()
    for k in range(int(nb.max())):
        has = k < nb
        low = (tmp & np.uint64(0x7F)).astype(np.uint8)
        more = (k + 1 < nb).astype(np.uint8)
        buf[pos[has] + k] = low[has] | (more[has] << 7)
        tmp = tmp >> np.uint64(7)
    return buf.tobytes()


def _varint_decode(b: bytes, n: int) -> np.ndarray:
    raw = np.frombuffer(b, dtype=np.uint8)
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    cont = (raw & 0x80) != 0
    starts = np.ones(len(raw), dtype=bool)
    starts[1:] = ~cont[:-1]
    vid = np.cumsum(starts) - 1          # value id per byte
    if vid[-1] + 1 != n or cont[-1]:
        raise ValueError("corrupt varint stream")
    first_idx = np.nonzero(starts)[0]
    k = np.arange(len(raw)) - first_idx[vid]   # byte position within value
    out = np.zeros(n, dtype=np.uint64)
    np.bitwise_or.at(out, vid,
                     (raw & np.uint8(0x7F)).astype(np.uint64)
                     << (np.uint64(7) * k.astype(np.uint64)))
    return out


def _zigzag(a: np.ndarray) -> np.ndarray:
    a = a.astype(np.int64)
    return ((a << 1) ^ (a >> 63)).astype(np.uint64)


def _unzigzag(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.uint64)
    return ((a >> np.uint64(1)).astype(np.int64)
            ^ -((a & np.uint64(1)).astype(np.int64)))


def encode_zarray(rows, cols, vals) -> bytes:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    # fast path: most producers emit row-major-sorted COO already; the
    # O(n) check is ~30x cheaper than the lexsort it skips
    dr = np.diff(rows)
    if len(rows) and ((dr < 0).any()
                      or (np.diff(cols)[dr == 0] < 0).any()):
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
    br = _varint_encode(np.diff(rows, prepend=0).astype(np.uint64))
    bc = _varint_encode(_zigzag(np.diff(cols, prepend=0)))
    streams = [
        zlib.compress(br, 6),
        zlib.compress(bc, 6),
        # f64 values are near-incompressible; level 1 trades ~2% size for
        # ~5x encode speed (decode reads any level)
        zlib.compress(vals.tobytes(), 1),
    ]
    out = bytearray(_MAGIC)
    out += struct.pack("<Q", len(vals))
    for s in streams:
        out += struct.pack("<Q", len(s))
        out += s
    return bytes(out)


def decode_zarray(blob: bytes):
    if blob[:4] != _MAGIC:
        raise ValueError("not an IBZ1 zarray blob")
    nnz = struct.unpack("<Q", blob[4:12])[0]
    off = 12
    streams = []
    for _ in range(3):
        ln = struct.unpack("<Q", blob[off:off + 8])[0]
        off += 8
        streams.append(zlib.decompress(blob[off:off + ln]))
        off += ln
    rows = np.cumsum(_varint_decode(streams[0], nnz).astype(np.int64))
    cols = np.cumsum(_unzigzag(_varint_decode(streams[1], nnz)))
    vals = np.frombuffer(streams[2], dtype=np.float64).copy()
    return rows, cols, vals
