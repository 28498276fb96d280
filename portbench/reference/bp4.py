"""Plain reader of a BP4-style series directory, in NumPy and the
standard library, for judging what the program wrote.

Layout: `md.idx` holds one 64-byte record a step (step, offset and
length of its metadata in `md.0`, crc32 of that metadata, flags, time,
two reserved words; little-endian `<QQQIIQQQ`); a step counts only when
its crc matches. The metadata is JSON: each variable's dtype, global
shape and chunks, each chunk a box (offset, extent) stored at a byte
offset of a subfile `data.<agg>`. A chunk's payload is a run of blocks,
each a 16-byte header (`JBPC`, codec id, item size, flags, raw length,
stored length) and its bytes: codec 0 stored raw (byte-shuffled when
flag 1 is set), 1 byte-shuffled then deflated, 3 deflated. A shuffle
transposes the block's [items, itemsize] byte matrix.
"""
from __future__ import annotations

import json
import pathlib
import struct
import zlib

import numpy as np

IDX = struct.Struct("<QQQIIQQQ")
BLOCK = struct.Struct("<4sBBHII")
PRESHUFFLED = 0x1


def _unshuffle(buf: bytes, itemsize: int) -> bytes:
    if itemsize <= 1 or len(buf) % itemsize:
        return buf
    return np.frombuffer(buf, np.uint8).reshape(itemsize, -1).T.tobytes()


def decode_block(header: tuple, body: bytes) -> bytes:
    """The raw bytes of one block; raises ValueError on a bad one."""
    magic, codec, isz, flags, raw, comp = header
    if magic != b"JBPC" or len(body) != comp:
        raise ValueError("bad or truncated block")
    if codec == 0:
        out = _unshuffle(body, isz) if flags & PRESHUFFLED else body
    elif codec == 1:
        out = _unshuffle(zlib.decompress(body), isz)
    elif codec == 3:
        out = zlib.decompress(body)
    else:
        raise ValueError(f"codec {codec} is not read by the reference")
    if len(out) != raw:
        raise ValueError(f"a block decodes to {len(out)} bytes, its header "
                         f"says {raw}")
    return out


class Series:
    """The committed steps of one series directory."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        idx = (self.path / "md.idx").read_bytes()
        md = (self.path / "md.0").read_bytes()
        self.meta = {}
        for i in range(0, len(idx) - IDX.size + 1, IDX.size):
            step, off, ln, crc, *_ = IDX.unpack_from(idx, i)
            blob = md[off:off + ln]
            if len(blob) == ln and zlib.crc32(blob) & 0xFFFFFFFF == crc:
                self.meta[step] = json.loads(blob)

    def steps(self) -> list[int]:
        return sorted(self.meta)

    def var(self, step: int, name: str) -> dict:
        """dtype, shape and chunks of a variable."""
        return self.meta[step]["vars"][name]

    def blocks(self, chunk: dict):
        """(raw offset in the chunk, file offset, header) of each block
        of a chunk, read from the headers alone."""
        out = []
        with open(self.path / f"data.{chunk['agg']}", "rb") as f:
            pos, end, raw_off = chunk["foff"], chunk["foff"] + chunk["nbytes"], 0
            while pos < end:
                f.seek(pos)
                head = BLOCK.unpack(f.read(BLOCK.size))
                out.append((raw_off, pos, head))
                raw_off += head[4]
                pos += BLOCK.size + head[5]
        return out

    def read_block(self, chunk: dict, pos: int, header: tuple) -> bytes:
        with open(self.path / f"data.{chunk['agg']}", "rb") as f:
            f.seek(pos + BLOCK.size)
            return decode_block(header, f.read(header[5]))

    def read(self, step: int, name: str) -> np.ndarray:
        """The variable's global array, assembled from its chunks."""
        var = self.var(step, name)
        dtype = np.dtype(var["dtype"])
        out = np.zeros(tuple(var["shape"]) or (1,), dtype=dtype)
        for ch in var["chunks"]:
            raw = b"".join(self.read_block(ch, pos, head)
                           for _, pos, head in self.blocks(ch))
            box = tuple(slice(o, o + e)
                        for o, e in zip(ch["offset"], ch["extent"]))
            out[box] = np.frombuffer(raw, dtype=dtype).reshape(ch["extent"])
        return out.reshape(tuple(var["shape"]))
