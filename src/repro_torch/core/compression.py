"""Compression codecs for the BP engine (paper §IV-D).

  * "blosc"  — Blosc-style pipeline: byte shuffle preconditioner + fast LZ
               stage (zlib level 1 stands in for LZ4). The shuffle transposes
               the [n_items, itemsize] byte matrix so same-significance bytes
               are contiguous — floats compress far better. The numpy path
               below is the host path and the kernel's oracle; tensors
               take the device path (kernels/bitshuffle, a CUDA kernel on
               the GPU) via `device_array_payload` / `outbound_chunk`,
               so the host only pays the cheap Z_RLE stage. The module
               imports no torch: the device functions import it where
               they run.
  * "lossy"  — error-bounded lossy codec for particle data: uniform scalar
               quantization to a caller-chosen bound, then shuffle + Z_RLE
               on the quantized ints. Spec strings carry the bound:
               "lossy:1e-3" (absolute) or "lossy:rel:1e-3" (relative to the
               block's max |x|). Reconstruction error is <= the bound by
               construction (q = round(x / 2*eps), x_hat = q * 2*eps); the
               per-block sub-header records the quantization step, so every
               block is self-describing. Blocks that cannot honor the bound
               losslessly fall back (non-finite values, zero effective
               bound, quantizer overflow -> lossless blosc for that block).
  * "bzip2"  — the paper's high-ratio/high-cost comparison point.
  * "zlib"   — plain deflate, no shuffle (ablation).
  * "none"   — pass-through.

All codecs are chunked (default 1 MiB) with a tiny self-describing header so
any block can be decompressed independently (needed for striped/aggregated
layouts and elastic re-sharding reads). The header's flags field carries
FLAG_PRESHUFFLED: set by producers whose bytes were already byte-shuffled
on-device before the host encode (workers skip the shuffle; readers of
blosc blocks are oblivious because decode always unshuffles, and stored-raw
fallback blocks unshuffle iff the flag is set). Old payloads wrote 0 in the
field, so pre-flag series decode bit-identically.
"""
from __future__ import annotations

import bz2
import math
import struct
import sys
import time
import zlib
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.darshan import CTR, MONITOR
from repro_torch.core.dxt import TRACER

if TYPE_CHECKING:
    import torch

MAGIC = b"JBPC"
HEADER = struct.Struct("<4sBBHII")  # magic, codec_id, itemsize, flags, raw, comp

#: stored bytes were byte-shuffled BEFORE the encode (on-device
#: preconditioning) — decode-relevant only for stored-raw ("none") blocks;
#: informational for "blosc" (its decode always unshuffles)
FLAG_PRESHUFFLED = 0x1

CODEC_IDS = {"none": 0, "blosc": 1, "bzip2": 2, "zlib": 3, "lossy": 4}
CODEC_NAMES = {v: k for k, v in CODEC_IDS.items()}
DEFAULT_BLOCK = 1 * 1024 * 1024

#: lossy block sub-header: quantization step (x_hat = q * scale, so the
#: error bound is scale/2) and the width of the stored quantized ints
LOSSY_SUB = struct.Struct("<dB")
_FLOAT_BY_ITEMSIZE = {2: np.float16, 4: np.float32, 8: np.float64}
_QINT_BY_SIZE = {4: np.int32, 8: np.int64}
#: one ulp, relative, per float width — the error the final cast back to
#: the stored dtype can add on top of the float64 quantization error
_CAST_ULP = {2: 2.0 ** -10, 4: 2.0 ** -23, 8: 2.0 ** -52}


class CorruptPayloadError(ValueError):
    """A stored payload failed validation while decoding: bad JBPC magic,
    truncated header/payload slice, unknown codec id, a codec stream the
    decompressor rejects, or a decompressed length that does not match the
    header. This is a REAL exception, not an `assert` — bit rot must be
    diagnosed identically under `python -O`, and service-plane callers
    (jbpd, jbpfsck-style deep scans) map it to a clean error response
    instead of surfacing garbage data or an opaque unpack traceback."""


def parse_codec(spec) -> tuple[str, float, bool]:
    """Parse a codec spec -> (name, lossy_bound, lossy_is_relative).

    Lossless specs are their own name ("blosc" -> ("blosc", 0.0, False));
    the lossy codec carries its error bound in the spec string:
    "lossy:1e-3" (absolute) or "lossy:rel:1e-3" (relative to each block's
    max |x|). Raises ValueError for unknown names or unusable bounds."""
    s = str(spec)
    if s == "lossy" or s.startswith("lossy:"):
        parts = s.split(":")
        rel = len(parts) == 3 and parts[1] == "rel"
        if len(parts) < 2 or not (len(parts) == 2 or rel):
            raise ValueError(
                f"bad lossy codec spec {spec!r} — use 'lossy:<abs_bound>' "
                f"or 'lossy:rel:<rel_bound>'")
        try:
            bound = float(parts[-1])
        except ValueError:
            raise ValueError(
                f"bad lossy codec bound in {spec!r}: {parts[-1]!r} is not "
                f"a number") from None
        if not (bound > 0.0 and math.isfinite(bound)):
            raise ValueError(
                f"lossy codec bound must be finite and > 0, got {bound!r}")
        return "lossy", bound, rel
    if s not in CODEC_IDS:
        raise ValueError(f"unknown codec {spec!r}")
    return s, 0.0, False


def byte_shuffle(buf, itemsize: int) -> bytes:
    """[n, itemsize] byte-matrix transpose (Blosc's shuffle filter)."""
    if itemsize <= 1 or len(buf) % itemsize:
        return bytes(buf)
    a = np.frombuffer(buf, dtype=np.uint8).reshape(-1, itemsize)
    return a.T.tobytes()


def byte_unshuffle(buf: bytes, itemsize: int) -> bytes:
    if itemsize <= 1 or len(buf) % itemsize:
        return buf
    a = np.frombuffer(buf, dtype=np.uint8).reshape(itemsize, -1)
    return a.T.tobytes()


def _rle_deflate(buf) -> bytes:
    """Deflate with Z_RLE strategy — a fast LZ stage much closer to Blosc's
    LZ4 cost profile than default deflate (§Perf hillclimb C iteration r7).
    After the byte shuffle, runs dominate, so Z_RLE keeps most of the ratio
    at a fraction of the match-search cost."""
    co = zlib.compressobj(1, zlib.DEFLATED, 15, 9, zlib.Z_RLE)
    return co.compress(buf) + co.flush()


def _lossy_block(block, itemsize: int, bound: float, rel: bool):
    """Quantize-to-bound one block: q = round(x / (2*eps)) stored as
    shuffled+Z_RLE'd int32/int64. Returns the payload (sub-header + body)
    or None when the block must fall back to lossless — not a float-width
    itemsize, non-finite values, zero effective bound (all-zero block under
    a relative bound), or quantizer overflow."""
    fdtype = _FLOAT_BY_ITEMSIZE.get(itemsize)
    if fdtype is None or len(block) % itemsize:
        return None
    x = np.frombuffer(block, dtype=fdtype).astype(np.float64)
    if x.size and not np.isfinite(x).all():
        return None
    amax = float(np.max(np.abs(x))) if x.size else 0.0
    eps = bound * amax if rel else (bound if not rel else 0.0)
    if not eps > 0.0:
        return None
    # reconstruction happens in float64 then casts back to the stored
    # width; shave one ulp of the largest representable reconstruction off
    # the quantization step so the bound holds strictly IN THE STORED
    # DTYPE, not just in float64. A bound below that representability
    # floor cannot be honored lossily -> lossless fallback.
    eps_int = eps - (amax + eps) * _CAST_ULP[itemsize]
    if not eps_int > 0.0:
        return None
    scale = 2.0 * eps_int
    q = np.round(x / scale)
    qmax = float(np.max(np.abs(q))) if q.size else 0.0
    if qmax <= 2.0 ** 31 - 1:
        qdtype = np.int32
    elif qmax <= 2.0 ** 63 - 1:
        qdtype = np.int64
    else:
        return None
    qa = q.astype(qdtype)
    body = _rle_deflate(byte_shuffle(qa.tobytes(), qa.dtype.itemsize))
    return LOSSY_SUB.pack(scale, qa.dtype.itemsize) + body


def _compress_block(block, codec: str, itemsize: int, *,
                    preshuffled: bool = False, lossy_bound: float = 0.0,
                    lossy_rel: bool = False) -> bytes:
    flags = 0
    if preshuffled:
        if codec not in ("blosc", "none"):
            raise ValueError(
                f"codec {codec!r} cannot encode pre-shuffled bytes — only "
                f"blosc/none understand the device-preconditioned layout")
        if itemsize > 1 and len(block) and len(block) % itemsize == 0:
            flags = FLAG_PRESHUFFLED
    if codec == "lossy":
        payload = _lossy_block(block, itemsize, lossy_bound, lossy_rel)
        if payload is not None:
            if len(payload) >= len(block):     # incompressible -> store raw
                hdr = HEADER.pack(MAGIC, CODEC_IDS["none"], itemsize, 0,
                                  len(block), len(block))
                return hdr + bytes(block)
            hdr = HEADER.pack(MAGIC, CODEC_IDS["lossy"], itemsize, 0,
                              len(block), len(payload))
            return hdr + payload
        codec = "blosc"                        # lossless fallback, this block
    if codec == "none":
        payload = bytes(block)
    elif codec == "blosc":
        payload = _rle_deflate(block if flags & FLAG_PRESHUFFLED
                               else byte_shuffle(block, itemsize))
    elif codec == "zlib":
        payload = zlib.compress(block, 6)
    elif codec == "bzip2":
        payload = bz2.compress(block, 9)
    else:
        raise ValueError(f"unknown codec {codec!r}")
    if len(payload) >= len(block):           # incompressible -> store raw
        # flags survive: a pre-shuffled raw store keeps FLAG_PRESHUFFLED so
        # decode knows to unshuffle the stored bytes
        codec, payload = "none", bytes(block)
    elif codec == "blosc":
        # blosc decode unshuffles unconditionally, so the flag carries no
        # decode information for a compressed block — clear it and the
        # device pipeline's payload stays BIT-IDENTICAL to the host path's
        flags = 0
    hdr = HEADER.pack(MAGIC, CODEC_IDS[codec], itemsize, flags,
                      len(block), len(payload))
    return hdr + payload


def iter_block_headers(data):
    """Walk a payload's JBPC block headers WITHOUT touching payload bytes:
    yields (offset, codec_id, itemsize, flags, raw, comp) per block after
    validating magic, codec id and the length chain. This is the
    `decompress` pre-scan and the `jbpfsck --deep` walk."""
    n = len(data)
    off = 0
    while off < n:
        if off + HEADER.size > n:
            raise CorruptPayloadError(
                f"truncated block header at offset {off}: "
                f"{n - off} bytes left, {HEADER.size} needed")
        magic, cid, itemsize, flags, raw, comp = HEADER.unpack_from(data, off)
        if magic != MAGIC:
            raise CorruptPayloadError(
                f"bad block magic at offset {off}: {magic!r} != {MAGIC!r} "
                f"(corrupt or misaligned payload)")
        if cid not in CODEC_NAMES:
            raise CorruptPayloadError(
                f"unknown codec id {cid} in block header at offset {off}")
        if cid == CODEC_IDS["lossy"] and comp < LOSSY_SUB.size:
            raise CorruptPayloadError(
                f"lossy block at offset {off} too short for its sub-header "
                f"({comp} bytes, {LOSSY_SUB.size} needed)")
        if off + HEADER.size + comp > n:
            raise CorruptPayloadError(
                f"truncated block payload at offset {off + HEADER.size}: "
                f"header promises {comp} bytes, "
                f"{n - off - HEADER.size} present")
        yield off, cid, itemsize, flags, raw, comp
        off += HEADER.size + comp


def _decompress_block(buf, off: int) -> tuple[bytes, int]:
    if off + HEADER.size > len(buf):
        raise CorruptPayloadError(
            f"truncated block header at offset {off}: "
            f"{len(buf) - off} bytes left, {HEADER.size} needed")
    magic, cid, itemsize, flags, raw, comp = HEADER.unpack_from(buf, off)
    if magic != MAGIC:
        raise CorruptPayloadError(
            f"bad block magic at offset {off}: {magic!r} != {MAGIC!r} "
            f"(corrupt or misaligned payload)")
    start = off + HEADER.size
    if start + comp > len(buf):
        raise CorruptPayloadError(
            f"truncated block payload at offset {start}: header promises "
            f"{comp} bytes, {len(buf) - start} present")
    payload = buf[start:start + comp]
    codec = CODEC_NAMES.get(cid)
    if codec is None:
        raise CorruptPayloadError(
            f"unknown codec id {cid} in block header at offset {off}")
    if codec == "lossy":
        # sub-header validation happens OUTSIDE the stream-decode try so a
        # malformed sub-header reports itself, not a wrapped decode error
        if len(payload) < LOSSY_SUB.size:
            raise CorruptPayloadError(
                f"lossy block at offset {off} too short for its sub-header "
                f"({len(payload)} bytes, {LOSSY_SUB.size} needed)")
        scale, qsize = LOSSY_SUB.unpack_from(payload)
        fdtype = _FLOAT_BY_ITEMSIZE.get(itemsize)
        qdtype = _QINT_BY_SIZE.get(qsize)
        if fdtype is None or qdtype is None:
            raise CorruptPayloadError(
                f"lossy block at offset {off} has unsupported widths "
                f"(float itemsize {itemsize}, quantized width {qsize})")
    try:
        if codec == "none":
            out = (byte_unshuffle(bytes(payload), itemsize)
                   if flags & FLAG_PRESHUFFLED else payload)
        elif codec == "blosc":
            out = byte_unshuffle(zlib.decompress(payload), itemsize)
        elif codec == "zlib":
            out = zlib.decompress(payload)
        elif codec == "lossy":
            ints = byte_unshuffle(
                zlib.decompress(payload[LOSSY_SUB.size:]), qsize)
            q = np.frombuffer(ints, dtype=qdtype)
            out = (q.astype(np.float64) * scale).astype(fdtype).tobytes()
        else:
            out = bz2.decompress(payload)
    except (zlib.error, OSError, ValueError) as e:
        raise CorruptPayloadError(
            f"{codec} stream at offset {start} failed to decode: {e}") from e
    if len(out) != raw:
        raise CorruptPayloadError(
            f"decompressed length mismatch at offset {off}: header promises "
            f"{raw} raw bytes, stream decoded to {len(out)}")
    return out, start + comp


def compress(data, codec: str = "none", itemsize: int = 1,
             block: int = DEFAULT_BLOCK, *, preshuffled: bool = False) -> bytes:
    """Chunked compress; output is a sequence of self-describing blocks.
    `data` may be any buffer (bytes, memoryview, numpy .data) — block
    slicing is zero-copy via memoryview. `codec` accepts spec strings
    ("blosc", "lossy:1e-3", "lossy:rel:1e-3"); `preshuffled=True` marks the
    input bytes as already byte-shuffled per block (device path)."""
    name, bound, rel = parse_codec(codec)
    mv = memoryview(data).cast("B")
    out = []
    for i in range(0, max(len(mv), 1), block):
        out.append(_compress_block(mv[i:i + block], name, itemsize,
                                   preshuffled=preshuffled,
                                   lossy_bound=bound, lossy_rel=rel))
    return b"".join(out)


def _decompress_into(data) -> bytearray:
    """Pre-scan the headers to size the output exactly, then decode each
    block into a preallocated bytearray — no quadratic `out +=` growth."""
    out = bytearray(sum(h[4] for h in iter_block_headers(data)))
    pos = 0
    off = 0
    n = len(data)
    while off < n:
        blk, off = _decompress_block(data, off)
        out[pos:pos + len(blk)] = blk
        pos += len(blk)
    return out


def decompress(data: bytes) -> bytes:
    return bytes(_decompress_into(data))


def array_payload(arr: np.ndarray, codec: str,
                  block: int = DEFAULT_BLOCK) -> bytes:
    a = np.ascontiguousarray(arr)
    if parse_codec(codec)[0] == "lossy" and a.dtype.kind != "f":
        # error-bounded quantization is defined over IEEE floats only —
        # the byte-level compress() would misread ints (or bfloat16) as
        # same-width floats. Integers etc. get the lossless pipeline.
        codec = "blosc"
    # zero-copy into the chunked compressor (no .tobytes() duplication)
    with TRACER.span("encode", length=a.nbytes):
        return compress(a.reshape(-1).view(np.uint8).data, codec,
                        itemsize=a.dtype.itemsize, block=block)


def payload_to_array(buf: bytes, dtype, shape) -> np.ndarray:
    dtype = np.dtype(dtype)
    first = next(iter_block_headers(buf), None)
    if first is not None:
        off, cid, _isz, flags, raw, comp = first
        if (off + HEADER.size + comp == len(buf)
                and cid == CODEC_IDS["none"]
                and not flags & FLAG_PRESHUFFLED
                and comp == raw and raw
                and raw % dtype.itemsize == 0):
            # single stored-raw block: view straight into the payload
            # buffer, zero-copy (read-only, same as the frombuffer path)
            try:
                return np.frombuffer(
                    buf, dtype=dtype, count=raw // dtype.itemsize,
                    offset=HEADER.size).reshape(shape)
            except ValueError as e:
                raise CorruptPayloadError(
                    f"stored-raw payload ({raw} bytes) does not fit a "
                    f"{dtype} array of shape {tuple(shape)}: {e}") from e
    raw_buf = _decompress_into(buf)
    try:
        return np.frombuffer(raw_buf, dtype=dtype).reshape(shape)
    except ValueError as e:
        raise CorruptPayloadError(
            f"decoded payload ({len(raw_buf)} bytes) does not fit a "
            f"{dtype} array of shape {tuple(shape)}: {e}") from e


# --------------------------------------------------------------------------
# Device path: on-device byte-shuffle preconditioning (kernels/bitshuffle)
# --------------------------------------------------------------------------

# The host plane never imports torch: a tensor or a torch dtype can only
# exist once torch is in sys.modules, so the checks below look there.
_NP_BY_TORCH: dict = {}


def np_dtype(dtype) -> np.dtype:
    """numpy dtype of a numpy or torch dtype — the one torch->numpy map the
    engine uses, so a tensor's variable records the same dtype string as
    the ndarray it would become on host."""
    torch = sys.modules.get("torch")
    if torch is None or not isinstance(dtype, torch.dtype):
        return np.dtype(dtype)
    if not _NP_BY_TORCH:
        _NP_BY_TORCH.update({
            torch.bool: np.bool_, torch.uint8: np.uint8,
            torch.int8: np.int8, torch.int16: np.int16,
            torch.uint16: np.uint16, torch.int32: np.int32,
            torch.uint32: np.uint32, torch.int64: np.int64,
            torch.uint64: np.uint64, torch.float16: np.float16,
            torch.float32: np.float32, torch.float64: np.float64})
    if dtype not in _NP_BY_TORCH:
        raise TypeError(f"no numpy dtype for {dtype} (store bfloat16 as "
                        f"a uint16 view)")
    return np.dtype(_NP_BY_TORCH[dtype])


def is_device_array(x) -> bool:
    """True for a torch tensor: it stays a tensor until the encode, where
    a CUDA tensor is shuffled by the kernel and a CPU tensor by the plain
    version of the same transpose."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def codec_wants_device(codec) -> bool:
    """True when the codec's preconditioner can run on-device (the blosc
    byte shuffle). Lossy quantizes on host; zlib/bzip2 have no shuffle."""
    return parse_codec(codec)[0] == "blosc"


class DeviceStats:
    """Accounting a device-path encode hands back to the engine: bytes
    shuffled on-chip, host-LZ seconds that overlapped an in-flight device
    block, and the device-computed chunk stats (min/max without a second
    host pass)."""

    __slots__ = ("device_bytes", "overlap_s", "vmin", "vmax")

    def __init__(self, device_bytes: int = 0, overlap_s: float = 0.0,
                 vmin: float = 0.0, vmax: float = 0.0):
        self.device_bytes = device_bytes
        self.overlap_s = overlap_s
        self.vmin = vmin
        self.vmax = vmax


class PreshuffledChunk:
    """Host-side carrier of a device-preconditioned chunk: the
    byte-shuffled bytes (shuffled per codec block on the device, so
    block boundaries match the host encoder's) plus the metadata a writer
    worker needs to finish the encode WITHOUT re-shuffling. The JBPC
    pre-shuffled header flag keeps every reader oblivious."""

    __slots__ = ("data", "dtype", "shape", "block", "vmin", "vmax",
                 "device_bytes")

    def __init__(self, data: np.ndarray, dtype, shape, block: int,
                 vmin: float = 0.0, vmax: float = 0.0, device_bytes: int = 0):
        self.data = data                       # uint8[nbytes], shuffled
        self.dtype = np_dtype(dtype)
        self.shape = tuple(int(s) for s in shape)
        self.block = int(block)
        self.vmin = float(vmin)
        self.vmax = float(vmax)
        self.device_bytes = int(device_bytes)  # bytes actually shuffled on-chip

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize

    @property
    def nbytes(self) -> int:
        return int(self.data.nbytes)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def _device_byte_view(t: torch.Tensor) -> torch.Tensor:
    """uint8 [nbytes] view of a tensor's raw bytes, on its device."""
    import torch
    return t.contiguous().reshape(-1).view(torch.uint8)


def _device_minmax(t: torch.Tensor):
    """Launch the min/max reduction on the tensor's device (async); returns
    0-d tensors, or None for dtypes without an order. Floats reduce
    NaN-tolerantly (nanmin/nanmax: NaNs ignored, +-inf kept), the device
    semantics the engine's `finite_stats` then filters."""
    import torch
    kind = np_dtype(t.dtype).kind
    if kind not in "fiub" or not t.numel():
        return None
    if kind == "f":
        keep = ~torch.isnan(t)
        lo = torch.where(keep, t, math.inf).min()
        hi = torch.where(keep, t, -math.inf).max()
        return lo, hi
    if t.dtype in (torch.uint16, torch.uint32):   # no min/max kernels
        t = t.to(torch.int64)
    return t.min(), t.max()


def _device_shuffled_blocks(t: torch.Tensor, block: int, itemsize: int):
    """Shuffle the leaf's codec blocks on its device in one launch, then
    start each block's D2H copy into one pinned buffer, recording an event
    per block — the device queue runs ahead of the host. Returns (host
    uint8 buffer, blocks=[(lo, hi, event | None, was_shuffled)],
    device_bytes, minmax). The `device_shuffle` span covers this stage
    alone: the waits for the copies and the host LZ are spans of their
    own."""
    import torch

    from repro_torch.kernels.bitshuffle import ops as bops
    byts = _device_byte_view(t)
    nbytes = int(byts.shape[0])
    with TRACER.span("device_shuffle", length=nbytes, observe=True):
        minmax = _device_minmax(t)
        on_cuda = byts.is_cuda
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=on_cuda)
        spans = [(i, min(i + block, nbytes))
                 for i in range(0, max(nbytes, 1), block)]
        # mirror the host byte_shuffle no-op cases exactly so payloads are
        # bit-compatible: itemsize 1 or a non-multiple block pass through
        # (shuffle_blocks copies such a block unchanged)
        shuf = [itemsize > 1 and hi > lo and (hi - lo) % itemsize == 0
                for lo, hi in spans]
        if any(shuf):
            byts = bops.shuffle_blocks(byts, block=block, itemsize=itemsize)
        blocks = []
        for (lo, hi), was_shuffled in zip(spans, shuf):
            host[lo:hi].copy_(byts[lo:hi], non_blocking=on_cuda)
            ev = None
            if on_cuda:             # block k's D2H overlaps block k+1's LZ
                ev = torch.cuda.Event()
                ev.record()
            blocks.append((lo, hi, ev, was_shuffled))
    device_bytes = sum(hi - lo for (lo, hi), was in zip(spans, shuf) if was)
    return host.numpy(), blocks, device_bytes, minmax


def _land(ev):
    """Wait for one block's D2H copy (`bp.d2h_wait`)."""
    if ev is not None:
        with TRACER.span("d2h_wait"):
            ev.synchronize()


def _minmax_floats(minmax) -> tuple[float, float]:
    if minmax is None:
        return 0.0, 0.0
    return float(minmax[0]), float(minmax[1])


def device_precondition(t: torch.Tensor, *,
                        block: int = DEFAULT_BLOCK) -> PreshuffledChunk:
    """Run the bitshuffle preconditioner on the tensor's device and land
    the shuffled bytes on host as a `PreshuffledChunk` (the form a writer
    worker finishes with the LZ stage alone). Min/max chunk stats ride
    along from a device-side reduction."""
    dt = np_dtype(t.dtype)
    host, blocks, dev_bytes, minmax = _device_shuffled_blocks(
        t, block, dt.itemsize)
    for _lo, _hi, ev, _shuf in blocks:
        _land(ev)
    vmin, vmax = _minmax_floats(minmax)
    return PreshuffledChunk(host, dt, t.shape, block, vmin, vmax,
                            device_bytes=dev_bytes)


def outbound_chunk(chunk, cfg, path, codec: str | None = None):
    """A chunk in the form in which it leaves its process: through the
    write plane's ring or queue, the gather to rank 0, or a by-rank
    writer's encode. A tensor is byte-shuffled on its device into a
    `PreshuffledChunk` when `cfg.device_compress` and the codec (`codec`,
    else `cfg.codec`) want it, and copied to host otherwise; a
    `PreshuffledChunk` passes as it is, an array as a contiguous ndarray
    (at least 1-d, as `put` makes it). The chunk's bytes
    are a view of a pinned buffer that it keeps alive until the ring copy
    or the pickle has read it. A shuffle on the device books its bytes as
    COMPRESS_DEVICE_BYTES at rank 0 of `path`; with `path=None` the
    process that receives the chunk books them."""
    if isinstance(chunk, PreshuffledChunk):
        return chunk
    if not is_device_array(chunk):
        return np.ascontiguousarray(chunk)
    if not (cfg.device_compress and codec_wants_device(codec or cfg.codec)):
        return chunk.cpu().numpy()
    chunk = device_precondition(chunk, block=cfg.compression_block)
    if path is not None:
        MONITOR.record(0, str(path), CTR.COMPRESS_DEVICE_BYTES,
                       inc=float(chunk.device_bytes))
    return chunk


def array_payload_preshuffled(chunk: PreshuffledChunk, codec: str) -> bytes:
    """Finish a device-preconditioned chunk's encode on host: Z_RLE each
    already-shuffled block (the worker-side half of the split pipeline).
    Block boundaries were fixed at precondition time (`chunk.block`)."""
    name, _bound, _rel = parse_codec(codec)
    if name not in ("blosc", "none"):
        raise ValueError(
            f"codec {codec!r} cannot encode a pre-shuffled chunk — "
            f"precondition only when codec_wants_device() says so")
    mv = memoryview(chunk.data).cast("B")
    out = []
    for i in range(0, max(len(mv), 1), chunk.block):
        out.append(_compress_block(mv[i:i + chunk.block], name,
                                   chunk.itemsize, preshuffled=True))
    return b"".join(out)


def device_array_payload(t: torch.Tensor, codec: str,
                         block: int = DEFAULT_BLOCK
                         ) -> tuple[bytes, DeviceStats]:
    """Full on-device encode pipeline (the thread-pool engine's path):
    shuffle every codec block on the device in one launch and start each
    block's D2H copy, then run the host Z_RLE stage on block k once its
    event has fired while block k+1 is still in flight — double-buffered
    overlap. Returns (payload, DeviceStats).

    Codecs whose preconditioner cannot run on-device (lossy quantization,
    zlib/bzip2 ablations, plain "none") materialize the tensor once and
    take the host encoder."""
    name, _bound, _rel = parse_codec(codec)
    dt = np_dtype(t.dtype)
    if name != "blosc":
        a = t.cpu().numpy()
        stats = DeviceStats()
        if dt.kind in "fiub" and a.size:
            stats.vmin = float(np.min(a))
            stats.vmax = float(np.max(a))
        return array_payload(a, codec, block), stats
    host, blocks, device_bytes, minmax = _device_shuffled_blocks(
        t, block, dt.itemsize)
    out = []
    overlap_s = 0.0
    for k, (lo, hi, ev, shuf) in enumerate(blocks):
        _land(ev)           # lands block k; k+1's D2H may be in flight
        # this block's LZ overlaps a transfer only if the next block's
        # copy has not landed when it starts
        nxt = blocks[k + 1][2] if k + 1 < len(blocks) else None
        in_flight = nxt is not None and not nxt.query()
        t1 = time.perf_counter() if in_flight else 0.0
        with TRACER.span("encode", length=hi - lo):
            out.append(_compress_block(host[lo:hi].data, name, dt.itemsize,
                                       preshuffled=shuf))
        if in_flight:
            overlap_s += time.perf_counter() - t1
    vmin, vmax = _minmax_floats(minmax)
    stats = DeviceStats(device_bytes=device_bytes, overlap_s=overlap_s,
                        vmin=vmin, vmax=vmax)
    return b"".join(out), stats
