"""Top-level compress/decompress API over the device codec.

The byte-level protocol the reference exposes (host writes bytes / polls
progress counters, /root/reference/test_deflate.py:142-174) becomes a
block-chunked array API here: input is split into fixed-size chunks, every
chunk is encoded as an independent byte-aligned DEFLATE block run on
device (batched), and the chunks concatenate bytewise into one RFC 1950
stream whose Adler-32 is folded from per-chunk states with the combine
rule.  Decode mirrors it.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from tpu_deflate.config import DeflateConfig
from tpu_deflate.ops.checksum import adler32_state
from tpu_deflate.ops.encode import encode_blocks_batch
from zlib import crc32  # C implementation

from tpu_deflate.spec.checksum import adler32_combine


def _chunk(data: bytes, chunk_size: int):
    """Split into fixed-size chunks, pad the last; returns (array[B, C],
    lengths[B])."""
    n = len(data)
    nchunks = max(1, -(-n // chunk_size))
    padded = np.zeros((nchunks, chunk_size), dtype=np.uint8)
    flat = np.frombuffer(data, dtype=np.uint8)
    for i in range(nchunks):
        part = flat[i * chunk_size : (i + 1) * chunk_size]
        padded[i, : len(part)] = part
    lengths = np.minimum(
        np.maximum(n - np.arange(nchunks) * chunk_size, 0), chunk_size
    ).astype(np.int32)
    return padded, lengths


_adler_states = jax.jit(jax.vmap(adler32_state))


def deflate_device(data: bytes, config: DeflateConfig = DeflateConfig()):
    """Encode on device; returns (chunks uint8[B, M], out_lens[B], adler).

    The batch is padded to a power of two with empty blocks (trailing,
    dropped on assembly) so compiled programs are reused across sizes.
    ``config.one_block`` encodes the whole input as a single chunk (one
    DEFLATE block), the reference's ONEBLOCK elaboration
    (/root/reference/deflate.py:28).
    """
    chunk_size = config.chunk_size
    if config.one_block:
        chunk_size = max(
            chunk_size, 1 << int(np.ceil(np.log2(max(len(data), 2))))
        )
    arr, lengths = _chunk(data, chunk_size)
    nchunks = arr.shape[0]
    bpad = max(1, 1 << int(np.ceil(np.log2(nchunks))))
    if bpad > nchunks:
        arr = np.pad(arr, ((0, bpad - nchunks), (0, 0)))
        lengths = np.pad(lengths, (0, bpad - nchunks))
    finals = np.zeros(bpad, dtype=bool)
    finals[nchunks - 1] = True
    out, out_lens, _ = encode_blocks_batch(
        jnp.asarray(arr), jnp.asarray(lengths), jnp.asarray(finals), config
    )
    # per-chunk adler folded on host (cheap: B states); padded chunks have
    # length 0 and contribute the identity state (1, 0)
    a, b = _adler_states(jnp.asarray(arr), jnp.asarray(lengths))
    a = np.asarray(a)
    b = np.asarray(b)
    out = np.asarray(out)[:nchunks]
    out_lens = np.asarray(out_lens)[:nchunks]
    lengths = lengths[:nchunks]
    adler = 1
    for i in range(nchunks):
        chunk_ad = (int(b[i]) << 16) | int(a[i])
        adler = adler32_combine(adler, chunk_ad, int(lengths[i]))
    return np.asarray(out), np.asarray(out_lens), adler


def compress(data: bytes, config: DeflateConfig = DeflateConfig()) -> bytes:
    """zlib-compatible compress using the device encode path."""
    if not config.compress:
        raise ValueError("config disables compress")
    out, out_lens, adler = deflate_device(data, config)
    body = b"".join(
        out[i, : out_lens[i]].tobytes() for i in range(out.shape[0])
    )
    return b"\x78\x9c" + body + int(adler).to_bytes(4, "big")


def compress_gzip(data: bytes, config: DeflateConfig = DeflateConfig()) -> bytes:
    """gzip (RFC 1952) compress using the device encode path."""
    out, out_lens, _ = deflate_device(data, config)
    body = b"".join(
        out[i, : out_lens[i]].tobytes() for i in range(out.shape[0])
    )
    header = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff"
    trailer = crc32(data).to_bytes(4, "little") + (
        len(data) & 0xFFFFFFFF
    ).to_bytes(4, "little")
    return header + body + trailer


def decompress(data: bytes, config: DeflateConfig = DeflateConfig()) -> bytes:
    """zlib-compatible decompress on the device (ops/decode.py).

    Decodes any conformant RFC 1950 stream and verifies its Adler-32;
    raises DeflateError on a corrupt stream.  There is no host fallback.
    """
    if not config.decompress:
        raise ValueError("config disables decompress")
    from tpu_deflate.ops import decode as ddec

    return ddec.zlib_decompress_device(data, config)


def compress_indexed(data: bytes, config: DeflateConfig = DeflateConfig()):
    """Compress and return (zlib stream, chunk-size index).

    The index (compressed byte size of each chunk) enables chunk-parallel
    decode; it is a sidecar, the stream itself is plain RFC 1950 (any zlib
    can read it without the index).
    """
    out, out_lens, adler = deflate_device(data, config)
    body = b"".join(
        out[i, : out_lens[i]].tobytes() for i in range(out.shape[0])
    )
    stream = b"\x78\x9c" + body + int(adler).to_bytes(4, "big")
    return stream, np.asarray(out_lens, dtype=np.int64)


import functools as _functools


@_functools.lru_cache(maxsize=None)
def _chunk_decoder(chunk: int, tok_cap: int, static_only: bool):
    """Cached jitted chunk-parallel decoder.  A per-call closure would be
    a fresh jit cache key and recompile on EVERY call (measured: tens of
    seconds per decompress_indexed invocation)."""
    import jax

    from tpu_deflate.ops.decode import chunk_pwin, expand_batch, tokenize

    @jax.jit
    def dec(dbuf, ss, ee):
        tk, ta, tb, tp, _tot, _pos, err = jax.vmap(
            lambda s, e: tokenize(
                dbuf, s, tok_cap=tok_cap, end_bit=e, pwin=chunk_pwin(chunk),
                stop_at_eob=True, static_only=static_only,
            )
        )(ss, ee)
        o, total = expand_batch(dbuf, tk, ta, tb, tp, out_cap=chunk)
        return o, total, err

    return dec


def decompress_indexed(
    stream: bytes,
    index: np.ndarray,
    config: DeflateConfig = DeflateConfig(),
) -> bytes:
    """Chunk-parallel decompress of an indexed stream (vmapped lanes, one
    per chunk).  Verifies the Adler-32 trailer."""
    body = stream[2:-4]
    index = np.asarray(index, dtype=np.int64)
    nchunks = len(index)
    offsets = np.concatenate([[0], np.cumsum(index)])
    if offsets[-1] != len(body):
        raise ValueError("index does not cover the stream body")

    m_pad = max(1 << 12, 1 << int(np.ceil(np.log2(max(len(body), 2)))))
    buf = np.zeros(m_pad, np.uint8)
    buf[: len(body)] = np.frombuffer(body, np.uint8)
    dbuf = jnp.asarray(buf)

    bpad = max(1, 1 << int(np.ceil(np.log2(nchunks))))
    starts = np.full(bpad, 8 * offsets[-1], np.int64)
    ends = np.full(bpad, 8 * offsets[-1], np.int64)
    starts[:nchunks] = 8 * offsets[:-1]
    ends[:nchunks] = 8 * offsets[1:]

    chunk = config.chunk_size
    tok_cap = chunk + 16
    from tpu_deflate.ops.decode import ERR_DYNAMIC
    from tpu_deflate.ref.inflate import DeflateError

    # arithmetic static decode first (our container is static/stored
    # unless dynamic_encode); fall back on ERR_DYNAMIC lanes when the
    # config's DYNAMIC elaboration flag allows the dynamic decoder
    allow_dynamic = config.dynamic and not config.low_lut
    ss = jnp.asarray(starts, jnp.int32)
    ee = jnp.asarray(ends, jnp.int32)
    static_first = (not config.dynamic_encode) or not allow_dynamic
    outs, totals, errs = _chunk_decoder(chunk, tok_cap, static_first)(
        dbuf, ss, ee
    )
    errs = np.asarray(errs)[:nchunks]
    if static_first and (errs == ERR_DYNAMIC).any():
        if not allow_dynamic:
            raise DeflateError(
                "dynamic-Huffman block rejected: decoder compiled with "
                "dynamic=False/low_lut"
            )
        outs, totals, errs = _chunk_decoder(chunk, tok_cap, False)(
            dbuf, ss, ee
        )
        errs = np.asarray(errs)[:nchunks]
    if (errs != 0).any():
        raise ValueError(f"inflate error codes {errs[errs != 0][:8]}")
    outs_h = np.asarray(outs)[:nchunks]
    totals_h = np.asarray(totals)[:nchunks]
    if nchunks > 1 and (totals_h[:-1] == chunk).all():
        # common shape (all interior chunks full): one memcpy, not a
        # per-chunk join
        result = (
            outs_h[:-1].reshape(-1).tobytes()
            + outs_h[-1, : totals_h[-1]].tobytes()
        )
    else:
        result = b"".join(
            outs_h[i, : totals_h[i]].tobytes() for i in range(nchunks)
        )
    expect = int.from_bytes(stream[-4:], "big")
    import zlib as _z

    if _z.adler32(result) != expect:
        raise ValueError("Adler-32 mismatch")
    return result


class StreamCompressor:
    """Incremental compression — the array-API analog of the reference's
    flow-controlled streaming protocol (write bytes / poll progress /
    drain output, /root/reference/test_deflate.py:142-174,239-287).

    Feed arbitrary byte slices with compress(); complete chunks are
    encoded on device in batches and compressed bytes are returned as
    they become available.  flush() emits the final block and trailer.
    """

    def __init__(self, config: DeflateConfig = DeflateConfig()):
        self._config = config
        self._pending = bytearray()
        self._header_sent = False
        self._adler = 1
        self._finished = False

    def _encode_chunks(self, chunks: np.ndarray, lengths: np.ndarray, finals):
        out, out_lens, _ = encode_blocks_batch(
            jnp.asarray(chunks), jnp.asarray(lengths), jnp.asarray(finals),
            self._config,
        )
        out = np.asarray(out)
        out_lens = np.asarray(out_lens)
        return b"".join(
            out[i, : out_lens[i]].tobytes() for i in range(len(lengths))
        )

    def compress(self, data: bytes) -> bytes:
        if self._finished:
            raise ValueError("stream already flushed")
        self._pending.extend(data)
        C = self._config.chunk_size
        nfull = len(self._pending) // C
        if nfull == 0:
            return b"" if self._header_sent else b""
        take = bytes(self._pending[: nfull * C])
        del self._pending[: nfull * C]
        arr = np.frombuffer(take, np.uint8).reshape(nfull, C)
        lens = np.full(nfull, C, np.int32)
        finals = np.zeros(nfull, bool)
        from zlib import adler32 as _ad

        self._adler = _ad(take, self._adler)
        body = self._encode_chunks(arr, lens, finals)
        if not self._header_sent:
            self._header_sent = True
            return b"\x78\x9c" + body
        return body

    def flush(self) -> bytes:
        if self._finished:
            raise ValueError("stream already flushed")
        self._finished = True
        C = self._config.chunk_size
        tail = bytes(self._pending)
        self._pending.clear()
        arr = np.zeros((1, C), np.uint8)
        arr[0, : len(tail)] = np.frombuffer(tail, np.uint8)
        from zlib import adler32 as _ad

        self._adler = _ad(tail, self._adler)
        body = self._encode_chunks(
            arr, np.array([len(tail)], np.int32), np.array([True])
        )
        prefix = b"" if self._header_sent else b"\x78\x9c"
        self._header_sent = True
        return prefix + body + self._adler.to_bytes(4, "big")


# --- self-indexing multi-member gzip (BGZF-style) --------------------------
#
# Each chunk is a complete gzip member whose FEXTRA subfield 'TD' carries
# the member's total byte length, so member boundaries are discovered by a
# cheap header hop-scan and decode parallelizes with no sidecar index —
# while stock gzip tools read the stream unchanged (RFC 1952 requires
# readers to accept multi-member files and ignore unknown extra fields).

_GZ_SUBFIELD = b"TD"


def _gzip_member_header(member_len: int) -> bytes:
    extra = _GZ_SUBFIELD + (4).to_bytes(2, "little") + member_len.to_bytes(4, "little")
    return (
        b"\x1f\x8b\x08\x04"  # magic, deflate, FLG=FEXTRA
        + b"\x00\x00\x00\x00"  # mtime
        + b"\x00\xff"  # xfl, os
        + len(extra).to_bytes(2, "little")
        + extra
    )


_GZ_HDR_LEN = 10 + 2 + 8  # base + xlen + subfield


def compress_gzip_members(
    data: bytes, config: DeflateConfig = DeflateConfig()
) -> bytes:
    """Multi-member gzip: one member per chunk, self-indexing via FEXTRA."""
    arr, lengths = _chunk(data, config.chunk_size)
    nchunks = arr.shape[0]
    bpad = max(1, 1 << int(np.ceil(np.log2(nchunks))))
    if bpad > nchunks:
        arr = np.pad(arr, ((0, bpad - nchunks), (0, 0)))
        lengths = np.pad(lengths, (0, bpad - nchunks))
    finals = np.ones(bpad, dtype=bool)  # every member is a complete stream
    out, out_lens, _ = encode_blocks_batch(
        jnp.asarray(arr), jnp.asarray(lengths), jnp.asarray(finals), config
    )
    out = np.asarray(out)
    out_lens = np.asarray(out_lens)
    parts = []
    pos = 0
    for i in range(nchunks):
        raw = data[pos : pos + int(lengths[i])]
        pos += int(lengths[i])
        body = out[i, : out_lens[i]].tobytes()
        member_len = _GZ_HDR_LEN + len(body) + 8
        parts.append(_gzip_member_header(member_len))
        parts.append(body)
        parts.append(crc32(raw).to_bytes(4, "little"))
        parts.append((len(raw) & 0xFFFFFFFF).to_bytes(4, "little"))
    return b"".join(parts)


def _scan_gzip_members(data: bytes):
    """Hop-scan member boundaries via the 'TD' FEXTRA subfield.
    Returns list of (body_start, body_end, isize) or None if not ours."""
    members = []
    pos = 0
    n = len(data)
    while pos < n:
        if data[pos : pos + 2] != b"\x1f\x8b" or len(data) < pos + _GZ_HDR_LEN:
            return None
        if data[pos + 3] != 0x04:
            return None
        xlen = int.from_bytes(data[pos + 10 : pos + 12], "little")
        if xlen != 8 or data[pos + 12 : pos + 14] != _GZ_SUBFIELD:
            return None
        member_len = int.from_bytes(data[pos + 16 : pos + 20], "little")
        body_start = pos + _GZ_HDR_LEN
        body_end = pos + member_len - 8
        isize = int.from_bytes(
            data[pos + member_len - 4 : pos + member_len], "little"
        )
        if body_end <= body_start or pos + member_len > n:
            return None
        members.append((body_start, body_end, isize))
        pos += member_len
    return members


def decompress_gzip(data: bytes, config: DeflateConfig = DeflateConfig()) -> bytes:
    """gzip decompress: chunk-parallel for self-indexing members, member-
    by-member device decode otherwise."""
    members = _scan_gzip_members(data)
    if members is None:
        return _foreign_gzip_device(data, config)
    return b"".join(_decode_member_bodies(data, members, config))


def _parse_gzip_header(data: bytes, pos: int) -> int:
    """RFC 1952 header walk: return the deflate-body byte offset of the
    member starting at ``pos`` (handles FEXTRA/FNAME/FCOMMENT/FHCRC)."""
    from tpu_deflate.ref.inflate import DeflateError

    if data[pos : pos + 2] != b"\x1f\x8b":
        raise DeflateError("bad gzip magic")
    if data[pos + 2] != 8:
        raise DeflateError("unsupported gzip method")
    flg = data[pos + 3]
    p = pos + 10
    if flg & 0x04:  # FEXTRA
        xlen = int.from_bytes(data[p : p + 2], "little")
        p += 2 + xlen
    if flg & 0x08:  # FNAME
        p = data.index(b"\x00", p) + 1
    if flg & 0x10:  # FCOMMENT
        p = data.index(b"\x00", p) + 1
    if flg & 0x02:  # FHCRC
        p += 2
    return p


def _foreign_gzip_device(data: bytes, config: DeflateConfig) -> bytes:
    """Foreign (non-self-indexing) gzip: host header hop-scan + sequential
    DEVICE inflate of each member's deflate body.

    The decode-anything bar of the reference (its FSM decodes any
    conformant stream, /root/reference/deflate.py:656-732); member
    boundaries are only discoverable by decoding, so members run
    sequentially — each one on device via ``inflate_device``."""
    from tpu_deflate.ops.decode import inflate_device
    from tpu_deflate.ref.inflate import DeflateError
    from zlib import crc32 as _crc

    out_all = bytearray()
    pos = 0
    while pos < len(data):
        body_start = _parse_gzip_header(data, pos)
        out, total, end_bit = inflate_device(
            data,
            start_bit=8 * body_start,
            static_only=config.low_lut or not config.dynamic,
            one_block=config.one_block,
        )
        p = (end_bit + 7) // 8
        expect_crc = int.from_bytes(data[p : p + 4], "little")
        expect_isize = int.from_bytes(data[p + 4 : p + 8], "little")
        piece = out[:total].tobytes()
        if _crc(piece) != expect_crc:
            raise DeflateError("gzip CRC-32 mismatch")
        if (total & 0xFFFFFFFF) != expect_isize:
            raise DeflateError("gzip ISIZE mismatch")
        out_all.extend(piece)
        pos = p + 8
    return bytes(out_all)


def _decode_member_bodies(data: bytes, members, config: DeflateConfig):
    """Batched device decode of self-indexing gzip members.

    members: list of (body_start, body_end, isize) into ``data``.  Returns
    the decoded bytes of each member (CRC-verified), in order."""
    chunk = config.chunk_size
    if any(isize > chunk for (_s, _e, isize) in members):
        raise ValueError("member larger than config.chunk_size")
    nm = len(members)
    m_pad = max(1 << 12, 1 << int(np.ceil(np.log2(max(len(data), 2)))))
    buf = np.zeros(m_pad, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    dbuf = jnp.asarray(buf)
    bpad = max(1, 1 << int(np.ceil(np.log2(nm))))
    starts = np.full(bpad, 8 * len(data), np.int64)
    ends = np.full(bpad, 8 * len(data), np.int64)
    for i, (s, e, _) in enumerate(members):
        starts[i] = 8 * s
        ends[i] = 8 * e
    tok_cap = chunk + 16
    from tpu_deflate.ops.decode import ERR_DYNAMIC
    from tpu_deflate.ref.inflate import DeflateError

    allow_dynamic = config.dynamic and not config.low_lut
    ss = jnp.asarray(starts, jnp.int32)
    ee = jnp.asarray(ends, jnp.int32)
    static_first = (not config.dynamic_encode) or not allow_dynamic
    outs, totals, errs = _chunk_decoder(chunk, tok_cap, static_first)(dbuf, ss, ee)
    errs = np.asarray(errs)[:nm]
    if static_first and (errs == ERR_DYNAMIC).any():
        if not allow_dynamic:
            raise DeflateError(
                "dynamic-Huffman block rejected: decoder compiled with "
                "dynamic=False/low_lut"
            )
        outs, totals, errs = _chunk_decoder(chunk, tok_cap, False)(dbuf, ss, ee)
        errs = np.asarray(errs)[:nm]
    if (errs != 0).any():
        raise ValueError(f"inflate error codes {errs[errs != 0][:8]}")
    outs_h = np.asarray(outs)[:nm]
    totals_h = np.asarray(totals)[:nm]
    from zlib import crc32 as _crc

    parts = []
    for i, (s, e, isize) in enumerate(members):
        piece = outs_h[i, : totals_h[i]].tobytes()
        if len(piece) != isize:
            raise ValueError(f"member {i} ISIZE mismatch")
        expect = int.from_bytes(data[e : e + 4], "little")
        if _crc(piece) != expect:
            raise ValueError(f"member {i} CRC-32 mismatch")
        parts.append(piece)
    return parts


class StreamDecompressor:
    """Incremental decompression counterpart of StreamCompressor.

    Feed compressed bytes with decompress(); output is emitted as soon as
    complete units become decodable — member granularity for the
    self-indexing gzip container (each member's FEXTRA 'TD' length makes
    completeness checkable without decoding), BLOCK granularity for
    index-free zlib input (device decode per complete DEFLATE block,
    carrying the 32 KB output window across calls), whole-stream
    granularity for foreign gzip.  flush() verifies trailers and returns
    any remaining output.  This is the array-API analog of the
    reference's backpressured READ drain
    (/root/reference/test_deflate.py:142-174): the consumer receives
    bytes while the producer is still feeding.
    """

    def __init__(self, config: DeflateConfig = DeflateConfig()):
        self._config = config
        self._buf = bytearray()
        self._finished = False
        self._mode = None  # None (undecided) | "members" | "zlib" | "whole"
        # index-free zlib incremental state
        self._pending = bytearray()  # compressed bytes after the header
        self._pbit = 0  # bits of _pending[0] already consumed
        self._window = b""  # last <= 32 KB of emitted output
        self._adler = 1
        self._zdone = False  # final block decoded; trailer may follow

    def _complete_members(self):
        """Scan complete self-indexing members at the buffer head.
        Returns (members, consumed_bytes) without decoding anything."""
        members = []
        pos = 0
        buf = self._buf
        n = len(buf)
        while pos + _GZ_HDR_LEN <= n:
            if (
                bytes(buf[pos : pos + 2]) != b"\x1f\x8b"
                or buf[pos + 3] != 0x04
                or bytes(buf[pos + 12 : pos + 14]) != _GZ_SUBFIELD
            ):
                raise ValueError("not a self-indexing gzip member stream")
            member_len = int.from_bytes(buf[pos + 16 : pos + 20], "little")
            if pos + member_len > n:
                break  # incomplete member: wait for more input
            body_start = pos + _GZ_HDR_LEN
            body_end = pos + member_len - 8
            isize = int.from_bytes(
                buf[pos + member_len - 4 : pos + member_len], "little"
            )
            members.append((body_start, body_end, isize))
            pos += member_len
        return members, pos

    def _emit(self, pieces, emitted: bytes):
        from zlib import adler32 as _ad

        pieces.append(emitted)
        self._adler = _ad(emitted, self._adler)
        self._window = (bytes(self._window) + emitted)[-32768:]

    def _stored_step(self):
        """Decode one byte-aligned stored block at the pending head on the
        host (raw byte copy — the analog of the reference's 2-cycle COPY,
        deflate.py:1603-1626).  Returns (payload, consumed_bits, bfinal)
        or None if the block is not completely buffered."""
        buf = self._pending
        avail = 8 * len(buf) - self._pbit
        if avail < 3:
            return None
        bfinal = (buf[self._pbit >> 3] >> (self._pbit & 7)) & 1
        lo = (self._pbit + 3 + 7) >> 3  # align to byte after the 3-bit hdr
        if len(buf) < lo + 4:
            return None
        ln = buf[lo] | (buf[lo + 1] << 8)
        nln = buf[lo + 2] | (buf[lo + 3] << 8)
        if ln != (nln ^ 0xFFFF):
            raise ValueError("stored block LEN/NLEN mismatch")
        if len(buf) < lo + 4 + ln:
            return None
        payload = bytes(buf[lo + 4 : lo + 4 + ln])
        return payload, 8 * (lo + 4 + ln) - self._pbit, bool(bfinal)

    def _drain_zlib(self) -> bytes:
        """Decode every completely-buffered block; emit its output.

        Stored blocks are byte-aligned on the ORIGINAL stream's byte grid,
        which the bit-shifted synthetic buffer of inflate_stream_step
        cannot reproduce — they are handled on the host; huffman blocks
        decode on device (one block per step, window carried)."""
        from tpu_deflate.ops.decode import inflate_stream_step

        static_only = self._config.low_lut or not self._config.dynamic
        pieces = []
        while not self._zdone and self._pending:
            if 8 * len(self._pending) - self._pbit < 3:
                break
            hdr = int.from_bytes(bytes(self._pending[:2]).ljust(2, b"\0"),
                                 "little")
            btype = (hdr >> (self._pbit + 1)) & 3
            if btype == 3:
                raise ValueError("invalid DEFLATE block type 3")
            if btype == 0:
                step = self._stored_step()
                if step is None:
                    break
                emitted, consumed, done = step
            else:
                emitted, consumed, done = inflate_stream_step(
                    self._window, bytes(self._pending), self._pbit,
                    static_only=static_only,
                )
                if consumed == 0 and not done:
                    break  # next block not fully buffered yet
            nbit = self._pbit + consumed
            del self._pending[: nbit >> 3]
            self._pbit = nbit & 7
            if emitted:
                self._emit(pieces, emitted)
            self._zdone = done
        return b"".join(pieces)

    def decompress(self, data: bytes) -> bytes:
        if self._finished:
            raise ValueError("stream already finished")
        self._buf.extend(data)
        if self._mode is None and len(self._buf) >= 2:
            if bytes(self._buf[0:2]) == b"\x1f\x8b":
                if len(self._buf) < _GZ_HDR_LEN:
                    return b""  # gzip: need the full base header to decide
                is_member = (
                    self._buf[3] == 0x04
                    and bytes(self._buf[12:14]) == _GZ_SUBFIELD
                )
                self._mode = "members" if is_member else "whole"
            else:
                cmf, flg = self._buf[0], self._buf[1]
                if cmf & 0x0F == 8 and ((cmf << 8) | flg) % 31 == 0:
                    self._mode = "zlib"
                    del self._buf[:2]
                else:
                    self._mode = "whole"
        if self._mode == "zlib":
            self._pending.extend(self._buf)
            self._buf.clear()
            return self._drain_zlib()
        if self._mode != "members":
            return b""  # foreign gzip: output is delivered at flush
        members, consumed = self._complete_members()
        if not members:
            return b""
        head = bytes(self._buf[:consumed])
        del self._buf[:consumed]
        return b"".join(_decode_member_bodies(head, members, self._config))

    def flush(self) -> bytes:
        if self._finished:
            raise ValueError("stream already finished")
        self._finished = True
        if self._mode == "zlib":
            out = self._drain_zlib()
            if not self._zdone:
                raise ValueError("truncated zlib stream at flush")
            trailer_at = (self._pbit + 7) >> 3
            trailer = bytes(self._pending[trailer_at : trailer_at + 4])
            if len(trailer) < 4:
                raise ValueError("truncated zlib trailer at flush")
            if int.from_bytes(trailer, "big") != self._adler:
                raise ValueError("Adler-32 mismatch")
            return out
        tail = bytes(self._buf)
        self._buf.clear()
        if self._mode == "members":
            if tail:
                raise ValueError("truncated gzip member at end of stream")
            return b""
        if not tail:
            return b""
        if tail[:2] == b"\x1f\x8b":
            return decompress_gzip(tail, self._config)
        return decompress(tail, self._config)
