"""Device (JAX) codec tests on the virtual CPU backend, zlib as oracle in
both directions — the device analog of the reference's streaming testbench
(/root/reference/test_deflate.py:90-296)."""

import zlib

import numpy as np
import pytest

from tpu_deflate import api
from tpu_deflate.config import DeflateConfig
from tests.corpora import ALL_MODES, corpus

SMALL = DeflateConfig(window=256, max_match=10, chunk_size=4096)
FULL = DeflateConfig(window=32768, max_match=258, chunk_size=4096)
FAST = DeflateConfig(fast=True, chunk_size=4096)


class TestDeviceEncode:
    @pytest.mark.parametrize("mode", ALL_MODES)
    def test_encode_zlib_decodable(self, mode):
        data = corpus(mode, 3000)
        comp = api.compress(data, SMALL)
        assert zlib.decompress(comp) == data

    @pytest.mark.parametrize("mode", [0, 1, 3, 6])
    def test_full_window_encode(self, mode):
        data = corpus(mode, 3000)
        comp = api.compress(data, FULL)
        assert zlib.decompress(comp) == data

    def test_fast_config(self):
        data = corpus(1, 2200)
        assert zlib.decompress(api.compress(data, FAST)) == data

    def test_multichunk_stream(self):
        """Multiple independent device-encoded blocks concatenate into one
        valid zlib stream with a combined Adler-32."""
        data = b"".join(corpus(m, 3000) for m in [0, 1, 2, 3, 4])
        comp = api.compress(data, SMALL)
        assert zlib.decompress(comp) == data

    def test_empty(self):
        assert zlib.decompress(api.compress(b"", SMALL)) == b""

    def test_single_byte(self):
        assert zlib.decompress(api.compress(b"x", SMALL)) == b"x"

    def test_chunk_boundary_sizes(self):
        for size in [4095, 4096, 4097, 8192, 8193]:
            data = corpus(0, size)
            assert zlib.decompress(api.compress(data, SMALL)) == data

    def test_gzip_container(self):
        import gzip as gz

        data = corpus(1, 5000)
        assert gz.decompress(api.compress_gzip(data, SMALL)) == data

    def test_size_parity_with_host_reference(self):
        """Device encoder must be within a few % of the host greedy encoder
        (same window/match rules) — guards against parse regressions."""
        from tpu_deflate.ref.deflate import zlib_compress

        data = corpus(1, 3000)
        dev = len(api.compress(data, SMALL))
        host = len(zlib_compress(data, SMALL))
        assert dev <= host * 1.05, (dev, host)


class TestDeviceDecode:
    @pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
    @pytest.mark.parametrize("level", [1, 6, 9])
    def test_decode_zlib(self, mode, level):
        data = corpus(mode, 3000)
        comp = zlib.compress(data, level)
        assert api.decompress(comp) == data

    def test_decode_static(self):
        data = corpus(1, 3000)
        co = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_FIXED)
        comp = co.compress(data) + co.flush()
        assert api.decompress(comp) == data

    def test_decode_stored(self):
        data = corpus(3, 2000)
        assert api.decompress(zlib.compress(data, 0)) == data

    def test_decode_multiblock(self):
        co = zlib.compressobj(6)
        data = b""
        parts = []
        for mode in [0, 3, 1]:
            chunk = corpus(mode, 1500)
            data += chunk
            parts.append(co.compress(chunk))
            parts.append(co.flush(zlib.Z_SYNC_FLUSH))
        parts.append(co.flush())
        assert api.decompress(b"".join(parts)) == data

    def test_decode_full_window(self):
        data = corpus(0, 40000) + corpus(2, 5000)
        assert api.decompress(zlib.compress(data, 9)) == data

    def test_corrupt_detected(self):
        comp = bytearray(zlib.compress(corpus(1, 500)))
        comp[10] ^= 0x40
        with pytest.raises(ValueError):
            api.decompress(bytes(comp))

    def test_empty_stream(self):
        assert api.decompress(zlib.compress(b"")) == b""


class TestRoundTrip:
    """Hardware-self-test analog: our encoder -> our decoder, no zlib
    (reference test_deflate_bench does this on-chip,
    test_deflate.py:326-653)."""

    @pytest.mark.parametrize("mode", [0, 1, 2, 3, 5])
    def test_own_roundtrip(self, mode):
        data = corpus(mode, 3000)
        assert api.decompress(api.compress(data, SMALL)) == data

    def test_own_roundtrip_multichunk(self):
        data = b"".join(corpus(m, 2500) for m in [1, 0, 3])
        assert api.decompress(api.compress(data, FULL)) == data


class TestStoredFallback:
    """Incompressible chunks must be emitted as stored blocks (bounded
    expansion), including the >65535-byte two-block case."""

    def test_random_data_bounded_expansion(self):
        data = corpus(3, 100000)  # pure random
        cfg = DeflateConfig(window=256, max_match=10, chunk_size=65536)
        comp = api.compress(data, cfg)
        assert zlib.decompress(comp) == data
        # stored framing: 5 bytes per 65535 + container overhead
        assert len(comp) <= len(data) + 5 * (len(data) // 65535 + 2) + 16

    def test_mixed_compressible_incompressible(self):
        data = corpus(3, 5000) + corpus(0, 5000) + corpus(3, 5000)
        cfg = DeflateConfig(window=256, max_match=10, chunk_size=4096)
        comp = api.compress(data, cfg)
        assert zlib.decompress(comp) == data
        assert len(comp) < len(data)  # middle section compresses

    def test_own_decoder_handles_stored_fallback(self):
        data = corpus(3, 20000)
        cfg = DeflateConfig(window=256, max_match=10, chunk_size=4096)
        assert api.decompress(api.compress(data, cfg)) == data


class TestDynamicEncode:
    """Device-side dynamic-Huffman encode (capability beyond the
    reference, whose encoder is static-only)."""

    DYN = DeflateConfig(
        window=32768, max_match=258, chunk_size=8192, lazy=True,
        dynamic_encode=True,
    )

    @pytest.mark.parametrize("mode", [0, 1, 2, 3, 4, 6, 7])
    def test_zlib_decodable(self, mode):
        data = corpus(mode, 9000)
        comp = api.compress(data, self.DYN)
        assert zlib.decompress(comp) == data

    def test_beats_static(self):
        # mode 4: '0'/'1' characters — an 8-bit static literal code wastes
        # 7 bits per byte, so dynamic trees must win decisively
        data = corpus(4, 9000)
        dyn = len(api.compress(data, self.DYN))
        static = len(
            api.compress(
                data,
                DeflateConfig(
                    window=32768, max_match=258, chunk_size=8192, lazy=True
                ),
            )
        )
        assert dyn < static

    def test_own_decoder_roundtrip(self):
        data = b"".join(corpus(m, 5000) for m in [0, 2, 3])
        assert api.decompress(api.compress(data, self.DYN)) == data

    def test_empty_and_tiny(self):
        for data in [b"", b"a", b"ab" * 3]:
            assert zlib.decompress(api.compress(data, self.DYN)) == data

    def test_indexed_parallel_decode_of_dynamic(self):
        data = b"".join(corpus(m, 5000) for m in [1, 0])
        stream, index = api.compress_indexed(data, self.DYN)
        assert api.decompress_indexed(stream, index, self.DYN) == data


class TestGzipMembers:
    """Self-indexing multi-member gzip (BGZF-style): stock-compatible,
    sidecar-free parallel decode."""

    CFG = DeflateConfig(
        window=32768, max_match=258, chunk_size=4096, lazy=True,
        dynamic_encode=True,
    )

    def test_stock_gzip_reads_members(self):
        import gzip as gz

        data = b"".join(corpus(m, 6000) for m in [0, 1, 3])
        g = api.compress_gzip_members(data, self.CFG)
        assert gz.decompress(g) == data

    def test_parallel_member_decode(self):
        data = b"".join(corpus(m, 6000) for m in [0, 2, 3, 4])
        g = api.compress_gzip_members(data, self.CFG)
        assert api.decompress_gzip(g, self.CFG) == data

    def test_foreign_gzip_fallback(self):
        import gzip as gz

        data = corpus(1, 5000)
        assert api.decompress_gzip(gz.compress(data), self.CFG) == data

    def test_member_crc_verified(self):
        data = corpus(0, 9000)
        g = bytearray(api.compress_gzip_members(data, self.CFG))
        g[60] ^= 0x20
        with pytest.raises(ValueError):
            api.decompress_gzip(bytes(g), self.CFG)

    def test_empty(self):
        import gzip as gz

        g = api.compress_gzip_members(b"", self.CFG)
        assert gz.decompress(g) == b""
        assert api.decompress_gzip(g, self.CFG) == b""

    def test_foreign_gzip_on_device(self, monkeypatch):
        """Foreign (stock) gzip must decode via the DEVICE inflate, not
        the host reference loop (reference decodes any conformant stream
        in hardware, deflate.py:656-732)."""
        import gzip as gz
        import io

        import tpu_deflate.ref.inflate as ref_inflate

        def _boom(*a, **k):  # pragma: no cover - tripwire
            raise AssertionError("host gzip fallback used for foreign gzip")

        monkeypatch.setattr(ref_inflate, "gzip_decompress", _boom)
        data = b"".join(corpus(m, 20000) for m in [1, 3])
        assert api.decompress_gzip(gz.compress(data, 6)) == data
        # multi-member with FNAME/FCOMMENT header fields
        buf = io.BytesIO()
        with gz.GzipFile(fileobj=buf, mode="wb", filename="a.txt") as f:
            f.write(data[:5000])
        stream = buf.getvalue() + gz.compress(data[5000:9000], 1)
        assert api.decompress_gzip(stream) == data[:9000]


class TestStreamDecompressor:
    """Incremental decode: output must flow BEFORE the final flush when
    the input is the self-indexing member container (the analog of the
    reference's backpressured READ drain, test_deflate.py:142-174)."""

    CFG = DeflateConfig(window=256, max_match=10, chunk_size=4096)

    def test_incremental_member_output(self):
        data = b"".join(corpus(m, 6000) for m in [0, 1, 3, 2])
        g = api.compress_gzip_members(data, self.CFG)
        d = api.StreamDecompressor(self.CFG)
        got = b""
        early = 0
        step = 1000
        for i in range(0, len(g), step):
            piece = d.decompress(g[i : i + step])
            got += piece
            if i + step < len(g) and piece:
                early += len(piece)
        got += d.flush()
        assert got == data
        assert early > 0, "no output produced before flush"

    def test_single_shot_members(self):
        data = corpus(1, 9000)
        g = api.compress_gzip_members(data, self.CFG)
        d = api.StreamDecompressor(self.CFG)
        out = d.decompress(g) + d.flush()
        assert out == data

    def test_zlib_incremental(self):
        data = corpus(3, 9000)
        comp = api.compress(data, self.CFG)
        d = api.StreamDecompressor(self.CFG)
        got = d.decompress(comp[:50])
        got += d.decompress(comp[50:])
        assert got, "no output produced before flush"
        got += d.flush()
        assert got == data

    def test_zlib_incremental_foreign(self):
        """zlib -6 stream (dynamic trees, 32 KB back-refs) fed in 4 KiB
        slices must emit output before flush and round-trip, carrying
        the output window across calls (the backpressured feed/drain of
        /root/reference/test_deflate.py:142-174)."""
        import zlib

        data = b"".join(corpus(m, 40000) for m in [1, 3, 0])
        comp = zlib.compress(data, 6)
        d = api.StreamDecompressor()
        got = b""
        early = 0
        step = 4096
        for i in range(0, len(comp), step):
            piece = d.decompress(comp[i : i + step])
            if i + step < len(comp) and piece:
                early += len(piece)
            got += piece
        got += d.flush()
        assert got == data
        assert early > 0, "no output produced before flush"

    def test_zlib_incremental_truncated(self):
        data = corpus(1, 9000)
        comp = api.compress(data, self.CFG)
        d = api.StreamDecompressor(self.CFG)
        d.decompress(comp[: len(comp) - 6])
        with pytest.raises(ValueError):
            d.flush()

    def test_zlib_incremental_bad_adler(self):
        data = corpus(1, 9000)
        comp = bytearray(api.compress(data, self.CFG))
        comp[-1] ^= 0xFF
        d = api.StreamDecompressor(self.CFG)
        d.decompress(bytes(comp))
        with pytest.raises(ValueError, match="Adler"):
            d.flush()

    def test_truncated_member_rejected(self):
        data = corpus(0, 9000)
        g = api.compress_gzip_members(data, self.CFG)
        d = api.StreamDecompressor(self.CFG)
        d.decompress(g[: len(g) - 7])
        with pytest.raises(ValueError):
            d.flush()


class TestStaticOnlyTokenizer:
    """static_only=True must agree bit-exactly with the general tokenizer
    on stored/static streams and reject dynamic blocks with ERR_DYNAMIC."""

    def test_static_stream_parity(self):
        import zlib

        import jax.numpy as jnp

        from tpu_deflate.ops import decode as D

        data = (b"hello world, hello TPU! " * 300) + bytes(range(256)) * 4
        co = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_FIXED)
        s = co.compress(data) + co.flush()
        raw = np.frombuffer(s, np.uint8)[2:-4]
        arr = jnp.asarray(np.pad(raw, (0, 4096 - len(raw))))
        outs = []
        for so in (False, True):
            tk, ta, tb, tp, tot, pos, err = D.tokenize(
                arr, 0, tok_cap=1 << 14, pwin=1 << 15,
                stop_at_eob=True, static_only=so,
            )
            assert int(err) == 0
            out, total = D.expand(arr, tk, ta, tb, tp, out_cap=1 << 14)
            outs.append(np.asarray(out)[: int(total)].tobytes())
        assert outs[0] == data
        assert outs[1] == data

    def test_stored_block_under_static_only(self):
        import zlib

        import jax.numpy as jnp

        from tpu_deflate.ops import decode as D

        data = np.random.default_rng(9).integers(0, 256, 5000, np.uint8).tobytes()
        s = zlib.compress(data, 0)  # stored blocks
        raw = np.frombuffer(s, np.uint8)[2:-4]
        arr = jnp.asarray(np.pad(raw, (0, 8192 - len(raw))))
        tk, ta, tb, tp, tot, pos, err = D.tokenize(
            arr, 0, tok_cap=1 << 14, pwin=1 << 15,
            stop_at_eob=False, static_only=True,
        )
        assert int(err) == 0
        out, total = D.expand(arr, tk, ta, tb, tp, out_cap=1 << 14)
        assert np.asarray(out)[: int(total)].tobytes() == data

    def test_dynamic_rejected(self):
        import zlib

        import jax.numpy as jnp

        from tpu_deflate.ops import decode as D

        rng = np.random.default_rng(3)
        data = rng.integers(0, 200, 8000, np.uint8).tobytes() * 2
        s = zlib.compress(data, 6)
        raw = np.frombuffer(s, np.uint8)[2:-4]
        arr = jnp.asarray(np.pad(raw, (0, (1 << 15) - len(raw))))
        assert (raw[0] >> 1) & 3 == 2, "corpus should force a dynamic block"
        tk, ta, tb, tp, tot, pos, err = D.tokenize(
            arr, 0, tok_cap=1 << 14, pwin=1 << 15,
            stop_at_eob=True, static_only=True,
        )
        assert int(err) == D.ERR_DYNAMIC

    def test_indexed_roundtrip_static_fast_path(self):
        from tpu_deflate import api
        from tpu_deflate.config import DeflateConfig

        cfg = DeflateConfig(chunk_size=4096)
        data = b"".join(
            bytes([i % 251]) * (17 + i % 37) for i in range(600)
        )
        stream, index = api.compress_indexed(data, cfg)
        assert api.decompress_indexed(stream, index, cfg) == data


def test_multi_pass_boundary_chase():
    """Streams longer than one plane window: tokens accumulate across
    block passes (the window-continue path and the compaction's
    cross-pass slot offsets)."""
    import zlib

    import jax
    import jax.numpy as jnp

    from tpu_deflate.ops import decode as D

    data = (b"multi pass check %d " * 700) % tuple(range(700))
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_FIXED)
    s = co.compress(data) + co.flush()
    raw = np.frombuffer(s, np.uint8)[2:-4]
    m_pad = 1 << int(np.ceil(np.log2(len(raw) + 8)))
    arr = jnp.asarray(np.pad(raw, (0, m_pad - len(raw))))
    rows = jnp.stack([arr, arr])
    ends = jnp.asarray([8 * len(raw)] * 2, jnp.int32)
    for pwin in (1088, 17408):
        tk, ta, tb, tp, tot, pos, err = jax.vmap(
            lambda row, ee: D.tokenize(
                row, 0, tok_cap=1 << 15, end_bit=ee, pwin=pwin,
                stop_at_eob=True, static_only=True,
            )
        )(rows, ends)
        assert (np.asarray(err) == 0).all(), (pwin, np.asarray(err))
        out, total = D.expand_batch(rows, tk, ta, tb, tp, out_cap=1 << 15)
        got = np.asarray(out)[0, : int(np.asarray(total)[0])].tobytes()
        assert got == data, pwin


class TestFarMatcherKnob:
    def test_fast_far_matcher_roundtrip(self):
        """far_matcher='fast' (diagonal-run lengths) must still emit valid
        streams; ratio may trail the exact matcher but stays sane."""
        import zlib

        import tpu_deflate
        from tpu_deflate.config import DeflateConfig

        data = (corpus(1, 20000) + corpus(3, 8000) + b"\x00" * 5000) * 2
        exact = tpu_deflate.compress(
            data, DeflateConfig(window=32768, max_match=258, lazy=True,
                                far_matcher="exact")
        )
        fast = tpu_deflate.compress(
            data, DeflateConfig(window=32768, max_match=258, lazy=True,
                                far_matcher="fast")
        )
        assert zlib.decompress(exact) == data
        assert zlib.decompress(fast) == data
        assert len(fast) < len(data)  # still a real compressor
        assert len(exact) <= len(fast) * 1.05 or len(exact) <= len(fast)
