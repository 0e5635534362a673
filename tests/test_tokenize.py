"""Stage 1 (``tokenize``) and the chunk-parallel ``decode_rows_batch``,
checked against zlib and against a sequential walk.

Lanes cover static-tree, stored, dynamic-tree, corrupt and short-code
(2-bit literal) streams.  Tokens are replayed by a sequential token
replayer and compared with what stock zlib decodes; the boundary chase
(``chase_reach``) is compared with a plain Python walk.  Everything is
integer arithmetic with no float matrix product, so TF32 cannot affect
results and each comparison is byte equality.
"""

import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_expand import _emulate
from tpu_deflate.ops.decode import (
    ERR_OK,
    chase_reach,
    chunk_pwin,
    decode_rows_batch,
    expand_batch,
    tokenize,
)

PW = 64 * 512  # plane window for the small single-stream cases


def _zfixed(payload: bytes) -> bytes:
    co = zlib.compressobj(9, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    return co.compress(payload) + co.flush()


def _raw_deflate(payload: bytes, level: int = 9) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(payload) + co.flush()


def _rows(streams, width):
    rows = np.zeros((len(streams), width), np.uint8)
    ends = np.zeros(len(streams), np.int32)
    for i, s in enumerate(streams):
        rows[i, : len(s)] = np.frombuffer(s, np.uint8)
        ends[i] = 8 * len(s)
    return rows, ends


def _tokens(row, end, static_only, pwin=PW, tok_cap=4096):
    tk, ta, tb, tp, tot, pos, err = tokenize(
        jnp.asarray(row), 0, tok_cap=tok_cap, end_bit=int(end), pwin=pwin,
        stop_at_eob=True, static_only=static_only,
    )
    tp = int(tp)
    return (np.asarray(tk)[:tp], np.asarray(ta)[:tp], np.asarray(tb)[:tp],
            int(tot), int(pos), int(err))


@pytest.fixture(scope="module")
def static_streams(rng):
    payloads = [
        b"hello world " * 50,
        bytes(rng.integers(65, 91, 700, dtype=np.uint8)) * 2,
        b"a" * 1000,
        b"",
        b"x",
        (b"ab" * 700),
    ]
    return [(p, _zfixed(p)) for p in payloads]


class TestTokenizeStatic:
    def test_tokens_replay_to_zlib_output(self, static_streams):
        rows, ends = _rows([s for _p, s in static_streams], PW // 8 + 32)
        for i, (p, s) in enumerate(static_streams):
            assert zlib.decompress(s, -15) == p
            tk, ta, tb, tot, pos, err = _tokens(rows[i], ends[i], True)
            assert err == ERR_OK
            assert _emulate(tk, ta, tb) == p
            assert tot == len(p)
            # end position: the bit after the final end-of-block code
            assert (pos + 7) // 8 == len(s)

    def test_stored_and_empty_lanes(self, rng):
        """A stored block (incompressible payload) and an empty lane in the
        arithmetic static decoder's batch: the stored lane decodes, the
        empty lane yields no tokens and no error."""
        p = bytes(rng.integers(0, 256, 600, dtype=np.uint8))
        s = _zfixed(p)
        assert (s[0] >> 1) & 3 == 0  # zlib chose a stored block
        rows, ends = _rows([s, b""], 1024)
        out, totals, errs = decode_rows_batch(
            jnp.asarray(rows), jnp.asarray(ends), out_cap=1024, tok_cap=1040,
            static_only=True,
        )
        assert np.asarray(errs).tolist() == [0, 0]
        assert np.asarray(out)[0, : int(totals[0])].tobytes() == p
        assert int(totals[1]) == 0

    def test_zlib_streams_expand(self, static_streams):
        """Tokens of zlib's own static streams through expand_batch."""
        for p, s in static_streams:
            row = np.zeros(len(s) + 64, np.uint8)
            row[: len(s)] = np.frombuffer(s, np.uint8)
            tk, ta, tb, tp, _t, _p2, err = tokenize(
                jnp.asarray(row), 0, tok_cap=4096, end_bit=8 * len(s),
                pwin=PW, stop_at_eob=True, static_only=True,
            )
            assert int(err) == 0
            cap = ((len(p) + 2047) // 2048) * 2048 or 2048
            out, total = expand_batch(
                jnp.asarray(row)[None], tk[None, :cap + 16], ta[None, :cap + 16],
                tb[None, :cap + 16], tp[None], out_cap=cap,
            )
            assert np.asarray(out)[0, : int(total[0])].tobytes() == p

    def test_decode_rows_batch_static(self, static_streams):
        rows, ends = _rows([s for _p, s in static_streams], PW // 8 + 32)
        out, totals, errs = decode_rows_batch(
            jnp.asarray(rows), jnp.asarray(ends), out_cap=2048,
            tok_cap=2064, static_only=True,
        )
        for i, (p, _s) in enumerate(static_streams):
            assert int(errs[i]) == 0
            assert np.asarray(out)[i, : int(totals[i])].tobytes() == p


class TestTokenizeDynamic:
    """Dynamic-tree lanes of the own container and of zlib streams."""

    CH = 3072

    @pytest.fixture(scope="class")
    def dyn_container(self, rng):
        from tpu_deflate.config import DeflateConfig
        from tpu_deflate.ops.encode import encode_blocks_batch

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        text = open(os.path.join(root, "SURVEY.md"), "rb").read() * 4
        payloads = [
            text[: self.CH],
            bytes(rng.integers(97, 123, self.CH, np.uint8)),  # letters
            bytes(rng.integers(0, 256, self.CH, np.uint8)),  # random->static/stored
            b"z" * self.CH,  # extreme skew -> very short codes
        ]
        n = len(payloads)
        darr = jnp.asarray(
            np.frombuffer(b"".join(payloads), np.uint8).reshape(n, self.CH)
        )
        finals = np.zeros(n, bool)
        finals[-1] = True
        cfg = DeflateConfig(
            window=256, max_match=10, chunk_size=self.CH, dynamic_encode=True
        )
        out, sizes, _ = encode_blocks_batch(
            darr, jnp.full(n, self.CH, jnp.int32), jnp.asarray(finals),
            config=cfg,
        )
        return payloads, np.asarray(out), np.asarray(sizes)

    def _lane_tokens(self, rows, ends, i):
        return _tokens(rows[i], ends[i], False, pwin=chunk_pwin(self.CH),
                       tok_cap=self.CH + 16)

    def test_static_block_same_tokens_either_decoder(self):
        """A static-tree block decodes to the same tokens whether the
        tokenizer is compiled static-only or with dynamic trees."""
        s = _zfixed(b"hello hello hello, said the static tree")
        rows, ends = _rows([s], 1200)
        a = _tokens(rows[0], ends[0], True)
        b = _tokens(rows[0], ends[0], False)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert _emulate(*a[:3]) == zlib.decompress(s, -15)

    def test_tokens_replay_per_lane(self, dyn_container):
        payloads, rows, sizes = dyn_container
        ends = (8 * sizes).astype(np.int32)
        types = [(int(rows[i, 0]) >> 1) & 3 for i in range(len(payloads))]
        assert types.count(2) >= 2  # the corpus must exercise dynamic trees
        for i, p in enumerate(payloads):
            tk, ta, tb, tot, pos, err = self._lane_tokens(rows, ends, i)
            assert err == ERR_OK
            assert _emulate(tk, ta, tb, data=rows[i].tobytes()) == p
            assert pos <= ends[i]

    def test_corrupt_dynamic_lane(self, dyn_container):
        """Flip bits in the header and mid-block of a dynamic lane: where
        zlib rejects the stream, the tokenizer must report an error; where
        zlib decodes it (Huffman data resynchronises), the tokens must
        replay to zlib's output."""
        payloads, rows, sizes = dyn_container
        i = 0  # text lane: dynamic tree
        assert (int(rows[i, 0]) >> 1) & 3 == 2
        ends = (8 * sizes).astype(np.int32)
        n = int(sizes[i])
        seen = set()
        for at in (2, 10, 20, n // 3, n // 2):
            bad = rows.copy()
            bad[i, at] ^= 0xA5
            try:
                ref = zlib.decompressobj(-15).decompress(bad[i, :n].tobytes())
            except zlib.error:
                ref = None
            tk, ta, tb, tot, pos, err = self._lane_tokens(bad, ends, i)
            if ref is None:
                assert err != ERR_OK, at
            else:
                assert err == ERR_OK, at
                assert _emulate(tk, ta, tb, bad[i].tobytes()) == ref, at
            seen.add(ref is None)
        assert seen == {True, False}

    def test_decode_rows_batch_dynamic_roundtrip(self, dyn_container):
        payloads, rows, sizes = dyn_container
        out, totals, errs = decode_rows_batch(
            jnp.asarray(rows), jnp.asarray((8 * sizes).astype(np.int32)),
            out_cap=self.CH, tok_cap=self.CH + 16, static_only=False,
        )
        for i, p in enumerate(payloads):
            assert int(errs[i]) == 0
            assert np.asarray(out)[i, : int(totals[i])].tobytes() == p

    def test_short_literal_codes(self, rng):
        """A two-symbol alphabet gives zlib a literal tree with 2-bit
        codes (the shortest the candidate plane has to chase)."""
        payload = bytes(b"ab"[i] for i in rng.integers(0, 2, 3072))
        s = _raw_deflate(payload)
        rows, ends = _rows([s], 4096)
        tk, ta, tb, tot, pos, err = _tokens(
            rows[0], ends[0], False, pwin=chunk_pwin(3072))
        assert err == ERR_OK
        assert _emulate(tk, ta, tb) == payload == zlib.decompress(s, -15)
        assert (pos + 7) // 8 == len(s)

    def test_mixed_batch(self, dyn_container, rng):
        """Own dynamic lanes, a zlib short-code lane, a zlib stored lane
        and an empty lane decode together in one dynamic batch."""
        payloads, rows, sizes = dyn_container
        short = bytes(b"ab"[i] for i in rng.integers(0, 2, 3000))
        stored = bytes(rng.integers(0, 256, 2000, dtype=np.uint8))
        extra = [(short, _raw_deflate(short)), (stored, _raw_deflate(stored, 0)),
                 (b"", b"")]
        streams = [rows[i, : int(sizes[i])].tobytes() for i in range(len(payloads))]
        streams += [s for _p, s in extra]
        want = list(payloads) + [p for p, _s in extra]
        r, e = _rows(streams, rows.shape[1])
        out, totals, errs = decode_rows_batch(
            jnp.asarray(r), jnp.asarray(e), out_cap=self.CH,
            tok_cap=self.CH + 16, static_only=False,
        )
        for i, p in enumerate(want):
            assert int(errs[i]) == 0, i
            assert np.asarray(out)[i, : int(totals[i])].tobytes() == p, i


# ---------------------------------------------------------------------------
# Boundary chase vs a sequential walk
# ---------------------------------------------------------------------------


def _walk(adv, term):
    reached = np.zeros(len(adv), bool)
    p = 0
    while p < len(adv):
        reached[p] = True
        if term[p]:
            break
        p += int(adv[p])
    return reached


@pytest.mark.parametrize("P,max_adv,p_term", [(64 * 128, 15, 0.002),
                                              (64 * 256, 48, 0.0005)])
def test_chase_reach_matches_walk(P, max_adv, p_term):
    rng = np.random.default_rng(P)
    for _ in range(3):
        adv = rng.integers(1, max_adv, P).astype(np.int32)
        term = rng.random(P) < p_term
        got = np.asarray(chase_reach(jnp.asarray(adv), jnp.asarray(term), P))
        np.testing.assert_array_equal(got, _walk(adv, term))
