"""Stage 2 (``expand_batch``: tokens -> bytes) against a token replayer.

The oracle ``_emulate`` replays each token one byte at a time, the way a
sequential inflater's copy loop does.  Streams: random literal/match
mixes, overlapping runs (dist < len), multi-KB constant-distance runs,
stored-block tokens, and the real encoder and tokenizer end to end.
The codec is integer arithmetic with no float matrix product on any path,
so TF32 cannot affect results: the comparisons are byte equality.
"""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_deflate.ops.decode import TK_LIT, TK_MATCH, TK_STORED, expand_batch

MAXD = 256  # the short-distance regime of the own win256 container


def _emulate(tks, tas, tbs, data=b""):
    """Sequential replay: literal byte, (length, dist) copy, or stored
    (length, byte offset into ``data``)."""
    out = bytearray()
    for k, a, b in zip(tks, tas, tbs):
        if k == TK_LIT:
            out.append(a)
        elif k == TK_STORED:
            out.extend(data[b : b + a])
        else:
            for _ in range(a):
                out.append(out[-b])
    return bytes(out)


def _expand(lanes, out_cap, data=None):
    """lanes: list of (tks, tas, tbs).  Returns the decoded bytes per lane."""
    K = out_cap + 16
    B = len(lanes)
    tk = np.zeros((B, K), np.int32)
    ta = np.zeros((B, K), np.int32)
    tb = np.zeros((B, K), np.int32)
    tp = np.zeros(B, np.int32)
    for i, (tks, tas, tbs) in enumerate(lanes):
        tp[i] = len(tks)
        tk[i, : len(tks)] = tks
        ta[i, : len(tks)] = tas
        tb[i, : len(tks)] = tbs
    if data is None:
        data = np.zeros((B, 16), np.uint8)
    out, total = expand_batch(
        jnp.asarray(data), jnp.asarray(tk), jnp.asarray(ta), jnp.asarray(tb),
        jnp.asarray(tp), out_cap=out_cap,
    )
    out = np.asarray(out)
    total = np.asarray(total)
    for i in range(B):
        assert (out[i, total[i]:] == 0).all(), "bytes past the total"
    return [out[i, : total[i]].tobytes() for i in range(B)]


def make_tokens(rng, out_cap, max_dist=MAXD, max_len=258, nlanes=4,
                lit_bias=0.5):
    """Random valid token streams of out_cap/2 .. out_cap bytes each."""
    lanes = []
    for _ in range(nlanes):
        pos = 0
        tks, tas, tbs = [], [], []
        target = int(rng.integers(out_cap // 2, out_cap + 1))
        while pos < target:
            if pos == 0 or rng.random() < lit_bias:
                tks.append(TK_LIT)
                tas.append(int(rng.integers(0, 256)))
                tbs.append(0)
                pos += 1
            else:
                d = int(rng.integers(1, min(max_dist, pos) + 1))
                ln = int(rng.integers(3, min(max_len, target - pos + 3) + 1))
                ln = min(ln, target - pos) or 1
                tks.append(TK_MATCH)
                tas.append(ln)
                tbs.append(d)
                pos += ln
        lanes.append((tks, tas, tbs))
    return lanes


def _check(lanes, out_cap):
    got = _expand(lanes, out_cap)
    for g, lane in zip(got, lanes):
        assert g == _emulate(*lane)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("out_cap", [2048, 65536])
def test_expand_random(seed, out_cap):
    rng = np.random.default_rng(seed)
    _check(make_tokens(rng, out_cap, nlanes=2 if out_cap > 4096 else 4), out_cap)


def test_expand_overlap_runs():
    """dist < len runs (the off1/off2 cases) and deep nesting."""
    rng = np.random.default_rng(7)
    _check(make_tokens(rng, 4096, max_dist=4, lit_bias=0.15), 4096)


def test_expand_empty_and_all_literal():
    lanes = [([], [], []), ([TK_LIT] * 300, [k & 0xFF for k in range(300)], [0] * 300)]
    got = _expand(lanes, 2048)
    assert got[0] == b""
    assert got[1] == bytes(k & 0xFF for k in range(300))


def test_expand_long_runs():
    """Multi-KB constant-distance runs: a 40 KB d=1 zero-run and a 20 KB
    d=7 pattern run, plus a far flat copy after."""
    tks, tas, tbs = [TK_LIT], [0], [0]
    pos = 1
    while pos < 40961:
        ln = min(258, 40961 - pos)
        tks.append(TK_MATCH), tas.append(ln), tbs.append(1)
        pos += ln
    for v in range(1, 8):
        tks.append(TK_LIT), tas.append(v), tbs.append(0)
        pos += 1
    end = pos + 20000
    while pos < end:
        ln = min(258, end - pos)
        tks.append(TK_MATCH), tas.append(ln), tbs.append(7)
        pos += ln
    tks.append(TK_MATCH), tas.append(258), tbs.append(256)
    _check([(tks, tas, tbs)], 65536)


def test_expand_stored_tokens():
    """Stored-block tokens copy bytes from the lane's input row; matches
    may reach back into them."""
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 256, (2, 512), dtype=np.uint8)
    lanes = [
        ([TK_STORED, TK_MATCH, TK_LIT, TK_STORED], [100, 50, 65, 30],
         [5, 80, 0, 400]),
        ([TK_LIT, TK_STORED, TK_MATCH], [7, 200, 258], [0, 0, 150]),
    ]
    got = _expand(lanes, 2048, data=rows)
    for g, lane, row in zip(got, lanes, rows):
        assert g == _emulate(*lane, data=row.tobytes())


def test_expand_matches_decode_pipeline():
    """End to end through the real encoder and tokenizer, zlib as oracle."""
    from tpu_deflate.config import DeflateConfig
    from tpu_deflate.ops.decode import decode_rows_batch
    from tpu_deflate.ops.encode import encode_blocks_batch

    rng = np.random.default_rng(3)
    chunk = 4096
    base = bytes(rng.integers(65, 91, 512).astype(np.uint8))
    data = (base * 20)[:chunk] + bytes(rng.integers(0, 256, chunk).astype(np.uint8))
    cfg = DeflateConfig(window=256, max_match=10, chunk_size=chunk)
    arr = jnp.asarray(np.frombuffer(data, np.uint8).reshape(2, chunk))
    lens = jnp.asarray(np.full(2, chunk, np.int32))
    finals = jnp.asarray(np.array([False, True]))
    out, sizes, _ = encode_blocks_batch(arr, lens, finals, config=cfg)
    body = b"".join(
        np.asarray(out)[i, : int(sizes[i])].tobytes() for i in range(2))
    assert zlib.decompress(
        b"\x78\x9c" + body + zlib.adler32(data).to_bytes(4, "big")) == data
    outs, totals, errs = decode_rows_batch(
        out, (8 * sizes).astype(jnp.int32), out_cap=chunk,
        tok_cap=chunk + 16, static_only=True)
    assert (np.asarray(errs) == 0).all()
    assert np.asarray(outs).reshape(-1)[: len(data)].tobytes() == data


# ---------------------------------------------------------------------------
# Hand-built edge cases (chunk-boundary crossings, wide distances)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "name,tks,tas,tbs,cap",
    [
        ("literals", [0] * 100, list(range(1, 101)), [0] * 100, 2048),
        ("d1_run_crossing", [0] + [1] * 16, [65] + [258] * 16,
         [0] + [1] * 16, 6144),
        ("d2_run_crossing", [0, 0] + [1] * 16, [97, 98] + [258] * 16,
         [0, 0] + [2] * 16, 6144),
        ("match_at_boundary", [0] * 2045 + [1, 1] + [0] * 5,
         [(i % 251) + 1 for i in range(2045)] + [10, 5, 1, 2, 3, 4, 5],
         [0] * 2045 + [7, 2000] + [0] * 5, 4096),
        ("nested_overlaps", [0, 0, 0, 1, 1, 1, 1], [1, 2, 3, 5, 7, 11, 258],
         [0, 0, 0, 3, 5, 2, 13], 2048),
    ],
)
def test_expand_cases(name, tks, tas, tbs, cap):
    _check([(tks, tas, tbs)], cap)


def test_expand_wide_window(rng):
    """Distances past 2048, up to the RFC window."""
    tks = [0] * 4000 + [1] * 8
    tas = [int(x) for x in rng.integers(1, 255, 4000)] + [258] * 8
    tbs = [0] * 4000 + [3000, 3500, 2500, 4000, 3999, 2049, 2100, 2048]
    _check([(tks, tas, tbs)], 8192)
