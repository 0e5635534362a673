"""Data-parallel block DEFLATE encoder (jittable, static shapes).

Reinterprets the reference's one-byte-per-cycle encode FSM
(/root/reference/deflate.py:734-1062) as four data-parallel stages:

  1. match-find   — every position's nearest previous 3-byte occurrence,
                    computed for ALL positions at once.  This generalizes
                    the FAST mode's 32 combinational comparators
                    (deflate.py:407-421,979-994) from "whole window per
                    cycle" to "whole block per launch": a windowed compare
                    sweep for reference-parity windows (32/256) and a
                    stable-sort previous-occurrence matcher for the full
                    32 KB RFC window.
  2. extend       — vectorized match extension to max_match (5/10/258),
                    the SEARCHF/SEARCH10 ladder (deflate.py:899-964) across
                    all positions simultaneously.
  3. parse        — greedy LZ77 tokenization.  Sequential by nature
                    (token starts depend on match lengths); solved in
                    O(log N) pointer-doubling rounds instead of O(N) cycles.
  4. bit-pack     — Huffman codes + extra bits for every token, bit offsets
                    by prefix sum, then a scatter-add byte pack.  This
                    replaces the serial put()/outcarry path
                    (deflate.py:535-567,875-880).

Output blocks are bit-exact valid DEFLATE; with ``final=False`` each block
run ends byte-aligned via an empty stored block so independently encoded
chunks concatenate bytewise into one stream (the data-parallel container).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_deflate.config import DeflateConfig
from tpu_deflate.spec import tables as T

# Upper bound on compressed size of one block, bytes: static-tree worst case
# is 9 bits per literal + 3-bit header + 7-bit EOB + stored-block alignment
# tail (5 bytes) + slack.


def max_output_bytes(n: int) -> int:
    return n + (n >> 3) + 64


def _match_candidates_window(key3: jax.Array, window: int) -> jax.Array:
    """Nearest-match distances via windowed compare sweep.

    For every position i, the smallest d in [1, window] with
    key3[i] == key3[i-d], else 0.  Parity with the reference's
    priority-encoded matcher (nearest match wins, deflate.py:985-994).
    """
    N = key3.shape[0]
    kpad = jnp.concatenate([jnp.full((window,), -1, jnp.int32), key3])
    GU = 8 if window % 8 == 0 else 1  # distances per pass: XLA fuses the
    # unrolled group into one memory sweep (8x less HBM traffic than one
    # fori iteration per distance)

    def body(t, best):
        for u in range(GU):
            k = t * GU + u
            d = window - k  # sweep d = window..1 so the last writer is nearest
            shifted = jax.lax.dynamic_slice(kpad, (k,), (N,))
            best = jnp.where(key3 == shifted, d, best)
        return best

    return jax.lax.fori_loop(0, window // GU, body, jnp.zeros((N,), jnp.int32))


def _match_candidates_sorted(key3: jax.Array, window: int) -> jax.Array:
    """Nearest-match distances via stable sort (full 32 KB window).

    Stable-sorting positions by their exact 24-bit 3-byte key places every
    position next to the previous occurrence of the same string; the gap is
    the nearest match distance.  O(N log N) with no serial hash chains.
    """
    N = key3.shape[0]
    order = jnp.argsort(key3, stable=True)
    prev_pos = jnp.concatenate([jnp.full((1,), -1, jnp.int32), order[:-1]])
    same = jnp.concatenate(
        [jnp.zeros((1,), bool), key3[order[1:]] == key3[order[:-1]]]
    )
    cand = jnp.where(same, prev_pos, -1)
    prev = jnp.zeros((N,), jnp.int32).at[order].set(cand)
    idx = jnp.arange(N, dtype=jnp.int32)
    dist = idx - prev
    return jnp.where((prev >= 0) & (dist <= window), dist, 0)


def _prev_occurrence(key: jax.Array) -> jax.Array:
    """prev[i] = largest j < i with key[j] == key[i], else -1 (stable sort)."""
    N = key.shape[0]
    order = jnp.argsort(key, stable=True)
    prev_pos = jnp.concatenate([jnp.full((1,), -1, jnp.int32), order[:-1]])
    same = jnp.concatenate(
        [jnp.zeros((1,), bool), key[order[1:]] == key[order[:-1]]]
    )
    cand = jnp.where(same, prev_pos, -1)
    return jnp.full((N,), -1, jnp.int32).at[order].set(cand)


def _extend_partial(b, dist, valid, n, k_from: int, k_to: int, alive, length):
    """Extend matches comparing bytes k_from..k_to-1; carries (alive, len)."""
    N = b.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)

    def body(k, carry):
        al, ln = carry
        src = jnp.clip(idx - dist + k, 0, N - 1)
        tgt = jnp.clip(idx + k, 0, N - 1)
        ok = al & (idx + k < n) & (b[src] == b[tgt])
        return ok, ln + ok.astype(jnp.int32)

    return jax.lax.fori_loop(k_from, k_to, body, (alive & valid, length))


def _extend_words(b, b4, dist, active, n, start: int, max_match: int):
    """Word-galloping LCP extension: 4 bytes per pair of gathers instead
    of 1 (the gathers are the cost: ~100M idx/s on this chip), then a
    <=3-byte refinement with exact byte/boundary semantics.  Returns the
    absolute match length for `active` positions (garbage elsewhere)."""
    N = b.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    L0 = jnp.full((N,), start, jnp.int32)
    b4pad = jnp.concatenate([b4, jnp.zeros((max_match + 8,), jnp.int32)])

    def wbody(t, carry):
        al, L = carry
        # positions still alive at step t have L = start + 4t exactly, so
        # the target side is a STATIC shift (one gather per word, not two)
        k = start + 4 * t
        src = jnp.clip(idx - dist + k, 0, N - 1)
        tgt = jax.lax.dynamic_slice(b4pad, (k,), (N,))
        ok = (
            al
            & (k + 4 <= max_match)
            & (idx + k + 4 <= n)
            & (b4[src] == tgt)
        )
        return ok, jnp.where(ok, L + 4, L)

    steps = max(0, (max_match - start + 3) // 4)
    _, L = jax.lax.fori_loop(0, steps, wbody, (active, L0))

    # refinement: the word phase stops within 3 bytes of the true end
    # (mismatch inside the last word, the n boundary, or the length cap)
    al = active
    for _ in range(3):
        src = jnp.clip(idx - dist + L, 0, N - 1)
        tgt = jnp.clip(idx + L, 0, N - 1)
        ok = al & (L < max_match) & (idx + L < n) & (b[src] == b[tgt])
        L = jnp.where(ok, L + 1, L)
        al = ok
    return L


def _match_candidates_multi(
    b: jax.Array,
    key3: jax.Array,
    n,
    window: int,
    max_match: int,
    depth: int = 4,
):
    """Best-of-many matcher for the full 32 KB window.

    Candidates per position: the `depth` most recent previous occurrences
    of the exact 3-byte key (hash-chain walk == iterated prev[] gathers),
    plus the most recent occurrences of hashed 6- and 10-byte keys (long
    matches far away that the 3-byte chain would miss).  Each candidate is
    probed to length <= PROBE cheaply; only the winner gets the full
    extension to max_match.  This replaces zlib's sequential chain walk
    with O(depth) vectorized gathers.
    """
    N = b.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    PROBE = min(16, max_match)

    def key_hash(nbytes: int) -> jax.Array:
        # multiplicative hash of b[i..i+nbytes-1]; invalid tails unique
        acc = jnp.zeros((N,), jnp.uint32)
        for k in range(nbytes):
            bk = jnp.concatenate([b[k:], jnp.zeros((k,), jnp.int32)]) if k else b
            acc = acc * jnp.uint32(0x9E3779B1) + bk.astype(jnp.uint32)
        acc = (acc ^ (acc >> 15)).astype(jnp.int32) & 0x7FFFFFFF
        return jnp.where(idx + nbytes <= n, acc, -(idx + 2))

    prev3 = _prev_occurrence(key3)
    cands = []
    c = prev3
    for _ in range(depth):
        cands.append(c)
        c = jnp.where(c >= 0, prev3[jnp.clip(c, 0, N - 1)], -1)
    cands.append(_prev_occurrence(key_hash(6)))
    cands.append(_prev_occurrence(key_hash(10)))

    # packed 4-byte words make extension cost 2 gathers per 4 bytes
    b1 = jnp.concatenate([b[1:], jnp.zeros((1,), jnp.int32)])
    b2 = jnp.concatenate([b[2:], jnp.zeros((2,), jnp.int32)])
    b3 = jnp.concatenate([b[3:], jnp.zeros((3,), jnp.int32)])
    b4 = b | (b1 << 8) | (b2 << 16) | (b3 << 24)

    best_len = jnp.zeros((N,), jnp.int32)
    best_dist = jnp.zeros((N,), jnp.int32)
    for c in cands:
        d = idx - c
        valid = (c >= 0) & (d >= 1) & (d <= window)
        # exact 3-byte seed via the key itself (hashed keys may collide;
        # key3 carries unique sentinels beyond n, covering idx+3<=n too)
        seed = key3[jnp.clip(c, 0, N - 1)] == key3[idx]
        valid = valid & seed
        ln = jnp.where(
            valid, _extend_words(b, b4, d, valid, n, 3, PROBE), 0
        )
        better = (ln > best_len) | ((ln == best_len) & (ln > 0) & (d < best_dist))
        best_len = jnp.where(better, ln, best_len)
        best_dist = jnp.where(better, d, best_dist)

    # full extension for the winner only
    if max_match > PROBE:
        at_cap = best_len == PROBE
        ext2 = _extend_words(b, b4, best_dist, at_cap, n, PROBE, max_match)
        best_len = jnp.where(at_cap, ext2, best_len)
    best_len = jnp.minimum(best_len, jnp.maximum(n - idx, 0))
    return best_dist, best_len


def _match_candidates_fast(
    b: jax.Array,
    key3: jax.Array,
    n,
    window: int,
    max_match: int,
    depth: int = 2,
):
    """FAST full-window matcher: bounded probes + diagonal-run lengths.

    The speed end of the far-matcher quality knob (DeflateConfig.
    far_matcher): ~3.6x the exact matcher with a ~11%% worse ratio on the
    bench corpus (0.34 vs 0.29), because lengths past 8 bytes come from
    stitched diagonal runs rather than exact per-byte extension.

    Candidates per position: the `depth` most recent previous occurrences
    of the exact 3-byte key (hash-chain walk == iterated prev[] gathers),
    plus the most recent occurrence of a hashed 7-byte key (long matches
    far away that the 3-byte chain would miss).  Each candidate is probed
    to 8 bytes with two word compares; LONG matches extend GATHER-FREE by
    diagonal runs: if positions i..i+k all chose the same distance d and
    each verified an 8-byte match, the overlapping windows certify a
    single match of length k+8 at i — so the per-position extension loop
    (61 full-array gather steps to max_match, the r4 cost center at
    ~2 s/2 MiB) disappears, at the price of up to 7 bytes of
    under-extension past the last verified window.
    """
    N = b.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)

    def key_hash(nbytes: int) -> jax.Array:
        # multiplicative hash of b[i..i+nbytes-1]; invalid tails unique
        acc = jnp.zeros((N,), jnp.uint32)
        for k in range(nbytes):
            bk = jnp.concatenate([b[k:], jnp.zeros((k,), jnp.int32)]) if k else b
            acc = acc * jnp.uint32(0x9E3779B1) + bk.astype(jnp.uint32)
        acc = (acc ^ (acc >> 15)).astype(jnp.int32) & 0x7FFFFFFF
        return jnp.where(idx + nbytes <= n, acc, -(idx + 2))

    prev3 = _prev_occurrence(key3)
    cands = []
    c = prev3
    for _ in range(depth):
        cands.append(c)
        c = jnp.where(c >= 0, prev3[jnp.clip(c, 0, N - 1)], -1)
    cands.append(_prev_occurrence(key_hash(7)))
    cands.append(_prev_occurrence(key_hash(12)))

    # packed 4-byte words: an 8-byte probe is two word compares
    b1 = jnp.concatenate([b[1:], jnp.zeros((1,), jnp.int32)])
    b2 = jnp.concatenate([b[2:], jnp.zeros((2,), jnp.int32)])
    b3 = jnp.concatenate([b[3:], jnp.zeros((3,), jnp.int32)])
    b4 = b | (b1 << 8) | (b2 << 16) | (b3 << 24)
    b4n = jnp.concatenate([b4[4:], jnp.zeros((4,), jnp.int32)])

    def consider(best_len, best_dist, d, extra_valid=True, prefer_tie=False):
        valid = (d >= 1) & (d <= jnp.minimum(window, idx)) & (
            idx + 3 <= n
        ) & extra_valid
        cc = jnp.clip(idx - d, 0, N - 1)
        # exact 3-byte seed via the key itself (collision-proof: key3
        # carries unique sentinels beyond n, covering idx+3<=n too)
        valid = valid & (key3[cc] == key3[idx])
        # exact words 0-3 and 4-7 of the candidate (two gathers)
        cw0 = b4[cc]
        cw1 = b4n[cc]
        m4 = valid & (cw0 == b4)
        ok8 = m4 & (cw1 == b4n)
        ln = jnp.where(valid, 3, 0)
        ln = jnp.where(m4, 4, ln)
        # refine 5..7: bytes 4, 5, 6 individually from word 1's lanes
        for kk in range(3):
            bk = (cw1 >> (8 * kk)) & 0xFF
            tk = (b4n >> (8 * kk)) & 0xFF
            more = m4 & ~ok8 & (ln == 4 + kk) & (bk == tk)
            ln = jnp.where(more, ln + 1, ln)
        ln = jnp.where(ok8, 8, ln)
        tie = jnp.asarray(prefer_tie) | (d < best_dist)
        better = (ln > best_len) | ((ln == best_len) & (ln > 0) & tie)
        return (
            jnp.where(better, ln, best_len),
            jnp.where(better, d, best_dist),
        )

    best_len = jnp.zeros((N,), jnp.int32)
    best_dist = jnp.zeros((N,), jnp.int32)
    for c in cands:
        best_len, best_dist = consider(
            best_len, best_dist, idx - c, extra_valid=c >= 0
        )
    # diagonal-adoption sweeps: a long repeat's trigram chain rarely picks
    # the same occurrence at every position, fragmenting the diagonal run
    # the length pass below depends on; testing the distances the previous
    # 1 and 2 positions verified stitches the fragments (each test is two
    # word gathers, exact)
    for shift in (1, 2, 1):
        d_prev = jnp.concatenate(
            [jnp.zeros((shift,), jnp.int32), best_dist[:-shift]]
        )
        l_prev = jnp.concatenate(
            [jnp.zeros((shift,), jnp.int32), best_len[:-shift]]
        )
        best_len, best_dist = consider(
            best_len, best_dist, d_prev,
            extra_valid=(l_prev >= 8) & (d_prev != best_dist),
            prefer_tie=True,  # run continuity beats a nearer distance
        )

    # --- gather-free long extension by diagonal runs --------------------
    # at8[i] = the winning candidate verified 8 bytes at distance d[i]; a
    # maximal run i..i+k of at8 positions sharing the SAME distance
    # certifies (by the overlapping 8-byte windows) a single match of
    # length k+8 at i.  The run tail is found with one reversed cummin of
    # break positions — no per-byte loop, at most 7 bytes under-extended
    # past the last verified window.
    at8 = best_len == 8
    nxt_same = at8 & jnp.concatenate(
        [at8[1:] & (best_dist[1:] == best_dist[:-1]), jnp.zeros((1,), bool)]
    )
    brk_idx = jnp.where(at8 & ~nxt_same, idx, N)
    run_end = jax.lax.cummin(brk_idx[::-1])[::-1]
    remaining = jnp.where(at8, run_end - idx, 0)
    best_len = jnp.where(at8, jnp.minimum(8 + remaining, max_match), best_len)
    best_len = jnp.minimum(best_len, jnp.maximum(n - idx, 0))
    return best_dist, best_len


def _extend_matches(
    b: jax.Array, dist: jax.Array, n, max_match: int
) -> jax.Array:
    """Match lengths for every position given candidate distances.

    b: int32[N] byte values; dist: int32[N] (0 = no candidate).
    Returns length[N] (0 or >= 3).  Overlapping sources (dist < length)
    compare raw input bytes, which is exactly the run-detection the
    reference gets from its off1/off2 handling on the decode side.
    """
    N = b.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    has = dist > 0
    # verify the 3-byte seed (window sweep guarantees it; sort matcher too,
    # since keys are exact 24-bit values) and bounds: match fits in [0, n)
    has = has & (idx + 3 <= n) & (dist <= idx)

    def body(k, carry):
        alive, length = carry
        src = jnp.clip(idx - dist + k, 0, N - 1)
        tgt = jnp.clip(idx + k, 0, N - 1)
        ok = alive & (idx + k < n) & (b[src] == b[tgt])
        return ok, length + ok.astype(jnp.int32)

    alive0 = has
    length0 = jnp.zeros((N,), jnp.int32)
    # bytes 0..2 are already known equal; extend from k=3
    _, ext = jax.lax.fori_loop(
        3, max_match, body, (alive0, length0)
    )
    length = jnp.where(has, 3 + ext, 0)
    return jnp.minimum(length, jnp.maximum(n - idx, 0))


def _extend_matches_select(b, dist, n, max_match: int, window: int):
    """Gather-free match extension: one-hot over the window's distances.

    For each d in [1, window], the equality plane eq_d[i] = (b[i]==b[i-d])
    is a shifted compare (slices, no gather); positions whose candidate
    dist == d extend along eq_d.  Replaces the reference's SEARCHF/
    SEARCH10 byte-at-a-time ladder (deflate.py:899-964) with
    window x max_match vector ops.
    """
    N = b.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    has = (dist > 0) & (idx + 3 <= n) & (dist <= idx)
    bpad = jnp.concatenate([jnp.full((window,), -1, jnp.int32), b])
    kmask = [idx + k < n for k in range(3, max_match)]
    GU = 8 if window % 8 == 0 else 1  # distances per fused memory pass

    def dbody(t, ext_acc):
        for u in range(GU):
            d = t * GU + u + 1
            eqd = b == jax.lax.dynamic_slice(bpad, (window - d,), (N,))
            sel = has & (dist == d)
            alive = sel
            ext = jnp.zeros((N,), jnp.int32)
            for k in range(3, max_match):
                eqk = jnp.concatenate([eqd[k:], jnp.zeros((k,), bool)])
                alive = alive & kmask[k - 3] & eqk
                ext = ext + alive
            ext_acc = ext_acc + ext
        return ext_acc

    ext = jax.lax.fori_loop(0, window // GU, dbody, jnp.zeros((N,), jnp.int32))
    length = jnp.where(has, 3 + ext, 0)
    return jnp.minimum(length, jnp.maximum(n - idx, 0))


def _match_extend_bitplane(b: jax.Array, n, window: int, max_match: int):
    """Stages 1+2 fused via DISTANCE BITPLANES (window <= 256).

    One byte-equality compare per distance, packed as bit (d-1)&31 of
    uint32 channel (d-1)>>5.  From the packed planes, BOTH outputs fall
    out in O(channels) ops per position:
      * nearest 3-byte match: AND of three position-shifted planes, then
        least-set-bit (priority encoder) across channels — the exact
        semantics of the reference's matcher3 + priority scan
        (deflate.py:407-421,979-994);
      * extension (SEARCHF/SEARCH10 ladder, deflate.py:899-964): the
        chosen distance's bit, extracted per position with a variable
        shift, walked over max_match-3 position shifts.
    Everything is static slices and elementwise ops, which XLA fuses
    into a few loop kernels.
    """
    N = b.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    bpad = jnp.concatenate([jnp.full((window,), -1, jnp.int32), b])
    nch = (window + 31) // 32

    def sh(x, j):
        return jnp.concatenate([x[j:], jnp.zeros((j,), x.dtype)])

    chans = []
    for c in range(nch):
        ch = jnp.zeros((N,), jnp.uint32)
        for k in range(32):
            d = 32 * c + k + 1
            if d > window:
                break
            eqb = (b == jax.lax.dynamic_slice(bpad, (window - d,), (N,))).astype(
                jnp.uint32
            )
            ch = ch | (eqb << k)
        chans.append(ch)

    # 3-byte seed = three consecutive byte-equalities at the same distance
    seeds = [ch & sh(ch, 1) & sh(ch, 2) for ch in chans]
    best_d = jnp.zeros((N,), jnp.int32)
    found = jnp.zeros((N,), bool)
    for c, mc in enumerate(seeds):
        lsb = mc & (~mc + jnp.uint32(1))
        k = (31 - jax.lax.clz(lsb)).astype(jnp.int32)  # -1 when mc == 0
        has_c = mc != 0
        best_d = jnp.where(~found & has_c, 32 * c + k + 1, best_d)
        found = found | has_c

    has = found & (idx + 3 <= n) & (best_d <= idx)
    bd1 = jnp.where(has, best_d - 1, 0)
    cidx = bd1 >> 5
    bit = (bd1 & 31).astype(jnp.uint32)
    alive = has
    length = jnp.zeros((N,), jnp.int32)
    for k in range(3, max_match):
        w = jnp.zeros((N,), jnp.uint32)
        for c in range(nch):
            w = jnp.where(cidx == c, sh(chans[c], k), w)
        bitv = ((w >> bit) & 1) == 1
        alive = alive & bitv & (idx + k < n)
        length = length + alive.astype(jnp.int32)
    length = jnp.where(has, 3 + length, 0)
    length = jnp.minimum(length, jnp.maximum(n - idx, 0))
    dist = jnp.where(has, best_d, 0)
    return dist, length


def _greedy_parse_chase(length: jax.Array, n) -> jax.Array:
    """Gather-free greedy parse via the shared select-based chase
    (decode.chase_reach).  Valid when max step <= 48 and N % 64 == 0."""
    from tpu_deflate.ops.decode import chase_reach

    N = length.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    step = jnp.where(length >= 3, length, 1)
    reach = chase_reach(step, jnp.zeros((N,), bool), N)
    return reach & (idx < n)


def _select_meta(meta: jax.Array, idx: jax.Array) -> jax.Array:
    """meta[idx] by one-hot multiply-reduce over a small table."""
    k = jnp.arange(meta.shape[0], dtype=jnp.int32)
    return jnp.sum(jnp.where(idx[..., None] == k, meta, 0), axis=-1)


def _assign_code_lengths_jax(freq: jax.Array, max_bits: int) -> jax.Array:
    """Vectorized length-limited prefix-code length assignment.

    Polar-style initial lengths l_i = ceil(log2(total / f_i)) guarantee
    Kraft <= 1 before clipping; two small fixup loops repair clipping
    overflow and tighten the deficit so the tree is COMPLETE (zlib's
    inflate rejects incomplete literal trees).  Within ~1% of true Huffman
    on real data, and every step is a vector op — no heap, no sort-merge.
    (The reference has no encoder-side tree builder at all; its dynamic
    trees exist only in the decoder, deflate.py:1204-1400.)
    """
    S = freq.shape[0]
    f = freq.astype(jnp.int32)
    total = jnp.maximum(jnp.sum(f), 1)
    active = f > 0
    nactive = jnp.sum(active.astype(jnp.int32))

    # ceil(log2(total / f)) via integer bit arithmetic, no floats:
    # q = floor(total/f); for non-power-of-two q, ceil matches ceil_log2(q);
    # for power-of-two q with a nonzero remainder the true ratio exceeds q,
    # so one more bit is needed.
    fm = jnp.maximum(f, 1)
    q = total // fm
    blen = 32 - jax.lax.clz(jnp.maximum(q, 1))  # floor(log2 q) + 1
    is_pow2 = (q & (q - 1)) == 0
    ceil_log = jnp.where(is_pow2, blen - 1, blen)
    bump = is_pow2 & ((total % fm) != 0)
    lengths = jnp.clip(ceil_log + bump.astype(jnp.int32), 1, max_bits)
    lengths = jnp.where(active, lengths, 0)

    unit = jnp.int32(1 << max_bits)

    def kraft(ls):
        return jnp.sum(jnp.where(ls > 0, 1 << (max_bits - ls), 0))

    # overflow repair: lengthen lowest-frequency symbols while S > unit
    def over_body(i, ls):
        S_ = kraft(ls)
        can = (ls > 0) & (ls < max_bits)
        pick = jnp.argmin(jnp.where(can, f, jnp.int32(1 << 30)))
        ls = ls.at[pick].add(jnp.where(S_ > unit, 1, 0))
        return ls

    lengths = jax.lax.fori_loop(0, 48, over_body, lengths)

    # Deficit tightening by bulk level sweeps: at each code length l
    # (coarse to fine), promote (shorten by 1) the top-frequency symbols at
    # that level, as many as the remaining budget D allows at granularity
    # c = 2^(max_bits - l).  Two sweeps drive D to 0 in practice; callers
    # must verify completeness (kraft == unit) and fall back otherwise.
    def sweep(_, ls):
        def level(i, ls):
            l = max_bits + 1 - i  # descending l = max_bits .. 2, so a
            # promoted symbol lands on the level processed next and can
            # cascade several promotions within one sweep
            c = jnp.int32(1) << (max_bits - l)
            D = unit - kraft(ls)
            k = D // c
            at_l = ls == l
            # rank symbols at this level by descending frequency
            key = jnp.where(at_l, -f, jnp.int32(1 << 30))
            rank = jnp.argsort(jnp.argsort(key))
            promote = at_l & (rank < k)
            return ls - promote.astype(jnp.int32)

        return jax.lax.fori_loop(1, max_bits, level, ls)

    lengths = jax.lax.fori_loop(0, 2, sweep, lengths)
    # single-symbol tree: length 1 (incomplete; callers only allow this for
    # the distance tree, where zlib tolerates it)
    lengths = jnp.where((nactive == 1) & active, jnp.int32(1), lengths)
    return lengths


def _rle_code_lengths_jax(L: jax.Array, ops_cap: int = 320):
    """Vectorized RFC 1951 3.2.7 run-length encoding of code lengths.

    L: int32[S] (the HLIT+HDIST concatenated lengths).  Returns
    (sym[ops_cap], extra[ops_cap], ebits[ops_cap], nops): op streams using
    symbols 0-15 plus 16 (repeat prev 3-6), 17 (3-10 zeros), 18 (11-138
    zeros).  Dead slots have sym 0 and are masked by nops.
    """
    S = L.shape[0]
    i = jnp.arange(S, dtype=jnp.int32)
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), L[:-1]])
    new_run = (i == 0) | (L != prev)
    rid = jnp.cumsum(new_run.astype(jnp.int32)) - 1  # run id per position
    nruns = rid[-1] + 1
    # per-run value and start (scatter into S-sized run tables)
    run_val = jnp.zeros((S,), jnp.int32).at[rid].max(jnp.where(new_run, L, 0))
    run_start = (
        jnp.full((S,), S, jnp.int32).at[rid].min(jnp.where(new_run, i, S))
    )
    ridx = jnp.arange(S, dtype=jnp.int32)
    next_start = jnp.where(
        ridx + 1 < nruns,
        run_start[jnp.clip(ridx + 1, 0, S - 1)],
        S,
    )
    run_len = jnp.where(ridx < nruns, next_start - run_start, 0)

    v = run_val
    ln = jnp.maximum(run_len, 0)
    # zero runs: k18 full 138-chunks, then one 18/17 for the 3..137 tail,
    # then <3 literal zeros
    k18 = ln // 138
    r1 = ln % 138
    z_extra_op = (r1 >= 3).astype(jnp.int32)
    z_lits = jnp.where(r1 < 3, r1, 0)
    count_zero = k18 + z_extra_op + z_lits
    # nonzero runs: 1 literal, then 16-chunks of 6, then a 3..5 16-chunk or
    # <3 literal repeats
    rem = jnp.maximum(ln - 1, 0)
    k16f = rem // 6
    r2 = rem % 6
    n_extra16 = (r2 >= 3).astype(jnp.int32)
    n_lits = jnp.where(r2 < 3, r2, 0)
    count_nz = 1 + k16f + n_extra16 + n_lits
    counts = jnp.where(ridx < nruns, jnp.where(v == 0, count_zero, count_nz), 0)
    op_off = jnp.cumsum(counts) - counts
    nops = jnp.sum(counts)

    o = jnp.arange(ops_cap, dtype=jnp.int32)
    r = jnp.clip(jnp.searchsorted(op_off, o, side="right") - 1, 0, S - 1)
    j = o - op_off[r]
    rv = v[r]
    rk18, rr1 = k18[r], r1[r]
    rk16f, rr2 = k16f[r], r2[r]

    # zero-run op j
    z_sym = jnp.where(
        j < rk18,
        18,
        jnp.where((j == rk18) & (rr1 >= 11), 18, jnp.where((j == rk18) & (rr1 >= 3), 17, 0)),
    )
    z_ext = jnp.where(
        j < rk18,
        138 - 11,
        jnp.where((j == rk18) & (rr1 >= 11), rr1 - 11, jnp.where((j == rk18) & (rr1 >= 3), rr1 - 3, 0)),
    )
    z_eb = jnp.where(
        j < rk18,
        7,
        jnp.where((j == rk18) & (rr1 >= 11), 7, jnp.where((j == rk18) & (rr1 >= 3), 3, 0)),
    )
    # nonzero-run op j
    n_is_lit0 = j == 0
    n_is_full16 = (j >= 1) & (j <= rk16f)
    n_is_part16 = (j == rk16f + 1) & (rr2 >= 3)
    n_sym = jnp.where(n_is_lit0, rv, jnp.where(n_is_full16, 16, jnp.where(n_is_part16, 16, rv)))
    n_ext = jnp.where(n_is_full16, 3, jnp.where(n_is_part16, rr2 - 3, 0))
    n_eb = jnp.where(n_is_full16 | n_is_part16, 2, 0)

    live = o < nops
    sym = jnp.where(live, jnp.where(rv == 0, z_sym, n_sym), 0)
    extra = jnp.where(live, jnp.where(rv == 0, z_ext, n_ext), 0)
    ebits = jnp.where(live, jnp.where(rv == 0, z_eb, n_eb), 0)
    return sym, extra, ebits, nops


def _kraft_complete(lengths: jax.Array, max_bits: int) -> jax.Array:
    """True iff the code is exactly complete (zlib requirement for the
    literal and code-length trees)."""
    unit = jnp.int32(1 << max_bits)
    s = jnp.sum(jnp.where(lengths > 0, 1 << (max_bits - lengths), 0))
    return s == unit


def _canonical_codes_jax(lengths: jax.Array) -> jax.Array:
    """RFC 1951 canonical code values (MSB-first) for given lengths,
    fully vectorized (sort + prefix sums)."""
    S = lengths.shape[0]
    sym_idx = jnp.arange(S, dtype=jnp.int32)
    valid = lengths > 0
    order = jnp.argsort(jnp.where(valid, lengths, 99) * S + sym_idx)
    len_sorted = lengths[order]
    ones = valid.astype(jnp.int32)
    bl_count = jnp.zeros((17,), jnp.int32).at[jnp.clip(lengths, 0, 16)].add(ones)

    def nc_step(carry, blc):
        code = (carry + blc) << 1
        return code, code

    _, nc = jax.lax.scan(nc_step, jnp.int32(0), bl_count[:16])
    next_code = jnp.concatenate([jnp.zeros((1,), jnp.int32), nc])
    cum_before = jnp.cumsum(bl_count) - bl_count
    rank = jnp.arange(S, dtype=jnp.int32) - cum_before[jnp.clip(len_sorted, 0, 16)]
    code_sorted = next_code[jnp.clip(len_sorted, 0, 16)] + rank
    codes = jnp.zeros((S,), jnp.int32).at[order].set(code_sorted)
    return jnp.where(valid, codes, 0)


def _revbits_vec(x: jax.Array, nbits: jax.Array) -> jax.Array:
    """Bit-reverse the low `nbits` (<=16) bits of each element."""
    x = x.astype(jnp.uint32)
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return (x.astype(jnp.int32) >> (16 - nbits)) & ((1 << nbits) - 1)


def _greedy_parse(length: jax.Array, n) -> jax.Array:
    """Token-start mask by pointer doubling over next[i] = i + step[i].

    The reference walks this chain one token per FSM visit
    (CSTATIC -> SEARCH -> ... -> CSTATIC); we close it in log2(N) rounds.
    """
    N = length.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    step = jnp.where(length >= 3, length, 1)
    nxt = jnp.minimum(idx + step, N)
    J = jnp.concatenate([nxt, jnp.array([N], jnp.int32)])
    r = jnp.zeros((N + 1,), jnp.int32).at[0].set(1)
    rounds = max(1, int(np.ceil(np.log2(max(N, 2)))) + 1)
    for _ in range(rounds):
        r = jnp.maximum(r, jnp.zeros_like(r).at[J].max(r))
        J = J[J]
    return (r[:N] == 1) & (idx < n)


def _encode_emissions(
    data: jax.Array,
    n: jax.Array,
    final: jax.Array,
    window: int,
    max_match: int,
    use_sort_matcher: bool,
    lazy: bool = False,
    dynamic_encode: bool = False,
    far_matcher: str = "exact",
):
    """Stages 1-4 of one block's encode: match, extend, parse, per-token
    emission values/widths and bit offsets.  Pure per-lane (vmappable);
    the byte pack happens in the caller (per lane in encode_block_bits,
    batched in encode_blocks_batch)."""
    N = data.shape[0]
    M = max_output_bytes(N)
    b = data.astype(jnp.int32)
    n = jnp.asarray(n, jnp.int32)
    final = jnp.asarray(final, bool)
    idx = jnp.arange(N, dtype=jnp.int32)

    # --- stage 1: match candidates --------------------------------------
    b1 = jnp.concatenate([b[1:], jnp.zeros((1,), jnp.int32)])
    b2 = jnp.concatenate([b[2:], jnp.zeros((2,), jnp.int32)])
    key3 = b | (b1 << 8) | (b2 << 16)
    # make positions whose 3-byte window crosses n unique so they never match
    key3 = jnp.where(idx + 3 <= n, key3, (1 << 24) + idx)
    if use_sort_matcher:
        # stages 1+2 fused: best-of-many candidates (quality knob: exact
        # winner extension vs fast diagonal-run lengths)
        mf = (_match_candidates_fast if far_matcher == "fast"
              else _match_candidates_multi)
        dist, length = mf(b, key3, n, window, max_match)
    elif window <= 256:
        dist, length = _match_extend_bitplane(b, n, window, max_match)
    else:
        dist = _match_candidates_window(key3, window)
        # --- stage 2: extension -----------------------------------------
        if window <= 512:
            length = _extend_matches_select(b, dist, n, max_match, window)
        else:
            length = _extend_matches(b, dist, n, max_match)

    # --- stage 3: parse --------------------------------------------------
    if lazy:
        # one-step lazy matching (zlib-style): if the next position has a
        # strictly longer match, emit a literal here and take that one.
        # The parse stays a static next[] function, so pointer doubling
        # still applies.  (The reference is greedy-only.)
        ln_next = jnp.concatenate([length[1:], jnp.zeros((1,), jnp.int32)])
        defer = (length >= 3) & (ln_next > length)
        length = jnp.where(defer, 0, length)
    if max_match <= 48 and N % 64 == 0:
        start = _greedy_parse_chase(length, n)
    else:
        start = _greedy_parse(length, n)
    is_match = start & (length >= 3)
    is_lit = start & ~(length >= 3)

    # --- stage 4: per-token emissions, CLOSED FORM.  The RFC 1951 length/
    # distance bucket tables and the static Huffman code are piecewise
    # affine in log2 (the decode side already exploits this,
    # decode._candidate_plane_static); arithmetic replaces every broadcast
    # one-hot/bucket select — including the reference's CopyDistance
    # linear scan (deflate.py:848-860) — with ~10 vector ops each. -------
    ln = jnp.clip(length, 0, 258)
    l3 = jnp.clip(ln - 3, 0, 255)
    msbl = 31 - jax.lax.clz(jnp.maximum(l3, 1))  # floor(log2 l3)
    lsym = jnp.where(
        l3 < 8, l3, 4 * (msbl - 1) + ((l3 >> jnp.maximum(msbl - 2, 0)) & 3)
    )
    lsym = jnp.where(ln >= 258, 28, lsym)  # length 258 = symbol 285 exactly
    lebits = jnp.where(lsym == 28, 0, jnp.clip((lsym >> 2) - 1, 0, 5))
    lbase = jnp.where(lsym < 8, lsym + 3, ((4 + (lsym & 3)) << lebits) + 3)
    lbase = jnp.where(lsym == 28, 258, lbase)
    lit_sym = b
    litlen_sym = jnp.where(is_lit, lit_sym, 257 + lsym)  # per-token lit/len symbol

    d = jnp.clip(dist, 0, 32768)
    v1 = jnp.clip(d - 1, 0, 32767)
    msbd = 31 - jax.lax.clz(jnp.maximum(v1, 1))
    dsym = jnp.where(
        v1 < 4, v1, 2 * msbd + ((v1 >> jnp.maximum(msbd - 1, 0)) & 1)
    )
    debits_v = jnp.clip((dsym >> 1) - 1, 0, 13)
    dbase = jnp.where(dsym < 2, dsym + 1, ((2 + (dsym & 1)) << debits_v) + 1)

    # --- static-tree code tables (dynamic_encode still selects from its
    # per-chunk tables; the static path is fully arithmetic below) -------
    s_lit_code = jnp.asarray(T.STATIC_LITLEN_CODES_REV)
    s_lit_len = jnp.asarray(T.STATIC_LITLEN_LENGTHS)
    s_dist_code = jnp.asarray(T.STATIC_DIST_CODES_REV)
    s_dist_len = jnp.full((32,), 5, jnp.int32)
    dist_ebits = jnp.asarray(T.DIST_EXTRA_BITS)

    # static lit/len code, closed form (RFC 1951 3.2.6): 4 affine ranges
    sym_ = litlen_sym
    s_nb = jnp.where(
        sym_ < 144, 8, jnp.where(sym_ < 256, 9, jnp.where(sym_ < 280, 7, 8))
    )
    s_code = jnp.where(
        sym_ < 144,
        0x30 + sym_,
        jnp.where(
            sym_ < 256,
            0x190 + (sym_ - 144),
            jnp.where(sym_ < 280, sym_ - 256, 0xC0 + (sym_ - 280)),
        ),
    )

    if dynamic_encode:
        # ---- per-chunk dynamic Huffman trees (encoder-side; a capability
        # the reference lacks — its dynamic trees exist only in its
        # DECODER, deflate.py:1204-1400) -------------------------------
        dump_lit = jnp.where(start, litlen_sym, jnp.int32(286))
        lit_freq = (
            jnp.zeros((287,), jnp.int32)
            .at[dump_lit]
            .add(start.astype(jnp.int32))[:286]
        )
        lit_freq = lit_freq.at[256].add(1)  # EOB
        dump_d = jnp.where(is_match, dsym, jnp.int32(30))
        dist_freq = (
            jnp.zeros((31,), jnp.int32)
            .at[dump_d]
            .add(is_match.astype(jnp.int32))[:30]
        )
        dyn_lit_len = _assign_code_lengths_jax(lit_freq, 15)
        # RFC requires >= 1 distance code slot even when unused
        dist_freq = jnp.where(
            (jnp.sum(dist_freq) == 0) & (jnp.arange(30) == 0), 1, dist_freq
        )
        dyn_dist_len = _assign_code_lengths_jax(dist_freq, 15)
        dyn_lit_code = _revbits_vec(_canonical_codes_jax(dyn_lit_len), jnp.maximum(dyn_lit_len, 1))
        dyn_dist_code = _revbits_vec(_canonical_codes_jax(dyn_dist_len), jnp.maximum(dyn_dist_len, 1))
        # pad to the static table sizes for uniform gathers
        dyn_lit_code = jnp.pad(dyn_lit_code, (0, 288 - 286))
        dyn_lit_len_p = jnp.pad(dyn_lit_len, (0, 288 - 286))
        dyn_dist_code = jnp.pad(dyn_dist_code, (0, 32 - 30))
        dyn_dist_len_p = jnp.pad(dyn_dist_len, (0, 32 - 30))

        # ---- dynamic header: HLIT/HDIST/HCLEN + 19 CL lengths + the 316
        # code lengths run-length encoded with symbols 16/17/18 ----------
        all_lens316 = jnp.concatenate([dyn_lit_len, dyn_dist_len])  # [316]
        rle_sym, rle_extra, rle_ebits, rle_n = _rle_code_lengths_jax(all_lens316)
        OPS = rle_sym.shape[0]
        rle_live = jnp.arange(OPS, dtype=jnp.int32) < rle_n
        cl_freq = (
            jnp.zeros((20,), jnp.int32)
            .at[jnp.where(rle_live, rle_sym, 19)]
            .add(1)[:19]
        )
        cl_len = _assign_code_lengths_jax(cl_freq, 7)
        cl_code = _revbits_vec(_canonical_codes_jax(cl_len), jnp.maximum(cl_len, 1))
        cl_order = jnp.asarray(T.CODE_LENGTH_ORDER)
        hdr_e0_val = jnp.int32((286 - 257) | ((30 - 1) << 5) | ((19 - 4) << 10))
        op_nbs = jnp.where(rle_live, cl_len[rle_sym] + rle_ebits, 0)
        op_vals = jnp.where(
            rle_live, cl_code[rle_sym] | (rle_extra << cl_len[rle_sym]), 0
        )
        hdr_vals = jnp.concatenate(
            [
                hdr_e0_val[None],
                cl_len[cl_order],  # 19 x 3 bits
                op_vals,
            ]
        )
        hdr_nbs_dyn = jnp.concatenate(
            [
                jnp.full((1,), 14, jnp.int32),
                jnp.full((19,), 3, jnp.int32),
                op_nbs,
            ]
        )
        dyn_hdr_bits = jnp.sum(hdr_nbs_dyn)

        # ---- choose static vs dynamic by exact bit count --------------
        lebits_sel = lebits
        debits_sel = debits_v
        tok_bits_static = jnp.sum(
            jnp.where(
                start,
                s_nb + jnp.where(is_match, lebits_sel + 5 + debits_sel, 0),
                0,
            )
        ) + 7  # static EOB
        tok_bits_dyn = jnp.sum(
            jnp.where(
                start,
                _select_meta(dyn_lit_len_p, litlen_sym)
                + jnp.where(
                    is_match,
                    lebits_sel + _select_meta(dyn_dist_len_p, dsym) + debits_sel,
                    0,
                ),
                0,
            )
        ) + dyn_lit_len[256]
        cl_active = jnp.sum((cl_freq > 0).astype(jnp.int32))
        lit_active = jnp.sum((lit_freq > 0).astype(jnp.int32))
        dist_active = jnp.sum((dist_freq > 0).astype(jnp.int32))
        # zlib's inflate rejects incomplete literal / code-length trees;
        # a one-code incomplete distance tree is tolerated (RFC note).
        trees_ok = (
            _kraft_complete(dyn_lit_len, 15)
            & _kraft_complete(cl_len, 7)
            & (_kraft_complete(dyn_dist_len, 15) | (dist_active <= 1))
        )
        allow_dyn = (cl_active >= 2) & (lit_active >= 2) & trees_ok
        use_dyn = allow_dyn & (dyn_hdr_bits + tok_bits_dyn < tok_bits_static)

        lit_code_eff = jnp.where(use_dyn, dyn_lit_code, s_lit_code)
        lit_len_eff = jnp.where(use_dyn, dyn_lit_len_p, s_lit_len)
        dist_code_eff = jnp.where(use_dyn, dyn_dist_code, s_dist_code)
        dist_len_eff = jnp.where(use_dyn, dyn_dist_len_p, s_dist_len)
        hdr_nbs = jnp.where(use_dyn, hdr_nbs_dyn, 0)
        btype = jnp.where(use_dyn, jnp.int32(2), jnp.int32(1))
        eob_val = jnp.where(use_dyn, dyn_lit_code[256], 0)
        eob_nb = jnp.where(use_dyn, dyn_lit_len[256], 7)

        # emission 0: literal code OR length code + length extra bits
        lit_meta = (lit_len_eff << 16) | lit_code_eff  # len(<=15)|code(15b)
        lm = _select_meta(lit_meta, litlen_sym)
        e0_code = lm & 0xFFFF
        e0_clen = lm >> 16
        e0_extra = jnp.where(is_match, ln - lbase, 0)
        e0_ebits = jnp.where(is_match, lebits, 0)
        e0_val = e0_code | (e0_extra << e0_clen)
        e0_nb = jnp.where(start, e0_clen + e0_ebits, 0)
        # emissions 1+2: distance code, then distance extra bits
        dist_meta = (
            (jnp.pad(dist_ebits, (0, 2)) << 20)
            | (dist_len_eff << 16)
            | dist_code_eff
        )  # (32,) ebits(4)|len(4)|code(15b)
        dm = _select_meta(dist_meta, dsym)
        e1_val = jnp.where(is_match, dm & 0xFFFF, 0)
        e1_nb = jnp.where(is_match, (dm >> 16) & 0xF, 0)
        e2_val = jnp.where(is_match, d - dbase, 0)
        e2_nb = jnp.where(is_match, dm >> 20, 0)
    else:
        hdr_vals = jnp.zeros((0,), jnp.int32)
        hdr_nbs = jnp.zeros((0,), jnp.int32)
        btype = jnp.int32(1)
        eob_val = jnp.int32(0)
        eob_nb = jnp.int32(7)

        # fully arithmetic static emissions: code/length from the closed
        # form above, bit-reversed on the wire; 5-bit reversed dist code
        e0_code = _revbits_vec(s_code, s_nb)
        e0_clen = s_nb
        e0_extra = jnp.where(is_match, ln - lbase, 0)
        e0_ebits = jnp.where(is_match, lebits, 0)
        e0_val = e0_code | (e0_extra << e0_clen)
        e0_nb = jnp.where(start, e0_clen + e0_ebits, 0)
        rev5 = (
            ((dsym & 1) << 4) | ((dsym & 2) << 2) | (dsym & 4)
            | ((dsym >> 2) & 2) | (dsym >> 4)
        )
        e1_val = jnp.where(is_match, rev5, 0)
        e1_nb = jnp.where(is_match, 5, 0)
        e2_val = jnp.where(is_match, d - dbase, 0)
        e2_nb = jnp.where(is_match, debits_v, 0)

    # distance code + distance extra merged: <= 15 + 13 = 28 bits, so the
    # batched pack sees 2 emissions per position instead of 3
    e12_val = e1_val | (e2_val << e1_nb)
    e12_nb = e1_nb + e2_nb

    if dynamic_encode:
        # dynamic codes can reach 15 bits each; two slots per position
        vals = jnp.stack([e0_val, e12_val], axis=1).reshape(-1)
        nbs = jnp.stack([e0_nb, e12_nb], axis=1).reshape(-1)
    else:
        # static trees: e0 <= 13 bits (8-bit length code + 5 extras) and
        # e12 <= 18 (5-bit distance code + 13 extras), so one merged
        # <= 31-bit slot per position — HALVES the batched pack's entry
        # count
        vals = e0_val | (e12_val << e0_nb)
        nbs = e0_nb + e12_nb

    # --- bit offsets: 3-bit header + [dyn header] + tokens + EOB --------
    hdr_val3 = jnp.where(final, jnp.int32(1), jnp.int32(0)) | (btype << 1)
    all_vals = jnp.concatenate(
        [hdr_val3[None], hdr_vals, vals, eob_val[None]]
    )
    all_nbs = jnp.concatenate(
        [jnp.full((1,), 3, jnp.int32), hdr_nbs, nbs, eob_nb[None]]
    )
    csum = jnp.cumsum(all_nbs)
    all_offs = csum - all_nbs  # exclusive prefix
    total_bits = csum[-1]
    ntokens = jnp.sum(start.astype(jnp.int32))
    return all_vals, all_nbs, all_offs, total_bits, ntokens


def _finalize_block(data, n, final, out, total_bits, M: int):
    """Byte-alignment tail + stored-block fallback for one packed block.

    final: pad to byte with zero bits.  Non-final: 3-bit stored header
    (000) -> align -> LEN=0 NLEN=FFFF so chunks concatenate bytewise.
    Incompressible chunks fall back to method-0 stored blocks (RFC 1951
    3.2.4; the reference decodes these at deflate.py:1603-1626 but its
    encoder cannot emit them — ours picks whichever is smaller)."""
    final_len = (total_bits + 7) >> 3
    aligned = (total_bits + 3 + 7) >> 3
    out = out.at[jnp.clip(aligned + 2, 0, M - 1)].add(jnp.where(final, 0, 0xFF))
    out = out.at[jnp.clip(aligned + 3, 0, M - 1)].add(jnp.where(final, 0, 0xFF))
    out_len = jnp.where(final, final_len, aligned + 4)

    out_s, out_len_s = _stored_output(data, n, final, M)
    use_stored = out_len_s < out_len
    out = jnp.where(use_stored, out_s, out)
    out_len = jnp.where(use_stored, out_len_s, out_len)
    return out.astype(jnp.uint8), out_len


@functools.partial(
    jax.jit,
    static_argnames=(
        "window",
        "max_match",
        "use_sort_matcher",
        "lazy",
        "dynamic_encode",
        "far_matcher",
    ),
)
def encode_block_bits(
    data: jax.Array,
    n: jax.Array,
    final: jax.Array,
    window: int,
    max_match: int,
    use_sort_matcher: bool,
    lazy: bool = False,
    dynamic_encode: bool = False,
    far_matcher: str = "exact",
):
    """Encode one block: uint8[N] -> (out_bytes uint8[M], out_len, ntok).

    Emits: 3-bit block header (BFINAL=final, BTYPE=static/dynamic), token
    codes, EOB; when final is false, appends an empty stored block so the
    output ends byte-aligned (bytewise-concatenatable chunks).
    Single-lane path with a per-byte scatter-add pack; the batched
    encode_blocks_batch packs 16-bit channels instead."""
    N = data.shape[0]
    M = max_output_bytes(N)
    all_vals, all_nbs, all_offs, total_bits, ntokens = _encode_emissions(
        data, n, final, window, max_match, use_sort_matcher,
        lazy, dynamic_encode, far_matcher=far_matcher,
    )
    byte_idx = all_offs >> 3
    shift = all_offs & 7
    v = all_vals  # <= 28 bits; v << shift can reach 35, so shifts below
    # are arranged to stay in int32
    out = jnp.zeros((M,), jnp.int32)
    live = all_nbs > 0
    for k in range(5):
        if k == 0:
            contrib = ((v & 0xFF) << shift) & 0xFF
        else:
            contrib = (v >> (8 * k - shift)) & 0xFF  # 8k - shift >= 1
        contrib = jnp.where(live, contrib, 0)
        tgt = jnp.clip(byte_idx + k, 0, M - 1)
        out = out.at[tgt].add(contrib)
    out, out_len = _finalize_block(data, n, final, out, total_bits, M)
    return out, out_len, ntokens


_STORED_MAX = 65535


def _stored_output(data: jax.Array, n: jax.Array, final: jax.Array, M: int):
    """Stored-block encoding of data[:n]: ceil(n/65535) method-0 blocks,
    each 5-byte header + raw bytes; always byte-aligned."""
    N = data.shape[0]
    nblocks = max(1, -(-N // _STORED_MAX))
    # oversized scratch so full-window dynamic_update_slice never clamps
    M_big = max(M, nblocks * (_STORED_MAX + 5) + 8)
    out = jnp.zeros((M_big,), jnp.int32)
    d = data.astype(jnp.int32)
    nb_live = jnp.maximum((n + _STORED_MAX - 1) // _STORED_MAX, 1)
    for sb in range(nblocks):
        off = sb * (_STORED_MAX + 5)
        live = (sb == 0) | (n > sb * _STORED_MAX)
        sb_len = jnp.clip(n - sb * _STORED_MAX, 0, _STORED_MAX)
        is_last = sb + 1 >= nb_live
        hdr = jnp.where(final & is_last, 1, 0)
        nlen = sb_len ^ 0xFFFF
        hdr_vals = jnp.stack(
            [hdr, sb_len & 0xFF, sb_len >> 8, nlen & 0xFF, nlen >> 8]
        )
        hdr_vals = jnp.where(live, hdr_vals, 0)
        out = jax.lax.dynamic_update_slice(out, hdr_vals, (off,))
        seg = jax.lax.dynamic_slice(
            jnp.pad(d, (0, _STORED_MAX)), (sb * _STORED_MAX,), (_STORED_MAX,)
        )
        j = jnp.arange(_STORED_MAX, dtype=jnp.int32)
        seg = jnp.where(live & (j < sb_len), seg, 0)
        out = jax.lax.dynamic_update_slice(out, seg, (off + 5,))
    out_len = nb_live * 5 + n
    return out[:M], out_len


def encode_block(
    data: jax.Array,
    n: jax.Array,
    final: jax.Array,
    config: DeflateConfig = DeflateConfig(),
):
    """Config-driven wrapper choosing the matcher strategy."""
    use_sort = config.window > 256
    return encode_block_bits(
        data,
        n,
        final,
        window=config.window,
        max_match=config.max_match,
        use_sort_matcher=use_sort,
        lazy=config.lazy,
        dynamic_encode=config.dynamic_encode,
        far_matcher=config.far_matcher,
    )


def scatter_add_channels(idx: jax.Array, vals: jax.Array, size: int) -> jax.Array:
    """out[..., c, j] = sum of vals[..., c, e] over idx[..., e] == j.

    idx: int32[..., K]; vals: int32[..., C, K].  Entries with idx outside
    [0, size) drop out.  Returns int32[..., C, size].  Integer adds are
    exact in any order, so the result does not depend on how the
    backend schedules the scatter.
    """
    tgt = jnp.clip(idx, 0, size - 1)
    drop = (idx < 0) | (idx >= size)
    v = jnp.where(drop[..., None, :], 0, vals)
    zero = jnp.zeros(vals.shape[:-1] + (size,), jnp.int32)
    if idx.ndim == 1:
        return zero.at[..., tgt].add(v)
    f = scatter_add_channels
    for _ in range(idx.ndim - 1):
        f = jax.vmap(f, in_axes=(0, 0, None))
    return f(idx, vals, size)


def pack_emissions(vals, nbs, offs, M: int, emax: int) -> jax.Array:
    """Batched bit-pack: emission values at bit offsets -> int32[B, M] bytes.

    vals/nbs/offs: int32[B, K] per-token emission values, widths and bit
    offsets (the parallel form of the reference's serial put()
    accumulator, deflate.py:535-567).  A value of emax bits shifted by
    <= 7 spans ceil((emax+7)/16) 16-bit channels at bytes j, j+2, j+4;
    one scatter-add per channel, then the channels are folded into bytes.
    Emissions are bit-disjoint, so every byte sum is carry-free."""
    live = nbs > 0
    nch = -(-(emax + 7) // 16)
    s = offs & 7
    byte_idx = offs >> 3
    c0 = ((vals & 0xFFFF) << s) & 0xFFFF
    c1 = (vals >> (16 - s)) & 0xFFFF
    c2 = (vals >> 16) >> (16 - s)
    ch = jnp.stack(
        [jnp.where(live, c, 0) for c in (c0, c1, c2)[:nch]], axis=1
    )  # (B, nch, K)
    packed = scatter_add_channels(byte_idx, ch, M + 8)
    out = (packed[:, 0, :M] & 0xFF) + jnp.pad(
        (packed[:, 0, : M - 1] >> 8) & 0xFF, ((0, 0), (1, 0))
    )
    for c in range(1, nch):
        disp = 2 * c
        out = out + jnp.pad(packed[:, c, : M - disp] & 0xFF, ((0, 0), (disp, 0)))
        out = out + jnp.pad(
            (packed[:, c, : M - disp - 1] >> 8) & 0xFF, ((0, 0), (disp + 1, 0))
        )
    return out


@functools.partial(jax.jit, static_argnames=("config",))
def encode_blocks_batch(data, lengths, finals, config: DeflateConfig = DeflateConfig()):
    """Batched multi-block encode: data uint8[B, N].

    Stages 1-4 run vmapped per lane; the bit-pack runs batched
    (pack_emissions)."""
    B, N = data.shape
    M = max_output_bytes(N)
    f = functools.partial(
        _encode_emissions,
        window=config.window,
        max_match=config.max_match,
        use_sort_matcher=config.window > 256,
        lazy=config.lazy,
        dynamic_encode=config.dynamic_encode,
        far_matcher=config.far_matcher,
    )
    vals, nbs, offs, total_bits, ntok = jax.vmap(f)(data, lengths, finals)
    # widest single emission (code + extra bits) the config can produce
    if config.dynamic_encode:
        emax = 28
    elif config.window <= 256 and config.max_match <= 18:
        emax = 20
    else:
        emax = 31
    out = pack_emissions(vals, nbs, offs, M, emax)
    outs, out_lens = jax.vmap(
        functools.partial(_finalize_block, M=M)
    )(data, lengths, finals, out, total_bits)
    return outs, out_lens, ntok
