"""Data-parallel DEFLATE decoder (jittable, static shapes).

Reinterprets the reference's 28-state decode FSM
(/root/reference/deflate.py:656-1659) in two stages:

  Stage 1 — tokenize, via PARALLEL BOUNDARY-CHASE.  Huffman streams are
  bit-serial: you only know where symbol k+1 starts after decoding symbol
  k.  The reference spends 1+ cycles per symbol on this chain
  (NEXT/D_NEXT, deflate.py:1402-1517).  Here we instead decode a
  *candidate* symbol at EVERY bit position of the block — one vectorized
  sweep — giving a jump array next[p] = p + symbol_bits(p).  The true
  symbol boundaries are the orbit of the block's start bit under next[].

  The tokenizer's hot path is gather-free by construction:

  * Bitstream peeks build per-position 64-bit windows from *consecutive*
    byte slices + variable shifts (replaces the reference's ``get4``
    barrel shifter, deflate.py:517-533) — zero gathers.
  * Symbol decode is COMPARISON-BASED canonical Huffman: a code's length
    is the first L whose left-aligned limit exceeds the 15 peeked
    (bit-reversed) bits — 15 vector compares against per-block scalars —
    then rank arithmetic and a one-hot multiply-reduce over the <=288
    per-rank metadata table.  This replaces the reference's 32768-entry
    instant-lookup ``leaves`` RAM + SPREAD replication
    (deflate.py:1204-1400) with no table at all, and makes the dynamic
    table "build" (HF1..SPREAD, 3x32768 cycles in the reference) a
    handful of 16-element scans.
  * The boundary chase runs on 64-bit tiles in a (64, T) layout: each
    tile's entry-phase→exit-phase transfer map is computed by pointer
    doubling with value-SELECT loops (64 predicated row-selects, no
    gather), maps are composed up a binary hierarchy, entry phases
    descend back down, and a final 64-step walk marks true boundaries.
    Jump advances are <=48 bits, so tile entry phases live in [0,48).

  Stage 2 — expand.  Tokens become output bytes in parallel: output
  offsets by prefix sum, per-byte ownership by scatter-at-segment-start +
  monotone cummax forward-fill (no searchsorted), and back-references
  (including overlapping dist<len runs, the off1/off2 special cases at
  deflate.py:1630-1652) resolved by pointer-doubling to each byte's
  literal root with an early-exit loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_deflate.config import DeflateConfig
from tpu_deflate.spec import tables as T

TABLE_BITS = 15
TABLE_SIZE = 1 << TABLE_BITS
CL_BITS = 7
MAX_SYMS = 320  # 288 lit/len + 32 dist
MAX_ADV = 48  # 15 (lit code) + 5 (len extra) + 15 (dist code) + 13 (dist extra)

# error codes
ERR_OK = 0
ERR_METHOD = 1
ERR_BAD_CODE = 2
ERR_BAD_SYM = 3
ERR_DIST = 4
ERR_OVERFLOW = 5
ERR_STORED = 6
ERR_INPUT = 7
ERR_DYNAMIC = 8  # static_only tokenizer met a dynamic-tree block

# readable names for raising typed errors on corrupt input — the analog
# of the reference's in-FSM ``raise Error("Bad method" / "Wrong distance"
# / ...)`` diagnostics (/root/reference/deflate.py:721,1506-1508,1535-1539)
ERR_NAMES = {
    ERR_METHOD: "bad block method",
    ERR_BAD_CODE: "invalid Huffman code",
    ERR_BAD_SYM: "invalid symbol",
    ERR_DIST: "back-reference distance before stream start",
    ERR_STORED: "malformed stored block",
    ERR_INPUT: "truncated stream (ran past end without EOB)",
}

# candidate kinds packed into the per-position plane
K_LIT = 0
K_EOB = 1
K_MATCH = 2
K_BAD = 3

# token kinds
TK_LIT = 0
TK_MATCH = 1
TK_STORED = 2

# FSM modes (outer, per-block loop only — there is no per-symbol loop)
M_HEADER = 0
M_CLLEN = 1
M_TABLES = 2
M_TOKENS = 3
M_DONE = 4
M_ERROR = 5

_STOP = 191  # chase sentinel: chain terminated (EOB/bad) inside an earlier tile


def _revbits15_vec(x: jax.Array) -> jax.Array:
    """Bit-reverse the low 16 bits of each element, vectorized."""
    x = x.astype(jnp.uint32)
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x.astype(jnp.int32)


# ---------------------------------------------------------------------------
# Comparison-decode parameters (replaces the leaves/d_leaves instant tables)
# ---------------------------------------------------------------------------
#
# For a canonical Huffman tree, the 15-bit MSB-first (bit-reversed wire)
# prefix v of a code of length L satisfies
#     lim[L-1] <= v < lim[L],  lim[L] = (next_code[L] + count[L]) << (15-L)
# with lim monotonically non-decreasing, so L = min{l : v < lim[l]}.
# The symbol is then  meta[rank],  rank = (v >> (15-L)) + rd[L],
# rd[L] = (#codes shorter than L) - next_code[L].


def _pack_lit_meta(sym: np.ndarray | jax.Array, xp=np):
    """kind(2)<<16 | extra_bits(3)<<12 | base(12) per lit/len symbol."""
    lb = xp.asarray(T.LENGTH_BASE)
    le = xp.asarray(T.LENGTH_EXTRA_BITS)
    li = xp.clip(sym - 257, 0, 28)
    is_lit = sym < 256
    is_eob = sym == 256
    bad = sym - 257 >= 29
    kind = xp.where(is_lit, K_LIT, xp.where(is_eob, K_EOB, xp.where(bad, K_BAD, K_MATCH)))
    base = xp.where(is_lit, sym, xp.where(kind == K_MATCH, lb[li], 0))
    ebits = xp.where(kind == K_MATCH, le[li], 0)
    return (kind << 16) | (ebits << 12) | base


def _pack_dist_meta(sym, xp=np):
    """extra_bits(4)<<16 | dist_base(16); -1 for invalid symbols (>=30)."""
    db = xp.asarray(T.DIST_BASE)
    de = xp.asarray(T.DIST_EXTRA_BITS)
    di = xp.clip(sym, 0, 29)
    meta = (de[di] << 16) | db[di]
    return xp.where(sym >= 30, -1, meta)


def _canon_params_np(lengths: np.ndarray, n_meta: int, pack) -> tuple:
    """Host-side canonical params for a static tree: (lim16, rd16, meta)."""
    lengths = np.asarray(lengths, np.int64)
    S = len(lengths)
    bl_count = np.bincount(np.clip(lengths, 0, 15), minlength=16)
    bl_count[0] = 0
    next_code = np.zeros(16, np.int64)
    code = 0
    for L in range(1, 16):
        code = (code + bl_count[L - 1]) << 1
        next_code[L] = code
    cum_before = np.concatenate([[0], np.cumsum(bl_count)[:-1]])
    lim = np.zeros(16, np.int64)
    for L in range(1, 16):
        lim[L] = (next_code[L] + bl_count[L]) << (15 - L)
        lim[L] = max(lim[L], lim[L - 1])
    rd = cum_before - next_code
    # rank of each valid symbol; meta by rank
    meta = np.full(n_meta, (K_BAD << 16) if pack is _pack_lit_meta else -1, np.int64)
    order = sorted((L, s) for s, L in enumerate(lengths) if L > 0)
    for r, (_L, s) in enumerate(order):
        meta[r] = pack(np.int64(s))
    return (
        lim.astype(np.int32),
        rd.astype(np.int32),
        meta.astype(np.int32),
    )


_S_LIT_LIM, _S_LIT_RD, _S_LIT_META = _canon_params_np(
    T.STATIC_LITLEN_LENGTHS, 288, _pack_lit_meta
)
_S_DIST_LIM, _S_DIST_RD, _S_DIST_META = _canon_params_np(
    T.STATIC_DIST_LENGTHS, 32, _pack_dist_meta
)


def _canon_params_jax(lengths: jax.Array, n_meta: int, pack_fn):
    """Vectorized canonical params for a dynamic tree built per block.

    lengths: int32[S].  Returns (lim[16], rd[16], meta[n_meta], oversub).
    O(1)-depth replacement for the reference's HF1..SPREAD table build
    (deflate.py:1204-1400).
    """
    S = lengths.shape[0]
    valid = (lengths > 0) & (lengths <= 15)
    ones = valid.astype(jnp.int32)
    Lc = jnp.clip(lengths, 0, 15)
    bl_count = jnp.zeros((16,), jnp.int32).at[Lc].add(ones, mode="drop")
    bl_count = bl_count.at[0].set(0)

    def nc_step(carry, blc):
        code = (carry + blc) << 1
        return code, code

    _, nc = jax.lax.scan(nc_step, jnp.int32(0), bl_count[:15])
    next_code = jnp.concatenate([jnp.zeros((1,), jnp.int32), nc])  # [16]
    cum_before = jnp.cumsum(bl_count) - bl_count
    lim = jnp.where(
        jnp.arange(16) > 0,
        (next_code + bl_count) << jnp.clip(15 - jnp.arange(16), 0, 15),
        0,
    )
    lim = jax.lax.associative_scan(jnp.maximum, lim)  # enforce monotone
    rd = cum_before - next_code
    # Kraft sum in units of 2^-15: oversubscribed trees are invalid input
    kraft = jnp.sum(jnp.where(valid, 1 << jnp.clip(15 - Lc, 0, 15), 0))
    oversub = kraft > (1 << 15)
    # rank per symbol: #shorter codes + #same-length codes at smaller index
    Ls = jnp.arange(1, 16, dtype=jnp.int32)  # (15,)
    eq = (lengths[None, :] == Ls[:, None]) & valid[None, :]  # (15, S)
    within = jnp.cumsum(eq.astype(jnp.int32), axis=1) - eq  # exclusive
    rank_within = jnp.sum(jnp.where(eq, within, 0), axis=0)
    rank = cum_before[Lc] + rank_within
    sym = jnp.arange(S, dtype=jnp.int32)
    bad_fill = (K_BAD << 16) if pack_fn is _pack_lit_meta else -1
    meta = jnp.full((n_meta,), bad_fill, jnp.int32)
    meta = meta.at[jnp.where(valid, rank, n_meta)].set(
        pack_fn(sym, xp=jnp).astype(jnp.int32), mode="drop"
    )
    return lim, rd, meta, oversub


# ---------------------------------------------------------------------------
# Scalar bit peek (outer loop: headers / code-length decode only)
# ---------------------------------------------------------------------------


def _peek_bits(data_u32: jax.Array, pos: jax.Array, nbits) -> jax.Array:
    """Peek up to 24 bits at absolute bit position(s) `pos` (elementwise —
    scalar or vector pos).  Gathers, so hot paths must not use it."""
    byte0 = pos >> 3
    sh = (pos & 7).astype(jnp.uint32)
    M = data_u32.shape[0]
    i0 = jnp.clip(byte0, 0, M - 1)
    i1 = jnp.clip(byte0 + 1, 0, M - 1)
    i2 = jnp.clip(byte0 + 2, 0, M - 1)
    i3 = jnp.clip(byte0 + 3, 0, M - 1)
    acc = (
        data_u32[i0]
        | (data_u32[i1] << 8)
        | (data_u32[i2] << 16)
        | (data_u32[i3] << 24)
    )
    v = (acc >> sh).astype(jnp.uint32)
    mask = jnp.uint32((1 << nbits) - 1) if isinstance(nbits, int) else (
        (jnp.uint32(1) << nbits.astype(jnp.uint32)) - 1
    )
    return (v & mask).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Gather-free candidate plane + boundary chase
# ---------------------------------------------------------------------------


def _select_rows(table: jax.Array, idx: jax.Array, nrows: int) -> jax.Array:
    """result[...] = table[idx[...], ...] via predicated row selects (no
    gather).  table: (nrows, C); idx values outside [0, nrows) keep their
    own value (used to freeze terminated chase chains)."""
    acc = idx
    for v in range(nrows):
        acc = jnp.where(idx == v, table[v, :], acc)
    return acc


def _select_small(meta: jax.Array, idx: jax.Array, K: int) -> jax.Array:
    """meta[idx] for a small table via one-hot multiply-reduce (no gather;
    XLA fuses the broadcast-compare into the reduction).  Callers must
    mask lanes whose idx was clipped."""
    k = jnp.arange(K, dtype=jnp.int32)
    return jnp.sum(jnp.where(idx[..., None] == k, meta, 0), axis=-1)


def _select16(vals: jax.Array, idx: jax.Array) -> jax.Array:
    """vals[idx] for a 16-entry vector of per-block scalars."""
    acc = jnp.zeros_like(idx)
    for L in range(16):
        acc = jnp.where(idx == L, vals[L], acc)
    return acc


def _candidate_plane(
    data: jax.Array,
    base: jax.Array,
    pwin: int,
    end_bit: jax.Array,
    lit_lim, lit_rd, lit_meta, dist_lim, dist_rd, dist_meta,
):
    """Decode a candidate symbol at every bit position [base, base+pwin).

    Returns a packed int32 plane per position:
        kind(2)<<30 | adv(6)<<24 | ta(9)<<15 | (dist-1)(15)
    kind: K_LIT (ta=byte), K_EOB (adv=nb), K_MATCH (ta=len, tb=dist),
    K_BAD.  adv = total bits consumed by the symbol (<= MAX_ADV).
    Entirely elementwise: byte windows from consecutive slices, code
    lengths by comparison, metadata by one-hot reduce.
    """
    U = pwin // 8 + 1
    byte0 = base >> 3
    r0 = base & 7
    nslice = U + 8
    b = jax.lax.dynamic_slice(data, (byte0,), (nslice,)).astype(jnp.uint32)
    lo = b[0:U] | (b[1:U + 1] << 8) | (b[2:U + 2] << 16) | (b[3:U + 3] << 24)
    hi = b[4:U + 4] | (b[5:U + 5] << 8) | (b[6:U + 6] << 16) | (b[7:U + 7] << 24)
    # (8, U) grids: row r = bit phase within byte; q = 8w + r
    lo = lo[None, :]
    hi = hi[None, :]
    r = jax.lax.broadcasted_iota(jnp.int32, (8, 1), 0)

    def get(shift, nbits):
        """nbits (<=15) at bit offset q+shift; shift may be (8,U) or (8,1).
        Max total shift is 7+42=49, end 49+15=64 — fits the 64-bit window."""
        s = (r + shift).astype(jnp.uint32)
        s2 = s & 31
        a = (lo >> s2) | ((hi << (31 - s2)) << 1)
        v = jnp.where(s < 32, a, hi >> s2).astype(jnp.uint32)
        if isinstance(nbits, int):
            mask = jnp.uint32((1 << nbits) - 1)
        else:
            mask = (jnp.uint32(1) << nbits.astype(jnp.uint32)) - 1
        return (v & mask).astype(jnp.int32)

    # --- literal/length code: length by comparison, rank arithmetic ----
    v15 = _revbits15_vec(get(0, 15)) >> 1  # rev16 of a 15-bit value / 2
    cnt = jnp.zeros((8, U), jnp.int32)
    for L in range(1, 16):
        cnt = cnt + (v15 < lit_lim[L])
    nb = 16 - cnt  # 16 => invalid code
    nbc = jnp.clip(nb, 1, 15)
    rank = (v15 >> (15 - nbc)) + _select16(lit_rd, nbc)
    meta = _select_small(lit_meta, jnp.clip(rank, 0, lit_meta.shape[0] - 1), lit_meta.shape[0])
    kind = (meta >> 16) & 3
    ebits = (meta >> 12) & 7
    basev = meta & 0xFFF
    bad_rank = (rank < 0) | (rank >= lit_meta.shape[0])
    kind = jnp.where((nb > 15) | bad_rank, K_BAD, kind)

    is_m = kind == K_MATCH
    lext = get(nbc, 5) & ((1 << ebits) - 1)
    length = basev + lext

    # --- distance code at offset nb+ebits (match candidates only) ------
    doff = nbc + ebits
    dv15 = _revbits15_vec(get(doff, 15)) >> 1
    dcnt = jnp.zeros((8, U), jnp.int32)
    for L in range(1, 16):
        dcnt = dcnt + (dv15 < dist_lim[L])
    dnb = 16 - dcnt
    dnbc = jnp.clip(dnb, 1, 15)
    drank = (dv15 >> (15 - dnbc)) + _select16(dist_rd, dnbc)
    dmeta = _select_small(
        dist_meta, jnp.clip(drank, 0, dist_meta.shape[0] - 1), dist_meta.shape[0]
    )
    bad_d = (dnb > 15) | (drank < 0) | (drank >= dist_meta.shape[0]) | (dmeta < 0)
    debits = (dmeta >> 16) & 0xF
    dbase = dmeta & 0xFFFF
    dext = get(doff + dnbc, 13) & ((1 << debits) - 1)
    dist = dbase + dext

    kind = jnp.where(is_m & bad_d, K_BAD, kind)
    is_m = kind == K_MATCH
    adv = jnp.where(is_m, nbc + ebits + dnbc + debits, jnp.where(kind == K_BAD, 1, nbc))
    ta = jnp.where(kind == K_LIT, basev, jnp.where(is_m, length, 0))
    tbm1 = jnp.where(is_m, dist - 1, 0)

    # out-of-bounds positions (q + r0-shift >= end) are K_BAD
    q = 8 * jax.lax.broadcasted_iota(jnp.int32, (8, U), 1) + jax.lax.broadcasted_iota(
        jnp.int32, (8, U), 0
    )
    p_abs = 8 * byte0 + q
    oob = p_abs >= end_bit
    kind = jnp.where(oob, K_BAD, kind)
    adv = jnp.where(oob, 1, adv)

    plane = (kind << 30) | (adv << 24) | (ta << 15) | tbm1
    # interleave phases: flat[q] = plane[q&7, q>>3]; then align to base
    flat = plane.T.reshape(-1)  # (8U,) indexed by q
    return jax.lax.dynamic_slice(flat, (r0,), (pwin,))


def _candidate_plane_static(data: jax.Array, base: jax.Array, pwin: int, end_bit: jax.Array):
    """Static-tree candidate plane with PURE ARITHMETIC symbol decode.

    The RFC 1951 static literal/length code (deflate.py:1064-1073 in the
    reference) is piecewise affine in the MSB-first prefix, and the
    length/distance base+extra tables follow closed forms — so no
    metadata table (and none of the 288-entry one-hot reduce that
    dominates the generic plane) is needed:

      7 bits: prefix>>8  in [  0, 24)  -> sym 256 + c
      8 bits: prefix>>7  in [ 48,192)  -> sym c - 48      (literals 0-143)
              prefix>>7  in [192,200)  -> sym 280 + c-192
      9 bits: prefix>>6  in [400,512)  -> sym 144 + c-400 (literals 144-255)
      length  sym 257+i: ebits = max(0,(i>>2)-1), base = i<8 ? i+3
              : ((4+(i&3))<<ebits)+3;  i=28 -> 258 exactly
      dist    sym d (5-bit reversed): debits = max(0,(d>>1)-1),
              base = d<2 ? d+1 : ((2+(d&1))<<debits)+1
    """
    U = pwin // 8 + 1
    byte0 = base >> 3
    r0 = base & 7
    nslice = U + 8
    b = jax.lax.dynamic_slice(data, (byte0,), (nslice,)).astype(jnp.uint32)
    lo = b[0:U] | (b[1:U + 1] << 8) | (b[2:U + 2] << 16) | (b[3:U + 3] << 24)
    hi = b[4:U + 4] | (b[5:U + 5] << 8) | (b[6:U + 6] << 16) | (b[7:U + 7] << 24)
    lo = lo[None, :]
    hi = hi[None, :]
    r = jax.lax.broadcasted_iota(jnp.int32, (8, 1), 0)

    def get(shift, nbits):
        s = (r + shift).astype(jnp.uint32)
        s2 = s & 31
        a = (lo >> s2) | ((hi << (31 - s2)) << 1)
        v = jnp.where(s < 32, a, hi >> s2).astype(jnp.uint32)
        if isinstance(nbits, int):
            mask = jnp.uint32((1 << nbits) - 1)
        else:
            mask = (jnp.uint32(1) << nbits.astype(jnp.uint32)) - 1
        return (v & mask).astype(jnp.int32)

    # literal/length: 9-bit reversed prefix, arithmetic classification
    v9 = _revbits15_vec(get(0, 9)) >> 7  # MSB-first 9-bit prefix
    c7 = v9 >> 2
    c8 = v9 >> 1
    is7 = c7 < 24
    is8 = ~is7 & (c8 >= 48) & (c8 < 200)
    # c8 in [24,48) and [200,208) are 8-bit gaps -> those prefixes are the
    # start of 9-bit codes; all 9-bit patterns >= 400 are valid literals
    is9 = ~is7 & ~is8 & (v9 >= 400)
    nb = jnp.where(is7, 7, jnp.where(is8, 8, 9))
    sym = jnp.where(
        is7,
        256 + c7,
        jnp.where(
            is8,
            jnp.where(c8 < 192, c8 - 48, 280 + (c8 - 192)),
            144 + (v9 - 400),
        ),
    )
    bad = ~(is7 | is8 | is9) | (sym > 285)
    is_lit = sym < 256
    is_eob = sym == 256
    i = jnp.clip(sym - 257, 0, 28)
    ebits = jnp.clip((i >> 2) - 1, 0, 5)
    lbase = jnp.where(i < 8, i + 3, ((4 + (i & 3)) << ebits) + 3)
    lbase = jnp.where(i == 28, 258, lbase)
    ebits = jnp.where(i == 28, 0, ebits)
    lext = get(nb, 5) & ((1 << ebits) - 1)
    length = lbase + lext
    is_m = ~is_lit & ~is_eob & ~bad

    # distance: 5 bits, bit-reversed, arithmetic base/extra
    doff = nb + jnp.where(is_m, ebits, 0)
    d5 = get(doff, 5)
    dsym = (
        ((d5 & 1) << 4) | ((d5 & 2) << 2) | (d5 & 4) | ((d5 >> 2) & 2) | (d5 >> 4)
    )
    bad_d = dsym > 29
    debits = jnp.clip((dsym >> 1) - 1, 0, 13)
    dbase = jnp.where(dsym < 2, dsym + 1, ((2 + (dsym & 1)) << debits) + 1)
    dext = get(doff + 5, 13) & ((1 << debits) - 1)
    dist = dbase + dext

    kind = jnp.where(
        bad | (is_m & bad_d),
        K_BAD,
        jnp.where(is_lit, K_LIT, jnp.where(is_eob, K_EOB, K_MATCH)),
    )
    is_m = kind == K_MATCH
    adv = jnp.where(
        is_m, nb + ebits + 5 + debits, jnp.where(kind == K_BAD, 1, nb)
    )
    ta = jnp.where(kind == K_LIT, sym, jnp.where(is_m, length, 0))
    tbm1 = jnp.where(is_m, dist - 1, 0)

    q = 8 * jax.lax.broadcasted_iota(jnp.int32, (8, U), 1) + jax.lax.broadcasted_iota(
        jnp.int32, (8, U), 0
    )
    p_abs = 8 * byte0 + q
    oob = p_abs >= end_bit
    kind = jnp.where(oob, K_BAD, kind)
    adv = jnp.where(oob, 1, adv)

    plane = (kind << 30) | (adv << 24) | (ta << 15) | tbm1
    flat = plane.T.reshape(-1)
    return jax.lax.dynamic_slice(flat, (r0,), (pwin,))


def _pack_rows4(m: jax.Array) -> jax.Array:
    """(64, T) int32 in [0, 256) -> (16, T): 4 row values per int32."""
    return m[0::4] | (m[1::4] << 8) | (m[2::4] << 16) | (m[3::4] << 24)


def _select_rows_packed(P4: jax.Array, idx: jax.Array) -> jax.Array:
    """table[idx] (table pre-packed 4 rows/int32) via 16 predicated
    selects + a byte extract; idx values outside [0, 64) keep their own
    value.  4x fewer select ops than the row-per-row loop — at these
    shapes op count, not element count, is the cost."""
    g = idx >> 2
    acc = jnp.zeros_like(idx)
    for v in range(16):
        acc = jnp.where(g == v, P4[v], acc)
    sub = (acc >> ((idx & 3) << 3)) & 0xFF
    return jnp.where((idx >= 0) & (idx < 64), sub, idx)


def chase_reach(adv: jax.Array, term: jax.Array, P: int) -> jax.Array:
    """Positions reachable from index 0 under next[p] = p + adv[p].

    adv: int32[P] jump lengths in [1, 48]; term: bool[P] chain terminators
    (the chain stops AT a terminal position, which is still marked
    reached).  Returns bool[P].  Select-based (gather-free) hierarchical
    transfer-map composition over 64-wide tiles — the data-parallel
    replacement for per-symbol/per-token FSM stepping, shared by the decoder's boundary
    chase and the encoder's greedy parse."""
    T64 = P // 64
    # (64, T) layout: tiles as columns so selects are row slices
    advT = adv.reshape(T64, 64).T
    termT = term.reshape(T64, 64).T
    e = jax.lax.broadcasted_iota(jnp.int32, (64, T64), 0)
    m0 = jnp.where(termT, 255, e + advT)  # one-step map; >=64 = exited

    # within-tile pointer doubling: 6 rounds, all chains exit or stop
    def dbl(_, m):
        return _select_rows_packed(_pack_rows4(m), m)

    m = jax.lax.fori_loop(0, 6, dbl, m0)
    phi = jnp.where(m >= 128, _STOP, m - 64)  # entry->next-tile phase, [0,48)

    # binary hierarchy of composed maps (finest first), stopping at <=64
    # segments; a sequential scan bridges the top (compile-time bound)
    levels = [phi]
    while levels[-1].shape[1] > 64:
        cur = levels[-1]
        even = cur[:, 0::2]
        odd = cur[:, 1::2]
        comp = _select_rows_packed(_pack_rows4(jnp.where(odd < 0, 0, odd)), even)
        levels.append(comp)

    # entry phase at each top-level segment start: chain the <=64 maps
    def seg_step(e, col):
        e2 = jnp.where(e < 64, col[jnp.clip(e, 0, 63)], e)
        return e2, e

    _, ent = jax.lax.scan(seg_step, jnp.int32(0), levels[-1].T)

    # descend: entry phase at the start of every tile
    for lvl in range(len(levels) - 2, -1, -1):
        even_maps = levels[lvl][:, 0::2]  # (64, T_k/2... matches ent)
        ent = jnp.stack(
            [ent, _select_rows_packed(_pack_rows4(even_maps), ent)], axis=1
        ).reshape(-1)
    # ent: (T64,) entry phase per tile ([0,48) or _STOP)

    # final walk: mark every visited phase (the true symbol boundaries)
    m0p = _pack_rows4(m0)

    def step(_, carry):
        cur, visited = carry
        active = cur < 64
        visited = visited | (active[None, :] & (e == cur[None, :]))
        return _select_rows_packed(m0p, cur), visited

    _, visited = jax.lax.fori_loop(
        0, 64, step, (ent, jnp.zeros((64, T64), bool))
    )
    return visited.T.reshape(-1)


def _chase(plane: jax.Array, pwin: int):
    """Decoder boundary chase over a packed candidate plane."""
    kind = (plane >> 30) & 3
    adv = (plane >> 24) & 0x3F
    term = (kind == K_EOB) | (kind == K_BAD)
    return chase_reach(adv, term, pwin)


CL_WIN = 4608  # dynamic-header window, bits: HLIT+HDIST <= 316 lengths,
# each op <= 7 (CL code) + 7 (repeat extra) bits -> header < 4424 bits


def _decode_cl_lengths(data_ext, pos0, target, cl_lim, cl_rd, cl_meta,
                       win: int = CL_WIN):
    """Decode the HLIT+HDIST code lengths of a dynamic block header.

    Vectorized mini boundary-chase over a ``win``-bit window starting at
    absolute bit ``pos0`` (the data-parallel form of the reference's
    READBL/REPEAT walk, /root/reference/deflate.py:1125-1146): a CL-symbol
    candidate at every bit position, boundaries by chase_reach, repeats
    resolved by exclusive forward fill, interval paints by prefix sums.
    Returns (lengths int32[MAX_SYMS], end_next_rel, ok) where end_next_rel
    is the bit offset from pos0 of the first symbol AFTER the header.
    """
    CL_WIN_ = win
    U = CL_WIN_ // 8 + 1
    byte0 = pos0 >> 3
    r0 = pos0 & 7
    bb = jax.lax.dynamic_slice(data_ext, (byte0,), (U + 8,)).astype(jnp.uint32)
    lo = bb[0:U] | (bb[1:U + 1] << 8) | (bb[2:U + 2] << 16) | (bb[3:U + 3] << 24)
    hi = bb[4:U + 4] | (bb[5:U + 5] << 8) | (bb[6:U + 6] << 16) | (bb[7:U + 7] << 24)
    lo = lo[None, :]
    hi = hi[None, :]
    rr = jax.lax.broadcasted_iota(jnp.int32, (8, 1), 0)

    def getw(shift, nbits):
        sft = (rr + shift).astype(jnp.uint32)
        s2 = sft & 31
        a = (lo >> s2) | ((hi << (31 - s2)) << 1)
        v = jnp.where(sft < 32, a, hi >> s2).astype(jnp.uint32)
        return (v & jnp.uint32((1 << nbits) - 1)).astype(jnp.int32)

    def flat(x):
        return jax.lax.dynamic_slice(x.T.reshape(-1), (r0,), (CL_WIN_,))

    v15g = _revbits15_vec(getw(0, 15)) >> 1
    cnt = jnp.zeros((8, U), jnp.int32)
    for L in range(1, 16):
        cnt = cnt + (v15g < cl_lim[L])
    nb = 16 - cnt
    nbc = jnp.clip(nb, 1, 15)
    rank = (v15g >> (15 - nbc)) + _select16(cl_rd, nbc)
    sym = _select_small(cl_meta, jnp.clip(rank, 0, 18), 19)
    bad_sym = (nb > 7) | (rank < 0) | (rank > 18) | (sym < 0)
    x7 = getw(nbc, 7)
    is16 = sym == 16
    is17 = sym == 17
    is18 = sym == 18
    ebits = jnp.where(is16, 2, jnp.where(is17, 3, jnp.where(is18, 7, 0)))
    count = jnp.where(
        sym < 16,
        1,
        jnp.where(
            is16,
            3 + (x7 & 3),
            jnp.where(is17, 3 + (x7 & 7), 11 + x7),
        ),
    )
    adv8 = jnp.where(bad_sym, 1, nbc + ebits)

    sym_f = flat(jnp.where(bad_sym, -1, sym))
    count_f = flat(count)
    adv_f = flat(adv8)
    term_f = sym_f < 0
    reached = chase_reach(adv_f, term_f, CL_WIN_)

    pidx = jnp.arange(CL_WIN_, dtype=jnp.int32)
    opc = jnp.where(reached & ~term_f, count_f, 0)
    cum = jnp.cumsum(opc)
    cum_ex = cum - opc
    live_op = reached & ~term_f & (cum_ex < target)
    total = jnp.max(jnp.where(live_op, cum, 0))
    end_next = jnp.max(jnp.where(live_op & (cum == target), pidx + adv_f, -1))

    # sym 16 copies the PREVIOUS emitted code length: forward-fill of
    # (assignments and zero-runs), exclusive at the reading position
    setk = jnp.where(
        live_op & (sym_f < 16),
        (pidx << 9) | (sym_f + 1),
        jnp.where(live_op & (sym_f >= 17), (pidx << 9) | 1, -1),
    )
    fill = jax.lax.cummax(setk)
    assign16 = (fill & 0x1FF) - 1
    bad16 = jnp.any(live_op & (sym_f == 16) & (fill < 0))
    assign = jnp.where(
        sym_f < 16, sym_f, jnp.where(sym_f == 16, assign16, 0)
    )

    # paint interval starts into the lengths array, forward-fill.  Targets
    # cum_ex are strictly increasing over live ops (count >= 1), so each
    # slot receives at most one live value; values are stored +1 so empty
    # slots read 0.
    pk = (cum_ex << 9) | (assign + 1)  # < 2^19, increasing in s
    tgt_idx = jnp.where(live_op, cum_ex, jnp.int32(MAX_SYMS))
    arr = jnp.full((MAX_SYMS,), -1, jnp.int32).at[tgt_idx].max(
        jnp.where(live_op, pk, -1), mode="drop"
    )
    farr = jax.lax.cummax(arr)
    sidx = jnp.arange(MAX_SYMS, dtype=jnp.int32)
    lengths = jnp.where(
        (sidx < target) & (farr >= 0), (farr & 0x1FF) - 1, 0
    )

    ok = (total == target) & ~bad16 & (end_next >= 0)
    return lengths, end_next, ok


@functools.partial(
    jax.jit,
    static_argnames=(
        "tok_cap", "pwin", "stop_at_eob", "static_only",
        "one_block", "return_bfinal",
    ),
)
def tokenize(
    data: jax.Array,
    start_bit: jax.Array,
    tok_cap: int,
    end_bit: jax.Array | None = None,
    pwin: int = 1 << 18,
    stop_at_eob: bool = False,
    static_only: bool = False,
    one_block: bool = False,
    return_bfinal: bool = False,
):
    """Stage 1: bitstream -> token arrays.

    data: uint8[M].  pwin: bit positions processed per parallel block pass
    (blocks longer than pwin continue in further passes).  ``end_bit``
    bounds this decode for chunk-parallel lanes; ``stop_at_eob`` makes any
    end-of-block terminate the lane (indexed chunks are one block each, so
    lanes skip the inter-chunk alignment markers entirely).
    ``static_only``: specialize for stored/static blocks only — the
    candidate plane becomes pure arithmetic (the LOWLUT analog; dynamic
    blocks return ERR_DYNAMIC so callers can fall back).  Our own
    container with dynamic_encode=False guarantees this statically.
    ``one_block``: terminate after the FIRST block of any type (the
    ONEBLOCK elaboration, deflate.py:28 — unlike stop_at_eob, a stored
    block also terminates).
    Returns (tk, ta, tb, tp, out_total, end_pos, err).
    """
    M = data.shape[0]
    # pad so window slicing near the stream end never clamps (the plane
    # window AND the 8192-bit dynamic-header window both slice ahead)
    data_ext = jnp.pad(data, (0, max(pwin // 8, 1024) + 16))
    d32 = data_ext.astype(jnp.uint32)
    nbits_total = 8 * M
    if end_bit is None:
        end_bit = jnp.int32(nbits_total)
    else:
        end_bit = jnp.asarray(end_bit, jnp.int32)

    len_base = jnp.asarray(T.LENGTH_BASE)
    len_extra = jnp.asarray(T.LENGTH_EXTRA_BITS)
    cl_order = jnp.asarray(T.CODE_LENGTH_ORDER)

    def peek(pos, nb):
        return _peek_bits(d32, pos, nb)

    state = dict(
        pos=jnp.asarray(start_bit, jnp.int32),
        mode=jnp.int32(M_HEADER),
        bfinal=jnp.int32(0),
        tk=jnp.zeros((tok_cap,), jnp.int32),
        ta=jnp.zeros((tok_cap,), jnp.int32),
        tb=jnp.zeros((tok_cap,), jnp.int32),
        tp=jnp.int32(0),
        out_total=jnp.int32(0),
        err=jnp.int32(ERR_OK),
    )
    if not static_only:
        state = dict(
        state,
        hlit=jnp.int32(0),
        hdist=jnp.int32(0),
        lit_lim=jnp.asarray(_S_LIT_LIM),
        lit_rd=jnp.asarray(_S_LIT_RD),
        lit_meta=jnp.asarray(_S_LIT_META),
        dist_lim=jnp.asarray(_S_DIST_LIM),
        dist_rd=jnp.asarray(_S_DIST_RD),
        dist_meta=jnp.asarray(_S_DIST_META),
        cl_lim=jnp.zeros((16,), jnp.int32),
        cl_rd=jnp.zeros((16,), jnp.int32),
        cl_meta=jnp.zeros((19,), jnp.int32),
        lengths=jnp.zeros((MAX_SYMS,), jnp.int32),
        )

    # ---------------- block header (stored / static / dynamic) ----------
    def header_fn(s):
        pos = s["pos"]
        bfinal = peek(pos, 1)
        btype = peek(pos + 1, 2)
        pos3 = pos + 3

        def stored(s):
            p = (pos3 + 7) & ~7  # align to byte
            ln = peek(p, 16)
            nln = peek(p + 16, 16)
            ok = ln == (nln ^ 0xFFFF)
            byte_off = (p + 32) >> 3
            tp = s["tp"]
            after_stored = (
                jnp.int32(M_DONE)  # ONEBLOCK: any block type terminates
                if one_block
                else jnp.where(
                    bfinal == 1, jnp.int32(M_DONE), jnp.int32(M_HEADER)
                )
            )
            return dict(
                s,
                pos=p + 32 + 8 * ln,
                tk=s["tk"].at[tp].set(TK_STORED),
                ta=s["ta"].at[tp].set(ln),
                tb=s["tb"].at[tp].set(byte_off),
                tp=tp + 1,
                out_total=s["out_total"] + ln,
                bfinal=bfinal,
                mode=jnp.where(~ok, jnp.int32(M_ERROR), after_stored),
                err=jnp.where(ok, s["err"], jnp.int32(ERR_STORED)),
            )

        def static(s):
            if static_only:
                return dict(s, pos=pos3, bfinal=bfinal, mode=jnp.int32(M_TOKENS))
            return dict(
                s,
                pos=pos3,
                bfinal=bfinal,
                lit_lim=jnp.asarray(_S_LIT_LIM),
                lit_rd=jnp.asarray(_S_LIT_RD),
                lit_meta=jnp.asarray(_S_LIT_META),
                dist_lim=jnp.asarray(_S_DIST_LIM),
                dist_rd=jnp.asarray(_S_DIST_RD),
                dist_meta=jnp.asarray(_S_DIST_META),
                mode=jnp.int32(M_TOKENS),
            )

        def dynamic(s):
            if static_only:
                return dict(
                    s, bfinal=bfinal, mode=jnp.int32(M_ERROR),
                    err=jnp.int32(ERR_DYNAMIC),
                )
            hlit = peek(pos3, 5) + 257
            hdist = peek(pos3 + 5, 5) + 1
            hclen = peek(pos3 + 10, 4) + 4
            p = pos3 + 14
            j = jnp.arange(19, dtype=jnp.int32)
            raw = peek(p + 3 * j, 3)
            raw = jnp.where(j < hclen, raw, 0)
            cl_lengths = jnp.zeros((19,), jnp.int32).at[cl_order].set(raw)
            clim, crd, cmeta, cover = _canon_params_jax(
                cl_lengths, 19, lambda sym, xp=np: sym
            )
            return dict(
                s,
                pos=p + 3 * hclen,
                bfinal=bfinal,
                hlit=hlit,
                hdist=hdist,
                cl_lim=clim,
                cl_rd=crd,
                cl_meta=cmeta,
                lengths=jnp.zeros((MAX_SYMS,), jnp.int32),
                mode=jnp.where(cover, jnp.int32(M_ERROR), jnp.int32(M_CLLEN)),
                err=jnp.where(cover, jnp.int32(ERR_BAD_CODE), s["err"]),
            )

        def bad(s):
            return dict(s, mode=jnp.int32(M_ERROR), err=jnp.int32(ERR_METHOD))

        return jax.lax.switch(jnp.clip(btype, 0, 3), [stored, static, dynamic, bad], s)

    # -------- code-length symbol decode (dynamic header) -----------------
    # Vectorized mini boundary-chase over the header region: the reference
    # (READBL/REPEAT, deflate.py:1125-1146) walks one CL symbol per step
    # (<=316 sequential iterations, each a data-dependent loop trip on the
    # device); instead decode a CL-symbol candidate at every bit position
    # of a CL_WIN-bit window, chase the boundaries, and assemble the
    # lengths with prefix sums and forward fills.

    def cllen_vec(s):
        lengths, end_next, ok = _decode_cl_lengths(
            data_ext, s["pos"], s["hlit"] + s["hdist"],
            s["cl_lim"], s["cl_rd"], s["cl_meta"],
        )
        return dict(
            s,
            pos=s["pos"] + end_next,
            lengths=lengths,
            err=jnp.where(ok, s["err"], jnp.int32(ERR_BAD_CODE)),
            mode=jnp.where(ok, jnp.int32(M_TABLES), jnp.int32(M_ERROR)),
        )

    def tables_fn(s):
        """Per-block comparison-decode params from the decoded lengths —
        replaces the reference's 3x32768-cycle HF1..SPREAD builds."""
        sidx = jnp.arange(MAX_SYMS, dtype=jnp.int32)
        lengths_ = s["lengths"]
        hlit = s["hlit"]
        lit_lengths = jnp.where(sidx < hlit, lengths_, 0)
        dl = lengths_[jnp.clip(hlit + sidx, 0, MAX_SYMS - 1)]
        dist_lengths = jnp.where(sidx < s["hdist"], dl, 0)
        llim, lrd, lmeta, lover = _canon_params_jax(lit_lengths, 288, _pack_lit_meta)
        dlim, drd, dmeta, dover = _canon_params_jax(dist_lengths, 32, _pack_dist_meta)
        bad = lover | dover
        return dict(
            s,
            lit_lim=llim,
            lit_rd=lrd,
            lit_meta=lmeta,
            dist_lim=dlim,
            dist_rd=drd,
            dist_meta=dmeta,
            mode=jnp.where(bad, jnp.int32(M_ERROR), jnp.int32(M_TOKENS)),
            err=jnp.where(bad, jnp.int32(ERR_BAD_CODE), s["err"]),
        )

    # -------- the parallel boundary-chase over one window ----------------
    def block_pass(s):
        base = s["pos"]
        rel = jnp.arange(pwin, dtype=jnp.int32)
        if static_only:
            plane = _candidate_plane_static(data_ext, base, pwin, end_bit)
        else:
            plane = _candidate_plane(
                data_ext, base, pwin, end_bit,
                s["lit_lim"], s["lit_rd"], s["lit_meta"],
                s["dist_lim"], s["dist_rd"], s["dist_meta"],
            )
        reach = _chase(plane, pwin)

        kind = (plane >> 30) & 3
        adv = (plane >> 24) & 0x3F
        ta_f = (plane >> 15) & 0x1FF
        tb_f = (plane & 0x7FFF) + 1
        is_lit = kind == K_LIT
        is_eob = kind == K_EOB
        is_match_c = kind == K_MATCH
        bad = kind == K_BAD

        # ordered token emission by prefix sum over reached positions
        tmask = reach & (is_lit | is_match_c)
        ord1 = jnp.cumsum(tmask.astype(jnp.int32))  # 1-based ordinal
        ntok = ord1[-1]
        tp = s["tp"]
        cap_ok = tp + ntok < tok_cap - 1
        slot = jnp.where(tmask & cap_ok, tp + ord1 - 1, jnp.int32(tok_cap - 1))
        tk_val = jnp.where(is_lit, jnp.int32(TK_LIT), jnp.int32(TK_MATCH))
        ta_val = ta_f
        tb_val = jnp.where(is_lit, 0, tb_f)

        produced = jnp.where(tmask, jnp.where(is_lit, 1, ta_f), 0)
        bad_reached = jnp.any(reach & bad)

        eob_hit = jnp.any(reach & is_eob)
        eob_rel = jnp.max(jnp.where(reach & is_eob, rel, -1))
        eob_nb = adv[jnp.clip(eob_rel, 0, pwin - 1)]
        # window continue: the last reached position's successor (>= pwin)
        last_rel = jnp.max(jnp.where(reach, rel, -1))
        cont_pos = base + last_rel + adv[jnp.clip(last_rel, 0, pwin - 1)]

        new_pos = jnp.where(eob_hit, base + eob_rel + eob_nb, cont_pos)
        after_eob = (
            jnp.int32(M_DONE)
            if stop_at_eob or one_block
            else jnp.where(
                s["bfinal"] == 1, jnp.int32(M_DONE), jnp.int32(M_HEADER)
            )
        )
        # ONE compaction per pass: token fields packed into a single int32
        # (kind 2b | len-or-byte 9b | dist 17b), scattered to their slots
        # (a cumsum of the reach mask).  Positions that are not tokens all
        # land on the sentinel slot tok_cap - 1, which cap_ok keeps unused.
        packed_tok = (tk_val << 26) | (ta_val << 17) | (tb_val & 0x1FFFF)
        new_tk = s["tk"].at[slot].set(packed_tok)

        # distance validity: each match must reach only already-produced
        # output.  Checked over the COMPACTED token slots (tok_cap-sized
        # prefix, ~4x cheaper than a plane-sized one).
        new_tp = tp + jnp.where(cap_ok, ntok, 0)
        tslots = jnp.arange(tok_cap, dtype=jnp.int32)
        live2 = tslots < new_tp
        is_stored_slot = new_tk == TK_STORED
        kindp = (new_tk >> 26) & 3
        lenp = jnp.where(
            is_stored_slot,
            s["ta"],
            jnp.where(kindp == TK_LIT, 1, (new_tk >> 17) & 0x1FF),
        )
        lenp = jnp.where(live2, lenp, 0)
        offp = jnp.cumsum(lenp) - lenp
        too_far = jnp.any(
            live2
            & (kindp == TK_MATCH)
            & ~is_stored_slot
            & ((new_tk & 0x1FFFF) > offp)
        )

        anybad = bad_reached | too_far | ~cap_ok
        mode = jnp.where(
            anybad,
            jnp.int32(M_ERROR),
            jnp.where(eob_hit, after_eob, jnp.int32(M_TOKENS)),
        )
        err = jnp.where(
            anybad,
            jnp.where(
                too_far,
                jnp.int32(ERR_DIST),
                jnp.where(~cap_ok, jnp.int32(ERR_OVERFLOW), jnp.int32(ERR_BAD_CODE)),
            ),
            s["err"],
        )
        return dict(
            s,
            pos=new_pos,
            tk=new_tk,
            tp=new_tp,
            out_total=s["out_total"] + jnp.where(cap_ok, jnp.sum(produced), 0),
            mode=mode,
            err=err,
        )

    # ---------------- outer per-block loop -------------------------------
    def in_bounds(s):
        return (
            (s["pos"] <= nbits_total)
            & (s["pos"] < end_bit)
            & (s["tp"] < tok_cap - 1)
        )

    def outer_cond(s):
        return (s["mode"] < M_DONE) & in_bounds(s)

    def outer_body(s):
        s = jax.lax.cond(s["mode"] == M_HEADER, header_fn, lambda s: s, s)
        if not static_only:
            s = jax.lax.cond(s["mode"] == M_CLLEN, cllen_vec, lambda s: s, s)
            s = jax.lax.cond(s["mode"] == M_TABLES, tables_fn, lambda s: s, s)
        s = jax.lax.cond(s["mode"] == M_TOKENS, block_pass, lambda s: s, s)
        return s

    # Hoist the first header out of the loop: under vmap every lax.cond
    # branch executes for the whole batch, so an outer iteration spent in
    # M_HEADER still pays for a full (plane + chase) block_pass.  With the
    # hoist, single-block chunk decodes run the loop exactly once.
    state = jax.lax.cond(outer_cond(state), header_fn, lambda s: s, state)
    s = jax.lax.while_loop(outer_cond, outer_body, state)
    clean_end = (s["mode"] == M_DONE) | (
        (s["err"] == ERR_OK) & (s["pos"] >= end_bit) & (s["mode"] == M_HEADER)
    )
    err = jnp.where(
        clean_end,
        s["err"],
        jnp.where(
            s["err"] != ERR_OK,
            s["err"],
            jnp.where(
                s["tp"] >= tok_cap - 1,
                jnp.int32(ERR_OVERFLOW),
                jnp.int32(ERR_INPUT),
            ),
        ),
    )
    # Unpack the token plane.  block_pass packs lit/match tokens into tk
    # alone; stored tokens (header_fn) use the separate ta/tb arrays and
    # are identified by tk == TK_STORED exactly — a packed value is 0, in
    # [2^17, 2^26) (literal) or >= 2^26 (match), never 2.
    tkp = s["tk"]
    is_stored = tkp == TK_STORED
    tk = jnp.where(is_stored, TK_STORED, (tkp >> 26) & 3)
    ta = jnp.where(is_stored, s["ta"], (tkp >> 17) & 0x1FF)
    tb = jnp.where(is_stored, s["tb"], tkp & 0x1FFFF)
    if return_bfinal:
        return tk, ta, tb, s["tp"], s["out_total"], s["pos"], err, s["bfinal"]
    return tk, ta, tb, s["tp"], s["out_total"], s["pos"], err


def _expand_fields(data, tk, ta, tb, tp, any_stored, out_cap: int):
    """Per-lane stage 2 prologue: token arrays -> (val, parent, in_range,
    total).

    Per-byte ownership by scatter-at-token-start + monotone cummax
    forward-fill (three 13-bit payload channels); constant-distance runs
    collapsed analytically; the remaining parent chains are resolved by
    the batched ``resolve_roots`` — together
    the parallel generalization of the reference's COPY state and its
    off1/off2 overlap cases (deflate.py:1593-1659)."""
    TOK = tk.shape[0]
    tok_idx = jnp.arange(TOK, dtype=jnp.int32)
    live = tok_idx < tp
    out_len_tok = jnp.where(
        live, jnp.where(tk == TK_LIT, 1, ta), 0
    )  # match & stored produce ta bytes
    out_off = jnp.cumsum(out_len_tok) - out_len_tok  # exclusive
    total = jnp.sum(out_len_tok)

    # Ownership: scatter each producing token's fields at its start byte,
    # then forward-fill.  Fills are monotone cummaxes of (start << w | val)
    # — native cumulative ops, no searchsorted.  kind+ta share an 11-bit
    # channel; tb (dist, or stored-block byte offset) is split 13/13.
    emits = live & (out_len_tok > 0)
    start = jnp.where(emits, out_off, out_cap).astype(jnp.int32)
    c1 = ((tk & 3) << 9) | (ta & 0x1FF)
    neg = jnp.full((out_cap,), -1, jnp.int32)

    def cmax(x):
        return jax.lax.cummax(x, axis=0)

    if out_cap <= (1 << 18):
        def ff(vals, width):
            packed = jnp.where(emits, (out_off << width) | vals, -1)
            arr = neg.at[start].max(packed, mode="drop")
            return cmax(arr)

        f1 = ff(c1, 11)
        f2 = ff(tb & 0x1FFF, 13)
        f3 = ff((tb >> 13) & 0x1FFF, 13)
        st0 = f1 >> 11
        v1 = f1 & 0x7FF
        b = (f2 & 0x1FFF) | ((f3 & 0x1FFF) << 13)
        filled = f1 >= 0
    else:
        # huge single-stream path: one cummax for ownership, then gather
        # the fields (acceptable off the chunk-parallel hot path)
        a_st = neg.at[start].max(jnp.where(emits, out_off, -1), mode="drop")
        st0 = cmax(a_st)
        filled = st0 >= 0
        a_c1 = neg.at[start].max(jnp.where(emits, c1, -1), mode="drop")
        a_tb = neg.at[start].max(jnp.where(emits, tb, -1), mode="drop")
        sidx = jnp.clip(st0, 0, out_cap - 1)
        v1 = a_c1[sidx]
        b = a_tb[sidx]
    kind = (v1 >> 9) & 3
    a = v1 & 0x1FF
    p = jnp.arange(out_cap, dtype=jnp.int32)
    j = p - st0
    in_range = (p < total) & filled

    M = data.shape[0]
    d = data.astype(jnp.int32)
    # stored-block bytes need a data gather; most streams have none, so
    # it is skipped batch-wide (any_stored is unbatched, keeping the cond
    # a real branch under vmap)
    stored_byte = jax.lax.cond(
        any_stored,
        lambda _: d[jnp.clip(b + j, 0, M - 1)],
        lambda _: jnp.zeros((out_cap,), jnp.int32),
        None,
    )

    is_root = in_range & (kind != TK_MATCH)
    val = jnp.where(kind == TK_LIT, a, stored_byte)
    parent = jnp.where(is_root | ~in_range, p, jnp.clip(p - b, 0, out_cap - 1))

    # Collapse constant-distance runs analytically: a maximal run of match
    # bytes sharing distance d forms the chain p -> p-d -> p-2d -> ...;
    # its first element before the run start S lands at S-d + (p-S) mod d.
    # One elementwise step replaces the run's entire chain — the general
    # form of the reference's off1/off2 overlap shortcuts
    # (deflate.py:1630-1652) — so pointer doubling only pays for
    # mixed-distance nesting depth, not run length.
    is_m = in_range & (kind == TK_MATCH)
    prev_m = jnp.concatenate([jnp.zeros((1,), bool), is_m[:-1]])
    prev_b = jnp.concatenate([jnp.zeros((1,), jnp.int32), b[:-1]])
    run_start = is_m & (~prev_m | (prev_b != b))
    S = cmax(jnp.where(run_start, p, -1))
    bc = jnp.maximum(b, 1)
    sd = S - bc
    collapsed = sd + jnp.remainder(p - sd, bc)
    parent = jnp.where(
        is_m & (S >= 0), jnp.clip(collapsed, 0, out_cap - 1), parent
    )
    return val, parent, in_range, total


def resolve_roots(parent: jax.Array, val: jax.Array) -> jax.Array:
    """Value at the root of each position's parent chain.

    parent/val: int32[..., N], parent indices into the last axis; a root
    is its own parent.  Pointer doubling (parent <- parent[parent]) until
    no pointer moves, then one gather of the root values; the loop takes
    ceil(log2(longest chain)) + 1 trips."""
    def cond(c):
        _, changed = c
        return changed

    def body(c):
        p, _ = c
        nxt = jnp.take_along_axis(p, p, axis=-1)
        return nxt, jnp.any(nxt != p)

    p, _ = jax.lax.while_loop(cond, body, (parent, jnp.bool_(True)))
    return jnp.take_along_axis(val, p, axis=-1)


@functools.partial(jax.jit, static_argnames=("out_cap",))
def expand_batch(data, tk, ta, tb, tp, out_cap: int):
    """Stage 2, batched over chunk lanes: token arrays -> output bytes.

    data: uint8[B, M] (or uint8[M], one stream shared by every lane);
    tk/ta/tb: int32[B, TOK]; tp: int32[B].  Returns (uint8[B, out_cap],
    int32[B] totals).  Stored-block bytes are gathered from ``data`` only
    when some lane holds a stored token."""
    data_axis = 0 if data.ndim == 2 else None  # 1-D = shared stream blob
    TOK = tk.shape[-1]
    live = jnp.arange(TOK) < tp[..., None]
    any_stored = jnp.any((tk == TK_STORED) & live)
    val, parent, in_range, total = jax.vmap(
        functools.partial(_expand_fields, out_cap=out_cap),
        in_axes=(data_axis, 0, 0, 0, 0, None),
    )(data, tk, ta, tb, tp, any_stored)
    root = resolve_roots(parent, val)
    out = jnp.where(in_range, root, 0).astype(jnp.uint8)
    return out, total


@functools.partial(jax.jit, static_argnames=("out_cap",))
def expand(data, tk, ta, tb, tp, out_cap: int):
    """Single-stream stage 2 (see expand_batch)."""
    out, total = expand_batch(
        data[None], tk[None], ta[None], tb[None], tp[None], out_cap=out_cap
    )
    return out[0], total[0]


@functools.partial(
    jax.jit, static_argnames=("out_cap", "tok_cap", "static_only")
)
def decode_rows_batch(
    rows: jax.Array,  # uint8[B, M] — one byte-aligned block run per lane
    ends: jax.Array,  # int32[B] — end bit (8 * compressed size per lane)
    out_cap: int,
    tok_cap: int,
    static_only: bool = True,
):
    """Chunk-parallel decode of per-lane rows: stage 1 + stage 2.

    Lanes stop at their first end-of-block (the indexed own-container
    layout: one block per chunk).  ``static_only`` compiles the
    arithmetic stored/static decoder; dynamic lanes then report
    ERR_DYNAMIC.  Returns (out uint8[B, out_cap], totals int32[B],
    errs int32[B]).
    """
    ends = ends.astype(jnp.int32)
    pwin = chunk_pwin(out_cap)
    tk, ta, tb, tp, _tot, _pos, err = jax.vmap(
        lambda row, e: tokenize(
            row, 0, tok_cap=tok_cap, end_bit=e, pwin=pwin,
            stop_at_eob=True, static_only=static_only,
        )
    )(rows, ends)
    out, total = expand_batch(rows, tk, ta, tb, tp, out_cap=out_cap)
    return out, total, err


def chunk_pwin(chunk: int) -> int:
    """Single-pass-friendly plane window for chunk-parallel decode.

    17 * 2^k bit positions (halvable to a <=64-tile chase hierarchy)
    covering one chunk's compressed stream in ONE boundary-chase pass for
    ratios up to ~0.53 — a bare power of two is a hair too small and
    forces a second full-batch pass (measured: 265728-bit lanes vs 2^18).
    """
    k = max(6, min(14, int(np.ceil(np.log2(max(chunk, 64)))) - 2))
    return 17 << k


def _pick_pwin(nbytes: int) -> int:
    """Window (bit positions per parallel pass) covering nbytes of
    compressed data, capped at 2^17: zlib emits a block per ~16K
    symbols, so wider planes mostly decode past the block end while the
    boundary chase's fixed hierarchy cost grows with pwin."""
    want = 8 * max(nbytes, 64)
    p = 1 << int(np.ceil(np.log2(want)))
    return min(p, 1 << 17)


def inflate_device(
    data: bytes | np.ndarray,
    start_bit: int = 0,
    out_cap: int | None = None,
    static_only: bool = False,
    one_block: bool = False,
) -> tuple[np.ndarray, int, int]:
    """Full device inflate.  Returns (output array, output length, end bit).

    Retries with a doubled output buffer on overflow, like a host resizing
    the reference's OBSIZE.  ``static_only`` compiles the LOWLUT analog
    (arithmetic stored/static decoder only; dynamic-tree blocks raise) —
    the elaboration specialization of the reference's DYNAMIC/LOWLUT flags
    (/root/reference/deflate.py:25,21,275-286).  ``one_block`` stops after
    the first end-of-block, the ONEBLOCK analog (deflate.py:28,415-421).
    """
    raw = np.frombuffer(bytes(data), dtype=np.uint8)
    m = len(raw)
    # pad the input to a power-of-two bucket so compiled programs are
    # reused across calls with different stream lengths
    m_pad = max(1 << 12, 1 << int(np.ceil(np.log2(max(m, 2)))))
    arr = jnp.asarray(np.pad(raw, (0, m_pad - m)))
    cap = out_cap or max(1 << 12, 1 << (int(np.ceil(np.log2(max(4 * m, 2))))))
    pwin = _pick_pwin(m_pad)
    while True:
        tok_cap = cap + 16
        tk, ta, tb, tp, out_total, pos, err = tokenize(
            arr, start_bit, tok_cap=tok_cap, pwin=pwin,
            static_only=static_only, one_block=one_block,
        )
        err = int(err)
        if err == ERR_OVERFLOW or (err == ERR_OK and int(out_total) > cap):
            cap *= 2
            if cap > 1 << 31:
                raise ValueError("output too large")
            continue
        if err == ERR_DYNAMIC:
            from tpu_deflate.ref.inflate import DeflateError

            raise DeflateError(
                "dynamic-Huffman block rejected: decoder compiled with "
                "dynamic=False/low_lut (reference DYNAMIC flag, "
                "deflate.py:25)"
            )
        if err != ERR_OK:
            from tpu_deflate.ref.inflate import DeflateError

            raise DeflateError(
                f"corrupt stream: {ERR_NAMES.get(err, f'error code {err}')}"
            )
        out, total = expand(arr, tk, ta, tb, tp, out_cap=cap)
        return np.asarray(out), int(total), int(pos)


def _shift_right_bits(data: bytes, k: int) -> bytes:
    """Drop the low ``k`` bits (0-7) of an LSB-first bitstream: output
    byte i carries input bits [8i + k, 8i + k + 8)."""
    if k == 0:
        return bytes(data)
    a = np.frombuffer(bytes(data), np.uint8).astype(np.uint16)
    nxt = np.concatenate([a[1:], np.zeros(1, np.uint16)])
    return (((a >> k) | ((nxt << (8 - k)) & 0xFF)) & 0xFF).astype(np.uint8).tobytes()


def inflate_stream_step(
    window: bytes,
    pending: bytes,
    pbit: int,
    static_only: bool = False,
) -> tuple[bytes, int, bool]:
    """One incremental inflate step over a partial stream.

    ``window`` is the last <= 32 KB of output already emitted; ``pending``
    holds unconsumed compressed bytes whose first ``pbit`` bits are
    already decoded.  Decodes the next complete block run on device by
    synthesizing a stored block that carries the window (so cross-call
    back-references resolve), then tokenizing from the stored block
    through the first end-of-block.  Returns (emitted bytes, bits of
    ``pending`` consumed, stream_done).  (b"", 0, False) means the next
    block is not completely buffered yet — feed more input and retry.

    This is the device analog of the reference's concurrent feed/drain
    streaming protocol (backpressured READ while WRITEs continue,
    /root/reference/test_deflate.py:142-174): output becomes available
    per block while the producer is still feeding.
    """
    W = len(window)
    assert W <= 0xFFFF
    prefix = (
        b"\x00"
        + W.to_bytes(2, "little")
        + (W ^ 0xFFFF).to_bytes(2, "little")
        + bytes(window)
    )
    shifted = _shift_right_bits(pending, pbit)
    raw = np.frombuffer(prefix + shifted, np.uint8)
    m = len(raw)
    m_pad = max(1 << 12, 1 << int(np.ceil(np.log2(max(m, 2)))))
    arr = jnp.asarray(np.pad(raw, (0, m_pad - m)))
    end_bit = 8 * len(prefix) + (8 * len(pending) - pbit)
    cap = max(1 << 12, 1 << int(np.ceil(np.log2(max(W + 4 * len(pending), 2)))))
    pwin = _pick_pwin(m_pad)
    while True:
        tk, ta, tb, tp, out_total, pos, err, bfinal = tokenize(
            arr, 0, tok_cap=cap + 16, end_bit=jnp.int32(end_bit), pwin=pwin,
            stop_at_eob=True, static_only=static_only, return_bfinal=True,
        )
        err = int(err)
        if err == ERR_OVERFLOW or (err == ERR_OK and int(out_total) > cap):
            cap *= 2
            if cap > 1 << 31:
                raise ValueError("output too large")
            continue
        if err == ERR_DYNAMIC:
            from tpu_deflate.ref.inflate import DeflateError

            raise DeflateError(
                "dynamic-Huffman block rejected: decoder compiled with "
                "dynamic=False/low_lut (reference DYNAMIC flag, "
                "deflate.py:25)"
            )
        if err != ERR_OK:
            # most commonly ERR_INPUT (block truncated at end_bit); any
            # genuinely malformed stream re-errors once fully buffered,
            # surfaced by the caller's flush
            return b"", 0, False
        if int(pos) > end_bit:
            # a block parsed past the buffered input (e.g. stored payload
            # truncated after its complete header): wait for more bytes
            return b"", 0, False
        out, total = expand(arr, tk, ta, tb, tp, out_cap=cap)
        consumed = int(pos) - 8 * len(prefix)
        if consumed <= 0:
            return b"", 0, False
        emitted = np.asarray(out)[W : int(total)].tobytes()
        return emitted, consumed, bool(int(bfinal))


def zlib_decompress_device(data: bytes, config: DeflateConfig = DeflateConfig()) -> bytes:
    """RFC 1950 unwrap + device inflate + Adler-32 verify.

    The config's DECOMPRESS-side elaboration flags specialize the compiled
    program: ``dynamic=False`` / ``low_lut`` select the table-free
    arithmetic static decoder (smaller program, ERR_DYNAMIC on dynamic
    blocks); ``one_block`` stops after the first block."""
    from tpu_deflate.ops.checksum import adler32_jax

    from tpu_deflate.ref.inflate import DeflateError

    if len(data) < 6:
        raise DeflateError("zlib stream too short")
    cmf, flg = data[0], data[1]
    if cmf & 0x0F != 8 or (cmf << 8 | flg) % 31 != 0:
        raise DeflateError("bad zlib header")
    out, total, end_bit = inflate_device(
        data,
        start_bit=16,
        static_only=config.low_lut or not config.dynamic,
        one_block=config.one_block,
    )
    trailer_at = (end_bit + 7) // 8
    expect = int.from_bytes(data[trailer_at : trailer_at + 4], "big")
    got = int(adler32_jax(jnp.asarray(out), total))
    if got != expect:
        raise DeflateError(f"Adler-32 mismatch {got:#x} != {expect:#x}")
    return out[:total].tobytes()
