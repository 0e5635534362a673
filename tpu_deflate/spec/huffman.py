"""Canonical Huffman code construction and instant-lookup decode tables.

The decode table is the software analog of the reference's ``leaves`` RAM +
SPREAD replication (tomtor/HDL-deflate: canonical builder HF1..HF4_3/SPREAD,
/root/reference/deflate.py:1204-1400; leaf packing ``makeLeaf``/``get_bits``/
``get_code``, deflate.py:253-266).  Instead of the reference's
instantMaxBit + widen-on-miss loop (deflate.py:1423-1430) we build a FULL
``2**max_bits`` table so decode is always a single lookup (a 15-bit table
is 128 KiB of int32) with a branch-free decode loop.

Leaf packing: entry = (symbol << 4) | nbits, nbits in 1..15, 0 == invalid.
"""

from __future__ import annotations

import numpy as np

MAX_CODE_BITS = 15
LEAF_BITS_MASK = 0xF


def reverse_bits(code: int, nbits: int) -> int:
    """Reverse the low `nbits` bits of `code` (Huffman codes go MSB-first
    on an LSB-first-packed wire)."""
    out = 0
    for _ in range(nbits):
        out = (out << 1) | (code & 1)
        code >>= 1
    return out


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """RFC 1951 section 3.2.2 canonical code assignment.

    lengths[i] == 0 means symbol i is absent.  Returns MSB-first integer
    codes (NOT bit-reversed).
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    max_bits = int(lengths.max(initial=0))
    bl_count = np.bincount(lengths, minlength=max_bits + 1).astype(np.int64)
    bl_count[0] = 0
    next_code = np.zeros(max_bits + 2, dtype=np.int64)
    code = 0
    for bits in range(1, max_bits + 1):
        code = (code + bl_count[bits - 1]) << 1
        next_code[bits] = code
    codes = np.zeros_like(lengths)
    for sym, n in enumerate(lengths):
        if n:
            codes[sym] = next_code[n]
            next_code[n] += 1
    return codes


def pack_leaf(symbol: int | np.ndarray, nbits: int | np.ndarray):
    return (symbol << 4) | nbits


def leaf_symbol(leaf):
    return leaf >> 4


def leaf_nbits(leaf):
    return leaf & LEAF_BITS_MASK


def build_decode_table(lengths: np.ndarray, table_bits: int | None = None) -> np.ndarray:
    """Full instant-lookup decode table.

    Index the table with `table_bits` bits peeked LSB-first from the
    stream; the entry gives (symbol, code length).  Short codes are
    replicated ("spread") into every aliasing slot, exactly the semantics
    of the reference's SPREAD state (deflate.py:1376-1400) but always at
    full depth so there is never a miss path.
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    if table_bits is None:
        table_bits = int(lengths.max(initial=1))
    if table_bits > MAX_CODE_BITS:
        raise ValueError(f"table_bits {table_bits} > {MAX_CODE_BITS}")
    codes = canonical_codes(lengths)
    table = np.zeros(1 << table_bits, dtype=np.int32)
    for sym, n in enumerate(lengths):
        n = int(n)
        if n == 0:
            continue
        if n > table_bits:
            raise ValueError(f"code length {n} exceeds table_bits {table_bits}")
        base = reverse_bits(int(codes[sym]), n)
        leaf = pack_leaf(sym, n)
        step = 1 << n
        table[base::step] = leaf  # spread across all aliased high bits
    return table


def code_lengths_from_freqs(freqs: np.ndarray, max_bits: int = MAX_CODE_BITS) -> np.ndarray:
    """Length-limited Huffman code lengths from symbol frequencies.

    Package-merge would be optimal; we use plain Huffman + heuristic
    depth-limiting (the zlib approach is similar in spirit).  Used by the
    dynamic-tree ENCODER, which is a capability the reference does not have
    (it only decodes dynamic trees) but the RFC requires for full parity
    with zlib-produced streams.
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    n = len(freqs)
    active = [i for i in range(n) if freqs[i] > 0]
    if not active:
        return np.zeros(n, dtype=np.int32)
    if len(active) == 1:
        out = np.zeros(n, dtype=np.int32)
        out[active[0]] = 1
        return out

    import heapq

    heap = [(int(freqs[i]), i, ("leaf", i)) for i in active]
    heapq.heapify(heap)
    counter = n
    while len(heap) > 1:
        f1, _, t1 = heapq.heappop(heap)
        f2, _, t2 = heapq.heappop(heap)
        heapq.heappush(heap, (f1 + f2, counter, ("node", t1, t2)))
        counter += 1
    depths = np.zeros(n, dtype=np.int32)
    stack = [(heap[0][2], 0)]
    while stack:
        node, d = stack.pop()
        if node[0] == "leaf":
            depths[node[1]] = max(d, 1)
        else:
            stack.append((node[1], d + 1))
            stack.append((node[2], d + 1))

    # Depth-limit: repeatedly move overlong leaves up.  Kraft fixing:
    while depths.max() > max_bits:
        # take one deepest leaf, find a leaf with depth < max_bits-? to pair
        over = int(np.argmax(depths))
        depths[over] = max_bits
        # restore Kraft inequality
        while True:
            kraft = np.sum((depths > 0) * (2.0 ** (-depths.astype(np.float64))))
            if kraft <= 1.0 + 1e-12:
                break
            # deepen the shallowest leaf that can be deepened
            cand = np.where((depths > 0) & (depths < max_bits))[0]
            if len(cand) == 0:
                raise RuntimeError("cannot satisfy Kraft with depth limit")
            shallow = cand[np.argmin(depths[cand])]
            depths[shallow] += 1
    # tighten: if Kraft < 1 we can shorten some codes (optional, keeps
    # canonical build valid either way as long as Kraft == sum <= 1 and the
    # tree is complete; DEFLATE requires a complete tree, so fix up)
    _make_kraft_exact(depths, max_bits)
    return depths


def _make_kraft_exact(depths: np.ndarray, max_bits: int) -> None:
    """Adjust code lengths in place so sum(2^-d) == 1 (complete tree)."""
    if depths.max(initial=0) == 0:
        return
    unit = 1 << max_bits
    total = int(np.sum((depths > 0) * (1 << (max_bits - np.minimum(depths, max_bits)))))
    # total > unit should not happen (Kraft violated); total < unit means
    # the tree is incomplete -> shorten codes greedily.
    while total > unit:
        # lengthen a shallowest code
        cand = np.where((depths > 0) & (depths < max_bits))[0]
        i = cand[np.argmin(depths[cand])]
        total -= 1 << (max_bits - depths[i])
        depths[i] += 1
        total += 1 << (max_bits - depths[i])
    while total < unit:
        # shorten the deepest code whose shortening does not overshoot
        order = np.argsort(-depths)
        done = False
        for i in order:
            if depths[i] > 1:
                gain = 1 << (max_bits - depths[i])
                if total + gain <= unit:
                    depths[i] -= 1
                    total += gain
                    done = True
                    break
        if not done:
            break
