"""Static configuration, the analog of the reference's elaboration flags.

The reference specializes hardware at elaboration time via module constants
COMPRESS / DECOMPRESS / DYNAMIC / MATCH10 / FAST / ONEBLOCK / LOWLUT and
sizes CWINDOW / IBSIZE / OBSIZE with legality rules
(/root/reference/deflate.py:21-89).  Here the same surface is a frozen
dataclass consumed BEFORE ``jax.jit`` tracing, so feature flags specialize
the compiled program exactly as the reference's ``if FLAG:`` blocks
specialize the netlist — disabled paths are simply never traced.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeflateConfig:
    """Compile-time configuration for the device codec.

    Mirrors the reference flag surface:
      compress / decompress  -> COMPRESS / DECOMPRESS (deflate.py:23-24)
      dynamic                -> DYNAMIC  (decode dynamic-Huffman blocks;
                                we additionally support dynamic-tree ENCODE,
                                which the reference lacks) (deflate.py:25)
      match10                -> MATCH10 (max match length 10 vs 5)
                                (deflate.py:26)
      fast                   -> FAST (32-byte window whole-window matcher)
                                (deflate.py:27)
      one_block              -> ONEBLOCK (single DEFLATE block per stream)
                                (deflate.py:28)
      window                 -> CWINDOW (deflate.py:55-62), extended up to
                                the full RFC 32768
      low_lut                -> LOWLUT (decompress-only, minimal tables)
                                (deflate.py:21)
    """

    compress: bool = True
    decompress: bool = True
    dynamic: bool = True
    match10: bool = True
    fast: bool = False
    one_block: bool = False
    low_lut: bool = False

    # Sliding-window size for the matcher.  Reference: 32 (FAST) or 256;
    # we additionally allow the full RFC 1951 window of 32768.
    window: int = 256

    # Maximum match length the encoder will emit.  Reference: 5 default,
    # 10 with MATCH10; RFC allows up to 258.
    max_match: int = 10

    # Block size for the data-parallel path (each chunk is encoded as an
    # independent byte-aligned DEFLATE block run).  The reference analog is
    # the IBSIZE/OBSIZE streaming buffers (deflate.py:63-71).
    chunk_size: int = 1 << 16

    # Emit dynamic-Huffman blocks when they are smaller (encoder-side
    # improvement over the reference, which is static-only).
    dynamic_encode: bool = False

    # One-step lazy matching (emit a literal when the next position holds
    # a strictly longer match).  Better ratio than the reference's greedy
    # parse; off for reference-parity configs.
    lazy: bool = False

    # Far-match (window > 256) quality knob, the zlib-level analog:
    # "exact" extends every winner to max_match byte-exactly (best ratio);
    # "fast" bounds probes to 8 bytes and stitches long matches from
    # diagonal runs (~3.6x faster, ~11% worse ratio on the bench corpus).
    far_matcher: str = "exact"

    def __post_init__(self):
        # Legality rules, mirroring /root/reference/deflate.py:43-53.
        if self.low_lut:
            if self.compress or self.dynamic or self.match10 or self.fast:
                raise ValueError(
                    "low_lut excludes compress/dynamic/match10/fast "
                    "(reference deflate.py:43-47)"
                )
            if not self.one_block:
                object.__setattr__(self, "one_block", True)
        if not self.compress and (self.match10 or self.fast):
            raise ValueError(
                "match10/fast require compress (reference deflate.py:49-53)"
            )
        if self.fast and self.window > 32:
            object.__setattr__(self, "window", 32)
        if self.window < 1 or self.window > 32768:
            raise ValueError("window must be in [1, 32768]")
        if not self.match10 and self.max_match > 5:
            object.__setattr__(self, "max_match", 5)
        if self.max_match < 3 or self.max_match > 258:
            raise ValueError("max_match must be in [3, 258]")
        if self.far_matcher not in ("exact", "fast"):
            raise ValueError("far_matcher must be 'exact' or 'fast'")


# Reference parity presets (README.md build configurations).
DEFAULT = DeflateConfig()
FAST_CONFIG = DeflateConfig(fast=True, window=32)
REFERENCE_PARITY = DeflateConfig(window=256, max_match=10)
FULL_WINDOW = DeflateConfig(
    window=32768, max_match=258, dynamic_encode=True, lazy=True
)
DECOMPRESS_ONLY = DeflateConfig(
    compress=False, match10=False, fast=False, max_match=258
)
LOWLUT = DeflateConfig(
    compress=False, decompress=True, dynamic=False, match10=False,
    fast=False, one_block=True, low_lut=True, max_match=258,
)
