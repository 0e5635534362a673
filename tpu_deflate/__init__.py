"""tpu-deflate: a data-parallel lossless DEFLATE (RFC 1950/1951/1952) codec.

A JAX reinterpretation of the capabilities of tomtor/HDL-deflate (an FPGA
MyHDL core): zlib-compatible compress and decompress as data-parallel
accelerator programs rather than a byte-per-cycle state machine.

Quick start::

    import tpu_deflate

    comp = tpu_deflate.compress(data)             # valid zlib stream
    out = tpu_deflate.decompress(comp)            # bit-exact round trip

    cfg = tpu_deflate.DeflateConfig(window=32768, max_match=258,
                                    dynamic_encode=True, lazy=True)
    comp = tpu_deflate.compress(data, cfg)
"""

import os as _os

import jax as _jax

#: Persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)

# Persistent XLA compilation cache, so that later processes start warm.
# JAX itself honours JAX_COMPILATION_CACHE_DIR; otherwise the cache sits in
# the checkout.  Opt out with TPU_DEFLATE_NO_COMPILE_CACHE=1.
if not _os.environ.get("TPU_DEFLATE_NO_COMPILE_CACHE"):
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _os.makedirs(CACHE_DIR, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from tpu_deflate.api import (
    StreamCompressor,
    compress,
    compress_gzip,
    compress_gzip_members,
    compress_indexed,
    decompress,
    decompress_gzip,
    decompress_indexed,
    StreamDecompressor,
)
from tpu_deflate.ref.inflate import DeflateError
from tpu_deflate.config import (
    DEFAULT,
    DECOMPRESS_ONLY,
    FAST_CONFIG,
    FULL_WINDOW,
    LOWLUT,
    REFERENCE_PARITY,
    DeflateConfig,
)

__version__ = "0.1.0"

__all__ = [
    "DeflateConfig",
    "DeflateError",
    "DEFAULT",
    "DECOMPRESS_ONLY",
    "FAST_CONFIG",
    "FULL_WINDOW",
    "LOWLUT",
    "REFERENCE_PARITY",
    "StreamCompressor",
    "StreamDecompressor",
    "compress",
    "compress_gzip",
    "compress_gzip_members",
    "compress_indexed",
    "decompress",
    "decompress_gzip",
    "decompress_indexed",
    "__version__",
]
