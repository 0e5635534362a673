"""Data-parallel sharding layer: how the codec scales across devices.

The reference's only I/O scaling story is its byte-wide host port protocol
with backpressure (/root/reference/deflate.py:18,220-221,599-605 and driver
test_deflate.py:142-174).  Across several devices the equivalent is data
parallelism over independent DEFLATE block runs (SURVEY.md section 2.3):
shard the chunk batch over a 1-D device mesh, encode/decode locally,
exchange sizes with an all-gather, compute global offsets by exclusive
scan, and assemble the ordered stream with a ragged gather.  Per-chunk
Adler-32 states fold with the associative combine rule, so the stream
checksum needs no serial pass anywhere.

Multi-host: the same mesh spans hosts via jax.distributed; nothing here
changes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from tpu_deflate.config import DeflateConfig
from tpu_deflate.ops.checksum import adler32_state
from tpu_deflate.ops.decode import chunk_pwin, expand_batch, tokenize
from tpu_deflate.ops.encode import encode_blocks_batch


def make_mesh(devices=None, axis: str = "dp") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def _adler_fold(a: jax.Array, b: jax.Array, lens: jax.Array):
    """Fold per-chunk (a, b, len) Adler states left-to-right (device);
    delegates to the int32-overflow-safe associative combine."""
    from tpu_deflate.ops.checksum import adler32_pair_combine

    def step(carry, x):
        return adler32_pair_combine(carry, x), None

    (fa, fb, fl), _ = jax.lax.scan(
        step, (jnp.int32(1), jnp.int32(0), jnp.int32(0)), (a, b, lens)
    )
    return fa, fb, fl


def assemble_ragged(chunks: jax.Array, sizes: jax.Array, total_cap: int):
    """Ordered ragged concat: uint8[B, M] + sizes[B] -> uint8[total_cap].

    Fully vectorized (searchsorted ownership + gather); this is the
    device-side replacement for draining the reference's output ring one
    byte per cycle.
    """
    B, M = chunks.shape
    offs = jnp.cumsum(sizes) - sizes  # exclusive
    total = jnp.sum(sizes)
    j = jnp.arange(total_cap, dtype=jnp.int32)
    owner = jnp.clip(jnp.searchsorted(offs, j, side="right") - 1, 0, B - 1)
    within = j - offs[owner]
    val = chunks[owner, jnp.clip(within, 0, M - 1)]
    return jnp.where(j < total, val, 0).astype(jnp.uint8), total


def encode_shard_fn(config: DeflateConfig, axis: str = "dp"):
    """Build the per-shard encode function for shard_map.

    In: data uint8[b, C], lengths int32[b], finals bool[b] (local shard).
    Out: (out uint8[b, M], out_sizes int32[b], global (a, b, len) fold).
    """
    def fn(data, lengths, finals):
        out, sizes, _ = encode_blocks_batch(data, lengths, finals, config)
        a, b = jax.vmap(adler32_state)(data, lengths)
        # fold local chunk states, then exchange 3 scalars per device
        # across the mesh with an all-gather.
        fa, fb, fl = _adler_fold(a, b, lengths)
        ga = jax.lax.all_gather(fa, axis)
        gb = jax.lax.all_gather(fb, axis)
        gl = jax.lax.all_gather(fl, axis)
        sa, sb, sl = _adler_fold(ga, gb, gl)
        return out, sizes, sa, sb, sl

    return fn


@functools.lru_cache(maxsize=None)
def _sharded_encoder(mesh: Mesh, config: DeflateConfig, axis: str):
    """Jitted shard_map encode, built once per (mesh, config, axis): a
    fresh ``jax.jit`` wrapper per call would re-trace every call."""
    return jax.jit(jax.shard_map(
        encode_shard_fn(config, axis),
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(), P(), P()),
        check_vma=False,
    ))


def encode_sharded(
    data: jax.Array,
    lengths: jax.Array,
    finals: jax.Array,
    mesh: Mesh,
    config: DeflateConfig = DeflateConfig(),
    axis: str = "dp",
):
    """DP-sharded batch encode over the mesh.

    data: uint8[B, C] with B divisible by mesh size.  Returns
    (out uint8[B, M], sizes int32[B], adler uint32) with out/sizes sharded
    over the batch axis.
    """
    out, sizes, sa, sb, sl = _sharded_encoder(mesh, config, axis)(
        data, lengths, finals
    )
    adler = (sb.astype(jnp.uint32) << 16) | sa.astype(jnp.uint32)
    return out, sizes, adler


def decode_shard_fn(chunk_out_size: int, tok_cap: int, axis: str = "dp",
                    static_only: bool = False):
    """Per-shard chunk-parallel decode for shard_map.

    Each lane decodes one chunk of the stream given its (start_bit,
    end_bit) boundaries; the full (replicated) stream is broadcast.
    In: data uint8[M] (replicated), start_bits int32[b], end_bits int32[b].
    Out: (out uint8[b, chunk_out_size], out_lens int32[b], errs int32[b]).
    """

    def fn(data, start_bits, end_bits):
        tk, ta, tb, tp, _tot, _pos, err = jax.vmap(
            lambda s, e: tokenize(
                data, s, tok_cap=tok_cap, end_bit=e,
                pwin=chunk_pwin(chunk_out_size),
                stop_at_eob=True, static_only=static_only,
            )
        )(start_bits, end_bits)
        out, total = expand_batch(data, tk, ta, tb, tp, out_cap=chunk_out_size)
        return out, total, err

    return fn


@functools.lru_cache(maxsize=None)
def _sharded_decoder(mesh: Mesh, chunk_out_size: int, axis: str,
                     static_only: bool):
    """Jitted shard_map decode, built once per argument set (see
    _sharded_encoder)."""
    fn = decode_shard_fn(chunk_out_size, chunk_out_size + 16, axis, static_only)
    return jax.jit(jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False,
    ))


def decode_sharded(
    data: jax.Array,
    start_bits: jax.Array,
    end_bits: jax.Array,
    mesh: Mesh,
    chunk_out_size: int,
    axis: str = "dp",
    static_only: bool = False,
):
    """DP-sharded chunk-parallel decode: stream replicated, chunk boundary
    lists sharded over the mesh.  ``static_only`` selects the arithmetic
    stored/static-tree decoder (our container's fast path)."""
    dec = _sharded_decoder(mesh, chunk_out_size, axis, static_only)
    return dec(data, start_bits, end_bits)
