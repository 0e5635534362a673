"""Encode stages against independent numpy oracles.

The bitplane matcher is checked against a brute-force nearest-match
finder, and the batched bit-pack's scatter-add against ``np.add.at``.
Every stage is integer arithmetic (no float matrix product anywhere), so
the comparisons are exact on every backend, TF32 or not."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from tests.corpora import corpus
from tpu_deflate.ops.encode import _match_extend_bitplane, scatter_add_channels


def test_encode_fast_config_end_to_end():
    """Full encode path at the FAST preset produces valid streams."""
    from tpu_deflate import api
    from tpu_deflate.config import DeflateConfig

    cfg = DeflateConfig(fast=True, chunk_size=4096)
    data = b"".join(corpus(m, 3000) for m in [0, 1, 3])
    comp = api.compress(data, cfg)
    assert zlib.decompress(comp) == data


# ---------------------------------------------------------------------------
# Channel scatter-add (the batched bit-pack) vs np.add.at
# ---------------------------------------------------------------------------


def _check_scatter(idx, vals, size):
    exp = np.zeros((vals.shape[0], size), np.int32)
    keep = (idx >= 0) & (idx < size)
    for c in range(vals.shape[0]):
        np.add.at(exp[c], idx[keep], vals[c][keep])
    got = np.asarray(scatter_add_channels(jnp.asarray(idx), jnp.asarray(vals), size))
    np.testing.assert_array_equal(got, exp)
    # batched form: a leading lane axis, lanes independent
    idx2 = np.stack([idx, idx[::-1].copy()])
    vals2 = np.stack([vals, vals[:, ::-1].copy()])
    got2 = np.asarray(
        scatter_add_channels(jnp.asarray(idx2), jnp.asarray(vals2), size)
    )
    np.testing.assert_array_equal(got2[0], exp)
    exp1 = np.zeros_like(exp)
    for c in range(vals.shape[0]):
        np.add.at(exp1[c], idx2[1][keep[::-1]], vals2[1][c][keep[::-1]])
    np.testing.assert_array_equal(got2[1], exp1)


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_add_matches_add_at(seed):
    """Compaction-shaped input: nondecreasing ranks for live entries, dead
    entries (idx == size) interleaved, repeated targets summed."""
    rng = np.random.default_rng(seed)
    K, size = 6144, 4096
    live = rng.random(K) < 0.3
    rank = np.cumsum(live) - live
    idx = np.where(live, rank, size).astype(np.int32)
    idx[:64] = rng.integers(0, 8, 64)  # collisions: several adds per slot
    vals = rng.integers(0, 1 << 16, (2, K)).astype(np.int32)
    _check_scatter(idx, vals, size)


def test_scatter_add_all_dead_slabs():
    """Live entries confined to the first 2048, the rest dead — including
    one exactly at the size boundary and dead entries carrying NONZERO
    values — must leave every slot >= 100 empty."""
    K, size = 3 * 2048, 4096
    nlive = 100
    idx = np.full(K, size, np.int32)
    idx[:nlive] = np.arange(nlive, dtype=np.int32)
    idx[2048:] = size + np.arange(2 * 2048, dtype=np.int32) % 7
    idx[nlive + 1] = -3  # below range: dropped as well
    rng = np.random.default_rng(3)
    vals = rng.integers(1, 1 << 14, (2, K)).astype(np.int32)
    got = np.asarray(scatter_add_channels(jnp.asarray(idx), jnp.asarray(vals), size))
    assert (got[:, nlive:] == 0).all()
    _check_scatter(idx, vals, size)


# ---------------------------------------------------------------------------
# Bitplane matcher vs a brute-force nearest-match finder
# ---------------------------------------------------------------------------


def _nearest_matches(b: np.ndarray, n: int, window: int, max_match: int):
    """For each position i with i + 3 <= n: the smallest distance d in
    [1, min(window, i)] whose 3 bytes match, extended byte by byte to
    max_match without crossing n.  Returns (dist, length), 0 where none."""
    N = len(b)
    b = b.astype(np.int64)
    dist = np.zeros(N, np.int64)
    idx = np.arange(N)
    ok = idx + 3 <= n
    for d in range(window, 0, -1):  # descending: the last hit is nearest
        hit = np.zeros(N, bool)
        i = idx[d: n - 2] if n - 2 > d else idx[:0]
        hit[i] = (b[i] == b[i - d]) & (b[i + 1] == b[i + 1 - d]) & (
            b[i + 2] == b[i + 2 - d])
        dist = np.where(hit & ok, d, dist)
    length = np.zeros(N, np.int64)
    has = dist > 0
    length[has] = 3
    alive = has.copy()
    for k in range(3, max_match):
        j = np.minimum(idx + k, N - 1)
        same = b[j] == b[np.clip(j - dist, 0, N - 1)]
        alive &= (idx + k < n) & same
        length += alive
    return dist, length


@pytest.mark.parametrize("mode", [0, 1, 3, 6])
@pytest.mark.parametrize("window,maxm", [(32, 10), (256, 10), (256, 5)])
def test_bitplane_matcher_equals_brute_force(mode, window, maxm):
    N = 4096
    raw = np.frombuffer(corpus(mode, 3500), np.uint8)
    for lane_data, n in ((raw, len(raw)), (raw[::-1], len(raw) - 7)):
        data = np.zeros(N, np.uint8)
        data[: len(lane_data)] = lane_data
        d0, l0 = _match_extend_bitplane(
            jnp.asarray(data).astype(jnp.int32), jnp.int32(n), window, maxm
        )
        d1, l1 = _nearest_matches(data, n, window, maxm)
        np.testing.assert_array_equal(np.asarray(d0), d1)
        np.testing.assert_array_equal(np.asarray(l0), l1)
