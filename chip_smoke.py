"""End-to-end smoke run of the codec on a GPU, checked byte for byte by zlib.

    python chip_smoke.py           # every public entry point on one GPU
    python chip_smoke.py --four    # data-parallel encode/decode on 4 GPUs

Drives the public API on the vendored 8 MiB real corpus (128 lanes of
64 KiB).  Each step prints one line: phase, step, bytes, cold (with
compile) and warm wall seconds, compressed/raw ratio and the device's
``peak_bytes_in_use``.  Every output is compared with stock zlib/gzip in
the same run; the codec is integer-exact, so every comparison is byte
equality.  The last line is a JSON object with ``"ok": true`` and the
device; any failure, or a device that is not a GPU, exits non-zero
without printing it.  Everything runs in this one process.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import sys
import time
import traceback
import zlib

MiB = 1 << 20
CHUNK = 1 << 16


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def step(phase: str, name: str, nbytes: int, fn, verify):
    """Run ``fn`` twice (cold, then warm), verify the warm result, print
    one line and return the result."""
    t0 = time.perf_counter()
    fn()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn()
    warm = time.perf_counter() - t0
    ratio = verify(out)
    r = "" if ratio is None else f" ratio={ratio:.4f}"
    print(f"phase={phase} step={name} bytes={nbytes} cold_s={cold:.3f} "
          f"warm_s={warm:.3f}{r} peak_bytes_in_use={_peak_bytes()}",
          flush=True)
    return out


def phase_device(count: int = 1) -> dict:
    """Require ``count`` GPUs; print what JAX reports about them."""
    import jax

    devs = jax.devices()
    d = devs[0]
    print(f"phase=device platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)} jax={jax.__version__} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    check(d.platform == "gpu", f"device is {d.platform}, not gpu")
    check(len(devs) >= count, f"need {count} GPUs, have {len(devs)}")
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


def phase_encode(data: bytes) -> bytes:
    import tpu_deflate as td

    def verify(comp):
        check(zlib.decompress(comp) == data, "compress: zlib disagrees")
        return len(comp) / len(data)

    return step("encode", "compress", len(data),
                lambda: td.compress(data, td.DEFAULT), verify)


def phase_own_decode(data: bytes, comp: bytes) -> None:
    import tpu_deflate as td

    step("own_decode", "decompress", len(data),
         lambda: td.decompress(comp),
         lambda out: check(out == data, "decompress mismatch"))

    stream, index = td.compress_indexed(data, td.DEFAULT)
    check(zlib.decompress(stream) == data, "compress_indexed: zlib disagrees")
    step("own_decode", "decompress_indexed", len(data),
         lambda: td.decompress_indexed(stream, index, td.DEFAULT),
         lambda out: check(out == data, "decompress_indexed mismatch"))


def phase_dynamic(data: bytes) -> None:
    import tpu_deflate as td

    cfg = td.DeflateConfig(dynamic_encode=True)

    def verify_enc(r):
        stream, _ = r
        check(zlib.decompress(stream) == data, "dynamic: zlib disagrees")
        return len(stream) / len(data)

    stream, index = step("dynamic", "compress_indexed", len(data),
                         lambda: td.compress_indexed(data, cfg), verify_enc)
    step("dynamic", "decompress_indexed", len(data),
         lambda: td.decompress_indexed(stream, index, cfg),
         lambda out: check(out == data, "dynamic decode mismatch"))


def phase_foreign_zlib(data: bytes) -> None:
    import tpu_deflate as td

    co = zlib.compressobj(9, zlib.DEFLATED, 15, 9, zlib.Z_FIXED)
    streams = [(f"zlib{lvl}", zlib.compress(data, lvl)) for lvl in (0, 1, 6, 9)]
    streams.append(("zlib_fixed", co.compress(data) + co.flush()))
    for name, s in streams:
        step("foreign_zlib", name, len(data), lambda s=s: td.decompress(s),
             lambda out, n=name: check(out == data, f"{n} mismatch"))


def phase_gzip(data: bytes) -> None:
    import tpu_deflate as td

    g6 = gzip.compress(data, 6)
    step("gzip", "decompress_gzip6", len(data),
         lambda: td.decompress_gzip(g6),
         lambda out: check(out == data, "foreign gzip mismatch"))

    def verify_gz(what):
        def v(g):
            check(gzip.decompress(g) == data, f"{what}: gzip disagrees")
            return len(g) / len(data)
        return v

    step("gzip", "compress_gzip", len(data),
         lambda: td.compress_gzip(data), verify_gz("compress_gzip"))
    members = step("gzip", "compress_gzip_members", len(data),
                   lambda: td.compress_gzip_members(data),
                   verify_gz("compress_gzip_members"))
    step("gzip", "decompress_gzip_members", len(data),
         lambda: td.decompress_gzip(members),
         lambda out: check(out == data, "gzip members mismatch"))


def phase_full_window(data: bytes) -> None:
    import tpu_deflate as td

    raw = data[: 2 * MiB]

    def verify(comp):
        check(zlib.decompress(comp) == raw, "FULL_WINDOW: zlib disagrees")
        return len(comp) / len(raw)

    step("full_window", "compress", len(raw),
         lambda: td.compress(raw, td.FULL_WINDOW), verify)


def phase_streaming(data: bytes, feed: int = MiB, nfeeds: int = 3) -> None:
    import tpu_deflate as td

    raw = data[: feed * nfeeds]

    def compress():
        sc = td.StreamCompressor(td.DEFAULT)
        parts = [sc.compress(raw[i:i + feed]) for i in range(0, len(raw), feed)]
        return b"".join(parts) + sc.flush()

    def verify(s):
        check(zlib.decompress(s) == raw, "StreamCompressor: zlib disagrees")
        return len(s) / len(raw)

    stream = step("streaming", "StreamCompressor", len(raw), compress, verify)

    zs = zlib.compress(raw, 6)
    cfeed = -(-len(zs) // nfeeds)

    def decompress():
        sd = td.StreamDecompressor()
        parts = [sd.decompress(zs[i:i + cfeed]) for i in range(0, len(zs), cfeed)]
        return b"".join(parts) + sd.flush()

    step("streaming", "StreamDecompressor", len(raw), decompress,
         lambda out: check(out == raw, "StreamDecompressor mismatch"))
    check(zlib.decompress(stream) == raw, "stream re-check")


def phase_selftest() -> None:
    from tpu_deflate.selftest import run_selftest

    step("selftest", "run_selftest", 0, lambda: run_selftest(verbose=False),
         lambda ok: check(ok, "selftest failed"))


def phase_four(data: bytes, devices, chunk: int = CHUNK) -> None:
    """Data-parallel encode and decode over a flat 1-D mesh of ``devices``.

    Per-lane compressed bytes must equal single-device
    ``encode_blocks_batch`` on devices[0] byte for byte, the assembled
    stream must satisfy zlib, and the sharded decode must give back
    ``data``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_deflate.config import DEFAULT
    from tpu_deflate.ops.encode import encode_blocks_batch
    from tpu_deflate.parallel.shard import decode_sharded, encode_sharded, make_mesh

    cfg = dataclasses.replace(DEFAULT, chunk_size=chunk)
    nd = len(devices)
    B = len(data) // chunk
    check(B % nd == 0 and B * chunk == len(data), "data must tile the mesh")
    mesh = make_mesh(devices)
    arr = np.frombuffer(data, np.uint8).reshape(B, chunk)
    lens = np.full(B, chunk, np.int32)
    finals = np.zeros(B, bool)
    finals[-1] = True

    def encode():
        out, sizes, adler = encode_sharded(
            jnp.asarray(arr), jnp.asarray(lens), jnp.asarray(finals), mesh, cfg)
        return np.asarray(out), np.asarray(sizes), int(adler)

    def verify_enc(r):
        out, sizes, adler = r
        body = b"".join(out[i, :sizes[i]].tobytes() for i in range(B))
        check(adler == zlib.adler32(data), "sharded Adler-32 differs from zlib")
        stream = b"\x78\x9c" + body + adler.to_bytes(4, "big")
        check(zlib.decompress(stream) == data, "sharded encode: zlib disagrees")
        return len(stream) / len(data)

    out, sizes, _ = step("four", "encode_sharded", len(data), encode, verify_enc)

    per = B // nd
    dev0 = devices[0]

    def single():
        res = []
        for k in range(nd):
            sl = slice(k * per, (k + 1) * per)
            o, s, _ = encode_blocks_batch(
                jax.device_put(arr[sl], dev0), jax.device_put(lens[sl], dev0),
                jax.device_put(finals[sl], dev0), cfg)
            res.append((np.asarray(o), np.asarray(s)))
        return res

    def verify_single(res):
        for k, (o, s) in enumerate(res):
            for i in range(per):
                g = k * per + i
                check(s[i] == sizes[g] and
                      o[i, :s[i]].tobytes() == out[g, :sizes[g]].tobytes(),
                      f"lane {g}: sharded bytes differ from single device")
        return None

    step("four", "encode_single_device", len(data), single, verify_single)

    body = b"".join(out[i, :sizes[i]].tobytes() for i in range(B))
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    buf = np.zeros(1 << int(np.ceil(np.log2(max(len(body), 2)))), np.uint8)
    buf[:len(body)] = np.frombuffer(body, np.uint8)

    def decode():
        o, t, e = decode_sharded(
            jnp.asarray(buf), jnp.asarray(8 * offsets[:-1], jnp.int32),
            jnp.asarray(8 * offsets[1:], jnp.int32), mesh,
            chunk_out_size=chunk, static_only=True)
        return np.asarray(o), np.asarray(t), np.asarray(e)

    def verify_dec(r):
        o, t, e = r
        check((e == 0).all(), f"sharded decode errors {e[e != 0][:8]}")
        got = b"".join(o[i, :t[i]].tobytes() for i in range(B))
        check(got == data, "sharded decode mismatch")
        return None

    step("four", "decode_sharded", len(data), decode, verify_dec)


def run(four: bool) -> dict:
    import jax

    from bench import load_corpus, nvidia_smi

    device = phase_device(4 if four else 1)
    print(nvidia_smi(), flush=True)
    if four:
        phase_four(load_corpus(32 * MiB), jax.devices()[:4])
        return device
    data = load_corpus(8 * MiB)
    comp = phase_encode(data)
    phase_own_decode(data, comp)
    phase_dynamic(data)
    phase_foreign_zlib(data)
    phase_gzip(data)
    phase_full_window(data)
    phase_streaming(data)
    phase_selftest()
    return device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU data-parallel path")
    args = ap.parse_args(argv)
    try:
        device = run(args.four)
    except Exception:  # any failure: report it, print no result line
        traceback.print_exc()
        print("chip_smoke FAILED", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
