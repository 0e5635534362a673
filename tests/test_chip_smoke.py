"""CPU checks of ``chip_smoke.py``: the GPU-only guard and every phase at
small sizes.

On the CPU the script as a whole must fail without a result line; each
phase function must pass here at 256 KiB (the same zlib/gzip checks the
GPU run makes at 8 MiB), and the four-device phase must pass on 4 of the
8 virtual CPU devices.  Byte-exact comparisons throughout: the codec has
no float matrix product on any path, so TF32 cannot affect results.
"""

import json

import jax
import pytest

import chip_smoke as cs
from bench import load_corpus

SMALL = 256 << 10


@pytest.fixture(scope="module")
def data():
    return load_corpus(SMALL)


def test_main_fails_on_cpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out
    for line in out.splitlines():
        if line.startswith("{"):
            assert not json.loads(line).get("ok")


def test_phase_device_requires_gpu(capsys):
    with pytest.raises(cs.SmokeFailure, match="not gpu"):
        cs.phase_device()
    assert "platform=cpu" in capsys.readouterr().out


def test_phase_encode_and_own_decode(data):
    comp = cs.phase_encode(data)
    cs.phase_own_decode(data, comp)


def test_phase_dynamic(data):
    cs.phase_dynamic(data)


def test_phase_foreign_zlib(data):
    cs.phase_foreign_zlib(data)


def test_phase_gzip(data):
    cs.phase_gzip(data)


def test_phase_full_window(data):
    cs.phase_full_window(data)


def test_phase_streaming(data):
    cs.phase_streaming(data, feed=64 << 10, nfeeds=3)


def test_phase_selftest():
    cs.phase_selftest()


def test_phase_four_on_virtual_devices():
    devices = jax.devices()[:4]
    assert len(devices) == 4
    cs.phase_four(load_corpus(4 * 8 * 4096), devices, chunk=4096)


def test_step_line_format(capsys):
    out = cs.step("p", "s", 3, lambda: b"abc", lambda r: 0.5)
    assert out == b"abc"
    line = capsys.readouterr().out.strip()
    fields = dict(kv.split("=", 1) for kv in line.split())
    assert fields["phase"] == "p" and fields["step"] == "s"
    assert fields["bytes"] == "3" and fields["ratio"] == "0.5000"
    assert {"cold_s", "warm_s", "peak_bytes_in_use"} <= fields.keys()


def test_failed_check_raises():
    with pytest.raises(cs.SmokeFailure, match="boom"):
        cs.step("p", "s", 0, lambda: 1, lambda r: cs.check(r == 2, "boom"))
