"""Package-level behaviour: where the compile cache goes, and that no
code path depends on a particular accelerator platform."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _cache_dir(env_value):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "TPU_DEFLATE_NO_COMPILE_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    r = subprocess.run(
        [sys.executable, "-c",
         "import tpu_deflate, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


def test_compile_cache_follows_env(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir(want) == want


def test_compile_cache_defaults_to_checkout():
    import tpu_deflate

    assert _cache_dir(None) == str(ROOT / ".jax_cache") == tpu_deflate.CACHE_DIR


@pytest.mark.parametrize("needle", [
    "pallas.tpu", "pallas import tpu", 'platform == "tpu"',
    "default_backend() != \"tpu\"", "TPU_DEFLATE_NO_", "interpret=",
])
def test_no_platform_specific_code(needle):
    hits = []
    for path in (ROOT / "tpu_deflate").rglob("*.py"):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if needle in line and "NO_COMPILE_CACHE" not in line:
                hits.append(f"{path.relative_to(ROOT)}:{n}: {line.strip()}")
    assert not hits, "\n".join(hits)
