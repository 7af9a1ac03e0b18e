"""Platform plumbing: the compile-cache location, and the GPU-only entry
points refusing any other backend instead of falling back."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Compile one small program in a fresh process and report where the
# persistent cache put it.
_COMPILE_ONE = """
import json, os, jax, jax.numpy as jnp
from dct3d_tpu.utils import enable_compilation_cache
d = enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: jnp.sin(x) * 3 + {salt})(jnp.arange(7.0)).block_until_ready()
print(json.dumps({{"dir": d, "entries": sorted(os.listdir(d))}}))
"""


def _compile_one(env_extra: dict, salt: float) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-c", _COMPILE_ONE.format(salt=salt)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_compile_cache_uses_jax_compilation_cache_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled entries land there and
    no other path is set."""
    out = _compile_one({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}, 1.25)
    assert out["dir"] == str(tmp_path)
    assert out["entries"], "no compiled entry in JAX_COMPILATION_CACHE_DIR"


def test_compile_cache_defaults_to_checkout_root():
    """Unset, the cache is the fixed .jax_cache/ at the checkout root."""
    from dct3d_tpu.utils import DEFAULT_CACHE_DIR

    assert DEFAULT_CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    out = _compile_one({}, 2.5)
    assert out["dir"] == DEFAULT_CACHE_DIR
    assert out["entries"], "no compiled entry in the checkout's .jax_cache"


def test_chip_smoke_fails_without_gpu():
    """chip_smoke.py exits non-zero, with no result line, on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "not 'gpu'" in r.stderr


def test_bench_refuses_non_gpu_backend(capsys):
    """bench.py measures the GPU only: on any other backend it exits 1
    before measuring anything."""
    sys.path.insert(0, ROOT)
    try:
        import bench
    finally:
        sys.path.remove(ROOT)
    assert bench.main() == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "measures a GPU" in out.err


@pytest.mark.parametrize("cfg_kw,want", [
    ({}, "float64"), ({"compute_dtype": "bfloat16"}, "bfloat16"),
])
def test_encode_matmul_dtype(cfg_kw, want):
    """The parity profile's encode matrices are float64 (so the product
    runs in float64 whatever JAX's global x64 setting); the bfloat16
    profile keeps its own dtype.  Decode stays float32."""
    from dct3d_tpu.codec.transform import TransformContext
    from dct3d_tpu.config import CodecConfig

    ctx = TransformContext(CodecConfig(**cfg_kw))
    assert str(ctx.enc_t.dtype) == want
    assert str(ctx.enc_t_pair.dtype) == want
    if not cfg_kw:
        assert str(ctx.dec_me.dtype) == "float32"
