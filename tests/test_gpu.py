"""Tests that need a GPU (marker `gpu`): the numerics of the encode path
on the card.  Skipped elsewhere; run there by `python -m pytest -m gpu
tests` (chip_smoke.py's gpu-tests phase).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dct3d_tpu import oracle
from dct3d_tpu.codec.encoder import encode_video
from dct3d_tpu.config import CodecConfig
from dct3d_tpu.ops import bitpack, exceptions, expgolomb

pytestmark = pytest.mark.gpu


def _values(rng, n, hot=0.01):
    vals = rng.integers(-2, 3, n).astype(np.int32)
    mask = rng.random(n) < hot
    vals[mask] = rng.integers(-5771, 5772, mask.sum())
    return vals


@pytest.mark.parametrize("carry_bits", [0, 5])
def test_pack_values_compiled_matches_numpy(rng, carry_bits):
    """The encoders' packer on the card vs the NumPy twin."""
    vals = _values(rng, 4096 * 256)
    carry = 3 if carry_bits else 0
    code, width = expgolomb.codewords_np(vals)
    code = np.concatenate([[np.uint32(carry)], code])
    width = np.concatenate([[np.int32(carry_bits)], width.astype(np.int32)])
    out_bytes = (int(width.sum()) + 7) // 8 + 5
    ref, ref_bits = bitpack.pack_bits_np(code, width, out_bytes)
    got, bits, tail, ovf = jax.jit(
        lambda v: bitpack.pack_values(
            v, jnp.uint32(carry), jnp.int32(carry_bits), out_bytes,
            max_width=29)
    )(vals)
    assert int(bits) == ref_bits and not bool(ovf)
    assert int(tail) == int(ref[(ref_bits - 1) // 8])
    np.testing.assert_array_equal(np.asarray(got), ref)


def test_einsum_forms_exact_on_gpu(rng):
    """The bf16 one-hot einsums stay exact on the card (f32 accumulation):
    pack_bits' level-1 pack and the turbo exception compaction."""
    vals = _values(rng, 1024 * 256, hot=0.02)
    code, width = expgolomb.codewords_np(vals)
    out_bytes = (int(width.sum()) + 7) // 8 + 5
    ref, ref_bits = bitpack.pack_bits_np(code, width, out_bytes)
    got, bits, _, _ = jax.jit(
        lambda c, w: bitpack.pack_bits(c, w, out_bytes, max_width=29)
    )(code, width.astype(np.int32))
    assert int(bits) == ref_bits
    np.testing.assert_array_equal(np.asarray(got), ref)

    lidx, ev, counts, ovf = exceptions.compact_exceptions(
        jnp.asarray(vals), slots=16)
    assert not bool(ovf)
    idx, val = exceptions.expand_exceptions_np(
        np.asarray(lidx), np.asarray(ev), np.asarray(counts))
    want = np.flatnonzero((vals < -8) | (vals > 7))
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_array_equal(val, vals[want])


@pytest.mark.parametrize("case", [0, 1])
def test_exact_tie_cubes_on_gpu(case):
    """Cubes with a coefficient exactly on a .5 boundary, tiled over a
    1080p GOP so the GEMM runs at its real shape: every copy quantizes as
    the oracle's exact arithmetic does."""
    import base64

    from test_pipeline import _TIE_CUBES

    from dct3d_tpu.codec import transform

    cube = np.frombuffer(base64.b64decode(_TIE_CUBES[case][0]), np.uint8)
    cfg = CodecConfig()
    frames = np.tile(cube.reshape(8, 8, 8), (1, 135, 240))
    want = oracle.quantized_coefficients(cube.reshape(8, 8, 8), cfg)
    ctx = transform.TransformContext(cfg)
    got = np.asarray(
        transform.quantize_step(jnp.asarray(frames), ctx.enc_t, cfg=cfg))
    assert got.shape == (135 * 240, 512)
    np.testing.assert_array_equal(got, np.broadcast_to(want, got.shape))


@pytest.mark.parametrize("kind", ["noise", "gradient"])
def test_encode_matches_oracle_on_gpu(rng, kind):
    """Parity-profile bytes on the card equal the float64 oracle's."""
    t, h, w = 16, 136, 240
    if kind == "noise":
        frames = rng.integers(0, 256, (t, h, w), dtype=np.uint8)
    else:
        from conftest import synthetic_video

        frames = synthetic_video(t, h, w, seed=3)
    cfg = CodecConfig()
    assert encode_video(frames, cfg) == oracle.encode(frames, cfg)
